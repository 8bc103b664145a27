"""Procedural test scene (counterpart of danerf_tpu/data/synthetic.py, numpy
path): Gaussian density blobs with constant colours, volume-rendered in
float64 numpy into a pose-consistent multi-view dataset.  For the same seed
the images, alphas, c2ws and focal are byte-identical to the JAX package's
``make_synthetic_scene(backend="numpy")``, and those of
``make_time_varying_scene`` (the blobs move with each view's capture time,
the data of the time-conditioned variant) to its ``make_time_varying_scene``.

The ground-truth render runs over row bands, which keeps its per-sample
temporaries small without changing any element's arithmetic.
"""

from __future__ import annotations

import numpy as np

from danerf_tpu_torch.data.dataset import RayDataset
from danerf_tpu_torch.ops.rays import look_at_c2w

SYNTHETIC_FOV = 0.6911   # radians, blender-like


def _blob_field(seed: int):
    """(centers, radii, densities, colors) of the deterministic scene."""
    rng = np.random.default_rng(seed)
    k = 6
    centers = rng.uniform(-0.8, 0.8, size=(k, 3))
    radii = rng.uniform(0.25, 0.5, size=(k,))
    dens = rng.uniform(8.0, 20.0, size=(k,))
    colors = rng.uniform(0.1, 1.0, size=(k, 3))
    return centers, radii, dens, colors


def _blob_motion(seed: int):
    """Per-blob oscillation of the time-varying scene: amplitude vectors and
    phases, center_i(t) = center_i + amp_i sin(pi t + ph_i) -- half a period
    over t in [0, 1], so the first and last views differ most."""
    rng = np.random.default_rng(seed + 77_000)
    k = 6
    amps = rng.uniform(-0.35, 0.35, size=(k, 3))
    phases = rng.uniform(0.0, 2 * np.pi, size=(k,))
    return amps, phases


def field_sigma_rgb(pts: np.ndarray, seed: int = 0, t: float | None = None):
    """Analytic density and colour at points (..., 3); with ``t`` the blob
    centers sit where ``_blob_motion`` moves them at that time.

    The sums over the 3 coordinates and the 6 blobs are written out left to
    right, the order numpy's reductions over such short axes take, so the
    values are bit for bit those of the JAX package's ``np.sum`` form
    without its (..., 6, 3) temporaries."""
    centers, radii, dens, colors = _blob_field(seed)
    if t is not None:
        amps, phases = _blob_motion(seed)
        centers = centers + amps * np.sin(np.pi * t + phases)[:, None]
    diff = pts[..., None, :] - centers                               # (..., k, 3)
    d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2   # (..., k)
    w = dens * np.exp(-d2 / (2 * radii ** 2))                        # (..., k)
    sigma = np.sum(w, axis=-1)
    rgb = w[..., 0, None] * colors[0]
    for k in range(1, len(colors)):
        rgb = rgb + w[..., k, None] * colors[k]
    rgb = rgb / (sigma[..., None] + 1e-8)
    return sigma, np.clip(rgb, 0.0, 1.0)


def _render_gt(c2w: np.ndarray, H: int, W: int, focal: float, near: float, far: float,
               n_samples: int, seed: int, t: float | None = None, band: int = 8):
    """Ground-truth render of the analytic field (the reference compositing
    math) at time ``t`` (None: the static scene): rgb (H, W, 3) and acc
    (H, W), ``band`` image rows at a time."""
    i, j = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                       indexing="ij")
    dirs = np.stack([(j - W * 0.5) / focal, -(i - H * 0.5) / focal, -np.ones_like(i)], axis=-1)
    dirs = np.sum(dirs[..., None, :] * c2w[:3, :3], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.broadcast_to(c2w[:3, 3], dirs.shape)
    z = np.linspace(near, far, n_samples)
    dists = np.concatenate([np.diff(z), [1e-3]])

    rgb_map = np.empty((H, W, 3))
    acc = np.empty((H, W))
    for r0 in range(0, H, band):
        o, d = origins[r0:r0 + band], dirs[r0:r0 + band]
        pts = o[..., None, :] + d[..., None, :] * z[:, None]
        sigma, rgb = field_sigma_rgb(pts, seed, t)
        alpha = 1.0 - np.exp(-sigma * dists)
        trans = np.cumprod(np.concatenate([np.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                                          axis=-1), axis=-1)[..., :-1]
        weights = alpha * trans
        rgb_map[r0:r0 + band] = np.sum(weights[..., None] * rgb, axis=-2)
        acc[r0:r0 + band] = np.sum(weights, axis=-1)
    return rgb_map, acc


def _scene(split, n_images, height, width, near, far, n_samples, seed, timed):
    """Views k = 0 .. n_images-1 from poses on a radius-4 sphere, with
    per-split deterministic jitter; with ``timed`` view k is captured at
    t_k = k / (n_images - 1) and the dataset carries the times."""
    split_seed = {"train": 1, "val": 2, "test": 3}.get(split, 4)
    rng = np.random.default_rng(seed * 100 + split_seed)
    focal = 0.5 * width / np.tan(0.5 * SYNTHETIC_FOV)
    radius = 4.0

    images, alphas, c2ws, times = [], [], [], []
    for k in range(n_images):
        theta = 2 * np.pi * k / n_images + rng.uniform(0, 0.3)
        phi = rng.uniform(-0.35, 0.35)
        pos = np.array([radius * np.cos(phi) * np.sin(theta), radius * np.sin(phi),
                        radius * np.cos(phi) * np.cos(theta)])
        c2w = look_at_c2w(pos, np.zeros(3), np.array([0.0, 1.0, 0.0]))
        t_k = k / max(n_images - 1, 1) if timed else None
        rgb, acc = _render_gt(c2w.astype(np.float64), height, width, focal, near, far,
                              n_samples, seed, t=t_k)
        images.append((np.clip(rgb, 0, 1) * 255).astype(np.uint8))
        alphas.append((np.clip(acc, 0, 1) * 255).astype(np.uint8))
        c2ws.append(c2w)
        times.append(t_k)
    return RayDataset(images=np.stack(images), alphas=np.stack(alphas), c2ws=np.stack(c2ws),
                      focal=float(focal), near=near, far=far, split=split,
                      times=np.asarray(times, np.float32) if timed else None)


def make_synthetic_scene(split: str = "train", n_images: int | None = None,
                         height: int = 100, width: int = 100, near: float = 2.0,
                         far: float = 6.0, n_samples: int = 192, seed: int = 0) -> RayDataset:
    """A RayDataset of ground-truth renders from poses on a radius-4 sphere,
    with per-split deterministic jitter (train/val/test see distinct
    viewpoints)."""
    if n_images is None:
        n_images = {"train": 20, "val": 4, "test": 8}.get(split, 8)
    return _scene(split, n_images, height, width, near, far, n_samples, seed, timed=False)


def make_time_varying_scene(split: str = "train", n_images: int | None = None,
                            height: int = 64, width: int = 64, near: float = 2.0,
                            far: float = 6.0, n_samples: int = 128,
                            seed: int = 0) -> RayDataset:
    """The scene of the time-conditioned variant (``use_time``): view k is
    captured at t_k = k / (n - 1) in [0, 1] while the blobs move
    (``_blob_motion``), so a model without the time input cannot fit every
    view.  The dataset carries the times (``RayDataset.times``)."""
    if n_images is None:
        n_images = {"train": 16, "val": 4, "test": 8}.get(split, 8)
    return _scene(split, n_images, height, width, near, far, n_samples, seed, timed=True)
