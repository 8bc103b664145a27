"""Evaluation (counterpart of danerf_tpu/train/evaluate.py): render held-out
views against their ground truth and score PSNR/SSIM, the numbers that the
0.1 dB parity bar is measured with.

- ``optimize_embedding``: the NeRF-W test-time protocol.  The model is
  frozen and one (app_dim,) appearance embedding, starting at zero, is fit
  by Adam (lr 0.05, beta 0.9/0.999, eps 1e-8: optax's ``adam``) to the
  rays of the view's left half, ``batch`` of them drawn with replacement a
  step.  Each step renders through ``render_rays`` (perturb off; the fused
  route under ``cfg.use_kernels``: K2, ``sample_pdf`` and K5 forward, K6
  and K3 backward, of which only the embedding's cotangent is used).
- ``EmbeddingFit``: the fit's buffers for one view size.  On the card the
  ``steps`` steps are one CUDA graph (the JAX ``fori_loop`` in one
  ``jit``), captured on the first fit and replayed for every later one;
  the embedding, Adam's moments and its count are reset inside the graph.
  A replay gives the eager fit's embedding bit for bit.  On the CPU the
  fit runs eagerly.
- ``evaluate``: every view (or the first ``max_views``) rendered by
  ``render_frame`` (perturb off) and scored on the device (``_score_view``:
  mse and ``ssim_device`` as one stacked tensor).  View i+1's ground truth
  goes up and view i-1's two scalars come back while view i renders; no
  host sync happens inside a view.

Index draws: the fit draws its (steps, batch) ray indices from a generator
seeded ``seed * 1,000,003 + 10,000 + i`` for view i (the JAX package folds
``10_000 + i`` into its key, another stream); ``idx`` replaces the draws.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.data.dataset import RayDataset
from danerf_tpu_torch.ops.rays import generate_rays
from danerf_tpu_torch.render.renderer import render_frame, render_rays
from danerf_tpu_torch.train.metrics import ssim_device
from danerf_tpu_torch.utils.hostio import fetch_async

PROTOCOL_FIT = "left-half-optimized, right-half-scored"
PROTOCOL_FULL = "full-image"


def fit_seed(seed: int, view: int) -> int:
    """The seed of view ``view``'s index draws."""
    return seed * 1_000_003 + 10_000 + view


@contextlib.contextmanager
def frozen(model):
    """The module with every parameter's ``requires_grad`` off, restored
    on exit."""
    flags = [p.requires_grad for p in model.parameters()]
    model.requires_grad_(False)
    try:
        yield model
    finally:
        for p, f in zip(model.parameters(), flags):
            p.requires_grad_(f)


def left_half_rays(c2w, height: int, width: int, focal, device):
    """Origins and directions (H * (W // 2), 3) of the view's left half."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    rays_o, rays_d = generate_rays(height, width, focal, c2w)
    half = width // 2
    return rays_o[:, :half].reshape(-1, 3), rays_d[:, :half].reshape(-1, 3)


class EmbeddingFit:
    """The embedding fit for views of ``n_rays`` left-half rays: static
    buffers for the rays, targets, index draws and time, the embedding
    (a leaf with a preallocated ``.grad``), Adam over it and the weights
    packed once.  ``graph`` (default: on CUDA) captures the ``steps``
    steps as one CUDA graph at the first fit, after one warm-up step on a
    side stream; a failed capture raises.  Launches counted while warming
    up or capturing are taken back and added again on every replay
    (``launches``: per fit)."""

    def __init__(self, model, cfg: NeRFConfig, n_rays: int, steps: int = 50,
                 batch: int = 1024, lr: float = 0.05, n_importance: Optional[int] = None,
                 device="cuda", graph: Optional[bool] = None):
        from danerf_tpu_torch.kernels.fused_mlp import pack_params
        from danerf_tpu_torch.train.trainer import _ready_for_capture

        dev = resolve_device(device)
        self.model, self.cfg, self.dev = model.to(dev), cfg, dev
        self.steps, self.batch, self.n_importance = steps, min(batch, n_rays), n_importance
        self.graph_on = dev.type == "cuda" if graph is None else graph
        if self.graph_on and dev.type != "cuda":
            raise ValueError("a CUDA-graph fit needs a CUDA device")
        self.rays_o = torch.zeros(n_rays, 3, device=dev)
        self.rays_d = torch.zeros(n_rays, 3, device=dev)
        self.target = torch.zeros(n_rays, 3, device=dev)
        self.idx = torch.zeros(steps, self.batch, dtype=torch.int64, device=dev)
        self.t = torch.zeros(1, 1, device=dev) if cfg.use_time else None
        self.emb = torch.zeros(cfg.appearance_dim, device=dev, requires_grad=True)
        self.opt = torch.optim.Adam([self.emb], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                    capturable=dev.type == "cuda")
        _ready_for_capture(self.opt)
        self.packed = (pack_params(model, cfg, appearance=True, device=dev)
                       if cfg.use_kernels else None)
        self.bg = (1.0, 1.0, 1.0) if cfg.white_background else None
        self.graph = None
        self.launches: dict = {}

    def _reset(self) -> None:
        with torch.no_grad():
            self.emb.zero_()
            for s in self.opt.state[self.emb].values():
                s.zero_()

    def _step(self, i: int) -> None:
        sel = self.idx[i]
        e = self.emb.expand(self.batch, self.cfg.appearance_dim)
        tt = None if self.t is None else self.t.expand(self.batch, 1)
        out = render_rays(self.model, self.cfg, self.rays_o[sel], self.rays_d[sel], e, t=tt,
                          n_importance=self.n_importance, perturb=False,
                          background_color=self.bg, fused_composite=self.cfg.use_kernels,
                          packed=self.packed)
        loss = torch.mean((out["rgb"] - self.target[sel]) ** 2)
        (g,) = torch.autograd.grad(loss, [self.emb])
        self.emb.grad.copy_(g)
        self.opt.step()

    def _run(self, steps: int) -> None:
        self._reset()
        for i in range(steps):
            self._step(i)

    def capture(self) -> None:
        from danerf_tpu_torch.kernels.fused_mlp import LAUNCHES

        before = dict(LAUNCHES)
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            self._run(1)
        torch.cuda.current_stream(self.dev).wait_stream(side)
        LAUNCHES.update(before)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.dev)
        with torch.cuda.graph(graph):
            self._run(self.steps)
        self.launches = {n: LAUNCHES[n] - before[n] for n in LAUNCHES}
        LAUNCHES.update(before)
        self.graph = graph

    def __call__(self, rays_o, rays_d, target, idx, t: Optional[float] = None) -> torch.Tensor:
        """Fit to these rays (n_rays, 3), targets (n_rays, 3) and index
        draws (steps, batch), at time ``t`` under ``use_time``; returns a
        copy of the fitted (app_dim,) embedding, on the device."""
        from danerf_tpu_torch.kernels.fused_mlp import LAUNCHES

        with torch.no_grad():
            self.rays_o.copy_(rays_o)
            self.rays_d.copy_(rays_d)
            self.target.copy_(target)
            self.idx.copy_(idx)
            if self.t is not None:
                self.t.fill_(0.0 if t is None else float(t))
        with frozen(self.model):
            if not self.graph_on:
                self._run(self.steps)
            else:
                if self.graph is None:
                    self.capture()
                self.graph.replay()
                for n, c in self.launches.items():
                    LAUNCHES[n] += c
        return self.emb.detach().clone()


def optimize_embedding(model, cfg: NeRFConfig, c2w, gt_image, focal,
                       n_importance: Optional[int] = None, steps: int = 50, batch: int = 1024,
                       lr: float = 0.05, t: Optional[float] = None, idx=None,
                       generator: Optional[torch.Generator] = None, device="cuda",
                       graph: Optional[bool] = None) -> torch.Tensor:
    """Fit an appearance embedding on the left half of a held-out view.

    gt_image: (H, W, 3) in [0, 1] (already over white where the caller
    composites).  ``idx`` (steps, min(batch, n_rays)) replaces the index
    draws from ``generator`` (default: seeded ``fit_seed(0, 0)``).
    Returns the (app_dim,) embedding on ``device``."""
    dev = resolve_device(device)
    gt = torch.as_tensor(np.asarray(gt_image, np.float32) if not torch.is_tensor(gt_image)
                         else gt_image, dtype=torch.float32, device=dev)
    h, w = gt.shape[:2]
    rays_o, rays_d = left_half_rays(c2w, h, w, focal, dev)
    target = gt[:, :w // 2].reshape(-1, 3)
    fit = EmbeddingFit(model, cfg, rays_o.shape[0], steps, batch, lr, n_importance, dev, graph)
    if idx is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(fit_seed(0, 0))
        idx = torch.randint(0, rays_o.shape[0], (steps, fit.batch), generator=generator,
                            device=dev)
    return fit(rays_o, rays_d, target, torch.as_tensor(idx, device=dev), t)


def _target(gt_u8: torch.Tensor, alpha_u8: Optional[torch.Tensor]) -> torch.Tensor:
    """u8 ground truth as f32 in [0, 1], over white in f32 when an alpha
    is given."""
    tgt = gt_u8.to(torch.float32) / 255.0
    if alpha_u8 is not None:
        a = alpha_u8.to(torch.float32)[..., None] / 255.0
        tgt = tgt * a + (1.0 - a)
    return tgt


def _score_view(pred, gt_u8, half: int, crop: bool, alpha_u8=None) -> torch.Tensor:
    """(mse, ssim) of one view as one stacked 0-dim pair on the device.
    ``alpha_u8``: the ground truth is composited over white in f32
    (``cfg.white_background``); ``crop``: only the right half (columns
    ``half:``) is scored, the fit protocol's leak-free half."""
    tgt = _target(gt_u8, alpha_u8)
    if crop:
        pred, tgt = pred[:, half:], tgt[:, half:]
    return torch.stack([torch.mean((pred - tgt) ** 2), ssim_device(pred, tgt)])


def _upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; to the card from pinned memory, so the copy
    is queued behind the work already on the stream instead of waiting."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def evaluate(model, cfg: NeRFConfig, dataset: RayDataset, appearance=None,
             max_views: Optional[int] = None, n_importance: Optional[int] = None,
             seed: int = 0, optimize_embeddings: bool = False, opt_steps: int = 50,
             opt_lr: float = 0.05, device="cuda", fit_idx: Optional[Sequence] = None) -> dict:
    """Render every view of ``dataset`` (the first ``max_views``) and compare
    to its ground truth.

    appearance: (N_img, app_dim) embeddings, one per view (the last row for
    views past its end): the right choice for the training split.
    optimize_embeddings: the NeRF-W held-out protocol, which takes
    precedence: per view, fit a fresh embedding on the left half
    (``EmbeddingFit``, one capture per call on the card) and score the
    right half only.  ``fit_idx``: per view, the (opt_steps, batch) index
    draws, replacing the seeded generator's.

    Returns the per-view and mean psnr/ssim/mse, ``n_views`` and the scoring
    ``protocol``, as the JAX function does."""
    dev = resolve_device(device)
    model = model.to(dev)
    n = dataset.n_images if max_views is None else min(max_views, dataset.n_images)
    h, w = dataset.height, dataset.width
    half = w // 2
    fitting = optimize_embeddings and cfg.use_appearance
    with_alpha = cfg.white_background and dataset.alphas is not None
    table = None
    if cfg.use_appearance and appearance is not None and not fitting:
        table = torch.as_tensor(appearance, dtype=torch.float32, device=dev)
    fit = None
    if fitting:
        fit = EmbeddingFit(model, cfg, h * half, opt_steps, 1024, opt_lr, n_importance, dev)

    per_view = []

    def collect(pending):
        i, wait = pending
        mse, ssim_val = (float(v) for v in wait())
        per_view.append({"view": i, "mse": mse,
                         "psnr": float(-10.0 * np.log10(max(mse, 1e-12))),
                         "ssim": ssim_val})

    def gt_dev(i):
        alpha = _upload(dataset.alphas[i], dev) if with_alpha else None
        return _upload(dataset.images[i], dev), alpha

    pending = None
    nxt = gt_dev(0) if n else None
    for i in range(n):
        t_i = None
        if getattr(dataset, "times", None) is not None:
            t_i = float(dataset.times[i])
        gt_i, alpha_i = nxt
        emb = None
        if fitting:
            rays_o, rays_d = left_half_rays(dataset.c2ws[i], h, w, dataset.focal, dev)
            target = _target(gt_i, alpha_i)[:, :half].reshape(-1, 3)
            if fit_idx is not None:
                idx = torch.as_tensor(np.asarray(fit_idx[i]), device=dev)
            else:
                g = torch.Generator(device=dev).manual_seed(fit_seed(seed, i))
                idx = torch.randint(0, rays_o.shape[0], (opt_steps, fit.batch),
                                    generator=g, device=dev)
            emb = fit(rays_o, rays_d, target, idx, t_i)
        elif table is not None:
            emb = table[min(i, table.shape[0] - 1)]
        rgb, _, _ = render_frame(model, cfg, dataset.c2ws[i], h, w, dataset.focal,
                                 appearance_embedding=emb, n_importance=n_importance,
                                 perturb=False, t=t_i, device=dev)
        wait = fetch_async(_score_view(rgb, gt_i, half, fitting, alpha_u8=alpha_i))
        if i + 1 < n:
            nxt = gt_dev(i + 1)          # the upload overlaps view i's work
        if pending is not None:
            collect(pending)             # view i-1's scores while view i renders
        pending = (i, wait)
    if pending is not None:
        collect(pending)

    return {
        "per_view": per_view,
        "psnr": float(np.mean([v["psnr"] for v in per_view])),
        "ssim": float(np.mean([v["ssim"] for v in per_view])),
        "mse": float(np.mean([v["mse"] for v in per_view])),
        "n_views": n,
        "protocol": PROTOCOL_FIT if fitting else PROTOCOL_FULL,
    }
