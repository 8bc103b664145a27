"""The 13 depth-aware post-processing effects, plus "Original", as PyTorch
tensor ops on the device (counterpart of danerf_tpu/fx/effects.py, formula
for formula, quirks included).

``apply_effect(name, image, depth=None, params=None, generator=None,
draws=None, device="cuda")`` takes an RGB image (uint8 or float, (H, W, 3))
and a depth map normalised to [0, 1] ((H, W) or (H, W, 1)), and returns
uint8 (H, W, 3) on the device it computed on: a tensor input's own device,
else ``device`` (CUDA unless the caller asks for the CPU).

Where the reference's behaviour is an artifact of its implementation rather
than its declared intent, the JAX package keeps it and says so, and so does
this port: the hologram's (0.8, 1.0, 0.2) channel gains, the floor before
the vignette multiply in cross processing and night vision, the (w/2)^2
radial normalisation and the int-truncated scanline bands.

The noise effects (Night Vision, Film Grain, Hologram) draw from a
``torch.Generator`` (default: seed 0 on the compute device), which is not
JAX's stream; ``draws=`` passes the draws in instead, as ``sample_stratified``'s
``rand=`` does: ``{"normal": ...}`` (standard normal, (H, W) for Night
Vision, (H, W, 3) for Film Grain and Hologram) and for Hologram also
``{"xs": ..., "widths": ...}`` (three streak columns in [0, W) and three
widths in [2, 6)).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.fx import imageops as io


def default_params() -> dict:
    """Default parameter set (reference src/post_processor.py:33-55)."""
    return {
        "toon_levels": 5,
        "toon_edge_strength": 1.0,
        "edge_threshold": 20,
        "color_saturation": 1.5,
        "bloom_strength": 0.3,
        "bloom_size": 15,
        "vignette_strength": 0.5,
        "fog_density": 5.0,
        "fog_color_r": 255,
        "fog_color_g": 255,
        "fog_color_b": 255,
        "fog_start": 0.1,
        "fog_exponent": 3.0,   # hardcoded 3.0 in the reference
        "fog_visibility": 0.3,  # hardcoded 0.3 in the reference
        "film_grain_amount": 0.2,
        "sketch_strength": 1.0,
        "posterize_levels": 4,
        "neon_glow_intensity": 0.7,
        "neon_glow_radius": 10,
        "hologram_lines": 50,
        "hologram_intensity": 0.8,
    }


# The tolerance between two computations of an effect (the port and the JAX
# package on the CPU, the card and the CPU), shared by the tests and
# chip_smoke.py: every pixel within 1 uint8 level, except where a threshold
# or a tie decides a mask (Toon's grad > 0.05, Posterize's e > 20, Canny's
# comparisons in Neon Glow): there at most FLIP_SHARE of the pixels may
# differ by more, each flip moving its neighbourhood.
THRESHOLDED = frozenset({"Toon Shader", "Posterize", "Neon Glow"})
FLIP_SHARE = 1e-3


def levels_apart(name: str, got, want) -> dict:
    """How far two uint8 (H, W, 3) results of effect ``name`` lie apart:
    the largest difference in levels, the pixels more than 1 level apart,
    and whether that is within the tolerance above."""
    got, want = (t.cpu() if torch.is_tensor(t) else torch.from_numpy(np.array(t))
                 for t in (got, want))
    if got.shape != want.shape:
        raise ValueError(f"{name}: shapes {tuple(got.shape)} and {tuple(want.shape)}")
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    over = int((diff.amax(dim=-1) > 1).sum())
    allowed = FLIP_SHARE * diff[..., 0].numel() if effect_name(name) in THRESHOLDED else 0
    return {"max_levels": int(diff.max()), "pixels_over_1": over, "ok": over <= allowed}


def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0, 255).to(torch.uint8)


# ------------------------------------------------------------------ effects
# Every effect: (image f32 [0,255] (H,W,3), depth f32 [0,1] (H,W) | None,
#                p: dict, draws: dict of tensors) -> f32 [0,255]

def _fx_original(img, depth, p, draws):
    return img


def _fx_toon(img, depth, p, draws):
    levels = p["toon_levels"]
    strength = p["toon_edge_strength"]
    quant = torch.floor(img / 255.0 * levels) / levels * 255.0
    if depth is not None:
        d = io.bilateral_filter(depth, 9, 75.0, 75.0)
        grad = io.sobel_magnitude(d)
        grad = grad / torch.clamp(grad.max(), min=1e-12)
        edges = (grad > 0.05).float()
        edges = torch.clamp(io.dilate3(edges), 0.0, 1.0)
    else:
        gray = io.rgb_to_gray(img)
        e = torch.abs(io.laplacian(gray))
        e = e / torch.clamp(e.max(), min=1e-12)
        edges = (e > 0.1).float()
    return quant * (1.0 - strength * edges[..., None])


def _fx_color_boost(img, depth, p, draws):
    h, s, v = io.rgb_to_hsv_u8(img)
    s = torch.clamp(s * p["color_saturation"], 0, 255)
    return io.hsv_to_rgb_u8(h, s, v)


_SEPIA = np.array([[0.393, 0.769, 0.189],
                   [0.349, 0.686, 0.168],
                   [0.272, 0.534, 0.131]], np.float32)


def _fx_sepia(img, depth, p, draws):
    # img @ m.T as three f32 multiply-adds a channel (no matmul, so no TF32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return torch.stack([r * float(m[0]) + g * float(m[1]) + b * float(m[2]) for m in _SEPIA],
                       dim=-1)


def _fx_bloom(img, depth, p, draws):
    size = int(p["bloom_size"])
    if size % 2 == 0:
        size += 1
    blur = io.gaussian_blur(img, size, 0.0)
    return img + blur * p["bloom_strength"]


def _radial(img, scale_by="diag"):
    h, w = img.shape[:2]
    y = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    x = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    cy, cx = h // 2, w // 2
    d2 = (x - cx) ** 2 + (y - cy) ** 2
    if scale_by == "diag":
        return torch.sqrt(d2) / float(np.float32(np.sqrt(cx ** 2 + cy ** 2)))
    return d2 / (w / 2) ** 2  # the (w/2)^2 normalisation several effects use


def _fx_vignette(img, depth, p, draws):
    dist = _radial(img, "diag")
    v = torch.clamp(1.0 - dist * p["vignette_strength"], 0.0, 1.0)
    return img * v[..., None]


def _fx_night_vision(img, depth, p, draws):
    gray = io.equalize_hist_u8(io.rgb_to_gray(img))
    noise = 15.0 * draws["normal"]
    green = torch.clamp(gray + noise, 0, 255)
    zero = torch.zeros_like(green)
    out = torch.stack([zero, green, zero], dim=-1)
    mask = torch.clamp(2.0 - _radial(img, "w2") * 1.5, 0.0, 1.0)
    return torch.floor(out) * mask[..., None]


def _fx_film_grain(img, depth, p, draws):
    grain = 50.0 * draws["normal"]
    return img + grain * p["film_grain_amount"]


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` (linear interpolation between the two
    nearest ranks, in f32) from a sort, which takes any size
    (``torch.quantile`` refuses more than 2^24 elements)."""
    v = torch.sort(x.reshape(-1).float()).values
    n = v.numel()
    pos = np.float32(q) / np.float32(100.0) * np.float32(n - 1)
    lo = np.floor(pos)
    hi_w = pos - lo
    lo_w = np.float32(1.0) - hi_w
    lo_i = int(min(max(lo, 0), n - 1))
    hi_i = int(min(max(np.ceil(pos), 0), n - 1))
    return v[lo_i] * float(lo_w) + v[hi_i] * float(hi_w)


def _fx_sketch(img, depth, p, draws):
    gray = io.rgb_to_gray(img)
    inv_blur = 255.0 - io.gaussian_blur(255.0 - gray, 21, 0.0)
    # cv2.divide(gray, inv_blur, scale=256) with saturation
    sketch = torch.clamp(gray / torch.clamp(inv_blur, min=1e-6) * 256.0, 0, 255)
    strength = p["sketch_strength"]
    if depth is not None:
        thresh = percentile(depth, 70.0)
        mask = 1.0 - torch.clamp((depth - thresh) * 5.0, 0.0, 1.0)
    else:
        mask = torch.ones_like(gray)
    blend = (1.0 - strength) * img + strength * sketch[..., None]
    return blend * mask[..., None] + img * (1.0 - mask[..., None])


def _fx_cross_processing(img, depth, p, draws):
    f = img / 255.0
    f = torch.stack([torch.clamp(f[..., 0] * 1.1, 0, 1),
                     torch.clamp(f[..., 1] * 1.3, 0, 1),
                     torch.clamp(f[..., 2] * 0.8, 0, 1)], dim=-1)
    f = (f - 0.5) * 1.4 + 0.5
    out = torch.clamp(f * 255.0, 0, 255)
    mask = torch.clamp(1.2 - _radial(img, "w2") * 0.4, 0.0, 1.0)
    # the reference casts to uint8 before the vignette multiply
    return torch.floor(out) * mask[..., None]


def _fx_posterize(img, depth, p, draws):
    levels = p["posterize_levels"]
    poster = torch.floor(img / 255.0 * levels) / levels * 255.0
    gray = io.rgb_to_gray(img)
    e = torch.abs(io.laplacian(gray))
    edges = torch.where(e > 20.0, 255.0, 0.0)
    edges3 = edges[..., None].expand_as(poster)
    return torch.where(edges3 > 0, edges3 * 0.3 + poster * 0.7, poster)


def _fx_neon_glow(img, depth, p, draws):
    if depth is not None:
        edges = io.canny_simple(torch.clamp(depth, 0, 1) * 255.0, 50.0, 150.0)
    else:
        edges = io.canny_simple(io.rgb_to_gray(img), 50.0, 150.0)
    edges = torch.clamp(io.dilate3(edges), 0.0, 255.0)
    h, s, v = io.rgb_to_hsv_u8(img)
    edge_hue = torch.remainder(h + 120.0, 180.0)
    edge_rgb = io.hsv_to_rgb_u8(edge_hue, torch.full_like(s, 255.0),
                                torch.clamp(edges, max=255.0))
    radius = int(p["neon_glow_radius"])
    glow = io.gaussian_blur(edge_rgb, radius * 2 + 1, 0.0)
    return torch.clamp(img * 0.7 + glow * p["neon_glow_intensity"], 0, 255)


def _hologram_scanlines(height: int, num_lines: int) -> np.ndarray:
    """Row darkening mask replicating the reference's int-truncated bands."""
    mask = np.ones((height,), np.float32)
    lh = height / num_lines
    for i in range(num_lines):
        y0 = int(i * lh)
        y1 = int(min((i + 0.7) * lh, height))
        mask[y0:y1] *= 0.85
    return mask


_HOLO_GAINS = (0.8, 1.0, 0.2)


def _fx_hologram(img, depth, p, draws):
    f = img / 255.0
    # The reference multiplies (R, G, B) by (0.8, 1.0, 0.2), whatever its
    # comments say the tint is; the code is authoritative.
    cyan = f * torch.tensor(_HOLO_GAINS, dtype=torch.float32, device=img.device)
    scan = torch.from_numpy(_hologram_scanlines(img.shape[0], int(p["hologram_lines"])))
    base = cyan * scan.to(img.device)[:, None, None]
    noise = 0.03 * draws["normal"]
    if depth is not None:
        e = io.sobel_magnitude(depth)
        e = e / torch.clamp(e.max(), min=1e-12)
        edge_glow = torch.stack([e * 0.1, e * 0.6, e * 0.3], dim=-1)
    else:
        edge_glow = torch.zeros_like(f)
    holo = base + edge_glow + noise
    # 3 random vertical CRT streaks brightened 1.5x
    w = img.shape[1]
    xs, widths = draws["xs"], draws["widths"]
    col = torch.arange(w, device=img.device)
    streak = torch.zeros((w,), dtype=torch.bool, device=img.device)
    for i in range(3):
        streak = streak | ((col >= xs[i]) & (col < torch.clamp(xs[i] + widths[i], max=w)))
    holo = torch.where(streak[None, :, None], holo * 1.5, holo)
    return torch.clamp(holo * 255.0, 0, 255)


def _fx_fog(img, depth, p, draws):
    fog_color = torch.tensor([p["fog_color_r"], p["fog_color_g"], p["fog_color_b"]],
                             dtype=torch.float32, device=img.device)
    if depth is None:
        return img * 0.05 + fog_color * 0.95
    start = p["fog_start"]
    adj = torch.clamp(torch.clamp(depth - start, min=0.0) / (1.0 - start), 0.0, 1.0)
    adj = adj ** p["fog_exponent"]
    adj = adj * p["fog_visibility"]
    vis = adj[..., None]
    return img * vis + fog_color * (1.0 - vis)


EFFECTS = {
    "Original": _fx_original,
    "Toon Shader": _fx_toon,
    "Color Boost": _fx_color_boost,
    "Sepia": _fx_sepia,
    "Bloom": _fx_bloom,
    "Vignette": _fx_vignette,
    "Night Vision": _fx_night_vision,
    "Film Grain": _fx_film_grain,
    "Pencil Sketch": _fx_sketch,
    "Cross Processing": _fx_cross_processing,
    "Posterize": _fx_posterize,
    "Neon Glow": _fx_neon_glow,
    "Hologram": _fx_hologram,
    "Fog": _fx_fog,
}


def effect_name(name: str) -> str:
    """The EFFECTS key for ``name`` or a slug of it ("fog", "toon_shader",
    "neon-glow"); KeyError for an unknown effect."""
    if name in EFFECTS:
        return name
    slug = name.lower().replace("_", " ").replace("-", " ")
    match = next((k for k in EFFECTS if k.lower() == slug), None)
    if match is None:
        raise KeyError(f"unknown effect {name!r}; options: {list(EFFECTS)}")
    return match


def draw_noise(name: str, shape, generator: torch.Generator, device) -> dict:
    """The random draws effect ``name`` takes at image ``shape`` (H, W, 3),
    from ``generator`` (empty for the effects without noise)."""
    name = effect_name(name)
    h, w = shape[:2]
    if name == "Night Vision":
        return {"normal": torch.randn((h, w), generator=generator, device=device)}
    if name == "Film Grain":
        return {"normal": torch.randn((h, w, 3), generator=generator, device=device)}
    if name == "Hologram":
        return {"normal": torch.randn((h, w, 3), generator=generator, device=device),
                "xs": torch.randint(0, w, (3,), generator=generator, device=device),
                "widths": torch.randint(2, 6, (3,), generator=generator, device=device)}
    return {}


def _on(x, dev) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
    return t.to(device=dev, dtype=torch.float32)


def apply_effect(name: str, image, depth=None, params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None, draws: Optional[dict] = None,
                 device="cuda") -> torch.Tensor:
    """Apply effect ``name`` to an RGB image (uint8 or float, (H, W, 3)).

    depth: optional (H, W) float in [0, 1] (the renderer's normalised depth
    buffer).  generator / draws: the noise effects' random source (see the
    module docstring).  A tensor image stays on its device; a numpy image
    goes to ``device``.  Returns uint8 (H, W, 3) on that device.
    """
    name = effect_name(name)
    p = default_params()
    if params:
        p.update(params)
    dev = image.device if torch.is_tensor(image) else resolve_device(device)
    img = _on(image, dev)
    dep = None if depth is None else _on(depth, dev)
    if dep is not None and dep.ndim == 3:  # (H, W, 1) buffers, like the reference's
        dep = dep[..., 0]
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        draws = draw_noise(name, img.shape, generator, dev)
    else:
        draws = {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))).to(dev)
                 for k, v in draws.items()}
    return _u8(EFFECTS[name](img, dep, p, draws))
