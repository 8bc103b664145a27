"""Lanczos downscale (counterpart of PIL's ``Image.resize(size,
Image.LANCZOS)``, which the JAX Blender loader applies for ``downscale >
1``), in integer numpy arithmetic that gives Pillow's pixels.

Pillow's resample is separable: a horizontal pass, then a vertical one,
each a sum over a support of 3 x scale input pixels.  Each output pixel's
Lanczos-3 weights are normalised to sum to 1 and made fixed point with 22
fractional bits; each pass rounds (half up, the accumulator starts at
2^21) and clips to uint8 before the next.  An image with alpha is resized
premultiplied, as ``Image.resize`` does ("RGBA" -> "RGBa" -> "RGBA";
"LA" -> "La" -> "LA"): colour times alpha with Pillow's MULDIV255, then
the colour divided back by the resized alpha (255 * c // a, clipped).
"""

from __future__ import annotations

import math

import numpy as np

_PRECISION_BITS = 32 - 8 - 2
_SUPPORT = 3.0


def _lanczos(x: float) -> float:
    def sinc(v):
        if v == 0.0:
            return 1.0
        v *= math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _coefficients(in_size: int, out_size: int) -> np.ndarray:
    """The (out_size, in_size) int64 matrix of Pillow's fixed-point weights
    (``precompute_coeffs`` and ``normalize_coeffs_8bpc``, box = the whole
    image)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    mat = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(w)
        for x, v in enumerate(w):
            if ww != 0.0:
                v /= ww
            fixed = v * (1 << _PRECISION_BITS)
            mat[xx, xmin + x] = int(-0.5 + fixed) if v < 0 else int(0.5 + fixed)
    return mat


def _pass(img: np.ndarray, mat: np.ndarray, axis: int) -> np.ndarray:
    """One pass of the resample along ``axis`` of an (H, W, C) uint8 image.
    The products and sums are integers below 2^53 (255 x 2^22 x the
    support), so a float64 matmul computes them exactly in any order."""
    x = np.moveaxis(img, axis, -1)                             # (..., in)
    flat = x.reshape(-1, x.shape[-1]).astype(np.float64)
    acc = (flat @ mat.T.astype(np.float64)).astype(np.int64) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out.reshape(x.shape[:-1] + (mat.shape[0],)), -1, axis)


def _resample(img: np.ndarray, width: int, height: int) -> np.ndarray:
    h, w = img.shape[:2]
    if w != width:
        img = _pass(img, _coefficients(w, width), 1)
    if h != height:
        img = _pass(img, _coefficients(h, height), 0)
    return img


def _premultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's RGBA -> RGBa: each colour channel MULDIV255 by the alpha."""
    a = img[..., -1:].astype(np.uint32)
    tmp = img[..., :-1].astype(np.uint32) * a + 128
    return np.concatenate([(((tmp >> 8) + tmp) >> 8).astype(np.uint8), img[..., -1:]], axis=-1)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGBA: colour 255 * c // alpha clipped to 255, left as
    it is where the alpha is 0 or 255."""
    a = img[..., -1:].astype(np.int64)
    c = img[..., :-1].astype(np.int64)
    div = np.clip(255 * c // np.maximum(a, 1), 0, 255)
    col = np.where((a == 0) | (a == 255), c, div).astype(np.uint8)
    return np.concatenate([col, img[..., -1:]], axis=-1)


def lanczos_resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(img).resize((width, height), Image.LANCZOS)`` of a
    uint8 (H, W), (H, W, 2) gray + alpha, (H, W, 3) or (H, W, 4) image."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 image, got {img.dtype} {img.shape}")
    if img.shape[:2] == (height, width):
        return img.copy()
    if img.ndim == 2:
        return _resample(img[..., None], width, height)[..., 0]
    if img.shape[-1] in (2, 4):
        return _unpremultiply(_resample(_premultiply(img), width, height))
    return _resample(img, width, height)
