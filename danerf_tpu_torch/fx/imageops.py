"""Image-processing primitives as PyTorch tensor ops (counterpart of
danerf_tpu/fx/imageops.py): correlation with reflect-101 borders, Gaussian
blur with cv2's sigma-from-ksize rule, Sobel and Laplacian, 3x3 dilation,
the bilateral filter, HSV round trips with cv2's uint8 conventions, RGB to
gray, histogram equalisation and a simplified Canny.

Every correlation is a sum of shifted multiply-adds in f32, one pass a
non-zero tap, so the result does not depend on ``torch.backends``' TF32
flags (cuDNN convolutions run in TF32 on the card by default, and a 21-tap
blur in TF32 flips uint8 levels).  Borders are gathered through an index
map that reflects as numpy's ``reflect`` mode does, also where the pad is as
wide as the image or wider (``F.pad(mode="reflect")`` refuses that).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------- convolution

def reflect_index(n: int, pad: int, device=None) -> torch.Tensor:
    """Source index of each of the ``n + 2 * pad`` positions of a length-``n``
    axis padded by ``pad`` on both sides, reflecting without repeating the
    edge (cv2 BORDER_REFLECT_101, numpy ``reflect``), again and again where
    the pad is wider than the axis."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def pad_reflect101(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Pad the first two axes of ``x`` by (ph, pw) with reflect-101 borders."""
    rows = reflect_index(x.shape[0], ph, x.device)
    cols = reflect_index(x.shape[1], pw, x.device)
    return x.index_select(0, rows).index_select(1, cols)


def conv2d(img: torch.Tensor, kernel) -> torch.Tensor:
    """2-D correlation with reflect-101 borders, per channel.

    img: (H, W) or (H, W, C) float32; kernel: (kh, kw) numpy.
    """
    k = np.asarray(kernel, np.float32)
    kh, kw = k.shape
    h, w = img.shape[:2]
    x = pad_reflect101(img.float(), kh // 2, kw // 2)
    out = None
    for i in range(kh):
        for j in range(kw):
            if k[i, j] == 0:
                continue
            term = x[i:i + h, j:j + w] * float(k[i, j])
            out = term if out is None else out + term
    return torch.zeros_like(img, dtype=torch.float32) if out is None else out


def gaussian_kernel1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel: sigma<=0 => 0.3*((ksize-1)*0.5 - 1) + 0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(i ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur matching cv2.GaussianBlur(img, (k,k), sigma)."""
    k = gaussian_kernel1d(ksize, sigma)
    return conv2d(conv2d(img, k[:, None]), k[None, :])


SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
SOBEL_Y = SOBEL_X.T
LAPLACIAN = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)


def sobel_magnitude(img: torch.Tensor) -> torch.Tensor:
    """sqrt(Sx^2 + Sy^2) with 3x3 Sobel kernels (cv2.Sobel ksize=3)."""
    gx = conv2d(img, SOBEL_X)
    gy = conv2d(img, SOBEL_Y)
    return torch.sqrt(gx * gx + gy * gy)


def laplacian(img: torch.Tensor) -> torch.Tensor:
    return conv2d(img, LAPLACIAN)


def dilate3(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Dilation of an (H, W) map with a 3x3 all-ones structuring element
    (the window pads with -inf, as ``reduce_window`` does)."""
    out = mask[None, None]
    for _ in range(iterations):
        out = F.max_pool2d(out, 3, 1, 1)
    return out[0, 0]


def bilateral_filter(img: torch.Tensor, d: int = 9, sigma_color: float = 75.0,
                     sigma_space: float = 75.0) -> torch.Tensor:
    """cv2.bilateralFilter for a single-channel float image: a d x d window
    weighted by a spatial Gaussian times a Gaussian on the value difference."""
    r = d // 2
    x = pad_reflect101(img, r, r)
    h, w = img.shape
    acc = torch.zeros_like(img)
    norm = torch.zeros_like(img)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            w_s = float(np.float32(np.exp(-(dy * dy + dx * dx) / (2.0 * sigma_space ** 2))))
            patch = x[dy + r:dy + r + h, dx + r:dx + r + w]
            diff = patch - img
            w_r = torch.exp(-(diff * diff) / (2.0 * sigma_color ** 2))
            wt = w_r * w_s
            acc = acc + wt * patch
            norm = norm + wt
    return acc / norm


# --------------------------------------------------------------- colour space

def rgb_to_hsv_u8(img: torch.Tensor):
    """cv2.cvtColor(RGB2HSV) on uint8 semantics: H in [0,180), S,V in [0,255].

    Input (H, W, 3) float in [0, 255].  Returns float (h, s, v) channels.
    """
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    safe = torch.where(diff == 0, torch.ones_like(diff), diff)
    h = torch.where(v == r, 60.0 * (g - b) / safe,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff == 0, torch.zeros_like(h), h)
    h = torch.where(h < 0, h + 360.0, h) / 2.0  # cv2 packs H/2 into u8
    s = torch.where(v == 0, torch.zeros_like(v),
                    255.0 * diff / torch.where(v == 0, torch.ones_like(v), v))
    return h, s, v


def hsv_to_rgb_u8(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inverse of rgb_to_hsv_u8 (cv2 uint8 conventions)."""
    h = h * 2.0  # back to degrees
    s = s / 255.0
    c = v * s
    hp = h / 60.0
    xval = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    m = v - c
    z = torch.zeros_like(c)
    idx = torch.floor(hp).to(torch.int32) % 6

    def select(values):
        out = values[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(idx == k, values[k], out)
        return out

    r = select([c, xval, z, z, xval, c])
    g = select([xval, c, c, xval, z, z])
    b = select([z, z, xval, c, c, xval])
    return torch.stack([r + m, g + m, b + m], dim=-1)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """cv2 RGB2GRAY weights."""
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def equalize_hist_u8(gray: torch.Tensor) -> torch.Tensor:
    """cv2.equalizeHist on a float image holding uint8 values [0,255]."""
    g = torch.clamp(torch.round(gray), 0, 255).to(torch.int64)
    hist = torch.bincount(g.reshape(-1), minlength=256).to(torch.float32)
    cdf = torch.cumsum(hist, 0)
    # cv2: lut = round((cdf - cdf_min) / (total - cdf_min) * 255)
    nz_min = torch.where(hist > 0, cdf, torch.full_like(cdf, float("inf"))).min()
    denom = torch.clamp(g.numel() - nz_min, min=1.0)
    lut = torch.clamp(torch.round((cdf - nz_min) / denom * 255.0), 0, 255)
    return lut[g]


def canny_simple(gray_u8: torch.Tensor, low: float = 50.0, high: float = 150.0) -> torch.Tensor:
    """Simplified Canny: Gaussian 5x5 -> Sobel magnitude -> non-max
    suppression -> double threshold with one-pass hysteresis (weak pixels
    survive next to strong ones).  Returns a {0, 255} float mask."""
    g = gaussian_blur(gray_u8, 5, 0.0)
    gx = conv2d(g, SOBEL_X)
    gy = conv2d(g, SOBEL_Y)
    mag = torch.sqrt(gx * gx + gy * gy)

    # quantize gradient direction to 0/45/90/135 and compare both neighbours
    ang = torch.atan2(gy, gx) * 180.0 / np.pi
    ang = torch.remainder(ang, 180.0)
    p = F.pad(mag, (1, 1, 1, 1))
    h, w = mag.shape

    def nb(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    d0 = (ang < 22.5) | (ang >= 157.5)
    d45 = (ang >= 22.5) & (ang < 67.5)
    d90 = (ang >= 67.5) & (ang < 112.5)
    n1 = torch.where(d0, nb(0, 1), torch.where(d45, nb(-1, 1),
                                               torch.where(d90, nb(-1, 0), nb(-1, -1))))
    n2 = torch.where(d0, nb(0, -1), torch.where(d45, nb(1, -1),
                                                torch.where(d90, nb(1, 0), nb(1, 1))))
    keep = (mag >= n1) & (mag >= n2)
    thin = torch.where(keep, mag, torch.zeros_like(mag))

    strong = thin >= high
    weak = (thin >= low) & ~strong
    strong_grown = dilate3(strong.float()) > 0
    edges = strong | (weak & strong_grown)
    return edges.float() * 255.0
