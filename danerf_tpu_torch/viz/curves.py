"""Training curves drawn with numpy into a PNG (counterpart of the JAX
trainer's ``_save_training_curves``, which draws with matplotlib; the port
needs no plotting library): loss and PSNR against the step, two panels side
by side, each with its frame, its title, and the first and last step and
the lowest and highest value as labels in a 3x5 bitmap font."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

PANEL = (400, 500)                 # height, width of one panel, in pixels
MARGIN = (40, 20, 50, 80)          # top, right, bottom, left
LINE = (31, 119, 180)              # the curve's colour
INK = (0, 0, 0)
SCALE = 2                          # glyph pixels per font pixel

_GLYPHS = {
    "0": "###/#.#/#.#/#.#/###", "1": ".#./##./.#./.#./###", "2": "###/..#/###/#../###",
    "3": "###/..#/###/..#/###", "4": "#.#/#.#/###/..#/..#", "5": "###/#../###/..#/###",
    "6": "###/#../###/#.#/###", "7": "###/..#/..#/..#/..#", "8": "###/#.#/###/#.#/###",
    "9": "###/#.#/###/..#/###", ".": ".../.../.../.../.#.", "-": ".../.../###/.../...",
    "+": ".../.#./###/.#./...", " ": ".../.../.../.../...", "A": ".#./#.#/###/#.#/#.#",
    "E": "###/#../###/#../###", "G": "###/#../#.#/#.#/###", "I": "###/.#./.#./.#./###",
    "L": "#../#../#../#../###", "N": "#.#/###/###/###/#.#", "O": "###/#.#/#.#/#.#/###",
    "P": "###/#.#/###/#../#..", "R": "##./#.#/##./#.#/#.#", "S": "###/#../###/..#/###",
    "T": "###/.#./.#./.#./.#.",
}


def _text(img: np.ndarray, x: int, y: int, text: str, align: str = "left") -> None:
    """Draw ``text`` (upper case, digits, . - +) with its top at row y."""
    text = text.upper()
    step = 4 * SCALE
    if align == "right":
        x -= len(text) * step
    elif align == "center":
        x -= len(text) * step // 2
    for ch in text:
        rows = _GLYPHS.get(ch, _GLYPHS[" "]).split("/")
        for r, row in enumerate(rows):
            for c, on in enumerate(row):
                if on == "#":
                    y0, x0 = y + r * SCALE, x + c * SCALE
                    img[max(y0, 0):y0 + SCALE, max(x0, 0):x0 + SCALE] = INK
        x += step


def _label(v: float) -> str:
    return f"{v:.4g}"


def _panel(steps: np.ndarray, values: np.ndarray, title: str) -> np.ndarray:
    h, w = PANEL
    top, right, bottom, left = MARGIN
    img = np.full((h, w, 3), 255, np.uint8)
    x0, x1, y0, y1 = left, w - right, top, h - bottom
    img[y0, x0:x1 + 1] = img[y1, x0:x1 + 1] = INK
    img[y0:y1 + 1, x0] = img[y0:y1 + 1, x1] = INK
    _text(img, w // 2, 12, title, "center")
    ok = np.isfinite(values)
    if not ok.any():
        return img
    lo, hi = float(values[ok].min()), float(values[ok].max())
    s_lo, s_hi = float(steps[0]), float(steps[-1])
    _text(img, x0 - 6, y0, _label(hi), "right")
    _text(img, x0 - 6, y1 - 5 * SCALE, _label(lo), "right")
    _text(img, x0, y1 + 8, _label(s_lo))
    _text(img, x1, y1 + 8, _label(s_hi), "right")
    _text(img, (x0 + x1) // 2, y1 + 8 + 8 * SCALE, "ITERATION", "center")
    span_v = hi - lo if hi > lo else 1.0
    span_s = s_hi - s_lo if s_hi > s_lo else 1.0
    px = x0 + 2 + (steps - s_lo) / span_s * (x1 - x0 - 5)
    py = y1 - 2 - (values - lo) / span_v * (y1 - y0 - 5)
    pts = [(px[i], py[i]) for i in range(len(values))]
    for i in range(len(pts)):
        if not ok[i]:
            continue
        a = pts[i]
        b = pts[i + 1] if i + 1 < len(pts) and ok[i + 1] else a
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
        xs = np.rint(np.linspace(a[0], b[0], n)).astype(int)
        ys = np.rint(np.linspace(a[1], b[1], n)).astype(int)
        for dx in (0, 1):
            for dy in (0, 1):
                img[ys + dy, xs + dx] = LINE
    return img


def curves_image(steps: Sequence[float], panels: Sequence[Tuple[str, Sequence[float]]]
                 ) -> np.ndarray:
    """uint8 (PANEL height, PANEL width x len(panels), 3): one panel per
    (title, values), each the values against ``steps``."""
    steps = np.asarray(steps, np.float64)
    out = []
    for title, values in panels:
        v = np.asarray([math.nan if x is None else x for x in values], np.float64)
        out.append(_panel(steps, v, title))
    return np.concatenate(out, axis=1)


def write_training_curves(path: str, history: Sequence[dict]) -> np.ndarray:
    """``path``: loss and PSNR of ``history`` (``MetricsLogger`` rows)
    against their step, as a PNG.  Returns the image."""
    from danerf_tpu_torch.viz.png import write_png

    steps = [r["step"] for r in history]
    img = curves_image(steps, [("TRAINING LOSS", [r.get("loss") for r in history]),
                               ("TRAINING PSNR", [r.get("psnr") for r in history])])
    write_png(path, img)
    return img
