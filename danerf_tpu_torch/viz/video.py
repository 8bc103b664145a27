"""Video from an image sequence, the counterpart of danerf_tpu/viz/video.py's
``create_video_from_images``: glob pattern, sorted, optional resize, fps.

The JAX package writes through OpenCV's VideoWriter: MPEG-4 Part 2 as
``mp4v`` in ``.mp4``, ``.mov`` and ``.mkv`` and as ``XVID`` in ``.avi``,
any other name becoming ``<root>.mp4``.  The port writes the same files
with no imaging or media library: the codec is ``viz/mpeg4.py``, the
containers ``viz/mux.py``.  Frames are read as ``cv2.imread`` reads them
(``data/images.read_cv2``): a file cv2 cannot read is skipped, and if it is
the first the function returns False.  ``resolution`` resizes bilinearly as
``cv2.resize``'s default INTER_LINEAR does (half-pixel centres, no
antialiasing).  ``read_video`` decodes such a file back.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

from danerf_tpu_torch.data.images import read_cv2
from danerf_tpu_torch.viz import mpeg4
from danerf_tpu_torch.viz.mux import demux, open_writer

EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv")
# fourccs FFmpeg decodes with the XviD IDCT when the stream names no encoder
_XVID_TAGS = (b"XVID", b"XVIX", b"RMP4", b"ZMP4", b"SIPP")


def idct_for(path: str) -> str:
    """The inverse transform FFmpeg decodes the port's file at ``path``
    with: XviD's for an ``.avi`` (the XVID fourcc), the simple IDCT for
    the others."""
    return "xvid" if os.path.splitext(path)[1].lower() == ".avi" else "simple"


def _axis(n_out: int, n_in: int):
    """cv2 INTER_LINEAR source indices and weights along one axis."""
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0
    low = i0 < 0
    i0[low], frac[low] = 0, 0.0
    high = i0 >= n_in - 1
    i0[high], frac[high] = n_in - 1, 0.0
    return i0, np.minimum(i0 + 1, n_in - 1), frac


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W, C) to (height, width, C), ``size`` = (width, height) as
    cv2.resize takes it."""
    width, height = size
    y0, y1, fy = _axis(height, img.shape[0])
    x0, x1, fx = _axis(width, img.shape[1])
    a = img.astype(np.float64)
    fx, fy = fx[None, :, None], fy[:, None, None]
    top = a[y0][:, x0] * (1 - fx) + a[y0][:, x1] * fx
    bottom = a[y1][:, x0] * (1 - fx) + a[y1][:, x1] * fx
    return np.clip(np.rint(top * (1 - fy) + bottom * fy), 0, 255).astype(np.uint8)


def video_path(output_path: str) -> str:
    """The name the JAX package writes: ``output_path`` when it ends in one
    of ``EXTENSIONS`` (any case), else ``<root>.mp4``."""
    root, ext = os.path.splitext(output_path)
    return output_path if ext.lower() in EXTENSIONS else root + ".mp4"


class VideoWriter:
    """MPEG-4 Part 2 frames into the container of ``path``'s extension.
    ``write`` takes uint8 (height, width, 3) RGB; ``close`` writes the
    index.  On an exception inside a ``with`` block the file is removed."""

    def __init__(self, path: str, width: int, height: int, fps=30):
        self.encoder = mpeg4.Encoder(width, height, fps, idct=idct_for(path))
        self.mux = open_writer(path, self.encoder.headers, width, height, fps)
        self.frames = 0

    def write(self, rgb: np.ndarray):
        packet, key = self.encoder.encode(rgb)
        self.mux.add(packet, key)
        self.frames += 1

    def close(self):
        self.mux.close()

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        self.mux.__exit__(kind, value, tb)


def create_video_from_images(image_dir: str, output_path: str,
                             pattern: str = "rgb_*.png", fps: int = 30,
                             resolution: Optional[Tuple[int, int]] = None) -> bool:
    """Encode the images of ``image_dir`` matching ``pattern`` (sorted) at
    ``fps``; ``resolution`` = (width, height) resizes each frame.  Returns
    False when no image matches or the first cannot be read."""
    images = sorted(glob.glob(os.path.join(image_dir, pattern)))
    if not images:
        return False
    first = read_cv2(images[0])
    if first is None:
        return False
    if resolution:
        width, height = resolution
    else:
        height, width = first.shape[:2]

    output_path = video_path(output_path)
    out_dir = os.path.dirname(output_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with VideoWriter(output_path, width, height, fps) as video:
        for path in images:
            img = first if path == images[0] else read_cv2(path)
            if img is None:
                continue
            if resolution:
                img = resize_bilinear(img, (width, height))
            if img.shape[:2] != (height, width):
                raise ValueError(f"{path} is {img.shape[1]}x{img.shape[0]}, the video "
                                 f"{width}x{height}: pass a resolution")
            video.write(img)
    print(f"wrote {output_path}: {video.frames} frames, {width}x{height}, {fps} fps, "
          "MPEG-4 Part 2")
    return True


def decode_video(path: str):
    """(Y, Cb, Cr planes of each frame as FFmpeg shows them, I-VOP flags,
    frames per second) of a video this module writes."""
    headers, packets, _, fps, tag = demux(path)
    first = packets[0] if packets else b""
    head = headers or first[:first.find(b"\x00\x00\x01\xb6")]
    idct = "xvid" if tag.upper() in _XVID_TAGS and b"\x00\x00\x01\xb2" not in head else "simple"
    _, planes, keys = mpeg4.decode_stream(headers, packets, idct)
    return planes, keys, fps


def read_video(path: str):
    """The frames of a video this module writes as uint8 (N, H, W, 3) RGB
    (BT.601 limited range, chroma repeated over 2x2), and its frame rate."""
    planes, _, fps = decode_video(path)
    frames = np.stack([mpeg4.yuv420_to_rgb(*p) for p in planes])
    return frames, float(fps)
