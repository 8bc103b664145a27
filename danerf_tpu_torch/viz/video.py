"""Video from an image sequence (counterpart of danerf_tpu/viz/video.py's
``create_video_from_images``): glob pattern, sorted, optional resize, fps.

The JAX package writes through OpenCV's VideoWriter (mp4v or XVID).  The
port uses no imaging library, so it writes the container itself: a RIFF AVI
of uncompressed 24-bit ``DIB `` frames (BGR, each row padded to 4 bytes)
with an ``idx1`` index, which FFmpeg-based players and OpenCV read.  The
rows are stored top-down (a negative ``biHeight``, which BITMAPINFOHEADER
allows for uncompressed RGB): OpenCV 5.0's FFmpeg reader corrupts its heap
on the bottom-up layout, whose frames FFmpeg hands over with a negative
line size.  A ``.mp4``, ``.mov`` or ``.mkv`` name (any name not ending
in ``.avi``) becomes ``<root>.avi``; the function prints the path it wrote.
It raises before the file would pass RIFF's 32-bit size field (4 GiB).
``resolution`` resizes bilinearly as ``cv2.resize``'s default INTER_LINEAR
does (half-pixel centres, no antialiasing).  ``read_avi`` reads such a
file back.
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Iterable, Optional, Tuple

import numpy as np

from danerf_tpu_torch.data.custom import read_rgb

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10
_RIFF_MAX = 0xFFFFFFFF


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


def _chunk_header(tag: bytes, size: int) -> bytes:
    return tag + struct.pack("<I", size)


def write_avi(path: str, frames: Iterable[np.ndarray], n_frames: int, width: int,
              height: int, fps: int) -> None:
    """Write ``n_frames`` uint8 (height, width, 3) RGB frames as an
    uncompressed AVI.  The sizes are checked before ``frames`` is read."""
    stride = (3 * width + 3) & ~3
    frame_bytes = stride * height
    strl = 4 + (8 + 56) + (8 + 40)
    hdrl = 4 + (8 + 56) + (8 + strl)
    movi = 4 + n_frames * (8 + frame_bytes)
    idx1 = 16 * n_frames
    riff = 4 + (8 + hdrl) + (8 + movi) + (8 + idx1)
    if riff > _RIFF_MAX:
        raise ValueError(f"{n_frames} frames of {width}x{height} need {riff + 8} bytes; a RIFF "
                         "AVI holds at most 4 GiB: write fewer frames or pass a smaller "
                         "resolution")
    usec = int(round(1e6 / fps))
    avih = struct.pack("<14I", usec, min(frame_bytes * int(fps), _RIFF_MAX), 0, _AVIF_HASINDEX,
                       n_frames, 0, 1, frame_bytes, width, height, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", b"DIB ", 0, 0, 0, 0, 1, int(fps), 0,
                       n_frames, frame_bytes, 0xFFFFFFFF, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHHIIiiII", 40, width, -height, 1, 24, 0, frame_bytes, 0, 0, 0, 0)
    header = (_chunk_header(b"RIFF", riff) + b"AVI "
              + _chunk_header(b"LIST", hdrl) + b"hdrl" + _chunk_header(b"avih", 56) + avih
              + _chunk_header(b"LIST", strl) + b"strl" + _chunk_header(b"strh", 56) + strh
              + _chunk_header(b"strf", 40) + strf
              + _chunk_header(b"LIST", movi) + b"movi")
    row = np.zeros((height, stride), np.uint8)
    index = []
    with open(path, "wb") as f:
        f.write(header)
        n = 0
        for img in frames:
            if img.shape != (height, width, 3) or img.dtype != np.uint8:
                raise ValueError(f"frame {n} is {img.dtype} {img.shape}, expected uint8 "
                                 f"{(height, width, 3)}")
            row[:, :3 * width] = img[:, :, ::-1].reshape(height, 3 * width)
            index.append(struct.pack("<4sIII", b"00db", _AVIIF_KEYFRAME,
                                     4 + n * (8 + frame_bytes), frame_bytes))
            f.write(_chunk_header(b"00db", frame_bytes))
            f.write(row.tobytes())
            n += 1
        if n != n_frames:
            raise ValueError(f"got {n} frames, expected {n_frames}")
        f.write(_chunk_header(b"idx1", idx1) + b"".join(index))


def create_video_from_images(image_dir: str, output_path: str,
                             pattern: str = "rgb_*.png", fps: int = 30,
                             resolution: Optional[Tuple[int, int]] = None) -> bool:
    """Encode the images of ``image_dir`` matching ``pattern`` (sorted) as an
    AVI at ``fps``; ``resolution`` = (width, height) resizes each frame.
    Returns False when no image matches."""
    images = sorted(glob.glob(os.path.join(image_dir, pattern)))
    if not images:
        return False
    if resolution:
        width, height = resolution
    else:
        height, width = read_rgb(images[0]).shape[:2]

    root, ext = os.path.splitext(output_path)
    if ext.lower() != ".avi":
        output_path = root + ".avi"
    out_dir = os.path.dirname(output_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    def frames():
        for path in images:
            img = read_rgb(path)
            yield resize_bilinear(img, (width, height)) if resolution else img

    write_avi(output_path, frames(), len(images), width, height, fps)
    print(f"wrote {output_path}: {len(images)} frames, {width}x{height}, {fps} fps, "
          "uncompressed AVI")
    return True


def read_avi(path: str):
    """The frames of an uncompressed 24-bit AVI as uint8 (N, H, W, 3) RGB,
    and its frame rate."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path} is not a RIFF AVI file")
    info, frames = {}, []

    def walk(pos, end):
        while pos + 8 <= end:
            tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
            body = pos + 8
            if tag == b"LIST":
                walk(body + 4, body + size)
            elif tag == b"strh":
                info["scale"], info["rate"] = struct.unpack("<II", data[body + 20:body + 28])
            elif tag == b"strf":
                w, h, _, bits, comp = struct.unpack("<iiHHI", data[body + 4:body + 20])
                if bits != 24 or comp != 0:
                    raise ValueError(f"{path}: {bits}-bit frames, compression {comp}; only "
                                     "uncompressed 24-bit frames are read")
                info["w"], info["h"] = w, h
            elif tag[2:] in (b"db", b"dc"):
                frames.append(data[body:body + size])
            pos = body + size + (size & 1)

    walk(12, len(data))
    w, h = info["w"], abs(info["h"])
    stride = (3 * w + 3) & ~3
    out = np.empty((len(frames), h, w, 3), np.uint8)
    for i, raw in enumerate(frames):
        img = np.frombuffer(raw, np.uint8, stride * h).reshape(h, stride)[:, :3 * w]
        img = img.reshape(h, w, 3)[..., ::-1]
        out[i] = img[::-1] if info["h"] > 0 else img
    return out, info["rate"] / info["scale"]
