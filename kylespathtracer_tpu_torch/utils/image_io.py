"""Image export.

Port of kylespathtracer_tpu/utils/image_io.py: PNG through the native
encoder (utils/native.py) when the library is built, else Python's zlib,
the same pixels either way; PPM needs nothing.

Renderer images are float [0, 1] RGB with row 0 at the *bottom* (GL
fragCoord convention, see render/camera.py); the exporters flip them to
top-down file order.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _to_u8(image) -> np.ndarray:
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return img[::-1]  # bottom-up render rows → top-down file rows


def save_ppm(path, image) -> None:
    img = _to_u8(image)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def save_png(path, image) -> None:
    """8-bit RGB PNG, one zlib-compressed IDAT chunk, filter 0 per row: the
    native encoder when available, else Python's zlib."""
    from kylespathtracer_tpu_torch.utils import native

    img = _to_u8(image)
    if native.available():
        native.write_png(str(path), img)
        return
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    out += _png_chunk(b"IDAT", zlib.compress(raw, 6))
    out += _png_chunk(b"IEND", b"")
    Path(path).write_bytes(out)


def save_image(path, image) -> None:
    path = str(path)
    if path.endswith(".ppm"):
        save_ppm(path, image)
    else:
        save_png(path, image)
