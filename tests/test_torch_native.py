"""PyTorch port, the native library (utils/native.py, built from the repo's
native/ into build/native/) on the CPU: `write_png` decodes to its input,
and `image_io.save_png` gives the same pixels through the native encoder
and through Python's zlib; the C++ march against the port's `sdf.march`
at tests/test_native.py's tolerances. Skipped, as tests/test_native.py is,
only where the library cannot be built (no compiler)."""

import struct
import zlib

import numpy as np
import pytest
import torch

from kylespathtracer_tpu_torch.scene import sdf
from kylespathtracer_tpu_torch.scene.scene import default_scene
from kylespathtracer_tpu_torch.utils import image_io, native


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip(f"native library not built: {native.build_error()}")


def png_rgb(path) -> np.ndarray:
    """The u8[H, W, 3] pixels of an 8-bit RGB PNG with filter 0 rows."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            size = struct.unpack(">IIBBBBB", body)
            assert size[2:] == (8, 2, 0, 0, 0)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_write_png_decodes_to_its_input(lib, tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (24, 32, 3)).astype(np.uint8)
    native.write_png(str(tmp_path / "n.png"), img)
    np.testing.assert_array_equal(png_rgb(tmp_path / "n.png"), img)


def test_save_png_native_and_zlib_same_pixels(lib, tmp_path, monkeypatch):
    img = torch.from_numpy(np.random.default_rng(1).random((17, 23, 3)).astype(np.float32))
    image_io.save_png(tmp_path / "native.png", img)
    monkeypatch.setattr(native, "available", lambda: False)
    image_io.save_png(tmp_path / "zlib.png", img)
    a, b = png_rgb(tmp_path / "native.png"), png_rgb(tmp_path / "zlib.png")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, image_io._to_u8(img))


def test_native_march_matches_the_port(lib):
    """tests/test_native.py:25-47 against the port's march: ids equal on
    > 99.5% of the rays, the 99th percentile of |Δt| on equal ids < 5e-3."""
    scene = default_scene(device="cpu")
    rng = np.random.default_rng(3)
    n = 2000
    ro = np.stack([rng.uniform(-5, 9.5, n), rng.uniform(0.2, 9.5, n), rng.uniform(-9.5, 5, n)],
                  axis=-1).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

    t_c, id_c = native.march(scene, ro, rd, -1, 255)
    t_p, id_p = sdf.march(scene, torch.from_numpy(ro), torch.from_numpy(rd), -1, 255)
    t_p, id_p = t_p.numpy(), id_p.numpy()
    assert t_c.shape == id_c.shape == (n,)
    assert (id_c == id_p).mean() > 0.995
    m = id_c == id_p
    assert np.quantile(np.abs(t_c[m] - t_p[m]), 0.99) < 5e-3
