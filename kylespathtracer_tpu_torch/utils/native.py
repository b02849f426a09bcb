"""ctypes loader for the native runtime library (native/kpt_native.cpp).

Port of kylespathtracer_tpu/utils/native.py. The port builds its own copy
of the library at first use: the repo's `native/Makefile` and source are
copied into `build/native/<cpu>/` at the repo root and `make` runs there,
with the Makefile's compiler and flags. `-march=native` builds for the CPU
that runs the build, so the directory is keyed by that CPU (its model and
flags) and a library built on another host is never loaded; nor is the
committed native/libkpt_native.so. Every caller has a Python fallback, so
the package works without it: `available()` says whether it built, and
`build_error()` why not. Host code only, no device.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import platform
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCES = ("Makefile", "kpt_native.cpp")


def _cpu_key() -> str:
    """A short hash of this host's CPU model and flags."""
    try:
        info = Path("/proc/cpuinfo").read_text()
    except OSError:
        info = platform.processor()
    lines = sorted({line for line in info.splitlines() if line.startswith(("model name", "flags"))})
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:12]


def build_dir() -> Path:
    """Where this host builds the library: build/native/<cpu>/."""
    return _ROOT / "build" / "native" / _cpu_key()


_lib = None
_tried = False
_error = None
# The build's seconds and the compiler's output, when this process built it.
BUILD_LOG: dict = {}


def _build() -> Path:
    """Copy the sources into build_dir() and run make there, under a file
    lock (test workers and ranks may build at once); make rebuilds only when
    a copied source is newer than the library → the library's path."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for name in _SOURCES:
            src, dst = _ROOT / "native" / name, out / name
            if not dst.exists() or dst.read_bytes() != src.read_bytes():
                shutil.copyfile(src, dst)  # a fresh mtime: make rebuilds
        t0 = time.perf_counter()
        done = subprocess.run(["make", "-C", str(out)], capture_output=True, text=True, timeout=300)
        BUILD_LOG.update(seconds=time.perf_counter() - t0, output=done.stdout + done.stderr)
        if done.returncode != 0:
            raise RuntimeError(f"make failed ({done.returncode}): {done.stderr.strip()}")
    return out / "libkpt_native.so"


def _load():
    global _lib, _tried, _error
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _error = f"{type(e).__name__}: {e}"
        return None

    lib.kpt_write_png.argtypes = [ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    lib.kpt_write_png.restype = ctypes.c_int

    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.kpt_march.argtypes = [
        f32p, i32p, ctypes.c_int32,   # planes
        f32p, i32p, ctypes.c_int32,   # spheres
        f32p, i32p, ctypes.c_int32,   # boxes
        f32p, f32p, i32p,             # ro, rd, excl
        ctypes.c_int64, ctypes.c_int32,
        f32p, i32p,
    ]
    lib.kpt_march.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the library is not available (None when it is, or untried)."""
    return _error


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """8-bit RGB PNG of a top-down u8[H, W, 3] image."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable ({_error})")
    img = np.ascontiguousarray(rgb_u8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes u8[H, W, 3], not {img.shape}")
    h, w = img.shape[:2]
    rc = lib.kpt_write_png(str(path).encode(), w, h, img.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise IOError(f"kpt_write_png failed with code {rc}")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def march(scene, ro, rd, exclude=-1, steps: int = 255):
    """C++ re-execution of the sphere tracer (common.glsl:283-295), an
    independent oracle for tests → (t, object id) as numpy arrays.
    scene: the port's Scene (its tables are copied to the host); ro, rd:
    tensors or arrays f32[..., 3]."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable ({_error})")

    f32 = lambda a: np.ascontiguousarray(_host(a), np.float32)
    i32 = lambda a: np.ascontiguousarray(_host(a), np.int32)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    planes, plane_ids = f32(scene.planes), i32(scene.plane_ids)
    spheres, sphere_ids = f32(scene.spheres), i32(scene.sphere_ids)
    boxes, box_ids = f32(scene.boxes), i32(scene.box_ids)

    shape = _host(ro).shape[:-1]
    ro_f = f32(ro).reshape(-1, 3)
    rd_f = f32(rd).reshape(-1, 3)
    n = ro_f.shape[0]
    excl = np.ascontiguousarray(np.broadcast_to(i32(exclude), shape).reshape(-1))
    out_t = np.empty(n, np.float32)
    out_id = np.empty(n, np.int32)

    lib.kpt_march(
        fp(planes), ip(plane_ids), planes.shape[0],
        fp(spheres), ip(sphere_ids), spheres.shape[0],
        fp(boxes), ip(box_ids), boxes.shape[0],
        fp(ro_f), fp(rd_f), ip(excl),
        n, steps, fp(out_t), ip(out_id),
    )
    return out_t.reshape(shape), out_id.reshape(shape)
