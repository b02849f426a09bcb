"""Build and load the port's CUDA kernels.

The sources in `csrc/` compile with `nvcc` into one shared library with a
plain C interface, loaded with ctypes: one `nvcc -c` per source, all
started together, then one link. The build runs at first use, into
`build/kernels/` at the root of the checkout (git-ignored), under a name
that carries a hash of the sources, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import time. The port
therefore runs from a checkout, not from an installed package.

Flags: `-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3`, and no
`--use_fast_math` (it would change sqrt, rsqrt and division).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("frame_kernel.cu", "reproject_kernel.cu", "frame_grad.cu", "loss_kernel.cu",
           "geometry_kernel.cu", "path_kernel.cu", "frame_hist.cu", "shade_kernel.cu")
HEADERS = ("dual.cuh", "shade_core.cuh", "frame_core.cuh", "frame_adjoint.cuh", "reproject_core.cuh",
           "frame_body.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
# These kernels round every operation on its own, as their plain versions
# (one tensor op at a time) do. With nvcc's default contraction, K5 no
# longer meets chip_smoke.py phase 8's bar on the default scene; in the path
# kernel a contracted multiply-add can flip a sampling decision, which
# changes the whole path after it; in the mono temporal kernel (K8) an ulp
# of ray direction moves the reprojected tap position by ~4e-5 pixel at
# 1080p. K1 alone keeps nvcc's default contraction.
SOURCE_FLAGS = {name: ("-fmad=false",) for name in (
    "frame_grad.cu", "loss_kernel.cu", "geometry_kernel.cu", "path_kernel.cu", "shade_kernel.cu",
    "frame_hist.cu")}

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# The structs that K1, K4, K7 and K8 take by pointer, packed by the
# wrappers: csrc/frame_body.cuh:TableParts (15 f32 and 4 i32 pointers, then
# their 15 and 4 lengths), csrc/frame_kernel.cu:FrameOut (K1's 7 output
# planes) and csrc/shade_kernel.cu:ShadeIO (K4's G-buffer in and estimator
# pair out: normal, depth, ray_dir, obj_id, seed, est_d, est_s).
TABLE_PARTS = struct.Struct("=19Q19i")
FRAME_OUT = struct.Struct("=7Q")
SHADE_IO = struct.Struct("=7Q")


_SIGNATURES = {
    # parts, nP, nS, nB, nK, width, height, fov, frame, row_base, rows, smp,
    # decorrelate, biased, soft_beta, gloss, out, stream
    "kpt_frame_forward": (
        _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
        _I, _I, _I, _F, _I, _P, _P,
    ),
    # ho, dyrel, dxrel, wy0, wy1, wx0, wx1, hist_rgb, hist_cnt, hist_oid,
    # out_rgb, out_cnt, rows, H, W, K, row_base, hist_row0, stream
    "kpt_reproject_window": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ),
    # ftab, itab, seeds, n_seeds, nP, nS, nB, nK, width, height, fov, frame,
    # row_base, rows, smp, decorrelate, biased, soft_beta, gloss, g, present,
    # out_g, stream
    "kpt_frame_backward": (
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
        _I, _I, _I, _F, _I, _P, _I, _P, _P,
    ),
    # ftab, itab, seeds, n_seeds, nP, nS, nB, nK, width, height, fov, frame,
    # smp, decorrelate, biased, soft_beta, gloss, brightness, mse, target,
    # out_loss, out_g, stream
    "kpt_loss_grad": (
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
        _I, _I, _I, _F, _I, _F, _I, _P, _P, _P, _P,
    ),
    # ftab, itab, nP, nS, nB, nK, width, height, fov, out_f, out_oid, stream
    "kpt_geometry_pass": (_P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P),
    # parts, kinds, iors, nP, nS, nB, nK, width, height, fov, frame, spp,
    # max_depth, gloss, out, stream
    "kpt_pathtrace": (
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P, _P,
    ),
    # parts, prev loc, prev orient, nP, nS, nB, nK, width, height, fov,
    # frame, smp, decorrelate, biased, soft_beta, gloss, K, inv_asp,
    # temporal, two_t, t_m1, row_base, rows, hist_row0, hist d rgb/cnt/oid,
    # hist s rgb/cnt/oid, out d_rgb, d_cnt, s_rgb, s_cnt, alb, ene, oid, stream
    "kpt_frame_hist": (
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _F, _I, _I, _F, _F,
        _F, _F, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ),
    # parts, nP, nS, nB, nK, width, height, soft_beta, gloss, io, stream
    "kpt_dual_mis": (_P, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _digest(sources, defines) -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode() + repr(SOURCE_FLAGS).encode())
    for name in (*sources, *HEADERS):
        h.update(name.encode() + (CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False, sources=None, defines=()) -> Path:
    """Compile `csrc/` into build/kernels/libkpt_kernels_<hash>.so unless
    that file exists; return its path. The sources compile in parallel, one
    nvcc each. `verbose` adds `-Xptxas -v` and prints the compiler's report
    (registers, stack frame, spills) of every kernel. `sources` (default
    SOURCES) and `defines` (macros set with -D) make another library, such
    as the census build of K7 (path_kernel.census)."""
    sources = SOURCES if sources is None else tuple(sources)
    out = BUILD_DIR / f"libkpt_kernels_{_digest(sources, defines)}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    objs, procs = [], []
    for src in sources:
        obj = BUILD_DIR / f"{tag}.{Path(src).stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src, ()), *(f"-D{d}" for d in defines), *ptxas, "-c", "-o",
               str(obj), str(CSRC / src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    reports = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        for cmd, text, rc in reports:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}\n{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if verbose:
        for (_, text, _), src in zip(reports, sources):
            print(f"--- {src}\n{text}")
    os.replace(tmp, out)
    return out


def load():
    """The loaded kernel library (built on first call), with every entry
    point's argtypes and restype declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.kpt_error_string.argtypes = [ctypes.c_int]
            lib.kpt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`
    (what a kernel's C entry point takes)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype}{list(shape)} on {device}, "
                         f"got {t.dtype}{list(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = load().kpt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
