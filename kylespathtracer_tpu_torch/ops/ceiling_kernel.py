"""The op-mix ceiling probe: one CUDA kernel (K9) and its plain version.

Port of bench_ceiling.py:_mix_kernel (its `pallas_call` in `run_variant`).
The probe runs a template of elementwise operations as unrolled, nonlinear
dependency chains over two f32 planes, so that the rate at which the card
retires that mix can be measured (kylespathtracer_tpu_torch/bench_ceiling.py)
and the other kernels' operation counts divided by it. Three templates:
`frame_mix` (72 operations: the frame kernel's primitive mix, with one
division and one square root), `fma` (64 multiplies and adds) and
`fma_bf16` (the same in bfloat16, rounded at every operation).

`mix` launches csrc/ceiling_kernel.cu on CUDA tensors (one instantiation
per entry of KERNEL_VARIANTS; another variant raises) and runs
`mix_plain` on CPU tensors. Both compute the JAX kernel's function,
operation for operation: every Python constant is rounded once from its
double to f32 (or to bfloat16), nothing is contracted into a fused
multiply-add, and the square root and the division are correctly rounded.
"""

from __future__ import annotations

import re

import torch

from kylespathtracer_tpu_torch.ops import _build

# The plane the JAX probe runs on.
H, W = 1080, 1920
# Operations per template round, counted as the JAX file counts them
# (compares, ands, selects, min and max each one operation).
TEMPLATE_OPS = {"frame_mix": 72, "fma": 64, "fma_bf16": 64}
# The JAX probe's sweep (bench_ceiling.py:main), as (template, iters,
# chains, live planes): iters × chains held to ~2.6-2.9k operations per
# element.
SWEEP = (
    ("fma", 40, 1, 0), ("fma", 20, 2, 0), ("fma", 10, 4, 0), ("fma", 5, 8, 0),
    ("fma_bf16", 40, 1, 0), ("fma_bf16", 10, 4, 0),
    ("frame_mix", 40, 1, 0), ("frame_mix", 20, 2, 0), ("frame_mix", 10, 4, 0), ("frame_mix", 5, 8, 0),
    ("frame_mix", 20, 2, 16), ("frame_mix", 20, 2, 32), ("frame_mix", 20, 2, 64), ("frame_mix", 20, 2, 96),
)
# One fma round of 16 steps leaves the finite range after 8-10 steps, so
# the sweep's fma variants run almost wholly on infinities; this variant
# runs one round per chain, about half of it on finite values, to show
# whether the rate depends on that. Timed beside the sweep, not part of it.
INF_PROBE = ("fma", 1, 8, 0)
# The instantiations in csrc/ceiling_kernel.cu.
KERNEL_VARIANTS = SWEEP + (INF_PROBE,)
# Template ids of the C entry point (csrc/ceiling_kernel.cu).
TEMPLATE_IDS = {"fma": 0, "fma_bf16": 1, "frame_mix": 2}
# An instantiation's mangled name: mix_kernel<template id, iters, chains, live>.
MANGLED = re.compile(r"mix_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E")

# Launches of the CUDA kernel by `mix` and `mix_launch` in this process.
LAUNCHES = 0


def variant_of(name: str):
    """The (template, iters, chains, live) of a K9 instantiation's mangled
    name, or None for another kernel."""
    m = MANGLED.search(name)
    if m is None:
        return None
    tpl, iters, chains, live = map(int, m.groups())
    return next(t for t, i in TEMPLATE_IDS.items() if i == tpl), iters, chains, live


def _sqrt(v):
    """The correctly rounded f32 square root (sqrt.rn, as the kernel's
    sqrtf and XLA's). torch's f32 sqrt on the CPU (vector math) is off by
    an ulp on ~0.5% of inputs; the f64 root, within a few ulps, rounds to
    the correct f32 root, since an f32 root lies at least 2^-49 (relative)
    from the midpoint between two floats."""
    return torch.sqrt(v.double()).to(torch.float32)


def _template_mix(x, y, k):
    """One 72-operation round of the frame kernel's primitive mix
    (bench_ceiling.py:_template_mix)."""
    c1 = 0.6 + 0.05 * k
    # 17 mul, 12 add, 5 sub
    x = x * y + c1
    y = y * 0.75 + x * 0.125
    x = x - y * 0.25
    y = y * x + 0.3
    x = x * 0.5 - y
    y = y + x * 0.0625
    x = x * y + 0.2
    y = y * 0.8 + x
    x = x - y * 0.5
    y = y * x + c1
    x = x * 0.25 + y
    y = y - x * 0.125
    x = x * y + 0.15
    y = y * 0.7 + x
    x = x - y
    y = y + 0.4
    x = x * c1 + y * 0.3
    # 7 compares, 4 and, 7 selects, 3 max, 3 min
    m1 = x > y
    m2 = x < c1
    m3 = y >= 0.0
    m4 = x <= 2.0
    m5 = y != x
    m6 = x > 0.5
    m7 = y < 1.5
    a1 = m1 & m2
    a2 = m3 & m4
    a3 = m5 & m6
    a4 = a1 & m7
    x = torch.where(a1, x, y)
    y = torch.where(a2, y, x * 0.5)
    x = torch.where(a3, x + 0.125, x)
    y = torch.where(a4, y, 0.0)
    x = torch.where(m5, x, 1.0)
    y = torch.where(m6, y, x)
    x = torch.where(m7, x, y)
    # clamp_min/clamp_max with a scalar, like maximum/minimum, pass NaN on.
    x = torch.clamp_min(x, -4.0)
    y = torch.maximum(y, x * 0.25)
    x = torch.clamp_min(x, 0.001)
    x = torch.clamp_max(x, 4.0)
    y = torch.clamp_max(y, 3.0)
    x = torch.minimum(x, y + 2.0)
    # abs, neg, floor, div (tensor by tensor), sqrt
    y = torch.abs(y)
    x = -x
    y = y - torch.floor(y * 0.125)
    x = x / (y + 1.5)
    x = _sqrt(torch.abs(x) + 0.0625)
    return x, y


def _template_fma(x, y, k):
    """64 multiplies and adds in 16 nonlinear x·y steps
    (bench_ceiling.py:_template_fma)."""
    c1 = 0.6 + 0.05 * k
    for _ in range(16):
        x = x * y + c1
        y = y * 0.65 + x
    return x, y


def _bf16(v: float) -> float:
    """v rounded to bfloat16 (as jnp.bfloat16(v)), as a Python float."""
    return float(torch.tensor(v, dtype=torch.float64).to(torch.bfloat16))


def _template_fma_bf16(x, y, k):
    """The fma template in bfloat16 (bench_ceiling.py:_template_fma_bf16):
    each operation computes in f32 and rounds to bfloat16, as torch and XLA
    do; the constants are bfloat16 values."""
    c1, c2 = _bf16(0.6 + 0.05 * k), _bf16(0.65)
    x = x.to(torch.bfloat16)
    y = y.to(torch.bfloat16)
    for _ in range(16):
        x = x * y + c1
        y = y * c2 + x
    return x.to(torch.float32), y.to(torch.float32)


TEMPLATES = {
    "frame_mix": _template_mix,
    "fma": _template_fma,
    "fma_bf16": _template_fma_bf16,
}


def _check(x, y, template: str, iters: int, chains: int, live: int) -> None:
    if template not in TEMPLATES:
        raise ValueError(f"unknown template {template!r} (one of {sorted(TEMPLATES)})")
    if iters < 0 or chains < 1 or live < 0:
        raise ValueError(f"need iters >= 0, chains >= 1, live >= 0 (got {iters}, {chains}, {live})")
    if x.dtype != torch.float32 or y.dtype != torch.float32 or x.shape != y.shape or x.device != y.device:
        raise ValueError(f"x and y must be f32 tensors of one shape on one device, got {x.dtype}{list(x.shape)} "
                         f"on {x.device} and {y.dtype}{list(y.shape)} on {y.device}")


def mix_plain(x, y, template: str, iters: int, chains: int, live: int = 0):
    """The probe's function in plain tensor code (bench_ceiling.py:_mix_kernel):
    `chains` chains of `iters` template rounds each, round k =
    (i·chains + c) % 7; after each sweep i, live plane i % live gains
    xs[0]·1e-6; the output sums the chains, the ys·0.001 and the planes·1e-6
    in that order."""
    _check(x, y, template, iters, chains, live)
    fn = TEMPLATES[template]
    xs = [x * (1.0 + 0.0625 * c) for c in range(chains)]
    ys = [y + 0.03125 * c for c in range(chains)]
    planes = [x * (0.5 + 0.01 * j) + y * 0.125 for j in range(live)]
    for i in range(iters):
        for c in range(chains):
            xs[c], ys[c] = fn(xs[c], ys[c], (i * chains + c) % 7)
        if live:
            j = i % live
            planes[j] = planes[j] + xs[0] * 1e-6
    acc = xs[0]
    for c in range(1, chains):
        acc = acc + xs[c]
    for c in range(chains):
        acc = acc + ys[c] * 0.001
    for j in range(live):
        acc = acc + planes[j] * 1e-6
    return acc


def differing(a, b) -> int:
    """Elements of two f32 tensors whose bits differ, a NaN matching any
    NaN: 0 when a is b bit for bit, infinities and NaN in place."""
    same = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def mix_launch(x, y, template: str, iters: int, chains: int, live: int = 0):
    """`mix`'s CUDA route in two steps → (launch, out): the arguments are
    checked and the output allocated here; launch() launches K9 once into
    it and counts it. bench_ceiling.py times launch() alone."""
    _check(x, y, template, iters, chains, live)
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"mix: unsupported device {device}")
    variant = (template, iters, chains, live)
    if variant not in KERNEL_VARIANTS:
        raise ValueError(f"mix: {variant} is not instantiated in csrc/ceiling_kernel.cu "
                         f"(KERNEL_VARIANTS: {KERNEL_VARIANTS})")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("mix: x and y must be contiguous")
    out = torch.empty_like(x)
    args = (x.numel(), TEMPLATE_IDS[template], iters, chains, live, torch.cuda.current_stream(device).cuda_stream)

    # launch() reads x, y and out itself, so it keeps them alive after the
    # caller has dropped them.
    def launch():
        global LAUNCHES
        _build.check(_build.load().kpt_mix_ceiling(x.data_ptr(), y.data_ptr(), out.data_ptr(), *args),
                     "kpt_mix_ceiling")
        LAUNCHES += 1

    return launch, out


def mix(x, y, template: str, iters: int, chains: int, live: int = 0):
    """The probe's output for inputs x, y (f32, one shape). The tensors'
    device picks the route: CUDA launches K9 (or raises), CPU runs
    `mix_plain`."""
    if x.device.type == "cpu":
        return mix_plain(x, y, template, iters, chains, live)
    launch, out = mix_launch(x, y, template, iters, chains, live)
    launch()
    return out
