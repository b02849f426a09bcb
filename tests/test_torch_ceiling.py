"""PyTorch port, op-mix probe (K9's module, ops/ceiling_kernel.py): the plain
version against the JAX probe bench_ceiling.py:_mix_kernel on numpy-seeded
8×128 planes, two ways:

- the Pallas body run eagerly, one XLA operation at a time (jax.disable_jit,
  the refs a three-line shim): bitwise, infinities and NaN in place. Both
  sides round each IEEE operation once. The one operation that rounded
  differently was torch's f32 sqrt on the CPU (vector math, an ulp off on
  ~0.5% of inputs); the plain version takes the f32 root through f64
  (`ceiling_kernel._sqrt`), which is correctly rounded, as XLA's and the
  kernel's are;
- the Pallas kernel through `pl.pallas_call(..., interpret=True)`: XLA
  fuses the interpreted body and its CPU code contracts multiply-adds into
  fused multiply-adds, which round once where the probe rounds twice. In
  frame_mix the chains carry those ulps through nonlinear rounds: the bar
  is |Δ| <= 3e-5·max(1, |ref|) with the non-finite positions equal (up to
  ~8e-6 seen at iters <= 3). fma and fma_bf16 leave the finite range
  within their first round, so their outputs are infinities in the same
  places: bitwise.
"""

import ast
import functools
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bench_ceiling as jbc
from kylespathtracer_tpu_torch.ops import ceiling_kernel as ck

# (template, iters, chains, live) at iters <= 3, with chains > 1 and live
# > 0; (3, 3, 1) runs all seven round constants.
CASES = (
    ("fma", 1, 1, 0), ("fma", 3, 2, 2),
    ("fma_bf16", 1, 1, 0), ("fma_bf16", 3, 3, 1),
    ("frame_mix", 1, 1, 0), ("frame_mix", 3, 2, 2), ("frame_mix", 3, 3, 1), ("frame_mix", 3, 1, 4),
)


class _Ref:
    """A Pallas ref over a whole array, for running the kernel body eagerly."""

    def __init__(self, v=None):
        self.v = v

    def __getitem__(self, idx):
        return self.v

    def __setitem__(self, idx, v):
        self.v = v


def _planes(case):
    rng = np.random.default_rng(CASES.index(case))
    x, y = (rng.uniform(-2.0, 2.0, (8, 128)).astype(np.float32) for _ in range(2))
    return x, y


def _plain(x, y, case):
    before = ck.LAUNCHES
    out = ck.mix(torch.from_numpy(x), torch.from_numpy(y), *case).numpy()
    assert ck.LAUNCHES == before  # a CPU tensor runs the plain version
    return out


def _assert_bitwise(got, ref):
    assert ck.differing(torch.from_numpy(got), torch.from_numpy(np.array(ref))) == 0


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_mix_plain_matches_the_jax_body_op_by_op(case):
    template, iters, chains, live = case
    x, y = _planes(case)
    out = _Ref()
    with jax.disable_jit():
        jbc._mix_kernel(_Ref(jnp.asarray(x)), _Ref(jnp.asarray(y)), out, iters=iters, chains=chains,
                        template=template, live=live)
    _assert_bitwise(_plain(x, y, case), out.v)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_mix_plain_matches_the_interpreted_pallas_kernel(case):
    template, iters, chains, live = case
    x, y = _planes(case)
    kernel = functools.partial(jbc._mix_kernel, iters=iters, chains=chains, template=template, live=live)
    ref = np.asarray(pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                                    interpret=True)(x, y))
    got = _plain(x, y, case)
    if template != "frame_mix":
        assert not np.isfinite(ref).any()
        _assert_bitwise(got, ref)
        return
    fin = np.isfinite(ref)
    assert fin.all() and np.array_equal(np.isfinite(got), fin)
    assert np.all(np.abs(got - ref) <= 3e-5 * np.maximum(1.0, np.abs(ref)))


def _jax_sweep():
    """The (template, iters, chains, live) variants that bench_ceiling.py:main
    sweeps, read from its source."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(jbc.main)))
    loop = next(n for n in ast.walk(tree) if isinstance(n, ast.For) and isinstance(n.iter, ast.Tuple))
    return tuple((t, i, c, live) for t, sweeps in ast.literal_eval(loop.iter) for i, c, live in sweeps)


def test_template_ops_and_sweep_match_the_jax_probe():
    assert ck.TEMPLATE_OPS == jbc.TEMPLATE_OPS
    assert set(ck.TEMPLATES) == set(jbc.TEMPLATES)
    assert ck.SWEEP == _jax_sweep()
    assert ck.KERNEL_VARIANTS == ck.SWEEP + (ck.INF_PROBE,)
    assert (jbc.H, jbc.W) == (ck.H, ck.W)


def test_bf16_constants_match_jnp_bfloat16():
    for v in [0.6 + 0.05 * k for k in range(7)] + [0.65]:
        assert ck._bf16(v) == float(jnp.bfloat16(v))


def test_sqrt_is_correctly_rounded():
    v = np.random.default_rng(5).uniform(0.0, 8.0, 1 << 16).astype(np.float32)
    got = ck._sqrt(torch.from_numpy(v)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, np.sqrt(v))


def test_one_round_of_each_template_matches_jax():
    """Every round constant k (0..6) of each template against the JAX
    template, eagerly: bitwise."""
    x, y = _planes(CASES[0])
    for name, fn in ck.TEMPLATES.items():
        for k in range(7):
            with jax.disable_jit():
                jx, jy = jbc.TEMPLATES[name](jnp.asarray(x * 0.25), jnp.asarray(y * 0.25), k)
            tx, ty = fn(torch.from_numpy(x * 0.25), torch.from_numpy(y * 0.25), k)
            _assert_bitwise(tx.numpy(), jx)
            _assert_bitwise(ty.numpy(), jy)


def test_mix_dispatches_on_the_tensors_device():
    x, y = _planes(CASES[0])
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    before = ck.LAUNCHES
    assert torch.equal(ck.mix(tx, ty, "frame_mix", 2, 2, 1), ck.mix_plain(tx, ty, "frame_mix", 2, 2, 1))
    assert ck.LAUNCHES == before
    meta = torch.empty((8, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ck.mix(meta, meta, "frame_mix", 40, 1, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        ck.mix_launch(tx, ty, "frame_mix", 40, 1, 0)
    with pytest.raises(ValueError, match="unknown template"):
        ck.mix(tx, ty, "fma_f16", 1, 1, 0)
    with pytest.raises(ValueError, match="f32 tensors of one shape"):
        ck.mix(tx, ty[:4], "fma", 1, 1, 0)
    assert ck.LAUNCHES == before


def test_build_report_parses_per_instantiation():
    """bench_ceiling.ptxas_by_variant on a compiler report in ptxas -v's
    form: each K9 instantiation's registers, stack and spills, by its
    mangled name; other kernels left out. And the SASS groups' sums
    (ops/adjoint_variants.py:grouped)."""
    from kylespathtracer_tpu_torch import bench_ceiling
    from kylespathtracer_tpu_torch.ops import adjoint_variants

    def entry(name, regs, stack, stores, loads):
        return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    {stack} bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads\n"
                f"ptxas info    : Used {regs} registers, used 0 barriers, 380 bytes cmem[0]\n")

    report = (entry("_ZN3kpt12frame_kernelENS_10TablePartsENS_11FrameParamsENS_8FrameOutE", 95, 64, 0, 0)
              + entry("_ZN3kpt12_GLOBAL__N_110mix_kernelILi2ELi20ELi2ELi96EEEvPKfS3_Pfi", 127, 0, 0, 0)
              + entry("_ZN3kpt12_GLOBAL__N_110mix_kernelILi1ELi10ELi4ELi0EEEvPKfS3_Pfi", 15, 8, 4, 4))
    assert bench_ceiling.ptxas_by_variant(report) == {
        ("frame_mix", 20, 2, 96): {"registers": 127, "stack": 0, "spill_stores": 0, "spill_loads": 0},
        ("fma_bf16", 10, 4, 0): {"registers": 15, "stack": 8, "spill_stores": 4, "spill_loads": 4},
    }
    assert ck.variant_of("_ZN3kpt12frame_kernelENS_10TablePartsE") is None
    groups = adjoint_variants.grouped(["FADD"] * 3 + ["MUFU.RSQ", "ISETP.GE.AND", "ISETP.NE.AND", "BRA", "BRA"])
    assert groups["total"] == 8 and groups["f32 add, mul, fma"] == 3 and groups["control"] == 2
    assert groups["MUFU, FCHK, FRND"] == 1 and groups["integer and other"] == 2
    assert {ck.variant_of(f"mix_kernelILi{ck.TEMPLATE_IDS[t]}ELi{i}ELi{c}ELi{v}EE")
            for t, i, c, v in ck.KERNEL_VARIANTS} == set(ck.KERNEL_VARIANTS)


def test_sweep_check_holds_outputs_to_the_plain_version():
    """bench_ceiling.check, which holds the sweep's outputs to mix_plain:
    outputs equal bit for bit (NaN matching NaN) pass with the largest
    |diff| over the finite elements; an element one ulp off raises."""
    from kylespathtracer_tpu_torch import bench_ceiling

    x, y = bench_ceiling.inputs(torch.device("cpu"), 8, 128)
    variants = (("frame_mix", 2, 2, 2), ("fma", 1, 1, 0))
    outs = [ck.mix(x, y, *v) for v in variants]
    assert torch.isinf(outs[1]).any() or torch.isnan(outs[1]).any()
    assert bench_ceiling.check(outs, (x, y), variants) == 0.0
    outs[0][3, 5] = torch.nextafter(outs[0][3, 5], torch.tensor(float("inf")))
    with pytest.raises(AssertionError, match="1 of 1024 elements differ"):
        bench_ceiling.check(outs, (x, y), variants)
