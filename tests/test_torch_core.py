"""PyTorch port, core layer: RenderConfig, gmath, sampler, color against the
JAX package on the same numpy inputs; and the port's import hygiene."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kylespathtracer_tpu.core import color as jcolor
from kylespathtracer_tpu.core import gmath as jgmath
from kylespathtracer_tpu.core import sampler as jsampler
from kylespathtracer_tpu.ops import frame_kernel as jfk
from kylespathtracer_tpu.utils.config import RenderConfig as JConfig
from kylespathtracer_tpu_torch.core import color, gmath, sampler
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.utils.config import RenderConfig

REPO = Path(__file__).resolve().parents[1]


def test_render_config_fields_and_defaults_match():
    ours = [(f.name, f.default) for f in dataclasses.fields(RenderConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    assert ours == ref
    cfg = RenderConfig(width=64, height=32)
    assert cfg.resolution == (64, 32) and cfg.aspect == 2.0
    assert RenderConfig.__dataclass_params__.frozen


def test_gmath_constants_match():
    for name in ("EPS", "IEPS", "ZFAR", "FOV", "HPI", "PI", "TWOPI", "SQRT2", "SC45"):
        assert getattr(gmath, name) == getattr(jgmath, name), name


@pytest.mark.parametrize(
    "fn", ["dot", "length", "normalize", "normalize_fast", "cross", "mix",
           "smoothstep01", "rotate_xy"],
)
def test_gmath_matches_jax(fn):
    rng = np.random.default_rng(11)
    a = rng.normal(0, 2, (17, 3)).astype(np.float32)
    b = rng.normal(0, 2, (17, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (17, 3)).astype(np.float32)
    ang = rng.uniform(-3, 3, (17, 2)).astype(np.float32)
    args = {
        "dot": (a, b), "length": (a,), "normalize": (a,),
        "normalize_fast": (a,), "cross": (a, b), "mix": (a, b, t),
        "smoothstep01": (t,), "rotate_xy": (a, ang),
    }[fn]
    got = getattr(gmath, fn)(*(torch.from_numpy(x) for x in args))
    want = getattr(jgmath, fn)(*(jnp.asarray(x) for x in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _seed_inputs():
    rng = np.random.default_rng(5)
    px = rng.integers(0, 1 << 14, 257).astype(np.int32)
    py = rng.integers(0, 1 << 14, 257).astype(np.int32)
    return px, py


@pytest.mark.parametrize("frame", [0, 3, 1 << 20])
def test_gen_seed_and_weyl3_bit_exact(frame):
    px, py = _seed_inputs()
    s_t = sampler.gen_seed(frame, torch.from_numpy(px), torch.from_numpy(py), 1920, 1080)
    s_j = jsampler.gen_seed(jnp.int32(frame), jnp.asarray(px), jnp.asarray(py), 1920, 1080)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(
        sampler.weyl3(s_t).numpy(), np.asarray(jsampler.weyl3(s_j))
    )


@pytest.mark.parametrize("decorrelate", [False, True])
def test_fold_seed_bit_exact(decorrelate):
    px, py = _seed_inputs()
    seed = jsampler.gen_seed(jnp.int32(7), jnp.asarray(px), jnp.asarray(py), 64, 32)
    seed_t = torch.from_numpy(np.array(seed))
    for i in range(4):
        want = np.asarray(jsampler.fold_seed(seed, i, decorrelate))
        np.testing.assert_array_equal(sampler.fold_seed(seed_t, i, decorrelate).numpy(), want)
        # The frame kernel's per-sample streams are the same function.
        np.testing.assert_array_equal(
            fk._fold_seed(seed_t, i, decorrelate).numpy(),
            np.asarray(jfk._fold_seed(seed, i, decorrelate)),
        )


def test_color_matches_jax():
    rng = np.random.default_rng(2)
    x = np.concatenate([
        rng.uniform(-0.1, 0.01, (64, 3)), rng.uniform(0, 40, (64, 3))
    ]).astype(np.float32)
    np.testing.assert_allclose(
        color.linear_srgb(torch.from_numpy(x)).numpy(),
        np.asarray(jcolor.linear_srgb(jnp.asarray(x))), rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        color.aces_fitted(torch.from_numpy(x)).numpy(),
        np.asarray(jcolor.aces_fitted(jnp.asarray(x))), rtol=1e-6, atol=1e-6,
    )


def test_port_imports_without_jax_or_cuda():
    """Importing every module of the port pulls in neither jax nor the JAX
    package, and needs no CUDA device, nvcc or triton."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import kylespathtracer_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'kylespathtracer_tpu' or m.startswith('kylespathtracer_tpu.')\n"
        "       or m == 'triton']\n"
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "print(len(names), bad)\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 15, out.stdout
    assert bad.strip() == "[]", out.stdout
