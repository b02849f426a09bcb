"""PyTorch port, the pass pipeline (`render_frame` with `pipeline="pass"`:
the analytic G-buffer, the fused diffuse + specular passes or their
fallback, the composite) against the JAX package's, frame by frame over a
3-frame pan with populated history (`_torch_helpers.pass_pan_matches_jax`):
`shade_backend="xla"` (mis.dual_mis), the unbiased estimators, unequal smp
counts (the diffuse_pass/specular_pass fallback) and `no_history`;
tests/test_torch_passes_pallas.py holds `shade_backend="pallas"`. Also
`composite`, and the `render` CLI on the CPU.

Tolerance: the temporal-frame bar, atol 2e-4 (rtol 1e-5), `oid` exact;
`composite` atol 2e-5."""

import argparse
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from _torch_helpers import (np_, pass_pan_matches_jax, populated_history, to_torch_camera,
                            to_torch_channel, to_torch_config, to_torch_scene)
from kylespathtracer_tpu.render import composite as jcomp
from kylespathtracer_tpu.render import gbuffer as jgb
from kylespathtracer_tpu.render.camera import Camera
from kylespathtracer_tpu.scene import default_scene
from kylespathtracer_tpu.utils.config import RenderConfig
from kylespathtracer_tpu_torch.app import cli
from kylespathtracer_tpu_torch.render import composite, gbuffer

W, H = 32, 16
CAM0 = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))

CASES = {
    "xla": {},
    "unbiased": dict(biased=False),
    "unequal_smp": dict(smp_direct_lambert=2, smp_phong_surface_phong=2),
    "no_history": dict(no_history=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pass_pipeline_pan_matches_jax(case):
    pass_pan_matches_jax(CASES[case], W, H)


def test_composite_matches_jax():
    scene = default_scene()
    cfg = RenderConfig(width=W, height=H, pipeline="pass")
    gb = jgb.geometry_pass(scene, CAM0, cfg)
    hist = populated_history(gb.obj_id, CAM0)
    got = composite.composite(
        to_torch_scene(scene), to_torch_config(cfg),
        gbuffer.GBuffer(**{k: torch.from_numpy(np.array(getattr(gb, k)))
                           for k in ("normal", "obj_id", "depth", "ray_dir", "curv")}),
        to_torch_camera(CAM0), to_torch_channel(hist.diffuse), to_torch_channel(hist.specular))
    ref = jcomp.composite(scene, cfg, gb, CAM0, hist.diffuse, hist.specular)
    np.testing.assert_allclose(np_(got), np.asarray(ref), atol=2e-5, rtol=1e-5)


def _png(path):
    """(width, height, IDAT bytes after zlib) of a PNG written by save_png."""
    data = open(path, "rb").read()
    w, h = struct.unpack(">II", data[16:24])
    n = struct.unpack(">I", data[33:37])[0]
    assert data[37:41] == b"IDAT"
    return w, h, len(zlib.decompress(data[41:41 + n]))


def test_render_cli_on_cpu(tmp_path):
    out, metrics = tmp_path / "frames", tmp_path / "m.jsonl"
    cli.main(["render", "--device", "cpu", "--width", "16", "--height", "8", "--frames", "2",
              "--save-every", "1", "--out", str(out), "--metrics", str(metrics)])
    assert sorted(os.listdir(out)) == ["final.png", "frame_00000.png", "frame_00001.png"]
    for name in os.listdir(out):
        assert _png(out / name) == (16, 8, 8 * (1 + 16 * 3)), name
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["frame"] for r in records] == [0, 1]
    assert all(r["wall_s"] > 0 and r["rays_per_s"] > 0 for r in records)


def test_render_cli_config():
    """`--pipeline auto` is the fused frame on the card and the pass
    pipeline on the CPU; `--fused` is an alias of `--pipeline fused`;
    `--march` sphere-traces (intersect_mode="march")."""
    ns = argparse.Namespace
    base = dict(width=16, height=8, march=False, unbiased=False, pipeline="auto", fused=False)
    assert cli._config_from(ns(**base, device="cpu")).pipeline == "pass"
    assert cli._config_from(ns(**base, device="cuda")).pipeline == "fused"
    assert cli._config_from(ns(**dict(base, fused=True), device="cpu")).pipeline == "fused"
    assert cli._config_from(ns(**dict(base, unbiased=True), device="cpu")).biased is False
    with pytest.raises(SystemExit):
        cli._config_from(ns(**dict(base, fused=True, pipeline="pass"), device="cpu"))
    assert cli._config_from(ns(**base, device="cpu")).intersect_mode == "analytic"
    march = cli._config_from(ns(**dict(base, march=True), device="cpu"))
    assert (march.intersect_mode, march.pipeline) == ("march", "pass")
