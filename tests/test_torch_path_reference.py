"""PyTorch port, the multi-bounce path tracer against the benchmark's plain
reference (kpt_bench/reference/path.py): render/wavefront.render_pathtraced
on the CPU (K7's plain route) on three seeded scenes of BASELINE config 3's
shape (a mirror, a dielectric and a diffuse sphere, centers and radii moved
from the seed, random albedos, ior in [1.3, 1.7]) and on one with a glossy
sphere in place of the diffuse one, each held within the limits of the
benchmark's check of the cell pathtrace.spp4_1080. CPU, 32×16, 2 spp,
depth 6."""

import numpy as np
import pytest
import torch

from kpt_bench import harness
from kpt_bench.kinds import pathtrace as loop
from kpt_bench.reference import frame as rf
from kpt_bench.reference import path as rp
from kylespathtracer_tpu_torch.render import wavefront
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.scene.types import scene_from_numpy
from kylespathtracer_tpu_torch.utils.config import RenderConfig

W, H, SPP, DEPTH = 32, 16, 2, 6
CELL = harness.load_cell("pathtrace.spp4_1080")
LIMITS = {k: float(v) for k, v in CELL.traffic["limits"].items()}


def _spec(seed: int, third: str) -> dict:
    """Config 3's scene with its spheres moved, resized and recoloured from
    `seed`; the third sphere of BSDF `third`."""
    rng = np.random.default_rng(seed)
    base = CELL.config["scene"]
    centers = np.asarray(base["centers"]) + rng.uniform(-0.3, 0.3, (3, 3))
    return dict(base, centers=centers.tolist(),
                radii=(np.asarray(base["radii"]) * rng.uniform(0.85, 1.15, 3)).tolist(),
                albedos=rng.uniform(0.2, 0.95, (3, 3)).tolist(), kinds=["MIRROR", "DIELECTRIC", third],
                iors=rng.uniform(1.3, 1.7, 3).tolist())


@pytest.mark.parametrize("seed,third", [(11, "DIFFUSE"), (12, "DIFFUSE"), (13, "DIFFUSE"), (14, "GLOSSY")])
def test_render_pathtraced_matches_the_reference(seed, third):
    tree = loop.scene_tree(_spec(seed, third))
    cam = CELL.config["camera"]
    loc, orient = torch.tensor(cam["loc"]), torch.tensor(cam["orient"])
    frame = 1000 + seed
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH, gloss=5.0)
    img = wavefront.render_pathtraced(scene_from_numpy(tree, device="cpu"), Camera(loc=loc, orient=orient), cfg,
                                      frame)
    rc = dict(CELL.render, width=W, height=H, spp=SPP, max_depth=DEPTH)
    kinds, iors = rp.material_tables(tree, "cpu")
    assert kinds[5] == (rp.GLOSSY if third == "GLOSSY" else rp.DIFFUSE)
    tally = {}
    ref = rp.render(rf.scene_tables(tree, "cpu"), kinds, iors, loc, orient, frame, rc, 8, tally)
    got = loop.compare(img, ref)
    assert all(got[k] <= LIMITS[k] for k in loop.CHECKS), (got, LIMITS)
    # A lit image whose paths go past the first bounce.
    assert float(ref.amax()) > 0.5 and tally["traced"] > W * H * SPP > tally["hits"] > 0
