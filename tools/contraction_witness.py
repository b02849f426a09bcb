"""What `-fmad=false` buys the geometry (K3) and path (K7) kernels.

    python3 tools/contraction_witness.py

Needs a CUDA device. ops/_build.py compiles geometry_kernel.cu and
path_kernel.cu with `-fmad=false`, so that they round every operation on
its own, as their plain versions do. This script builds the kernel library
twice — as committed, then with those two sources under nvcc's default
multiply-add contraction — and holds each build against the plain versions
on the cases of chip_smoke.py phases 13, 14 and 16: K7 on the default
scene at 256×128 (spp 2) and 1920×1080 (spp 4) and on the JAX package's
config 3 at 512×512 (spp 4), all at depth 6; K3 on the default scene at
1920×1080 and on the sphere scene of tests/test_torch_cuda.py at 160×96.
It prints the statistics of `path_kernel.disagreement` and
`geometry_kernel.disagreement` and the CUDA-event time of each kernel at
1920×1080, per build.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kylespathtracer_tpu_torch.ops import _build  # noqa: E402
from kylespathtracer_tpu_torch.ops import geometry_kernel as gk  # noqa: E402
from kylespathtracer_tpu_torch.ops import path_kernel as pk  # noqa: E402
from kylespathtracer_tpu_torch.render.camera import Camera  # noqa: E402
from kylespathtracer_tpu_torch.scene.scene import default_scene, sphere_scene  # noqa: E402
from kylespathtracer_tpu_torch.scene.types import BSDF  # noqa: E402
from kylespathtracer_tpu_torch.utils.config import RenderConfig  # noqa: E402
from kylespathtracer_tpu_torch.utils.metrics import card_line, cuda_ms  # noqa: E402

SOURCES = ("geometry_kernel.cu", "path_kernel.cu")


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("contraction_witness: needs a CUDA device")
    dev = torch.device("cuda")
    card = card_line()
    print(f"card {card}", flush=True)
    scene = default_scene(device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    config3 = sphere_scene(
        [[-1.5, 1.0, 6.0], [1.5, 1.2, 6.5], [0.0, 0.8, 4.5]], [1.0, 1.2, 0.8],
        [[0.9, 0.9, 0.9], [0.7, 0.8, 0.9], [0.9, 0.6, 0.5]],
        kinds=[BSDF.MIRROR, BSDF.DIELECTRIC, BSDF.DIFFUSE], iors=[1.5, 1.5, 1.5], device=dev,
    )
    cam3 = Camera.create(loc=(0.0, 2.0, -2.0), orient=(-0.1, 0.0), device=dev)
    spheres = sphere_scene(
        [[5.5, 1.0, 0.0], [4.0, 0.5, 1.0], [6.0, 2.5, -1.5]], [1.0, 0.5, 0.7],
        [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]], device=dev,
    )
    path_cases = (
        ("K7 default 256x128 spp 2", scene, cam, RenderConfig(width=256, height=128, spp=2, max_depth=6)),
        ("K7 config 3 512x512 spp 4", config3, cam3, RenderConfig(width=512, height=512, spp=4, max_depth=6)),
        ("K7 default 1920x1080 spp 4", scene, cam, RenderConfig(width=1920, height=1080, spp=4, max_depth=6)),
    )
    geo_cases = (
        ("K3 default 1920x1080", scene, RenderConfig(width=1920, height=1080)),
        ("K3 spheres 160x96", spheres, RenderConfig(width=160, height=96)),
    )
    path_ref = {label: pk.pathtrace_plain(sc, cm, c, 0) for label, sc, cm, c in path_cases}
    geo_ref = {label: gk.geometry_pass_plain(sc, cam, 0, c) for label, sc, c in geo_cases}

    committed = dict(_build.SOURCE_FLAGS)
    contracted = {k: v for k, v in committed.items() if k not in SOURCES}
    for build, flags in (("-fmad=false (committed)", committed), ("default contraction", contracted)):
        _build.SOURCE_FLAGS = flags
        _build._lib = None  # load the library of these flags (its own file name)
        _build.load()
        print(f"--- {build}", flush=True)
        for label, sc, cm, c in path_cases:
            print(f"  {label}: {pk.disagreement(pk.pathtrace(sc, cm, c, 0), path_ref[label])}")
        for label, sc, c in geo_cases:
            print(f"  {label}: {gk.disagreement(gk.geometry_pass(sc, cam, 0, c), geo_ref[label])}")
        c_pt, c_geo = path_cases[2][3], geo_cases[0][2]
        k7 = cuda_ms(lambda: pk.pathtrace(scene, cam, c_pt, 0), reps=5)
        k3 = cuda_ms(lambda: gk.geometry_pass(scene, cam, 0, c_geo), reps=20, warmup=2)
        print(f"  K7 1920x1080 spp 4 depth 6 {k7:.4f} ms, K3 1920x1080 {k3:.4f} ms [{card}]", flush=True)
    _build.SOURCE_FLAGS = committed
    return 0


if __name__ == "__main__":
    sys.exit(main())
