"""Find the pixels that hold the backward kernel's distance from its plain
version, and weigh both against float64.

    python3 tools/gradient_witness.py [--frame small|1080p] [--pixels N]

Needs a CUDA device. On the chosen frame (small: the sphere scene at 96x64,
soft shadows 0.05, smp=2, every pixel; 1080p: the default scene at
1920x1080 without its ill-conditioned pixels, frame_kernel.ill_conditioned)
K5 (ops/frame_grad.frame_backward) and its plain version take the random
cotangents of tests/test_torch_cuda.py on the 13 float planes, every table
seeded. The script takes the gradient entry where they part most, relative
to its table's max |ref|, and bisects the image for the pixel that holds
most of the difference. For that pixel it prints the forward planes of K1, of the plain
version and of the plain version on float64 tables; the primary shading
point times the checker frequency of the material hit (the material's
checker reads floor() of it), from each version's depth along the float64
ray; and the pixel's share of the entry in K5, the plain version and
float64. Then it removes the pixel and looks again, N times in all.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import keep_planes, worst_entry  # noqa: E402
from kylespathtracer_tpu_torch.ops import frame_grad as fg  # noqa: E402
from kylespathtracer_tpu_torch.ops import frame_kernel as fk  # noqa: E402
from kylespathtracer_tpu_torch.render.camera import Camera  # noqa: E402
from kylespathtracer_tpu_torch.scene.scene import default_scene, sphere_scene  # noqa: E402
from kylespathtracer_tpu_torch.utils.config import RenderConfig  # noqa: E402

SMP2 = {k: 2 for k in ("smp_direct_lambert", "smp_lambert_surface_lambert", "smp_lambert_surface_phong",
                      "smp_direct_phong", "smp_phong_surface_lambert", "smp_phong_surface_phong")}


def float64(obj):
    """A scene, its materials or a camera with every float tensor in float64."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            kw[f.name] = v.double()
        elif dataclasses.is_dataclass(v):
            kw[f.name] = float64(v)
    return dataclasses.replace(obj, **kw)


def ray64(cam, px, py, cfg) -> torch.Tensor:
    """The primary ray of pixel (px, py) in float64 (ops/frame_kernel._raygen)."""
    xf = (2.0 * (px + 0.5) / cfg.width - 1.0) * (cfg.width / cfg.height)
    yf = 2.0 * (py + 0.5) / cfg.height - 1.0
    n = math.sqrt(xf * xf + yf * yf + cfg.fov * cfg.fov)
    dx, dy, dz = xf / n, yf / n, cfg.fov / n
    o0, o1 = cam.orient.double().tolist()
    y2 = dy * math.cos(o0) + dz * math.sin(o0)
    z1 = -dy * math.sin(o0) + dz * math.cos(o0)
    return torch.tensor([dx * math.cos(o1) + z1 * math.sin(o1), y2, -dx * math.sin(o1) + z1 * math.cos(o1)],
                        dtype=torch.float64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frame", choices=("small", "1080p"), default="small")
    ap.add_argument("--pixels", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gradient_witness: needs a CUDA device")
    dev = torch.device("cuda")
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    if args.frame == "small":
        scene = sphere_scene([[5.5, 1.0, 0.0], [4.0, 0.5, 1.0], [6.0, 2.5, -1.5]], [1.0, 0.5, 0.7],
                             [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]], device=dev)
        cfg = RenderConfig(width=96, height=64, soft_shadows=0.05, **SMP2)
    else:
        scene, cfg = default_scene(device=dev), RenderConfig(width=1920, height=1080)
    H, W = cfg.height, cfg.width
    out, ref = fk.frame_forward(scene, cam, 3, cfg), fk.frame_forward_plain(scene, cam, 3, cfg)
    sc64, cam64 = float64(scene), float64(cam)
    p64 = fk.frame_forward_plain(sc64, cam64, 3, cfg)
    # The cotangents of tests/test_torch_cuda.py: plane i from seed i.
    g = {k: torch.randn(out[k].shape, generator=torch.Generator(device=dev).manual_seed(i), device=dev)
         for i, k in enumerate(fg.OUT_KEYS[:6])}
    keep = torch.ones(H, W, dtype=torch.bool, device=dev)
    if args.frame == "1080p":
        keep = ~fk.ill_conditioned(out, ref)
        print(f"{int((~keep).sum())} ill-conditioned pixels masked")
    ti, e, rel = worst_entry(fg.frame_backward(scene, cam, 3, keep_planes(g, ~keep), cfg),
                             fg.frame_backward_plain(scene, cam, 3, keep_planes(g, ~keep), cfg))
    name = f"{fg.DIFF_NAMES[ti]}[{e}]"
    print(f"{W}x{H}: worst entry {name}, |Δ|/max|ref| {rel:.3g}")

    def share(sel, what=(fg.frame_backward, fg.frame_backward_plain), tables=((scene, cam),) * 2):
        m = torch.zeros(H * W, dtype=torch.bool, device=dev)
        m[sel] = True
        gm = keep_planes(g, ~m.reshape(H, W))
        return [f(sc, c, 3, gm, cfg)[ti].flatten()[e].item() for f, (sc, c) in zip(what, tables)]

    for _ in range(args.pixels):
        idx = keep.flatten().nonzero().flatten()
        a, b = share(idx)
        print(f"K5 - plain over the {idx.numel()} pixels left: {a - b:.6g}")
        while idx.numel() > 1:
            h = idx.numel() // 2
            (a0, b0), (a1, b1) = share(idx[:h]), share(idx[h:])
            idx = idx[:h] if abs(a0 - b0) >= abs(a1 - b1) else idx[h:]
        y, x = divmod(int(idx[0]), W)
        k5, plain, f64 = share(idx, (fg.frame_backward, fg.frame_backward_plain, fg.frame_backward_plain),
                               ((scene, cam), (scene, cam), (sc64, cam64)))
        oid = int(ref["oid"][y, x])
        print(f"pixel row {y} col {x} (row 0 at the bottom), object {oid}: its share of {name}: "
              f"K5 {k5:.9g}, plain {plain:.9g}, float64 {f64:.9g}")
        for key in fg.OUT_KEYS[:6]:
            print(f"  {key}: K1 {out[key][y, x].tolist()}, plain {ref[key][y, x].tolist()}, "
                  f"float64 {p64[key][y, x].tolist()}")
        if 0 <= oid < scene.materials.freq.shape[0]:
            rd, loc = ray64(cam, x, y, cfg), cam.loc.double().cpu()
            freq = float(scene.materials.freq[oid])
            for label, frame in (("K1", out), ("plain", ref), ("float64", p64)):
                hl = loc + rd * float(frame["depth"][y, x])
                print(f"  shading point x checker frequency, {label} depth: {(hl * freq).tolist()}")
        keep[y, x] = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
