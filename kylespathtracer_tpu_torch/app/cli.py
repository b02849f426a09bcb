"""Command-line driver of the PyTorch port.

Port of kylespathtracer_tpu/app/cli.py, the `pathtrace` subcommand (the
multi-bounce wavefront render through the path kernel K7):

    python -m kylespathtracer_tpu_torch.app.cli pathtrace --width 1920 \
        --height 1080 --depth 6 --spp 4 --out out.png

It prints one JSON line (`wall_s`, `depth`, `spp`, `path_segments`) and
runs on the card unless `--device cpu` is given. `render`, `invert`, `fly`
and `info` wait for ROADMAP Queue 1 #14.
"""

from __future__ import annotations

import argparse
import json
import time


def _add_size(p, w=1280, h=720):
    p.add_argument("--width", type=int, default=w)
    p.add_argument("--height", type=int, default=h)


def cmd_pathtrace(args):
    """Multi-bounce wavefront render (the JAX package's BASELINE config #3)."""
    import torch

    from kylespathtracer_tpu_torch.render import wavefront
    from kylespathtracer_tpu_torch.render.camera import Camera
    from kylespathtracer_tpu_torch.scene.scene import default_scene
    from kylespathtracer_tpu_torch.utils import image_io
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    config = RenderConfig(width=args.width, height=args.height, max_depth=args.depth, spp=args.spp)
    device = torch.device(args.device)
    scene = default_scene(device=device)
    camera = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=device)
    t0 = time.perf_counter()
    img = wavefront.render_pathtraced(scene, camera, config, 0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "wall_s": dt, "depth": args.depth, "spp": args.spp,
        "path_segments": args.width * args.height * args.spp * args.depth,
    }))
    if args.out:
        image_io.save_png(args.out, img)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kylespathtracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pathtrace", help="multi-bounce wavefront render")
    _add_size(p)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--out", default=None, help="output PNG path")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.set_defaults(fn=cmd_pathtrace)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
