"""Command-line driver of the PyTorch port.

Port of kylespathtracer_tpu/app/cli.py, the `render` and `pathtrace`
subcommands:

    python -m kylespathtracer_tpu_torch.app.cli render --width 1280 \
        --height 720 --frames 64 --save-every 8 --out out/
    python -m kylespathtracer_tpu_torch.app.cli pathtrace --width 1920 \
        --height 1080 --depth 6 --spp 4 --out out.png

`render` renders the scripted spline animation (app/driver.py), writes
PNGs and one JSONL metrics record per frame (to --metrics, else stderr);
`--pipeline auto` is the fused frame on the card and the pass pipeline on
the CPU. `pathtrace` is the multi-bounce wavefront render through the path
kernel K7 and prints one JSON line (`wall_s`, `depth`, `spp`,
`path_segments`). Both run on the card unless `--device cpu` is given.
`invert`, `fly` and `info`, and `render`'s checkpoint, resume and preview
options, wait for ROADMAP Queue 1 #14; `--march` for #11.
"""

from __future__ import annotations

import argparse
import json
import time


def _add_size(p, w=1280, h=720):
    p.add_argument("--width", type=int, default=w)
    p.add_argument("--height", type=int, default=h)


def _config_from(args):
    """The RenderConfig of `render`: size, estimators and the pipeline
    (`--fused` is the JAX CLI's alias of `--pipeline fused`)."""
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    if args.march:
        raise NotImplementedError(
            "--march: the sphere-trace intersector (scene/sdf.py) waits for ROADMAP Queue 1 #11")
    kw = dict(width=args.width, height=args.height)
    if args.unbiased:
        kw["biased"] = False
    choice = args.pipeline
    if args.fused:
        if choice == "pass":
            raise SystemExit("error: --fused conflicts with --pipeline pass "
                             "(--fused is an alias for --pipeline fused)")
        choice = "fused"
    if choice == "auto":
        choice = "fused" if args.device.startswith("cuda") else "pass"
    return RenderConfig(pipeline=choice, **kw)


def cmd_render(args):
    """Render the spline animation; PNGs and per-frame metrics."""
    import torch

    from kylespathtracer_tpu_torch.app.driver import render_animation
    from kylespathtracer_tpu_torch.scene.scene import default_scene
    from kylespathtracer_tpu_torch.utils.metrics import MetricsLogger

    config = _config_from(args)
    metrics = MetricsLogger(args.metrics)
    try:
        render_animation(default_scene(device=torch.device(args.device)), config,
                         num_frames=args.frames, out_dir=args.out,
                         save_every=args.save_every, metrics=metrics)
    finally:
        metrics.close()


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

    p = sub.add_parser("render", help="render an animated sequence")
    _add_size(p)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--out", default="out")
    p.add_argument("--save-every", type=int, default=0)
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--march", action="store_true", help="sphere-trace intersector")
    p.add_argument("--unbiased", action="store_true", help="ground-truth estimators")
    p.add_argument("--pipeline", choices=("auto", "pass", "fused"), default="auto",
                   help="frame pipeline (auto: fused on the card, pass on the CPU)")
    p.add_argument("--fused", action="store_true", help="alias for --pipeline fused")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    p.set_defaults(fn=cmd_render)

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
