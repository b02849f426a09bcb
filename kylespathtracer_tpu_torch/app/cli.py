"""Command-line driver of the PyTorch port.

Port of kylespathtracer_tpu/app/cli.py:

    python -m kylespathtracer_tpu_torch.app.cli render --width 1280 \
        --height 720 --frames 64 --save-every 8 --out out/
    python -m kylespathtracer_tpu_torch.app.cli pathtrace --width 1920 \
        --height 1080 --depth 6 --spp 4 --out out.png
    python -m kylespathtracer_tpu_torch.app.cli invert --ckpt-dir ck --resume
    python -m kylespathtracer_tpu_torch.app.cli fly
    python -m kylespathtracer_tpu_torch.app.cli info

`render` renders the scripted spline animation (app/driver.py), writes
PNGs and one JSONL metrics record per frame (to --metrics, else stderr),
checkpoints its history every --checkpoint-every frames and resumes from
the newest with --resume; `--pipeline auto` is the fused frame on the card
and the pass pipeline on the CPU; `--march` sphere-traces the G-buffer and
the passes (scene/sdf.py). `pathtrace` is the multi-bounce wavefront render
through the path kernel K7 and prints one JSON line (`wall_s`, `depth`,
`spp`, `path_segments`). `invert` recovers a sphere scene from rendered
targets (diff/inverse.py:run_recovery) and prints its result dict. `fly`
is the interactive fly-cam (app/fly.py), which needs an interactive
terminal. `info` prints the version, the torch backend, its devices and
whether the native library built. Every subcommand that makes tensors runs
on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import time


def _add_size(p, w=1280, h=720):
    p.add_argument("--width", type=int, default=w)
    p.add_argument("--height", type=int, default=h)


def _config_from(args):
    """The RenderConfig of `render` and `fly`: size, estimators and the
    pipeline (`--fused` is the JAX CLI's alias of `--pipeline fused`)."""
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    kw = dict(width=args.width, height=args.height)
    if getattr(args, "march", False):
        kw["intersect_mode"] = "march"
    if getattr(args, "unbiased", False):
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
                         save_every=args.save_every, metrics=metrics,
                         checkpoint_dir=args.checkpoint_dir,
                         checkpoint_every=args.checkpoint_every,
                         preview=args.preview, resume=args.resume)
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


def cmd_fly(args):
    """Interactive fly-cam over the terminal (reference: main.cpp:328-357)."""
    from kylespathtracer_tpu_torch.app import fly as fly_mod

    fly_mod.fly(config=_config_from(args), fps=args.fps, max_w=args.cols, max_h=args.rows,
                device=args.device)


def cmd_info(args):
    """Version, torch backend and devices, and the native library's status."""
    import torch

    import kylespathtracer_tpu_torch as pkg
    from kylespathtracer_tpu_torch.utils import native

    cuda = torch.cuda.is_available()
    devices = ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
               if cuda else ["cpu"])
    print(json.dumps({
        "version": pkg.__version__,
        "backend": "cuda" if cuda else "cpu",
        "devices": devices,
        "native_lib": native.available(),
    }, indent=2))


def cmd_invert(args):
    """Inverse rendering: recover a sphere scene; prints the result dict."""
    from kylespathtracer_tpu_torch.diff import inverse

    result = inverse.run_recovery(
        num_spheres=args.spheres, steps=args.steps, width=args.width, height=args.height,
        lr=args.lr, seed=args.seed, log_every=args.log_every, views=args.views,
        betas=tuple(args.betas), ckpt_dir=args.ckpt_dir, resume=args.resume,
        device=args.device,
    )
    print(json.dumps(result))


def _add_pipeline(p):
    p.add_argument("--pipeline", choices=("auto", "pass", "fused"), default="auto",
                   help="frame pipeline (auto: fused on the card, pass on the CPU)")
    p.add_argument("--fused", action="store_true", help="alias for --pipeline fused")


def _add_device(p):
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")


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
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in --checkpoint-dir")
    p.add_argument("--preview", action="store_true", help="live ANSI preview in the terminal")
    _add_pipeline(p)
    _add_device(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("pathtrace", help="multi-bounce wavefront render")
    _add_size(p)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--out", default=None, help="output PNG path")
    _add_device(p)
    p.set_defaults(fn=cmd_pathtrace)

    p = sub.add_parser("invert", help="inverse rendering: recover a sphere scene")
    _add_size(p, w=192, h=128)
    p.add_argument("--spheres", type=int, default=10)
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint (scene, optimizer) after every beta phase")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest phase checkpoint in --ckpt-dir")
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=25)
    p.add_argument("--views", type=int, default=5,
                   help="look-at cameras on an arc (removes depth ambiguity)")
    p.add_argument("--betas", type=float, nargs="+", default=[0.05, 0.02, 0.008, 0.003],
                   help="soft-shadow continuation schedule")
    _add_device(p)
    p.set_defaults(fn=cmd_invert)

    p = sub.add_parser("fly", help="interactive fly-cam (wasd/arrows, ANSI preview)")
    _add_size(p, w=480, h=270)
    p.add_argument("--fps", type=float, default=20.0)
    p.add_argument("--cols", type=int, default=100, help="preview width in cells")
    p.add_argument("--rows", type=int, default=48, help="preview height in cells")
    _add_pipeline(p)
    _add_device(p)
    p.set_defaults(fn=cmd_fly)

    p = sub.add_parser("info", help="version, torch backend and devices, native-lib status")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
