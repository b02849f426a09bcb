"""Where the time of the reverse-mode gradient kernels K5 and K6 goes.

    python -m kylespathtracer_tpu_torch.ops.adjoint_variants [--parent CSRC] [VARIANT ...]

Needs a CUDA device. For each variant it builds the kernel library from a
copy of kylespathtracer_tpu_torch/csrc under build/variants/ with one
change to the sources, prints the registers, stack and spills of K5
(frame_grad.cu) and K6 (loss_kernel.cu), and times with CUDA events K5 (13
cotangent planes, every table) and K6 (loss="mean", every table) at
1920×1080 on the default scene, and both at the recovery view (192×128,
spheres and alb_const, mse) on the recovery scene. Variants:

- `committed`: the sources as they are;
- `minblocks=N`: K5 and K6 under `__launch_bounds__(128, N)`;
- `no_atomics`, `no_roulettes`, `no_strategies`, `no_primary`, `no_soft`,
  `no_shade`: that part of the reverse sweep in csrc/frame_adjoint.cuh
  switched off. Their gradients are wrong; only their time is read.

With `--parent CSRC` (the csrc directory of another checkout) it first
compiles K1, K3, K4, K7 and K8 from both trees and says whether
`cuobjdump -sass` prints the same code for each.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from kylespathtracer_tpu_torch.diff import inverse
from kylespathtracer_tpu_torch.ops import _build
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import loss_kernel as lk
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.scene.scene import default_scene
from kylespathtracer_tpu_torch.utils.config import RenderConfig

ROOT = Path(__file__).resolve().parents[2]
ADJ = "frame_adjoint.cuh"
# One edit each: (source, text, replacement).
SWITCH_OFF = {
    "no_atomics": (ADJ, "    if (v == 0.0f) return;\n", "    return;\n"),
    "no_roulettes": (ADJ, "  if (bar[0] == 0.0f && bar[1] == 0.0f && bar[2] == 0.0f) return;\n", "  return;\n"),
    "no_strategies": (ADJ, "  if (w_lam_bar == 0.0f && w_pho_bar == 0.0f) return;\n", "  return;\n"),
    "no_primary": (ADJ, "  int nk = -1, ni = 0;\n", "  return;\n  int nk = -1, ni = 0;\n"),
    "no_soft": (ADJ, "  constexpr int GROUP = 16;\n", "  return;\n  constexpr int GROUP = 16;\n"),
    "no_shade": (ADJ, "  if (est && oid != T.light_id) {", "  if (false) {"),
}
FORWARD = ("frame_kernel.cu", "geometry_kernel.cu", "shade_kernel.cu", "path_kernel.cu", "frame_hist.cu")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() over `reps` runs, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_lines(report: str, source: str) -> str:
    """The registers/stack/spill lines of `source` in a verbose build report."""
    part = report.split(f"--- {source}\n", 1)[1].split("\n--- ", 1)[0]
    return "; ".join(ln.strip() for ln in part.splitlines()
                     if re.search(r"Used \d+ registers|bytes stack frame", ln))


def edit(csrc: Path, variant: str) -> None:
    """Apply `variant` to the copy of the sources in `csrc`."""
    edits = []
    if variant.startswith("minblocks="):
        n = int(variant.split("=", 1)[1])
        edits = [(src, None, n) for src in ("frame_grad.cu", "loss_kernel.cu")]
    elif variant != "committed":
        edits = [SWITCH_OFF[variant]]
    for src, old, new in edits:
        text = (csrc / src).read_text()
        if old is None:
            changed = re.sub(r"__launch_bounds__\(128(, \d+)?\)", f"__launch_bounds__(128, {new})", text)
        else:
            changed = text.replace(old, new, 1)
        if changed == text and not (old is None and f"__launch_bounds__(128, {new})" in text):
            raise SystemExit(f"adjoint_variants: {variant} does not apply to {src}")
        (csrc / src).write_text(changed)


def same_sass(parent: Path) -> None:
    """Compile the forward kernels from both trees; compare their SASS."""
    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    out = ROOT / "build" / "variants" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in FORWARD:
        for tag, tree in (("this", _build.CSRC), ("parent", parent)):
            obj = out / f"{tag}_{src}.o"
            cmd = [nvcc, *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(src, ()), "-c", "-o", str(obj),
                   str(tree / src)]
            jobs.append(subprocess.Popen(cmd))
    if any(job.wait() for job in jobs):
        raise SystemExit("adjoint_variants: nvcc failed")

    def sass(obj):
        text = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True, text=True, check=True).stdout
        return [ln for ln in text.splitlines() if "/*" in ln and "code for" not in ln]

    for src in FORWARD:
        a, b = sass(out / f"this_{src}.o"), sass(out / f"parent_{src}.o")
        print(f"SASS {src}: {len(a)} vs {len(b)} lines, identical {a == b}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="csrc directory of another checkout, for the SASS check")
    ap.add_argument("variants", nargs="*", default=["committed"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("adjoint_variants: needs a CUDA device")
    card = card_line()
    print(f"card {card}", flush=True)
    if args.parent:
        same_sass(args.parent)

    dev = torch.device("cuda")
    scene = default_scene(device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    cfg = RenderConfig(width=1920, height=1080)
    rng = np.random.default_rng(1)
    shapes = {"add_d": (3,), "add_s": (3,), "alb": (3,), "ene": (2,), "depth": (), "curv": ()}
    g_all = {k: torch.from_numpy(rng.normal(size=(1080, 1920) + s).astype(np.float32)).to(dev)
             for k, s in shapes.items()}
    truth, start, views = inverse.recovery_scenes(10, 5, device=dev)
    needs = fg.needs_for(("spheres", "alb_const"))
    c_rec = RenderConfig(width=192, height=128, soft_shadows=0.05, pipeline="fused")
    f0 = inverse.SEED_BASE
    target = inverse.render_once(truth, views[0], c_rec, f0)
    g_rec = {k: torch.from_numpy(rng.normal(size=(128, 192) + s).astype(np.float32)).to(dev)
             for k, s in shapes.items()}

    committed = (_build.CSRC, _build.BUILD_DIR)
    try:
        for variant in args.variants:
            csrc = ROOT / "build" / "variants" / variant / "csrc"
            shutil.rmtree(csrc, ignore_errors=True)
            shutil.copytree(committed[0], csrc)
            edit(csrc, variant)
            _build.CSRC, _build.BUILD_DIR, _build._lib = csrc, csrc.parent / "kernels", None
            report = io.StringIO()
            with contextlib.redirect_stdout(report):
                _build.build(verbose=True)
            for label, src in (("K5", "frame_grad.cu"), ("K6", "loss_kernel.cu")):
                print(f"[{variant}] ptxas {label}: {ptxas_lines(report.getvalue(), src)}", flush=True)
            times = (
                cuda_ms(lambda: fg.frame_backward(scene, cam, 3, g_all, cfg), reps=7),
                cuda_ms(lambda: lk.render_loss_and_grad(scene, cam, 3, cfg, loss="mean"), reps=7),
                cuda_ms(lambda: fg.frame_backward(start, views[0], f0, g_rec, c_rec, needs), reps=30, warmup=3),
                cuda_ms(lambda: lk.render_loss_and_grad(start, views[0], f0, c_rec, target, "mse", needs),
                        reps=30, warmup=3),
            )
            print(f"[{variant}] K5 / K6 at 1920x1080 {times[0]:.4f} / {times[1]:.4f} ms; at the 192x128 "
                  f"recovery view {times[2]:.4f} / {times[3]:.4f} ms [{card}]", flush=True)
        k1 = (cuda_ms(lambda: fk.frame_forward(scene, cam, 3, cfg), reps=20, warmup=2),
              cuda_ms(lambda: fk.frame_forward(start, views[0], f0, c_rec), reps=50, warmup=5))
        print(f"K1 for scale: 1920x1080 {k1[0]:.4f} ms, 192x128 recovery view {k1[1]:.4f} ms [{card}]", flush=True)
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._lib = committed[0], committed[1], None
    return 0


if __name__ == "__main__":
    sys.exit(main())
