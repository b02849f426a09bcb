"""Where the time of the hand-written frame kernels goes: the reverse-mode
gradient kernels K5 and K6, and (with --frame) the forward frame kernels K1
and K8.

    python -m kylespathtracer_tpu_torch.ops.adjoint_variants [--parent CSRC] [--frame] [VARIANT ...]

Needs a CUDA device. For each variant it builds the kernel library from a
copy of kylespathtracer_tpu_torch/csrc under build/variants/ with one
change to the sources and prints the registers, stack and spills of the
group's kernels. Without --frame it times with CUDA events K5 (13
cotangent planes, every table) and K6 (loss="mean", every table) at
1920×1080 on the default scene, and both at the recovery view (192×128,
spheres and alb_const, mse) on the recovery scene. Variants:

- `committed`: the sources as they are;
- `minblocks=N`: K5 and K6 under `__launch_bounds__(128, N)`;
- `no_atomics`, `no_roulettes`, `no_strategies`, `no_primary`, `no_soft`,
  `no_shade`: that part of the reverse sweep in csrc/frame_adjoint.cuh
  switched off. Their gradients are wrong; only their time is read.

With --frame it times K1 (frame 3) and K8 (frame 1 on a seeded history) at
1920×1080 on the default scene and K1 at the recovery view, each alone (CUDA
events around its launch) and with its wrapper (`frame_forward`,
`frame_hist`), and prints the static instruction mix of both kernels
(`cuobjdump -sass`). Variants:

- `committed`, and `minblocks=N`: K1 and K8 under
  `__launch_bounds__(128, N)`; `tile=WxH`: the block's 128 threads on a
  W×H tile of pixels (committed 16×8);
- `no_shade`: every pixel takes the miss path's work (raygen, primary hit,
  material); `no_roulettes`: the four plane roulettes and the strategies
  that feed them; `no_roulette_traces`: the roulettes' two visibility
  traces; `no_direct`: the direct light's visibility trace; `no_box`: the
  rounded box's candidates in every trace (the box disappears); `no_taps`:
  K8's history gathers (an empty history); `no_head_tail`: K8's
  reprojection head and accumulate tail (it writes its frame planes and a
  count of 1). Their images are wrong; only their time is read.
- `no_cull`: the box cull off (every ray runs the box's candidates);
  `serial_taps`: K8's taps gathered one after another by K2's `tap_sum`.
  Their images are right.

The breakdown of the frame kernels before their redesign (PERF.md, PR 6)
came from this tool's first form, whose edits targeted
frame_core.cuh:frame_pixel and shade_core.cuh:shade_core.

With `--parent CSRC` (the csrc directory of another checkout) it first
compiles the kernels that the group leaves alone from both trees and says
whether `cuobjdump -sass` prints the same code for each.
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
from kylespathtracer_tpu_torch.ops import frame_hist as fh
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import loss_kernel as lk
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.render.passes import Channel
from kylespathtracer_tpu_torch.scene.scene import default_scene
from kylespathtracer_tpu_torch.utils.config import RenderConfig

ROOT = Path(__file__).resolve().parents[2]
ADJ, SHADE, BODY, HIST = "frame_adjoint.cuh", "shade_core.cuh", "frame_body.cuh", "frame_hist.cu"
# The edits of each variant: (source, text, replacement) each.
SWITCH_OFF = {
    "no_atomics": [(ADJ, "    if (v == 0.0f) return;\n", "    return;\n")],
    "no_roulettes": [(ADJ, "  if (bar[0] == 0.0f && bar[1] == 0.0f && bar[2] == 0.0f) return;\n", "  return;\n")],
    "no_strategies": [(ADJ, "  if (w_lam_bar == 0.0f && w_pho_bar == 0.0f) return;\n", "  return;\n")],
    "no_primary": [(ADJ, "  int nk = -1, ni = 0;\n", "  return;\n  int nk = -1, ni = 0;\n")],
    "no_soft": [(ADJ, "  constexpr int GROUP = 16;\n", "  return;\n  constexpr int GROUP = 16;\n")],
    "no_shade": [(ADJ, "  if (est && oid != T.light_id) {", "  if (false) {")],
}
FRAME_OFF = {
    "no_shade": [(BODY, "  if (oid != T.light_id && hit) {", "  if (false) {")],
    "no_roulettes": [
        (BODY, "  for (int k = 0; k < 4; ++k) {\n    float r[3]", "  for (int k = 0; k < 0; ++k) {\n    float r[3]"),
        (BODY, "  for (int p = 0; p < T.nP; ++p) {\n    V3 dl, dp;", "  for (int p = 0; p < 0; ++p) {\n    V3 dl, dp;")],
    "no_roulette_traces": [
        (BODY, "  if (!nearest_is_target<true>(T, hl, dir_sel, ho, tp, valid_p, false, 0)) return;",
         "  if (!valid_p) return;"),
        (BODY, "  const bool lhit = light_visible<true>(T, hl2, sample_dir, po_sel);", "  const bool lhit = true;")],
    "no_direct": [(BODY, "    vis = light_visible<true>(T, hl, dl_dir, ho) ? 1.0f : 0.0f;\n", "    vis = 1.0f;\n")],
    "no_box": [
        (SHADE, "  for (int bx = 0; bx < T.nB; ++bx) {\n    const int q = T.boxes + bx * 7;\n    if constexpr (CULL)",
         "  for (int bx = 0; bx < 0; ++bx) {\n    const int q = T.boxes + bx * 7;\n    if constexpr (CULL)"),
        (SHADE, "  for (int bx = 0; bx < T.nB; ++bx) {\n    if constexpr (CULL) {\n      if (!box_may_hit",
         "  for (int bx = 0; bx < 0; ++bx) {\n    if constexpr (CULL) {\n      if (!box_may_hit")],
    "no_cull": [(SHADE, "__device__ __forceinline__ bool box_may_hit(const float* B, V3 o, V3 d, float tmax) {\n",
                 "__device__ __forceinline__ bool box_may_hit(const float* B, V3 o, V3 d, float tmax) {\n"
                 "  return true;\n")],
    "no_taps": [(HIST, "  tap_sum_gathered(hd_rgb, hd_cnt, hd_oid, oid, y, x, dy, dx, wy, wx, Q.K, H, W, acc);",
                 "  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;"),
                (HIST, "  tap_sum_gathered(hs_rgb, hs_cnt, hs_oid, oid, y, x, dy, dx, wy, wx, Q.K, H, W, acc);",
                 "  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;")],
    "serial_taps": [(HIST, "  tap_sum_gathered(hd_rgb,", "  tap_sum(hd_rgb,"),
                    (HIST, "  tap_sum_gathered(hs_rgb,", "  tap_sum(hs_rgb,"),
                    (HIST, '#include "frame_body.cuh"\n', '#include "frame_body.cuh"\n#include "reproject_core.cuh"\n')],
    "no_head_tail": [(HIST, "  // Anchors: the hit point for diffuse",
                      "  {\n    const size_t p = (size_t)y * W + x;\n"
                      "    for (int c = 0; c < 3; ++c) {\n"
                      "      out_drgb[3 * p + c] = vals[c];\n      out_srgb[3 * p + c] = vals[3 + c];\n"
                      "      out_alb[3 * p + c] = vals[6 + c];\n    }\n"
                      "    out_dcnt[p] = out_scnt[p] = 1.0f;\n"
                      "    out_ene[2 * p] = vals[9];\n    out_ene[2 * p + 1] = vals[10];\n"
                      "    out_oid[p] = oid;\n    return;\n  }\n  // Anchors: the hit point for diffuse")],
}
# Each group: its variants, the sources whose launch bounds minblocks=N
# sets, its kernels' (label, source), and the sources it leaves alone
# (compared by --parent).
GROUPS = {
    "adjoint": (SWITCH_OFF, ("frame_grad.cu", "loss_kernel.cu"),
                (("K5", "frame_grad.cu"), ("K6", "loss_kernel.cu")),
                ("frame_kernel.cu", "geometry_kernel.cu", "shade_kernel.cu", "path_kernel.cu", "frame_hist.cu")),
    "frame": (FRAME_OFF, ("frame_kernel.cu", "frame_hist.cu"),
              (("K1", "frame_kernel.cu"), ("K8", "frame_hist.cu")),
              ("reproject_kernel.cu", "geometry_kernel.cu", "shade_kernel.cu", "frame_grad.cu",
               "loss_kernel.cu", "path_kernel.cu")),
}


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


def edit(csrc: Path, variant: str, group: str) -> None:
    """Apply `variant` of `group` to the copy of the sources in `csrc`."""
    off, bounded = GROUPS[group][:2]
    edits = []
    if variant.startswith("minblocks="):
        n = int(variant.split("=", 1)[1])
        edits = [(src, None, n) for src in bounded]
    elif variant.startswith("tile=") and group == "frame":
        w, h = (int(v) for v in variant.split("=", 1)[1].split("x"))
        edits = [(BODY, "constexpr int BLOCK = 128, TILE_W = 16, TILE_H = 8;",
                  f"constexpr int BLOCK = 128, TILE_W = {w}, TILE_H = {h};")]
    elif variant != "committed":
        edits = off[variant]
    for src, old, new in edits:
        text = (csrc / src).read_text()
        if old is None:
            changed = re.sub(r"__launch_bounds__\((128|BLOCK)(, \d+)?\)", rf"__launch_bounds__(\1, {new})", text)
        else:
            changed = text.replace(old, new, 1)
        if changed == text and not (old is None and re.search(rf"__launch_bounds__\((128|BLOCK), {new}\)", text)):
            raise SystemExit(f"adjoint_variants: {variant} does not apply to {src}")
        (csrc / src).write_text(changed)


def _compile(jobs: list) -> None:
    """Compile (tree, source, object) jobs in parallel, with the build's flags."""
    nvcc = _build._nvcc()
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(src, ()), "-c", "-o", str(obj),
                               str(tree / src)]) for tree, src, obj in jobs]
    if any(proc.wait() for proc in procs):
        raise SystemExit("adjoint_variants: nvcc failed")


def _sass(obj: Path) -> list:
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True, text=True, check=True).stdout
    return [ln for ln in text.splitlines() if "/*" in ln and "code for" not in ln]


def same_sass(parent: Path, sources) -> None:
    """Compile `sources` from both trees; compare their SASS."""
    out = ROOT / "build" / "variants" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    _compile([(tree, src, out / f"{tag}_{src}.o") for src in sources
              for tag, tree in (("this", _build.CSRC), ("parent", parent))])
    for src in sources:
        a, b = _sass(out / f"this_{src}.o"), _sass(out / f"parent_{src}.o")
        print(f"SASS {src}: {len(a)} vs {len(b)} lines, identical {a == b}", flush=True)


# Opcode classes of the static instruction mix: FCHK guards every correctly
# rounded division (div.rn), MUFU.RSQ starts every sqrt.rn and rsqrt,
# LDL/STL are local-memory (stack) accesses.
MIX = ("FCHK", "MUFU.RCP", "MUFU.RSQ", "MUFU.SIN", "MUFU.COS", "MUFU.EX2", "MUFU.LG2", "CALL", "LDL", "STL",
       "LDS", "FFMA", "FMUL", "FADD", "FSETP", "FSEL", "BRA")


INSN = re.compile(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)")


def sass_mix(sources) -> None:
    """The static instruction mix of `sources` (this tree): instructions in
    all and per opcode class."""
    out = ROOT / "build" / "variants" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    _compile([(_build.CSRC, src, out / f"mix_{src}.o") for src in sources])
    for src in sources:
        ops = [m.group(1) for m in map(INSN.match, _sass(out / f"mix_{src}.o")) if m]
        counts = {k: sum(1 for op in ops if op == k or op.startswith(k + ".")) for k in MIX}
        print(f"SASS mix {src}: {len(ops)} instructions; " + ", ".join(f"{k} {v}" for k, v in counts.items()),
              flush=True)


def adjoint_times(dev, rng) -> callable:
    """The K5/K6 timing of one variant → a function that prints it."""
    scene = default_scene(device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    cfg = RenderConfig(width=1920, height=1080)
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

    def run(variant, card):
        times = (
            cuda_ms(lambda: fg.frame_backward(scene, cam, 3, g_all, cfg), reps=7),
            cuda_ms(lambda: lk.render_loss_and_grad(scene, cam, 3, cfg, loss="mean"), reps=7),
            cuda_ms(lambda: fg.frame_backward(start, views[0], f0, g_rec, c_rec, needs), reps=30, warmup=3),
            cuda_ms(lambda: lk.render_loss_and_grad(start, views[0], f0, c_rec, target, "mse", needs),
                    reps=30, warmup=3),
        )
        print(f"[{variant}] K5 / K6 at 1920x1080 {times[0]:.4f} / {times[1]:.4f} ms; at the 192x128 "
              f"recovery view {times[2]:.4f} / {times[3]:.4f} ms [{card}]", flush=True)

    return run


def frame_times(dev, rng) -> callable:
    """The K1/K8 timing of one variant → a function that prints it."""
    scene = default_scene(device=dev)
    prev = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.701), device=dev)
    cfg = RenderConfig(width=1920, height=1080, pipeline="fused", temporal_fusion="mono")
    oid = fk.frame_forward_plain(scene, prev, 0, cfg)["oid"]

    def channel():
        return Channel(rgb=torch.from_numpy(rng.uniform(0, 2, (1080, 1920, 3)).astype(np.float32)).to(dev),
                       cnt=torch.from_numpy(rng.integers(0, 17, (1080, 1920)).astype(np.float32)).to(dev),
                       oid=oid.clone())

    hd, hs = channel(), channel()
    _, start, views = inverse.recovery_scenes(10, 5, device=dev)
    c_rec = RenderConfig(width=192, height=128, soft_shadows=0.05, pipeline="fused")
    f0 = inverse.SEED_BASE

    def run(variant, card):
        k1 = fk.frame_launch(scene, cam, 3, cfg)[0]
        k1_rec = fk.frame_launch(start, views[0], f0, c_rec)[0]
        k8 = fh.frame_hist_launch(scene, cam, prev, hd, hs, 1, cfg)[0]
        times = (
            cuda_ms(k1, reps=20, warmup=2),
            cuda_ms(lambda: fk.frame_forward(scene, cam, 3, cfg), reps=20, warmup=2),
            cuda_ms(k8, reps=20, warmup=2),
            cuda_ms(lambda: fh.frame_hist(scene, cam, prev, hd, hs, 1, cfg), reps=20, warmup=2),
            cuda_ms(k1_rec, reps=50, warmup=5),
            cuda_ms(lambda: fk.frame_forward(start, views[0], f0, c_rec), reps=50, warmup=5),
        )
        print(f"[{variant}] alone / with wrapper: K1 1920x1080 {times[0]:.4f} / {times[1]:.4f} ms, "
              f"K8 1920x1080 {times[2]:.4f} / {times[3]:.4f} ms, K1 192x128 recovery view "
              f"{times[4]:.4f} / {times[5]:.4f} ms [{card}]", flush=True)

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="csrc directory of another checkout, for the SASS check")
    ap.add_argument("--frame", action="store_true", help="the forward frame kernels K1 and K8")
    ap.add_argument("variants", nargs="*", default=["committed"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("adjoint_variants: needs a CUDA device")
    group = "frame" if args.frame else "adjoint"
    kernels, others = GROUPS[group][2:]
    card = card_line()
    print(f"card {card}", flush=True)
    if args.parent:
        same_sass(args.parent, others)
    if args.frame:
        sass_mix([src for _, src in kernels])

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    run = (frame_times if args.frame else adjoint_times)(dev, rng)
    committed = (_build.CSRC, _build.BUILD_DIR)
    try:
        for variant in args.variants:
            csrc = ROOT / "build" / "variants" / variant / "csrc"
            shutil.rmtree(csrc, ignore_errors=True)
            shutil.copytree(committed[0], csrc)
            edit(csrc, variant, group)
            _build.CSRC, _build.BUILD_DIR, _build._lib = csrc, csrc.parent / "kernels", None
            report = io.StringIO()
            with contextlib.redirect_stdout(report):
                _build.build(verbose=True)
            for label, src in kernels:
                print(f"[{variant}] ptxas {label}: {ptxas_lines(report.getvalue(), src)}", flush=True)
            run(variant, card)
        if not args.frame:
            _build.CSRC, _build.BUILD_DIR, _build._lib = committed[0], committed[1], None
            _, start, views = inverse.recovery_scenes(10, 5, device=dev)
            c_rec = RenderConfig(width=192, height=128, soft_shadows=0.05, pipeline="fused")
            scene = default_scene(device=dev)
            cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
            cfg = RenderConfig(width=1920, height=1080)
            k1 = (cuda_ms(lambda: fk.frame_forward(scene, cam, 3, cfg), reps=20, warmup=2),
                  cuda_ms(lambda: fk.frame_forward(start, views[0], inverse.SEED_BASE, c_rec), reps=50, warmup=5))
            print(f"K1 for scale: 1920x1080 {k1[0]:.4f} ms, 192x128 recovery view {k1[1]:.4f} ms [{card}]",
                  flush=True)
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._lib = committed[0], committed[1], None
    return 0


if __name__ == "__main__":
    sys.exit(main())
