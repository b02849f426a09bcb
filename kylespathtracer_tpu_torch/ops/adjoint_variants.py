"""Where the time of the hand-written kernels goes: the reverse-mode
gradient kernels K5 and K6, (with --frame) the forward frame kernels K1
and K8, (with --path) the path-tracing kernel K7 and the pass pipeline's
shade kernel K4, and (with --geometry) the geometry-pass kernel K3.

    python -m kylespathtracer_tpu_torch.ops.adjoint_variants [--parent CSRC] [--frame | --path | --geometry] [VARIANT ...]
    python -m kylespathtracer_tpu_torch.ops.adjoint_variants (--path | --frame | --geometry) --turns ROOT

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
`frame_hist`), and prints the static instruction mix of both kernels,
K2's and the op-mix probe K9's (`cuobjdump -sass`; K9's per template round
of each instantiation, by opcode group). Variants:

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

With --path it times K7 at bench.py's wavefront cell (default scene,
1920×1080, 4 spp, depth 6, camera (3,2,-3) orient (0,0.7), frame 0) and on
the JAX package's config 3 (512×512, mirror, dielectric and diffuse
spheres), and K4 at 1920×1080 on the default scene's G-buffer, each alone
(CUDA events around its launch) and with its wrapper (`pathtrace`,
`dual_mis`), holds every variant whose image is right to K7's plain
version bit for bit, and prints the static instruction mix of both.
Variants, joined by `+` to combine them:

- `committed`; `minblocks=N`: K7 under `__launch_bounds__(128, N)`,
  `k4_minblocks=N` K4; `uncut`: K7 without its box cull (the earlier
  design); `depth=D`: the build at max_depth D (the
  marginal time of each bounce);
- `no_box`: the rounded box gone from the scene (the image is wrong; the
  floor of any treatment of the box); `cull_all`: the box cull's slab
  tests run but rule out every box, and `cull_free`: the cull rules out
  every box without its tests (both images wrong; what the cull and the
  box's code cost by themselves); `no_nee`: the light test skipped (every
  light sample counts as visible);
- `census`: an instrumented build that records, per sample, pixel and
  bounce, whether the segment is traced, whether the box cull passes its
  ray, and whether the light test runs, finds no plane or sphere in the
  way, and passes the cull. The image is unchanged. It prints per bounce
  the live lanes, the warps with a live lane (a warp: two rows of 16
  pixels of a 16×8 block), and the warps that run the box's candidates
  uncut, culled lane by lane, and deferred to the block (⌈n/32⌉ warps for
  the block's n rays), and the warp iterations of the nested loop against
  the flat one and the ideal.

With --geometry it times K3 at 1920×1080 on three cells: (a) bench.py's
raycast view of the default scene (camera (3,2,-3), orient (0,0.7), as
chip_smoke.py phase 13), (b) a view aimed at the rounded box (orient
(-0.165,2.356)), (c) view (b) with two more boxes; on each K3 alone (CUDA
events around its launch, one launch and 50 back to back) and with its
wrapper (`geometry_pass`), and whether its dict is bitwise its plain
version's. It prints once the plain version's and the G-buffer module's
(`gbuffer.geometry_pass`) time on (a) and (b). Variants, joined by `+`:

- `committed`; `minblocks=N`: K3 under `__launch_bounds__(128, N)`;
  `tile=WxH`: the block's 128 threads on a W×H tile (committed 32×4);
  `pixels=N`: N tiles a block (committed: as many blocks as the card
  holds at once, each walking the tiles spaced by the grid); `uncut`: the
  trace without the box cull or the bounding-sphere test (every ray runs
  the box's candidates); `slab_only`: the box cull without the
  bounding-sphere test before it (the cull of K7); `plain_stores`: the
  outputs written without the evict-first hint (`__stcs`);
- `no_box`: the rounded box gone from the trace; `cull_all`, `cull_free`:
  as for --path; `planar`: the normal written as three planes (the
  layout of the kernel before the dict's); `no_trace`: no raygen, trace or normal (every pixel
  writes zeros: the writes alone). Their dicts are wrong; only
  their time is read.

`--turns ROOT` times the group's kernels with their wrappers and alone
(their kernels' device time in a torch.profiler trace) from another
checkout ROOT and from this one, in turns (ROOT, this, this, ROOT), each
in a process of its own: with --path K7 and K4 on the cells above, with
--geometry K3 on its three cells, with
--frame K1 (frame 3), K8 (frame 1 on a seeded history) and K2 (the
split frame's reprojection of both channel sets, query heads included,
K = 8, on the same histories: alone on the anchors, `reproject_window`,
and as the split frame launches it, `reproject_tail`, which builds the
rays and anchors from K1's planes and runs the tail; in a checkout before
that, its rays and anchors as tensor ops and its K2 with the tail) at
1920×1080, full frame.

With `--parent CSRC` (the csrc directory of another checkout) it first
compiles the kernels that the group leaves alone from both trees and says
whether `cuobjdump -sass` prints the same code for each.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from kylespathtracer_tpu_torch.bench_configs import config3_case
from kylespathtracer_tpu_torch.diff import inverse
from kylespathtracer_tpu_torch.ops import _build
from kylespathtracer_tpu_torch.ops import ceiling_kernel as ck
from kylespathtracer_tpu_torch.ops import frame_grad as fg
from kylespathtracer_tpu_torch.ops import frame_hist as fh
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import geometry_kernel as gk
from kylespathtracer_tpu_torch.ops import loss_kernel as lk
from kylespathtracer_tpu_torch.ops import path_kernel as pk
from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
from kylespathtracer_tpu_torch.ops import shade_kernel as sk
from kylespathtracer_tpu_torch.render import gbuffer, passes
from kylespathtracer_tpu_torch.render.camera import Camera
from kylespathtracer_tpu_torch.render.passes import Channel
from kylespathtracer_tpu_torch.scene.scene import default_scene
from kylespathtracer_tpu_torch.utils.config import RenderConfig
from kylespathtracer_tpu_torch.utils.metrics import card_line, cuda_ms

ROOT = Path(__file__).resolve().parents[2]
ADJ, SHADE, BODY, HIST, PATH, GEO = ("frame_adjoint.cuh", "shade_core.cuh", "frame_body.cuh", "frame_hist.cu",
                                     "path_kernel.cu", "geometry_kernel.cu")
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
        (SHADE, "  for (int bx = 0; bx < (BOXES ? T.nB : 0); ++bx) {", "  for (int bx = 0; bx < 0; ++bx) {"),
        (SHADE, "  for (int bx = 0; bx < (BOXES ? T.nB : 0); ++bx) {", "  for (int bx = 0; bx < 0; ++bx) {")],
    "no_cull": [(SHADE, "__device__ __forceinline__ bool box_may_hit(const float* B, V3 o, V3 d, float tmax) {\n",
                 "__device__ __forceinline__ bool box_may_hit(const float* B, V3 o, V3 d, float tmax) {\n"
                 "  return true;\n")],
    "no_taps": [(HIST, "  tap_sum_gathered(hd_rgb, hd_cnt, hd_oid, oid, y, x, dy, dx, wy, wx, Q.K, H, W, hist_row0, acc);",
                 "  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;"),
                (HIST, "  tap_sum_gathered(hs_rgb, hs_cnt, hs_oid, oid, y, x, dy, dx, wy, wx, Q.K, H, W, hist_row0, acc);",
                 "  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;")],
    "serial_taps": [(HIST, "  tap_sum_gathered(hd_rgb,", "  tap_sum(hd_rgb,"),
                    (HIST, "  tap_sum_gathered(hs_rgb,", "  tap_sum(hs_rgb,")],
    "no_head_tail": [(HIST, "  // Anchors: the hit point for diffuse",
                      "  {\n    const size_t p = (size_t)r * W + x;\n"
                      "    for (int c = 0; c < 3; ++c) {\n"
                      "      out_drgb[3 * p + c] = vals[c];\n      out_srgb[3 * p + c] = vals[3 + c];\n"
                      "      out_alb[3 * p + c] = vals[6 + c];\n    }\n"
                      "    out_dcnt[p] = out_scnt[p] = 1.0f;\n"
                      "    out_ene[2 * p] = vals[9];\n    out_ene[2 * p + 1] = vals[10];\n"
                      "    out_oid[p] = oid;\n    return;\n  }\n  // Anchors: the hit point for diffuse")],
}
PATH_OFF = {
    "no_box": [(PATH, "  const Tables T = load_table_parts(smem, tp, F);\n",
                "  Tables T = load_table_parts(smem, tp, F);\n  T.nB = 0;\n")],
    "cull_all": [(SHADE, "  return t0 <= t1;\n}", "  return t0 <= t1 && tmax < -1.0f;\n}")],
    "cull_free": [(SHADE, "  const float oc[3] = {o.x - B[0], o.y - B[1], o.z - B[2]};\n  const float dv[3] = {d.x, d.y, d.z};\n"
                          "  float t0 = 0.0f, t1 = tmax;",
                   "  return false;\n  const float oc[3] = {o.x - B[0], o.y - B[1], o.z - B[2]};\n"
                   "  const float dv[3] = {d.x, d.y, d.z};\n  float t0 = 0.0f, t1 = tmax;")],
    "no_nee": [(PATH, "      CENSUS(census_nee(T, ro_off, l_wi, oid, bounce));\n      if (",
                "      CENSUS(census_nee(T, ro_off, l_wi, oid, bounce));\n      if (true || ")],
    "uncut": [(PATH, "    trace<float, true, false, true>(T, ro, rd, excl, t, oid);", "    trace<float, true>(T, ro, rd, excl, t, oid);"),
              (PATH, "      if (light_visible<true>(T, ro_off, l_wi, oid)) {", "      if (light_visible(T, ro_off, l_wi, oid)) {")],
}
GEOMETRY_OFF = {
    "uncut": [(GEO, "trace<float, false, false, true>(Tr, ro, rd, -1, t, oid);", "trace(T, ro, rd, -1, t, oid);")],
    "slab_only": [(GEO, "    if (!near_a_box(spheres, T.nB, rd)) Tr.nB = 0;\n", "")],
    "no_box": [(GEO, "    if (!near_a_box(spheres, T.nB, rd)) Tr.nB = 0;\n", "    Tr.nB = 0;\n")],
    "cull_all": PATH_OFF["cull_all"],
    "cull_free": PATH_OFF["cull_free"],
    "planar": [(GEO, "    __stcs(out.normal + 3 * o, hn.x);\n    __stcs(out.normal + 3 * o + 1, hn.y);\n"
                     "    __stcs(out.normal + 3 * o + 2, hn.z);\n",
                "    const size_t plane = (size_t)P.height * (size_t)P.width;\n    __stcs(out.normal + o, hn.x);\n"
                "    __stcs(out.normal + plane + o, hn.y);\n    __stcs(out.normal + 2 * plane + o, hn.z);\n")],
    "plain_stores": [(GEO, "    __stcs(out.depth + o, t - EPS);\n    __stcs(out.curv + o, curv);\n"
                           "    __stcs(out.normal + 3 * o, hn.x);\n    __stcs(out.normal + 3 * o + 1, hn.y);\n"
                           "    __stcs(out.normal + 3 * o + 2, hn.z);\n    __stcs(out.oid + o, oid);\n",
                      "    out.depth[o] = t - EPS;\n    out.curv[o] = curv;\n    out.normal[3 * o] = hn.x;\n"
                      "    out.normal[3 * o + 1] = hn.y;\n    out.normal[3 * o + 2] = hn.z;\n    out.oid[o] = oid;\n")],
    "no_trace": [(GEO, "    if (x >= P.width || y >= P.height) continue;\n",
                  "    if (x >= P.width || y >= P.height) continue;\n    {\n"
                  "      const size_t o = (size_t)y * (size_t)P.width + (size_t)x;\n"
                  "      out.depth[o] = out.curv[o] = out.normal[3 * o] = out.normal[3 * o + 1] = out.normal[3 * o + 2] = 0.0f;\n"
                  "      out.oid[o] = 0;\n      continue;\n    }\n")],
}
# Each group: its variants, the sources whose launch bounds minblocks=N
# sets, its kernels' (label, source), and the sources it leaves alone
# (compared by --parent).
GROUPS = {
    "adjoint": (SWITCH_OFF, ("frame_grad.cu", "loss_kernel.cu"),
                (("K5", "frame_grad.cu"), ("K6", "loss_kernel.cu")),
                ("frame_kernel.cu", "geometry_kernel.cu", "shade_kernel.cu", "path_kernel.cu", "frame_hist.cu")),
    "frame": (FRAME_OFF, ("frame_kernel.cu", "frame_hist.cu"),
              (("K1", "frame_kernel.cu"), ("K8", "frame_hist.cu"), ("K2", "reproject_kernel.cu"),
               ("K9", "ceiling_kernel.cu")),
              ("geometry_kernel.cu", "shade_kernel.cu", "frame_grad.cu", "loss_kernel.cu", "path_kernel.cu")),
    "path": (PATH_OFF, ("path_kernel.cu",), (("K7", "path_kernel.cu"), ("K4", "shade_kernel.cu")),
             ("frame_kernel.cu", "reproject_kernel.cu", "geometry_kernel.cu", "frame_grad.cu", "loss_kernel.cu",
              "frame_hist.cu")),
    "geometry": (GEOMETRY_OFF, (GEO,), (("K3", GEO),),
                 ("frame_kernel.cu", "reproject_kernel.cu", "frame_grad.cu", "loss_kernel.cu", "path_kernel.cu",
                  "frame_hist.cu", "shade_kernel.cu", "ceiling_kernel.cu")),
}


def burst_ms(fn, n: int = 50) -> float:
    """Milliseconds per call of fn() over n calls enqueued back to back
    between two CUDA events, after one call to warm up: the device's time per
    launch where the host enqueues faster than the device runs."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def ptxas_lines(report: str, source: str) -> str:
    """The registers/stack/spill lines of `source` in a verbose build report."""
    part = report.split(f"--- {source}\n", 1)[1].split("\n--- ", 1)[0]
    return "; ".join(ln.strip() for ln in part.splitlines()
                     if re.search(r"Used \d+ registers|bytes stack frame", ln))


def edits_of(variant: str, group: str) -> list:
    """The edits of one variant of `group` (parts joined by `+`): (source,
    text, replacement) each; text None sets the launch bounds' minimum
    blocks. Runtime options (depth=D, census) have none."""
    off, bounded = GROUPS[group][:2]
    edits = []
    for part in variant.split("+"):
        if part.startswith("minblocks="):
            edits += [(src, None, int(part.split("=", 1)[1])) for src in bounded]
        elif part.startswith("tile=") and group == "frame":
            w, h = (int(v) for v in part.split("=", 1)[1].split("x"))
            edits.append((BODY, "constexpr int BLOCK = 128, TILE_W = 16, TILE_H = 8;",
                          f"constexpr int BLOCK = 128, TILE_W = {w}, TILE_H = {h};"))
        elif part.startswith("tile=") and group == "geometry":
            w, h = (int(v) for v in part.split("=", 1)[1].split("x"))
            edits.append((GEO, "constexpr int TILE_W = 32, TILE_H = 4;", f"constexpr int TILE_W = {w}, TILE_H = {h};"))
        elif part.startswith("pixels=") and group == "geometry":
            n = int(part.split("=", 1)[1])
            edits.append((GEO, "  const int grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;",
                          f"  const int grid = (n_tiles + {n} - 1) / {n};"))
        elif part.startswith("k4_minblocks=") and group == "path":
            edits.append(("shade_kernel.cu", None, int(part.split("=", 1)[1])))
        elif (part.startswith("depth=") or part == "census") and group == "path":
            continue
        elif part != "committed":
            edits += off[part]
    return edits


def edit(csrc: Path, variant: str, group: str) -> None:
    """Apply `variant` of `group` to the copy of the sources in `csrc`;
    raise where an edit's text is not in its source."""
    for src, old, new in edits_of(variant, group):
        text = (csrc / src).read_text()
        if old is None:
            changed = re.sub(r"__launch_bounds__\((128|BLOCK)(, \d+)?\)", rf"__launch_bounds__(\1, {new})", text)
            ok = changed != text or re.search(rf"__launch_bounds__\((128|BLOCK), {new}\)", text)
        else:
            changed = text.replace(old, new, 1)
            ok = changed != text
        if not ok:
            raise SystemExit(f"adjoint_variants: {variant} does not apply to {src}")
        (csrc / src).write_text(changed)


def _compile(jobs: list) -> None:
    """Compile (tree, source, object) jobs in parallel, with the build's flags."""
    nvcc = _build._nvcc()
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(src, ()), "-c", "-o", str(obj),
                               str(tree / src)]) for tree, src, obj in jobs]
    if any(proc.wait() for proc in procs):
        raise SystemExit("adjoint_variants: nvcc failed")


def _sass_text(obj: Path) -> str:
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True, text=True, check=True).stdout


def _sass(obj: Path) -> list:
    return [ln for ln in _sass_text(obj).splitlines() if "/*" in ln and "code for" not in ln]


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
# Opcode groups of the mix, by an opcode's first word; every other opcode
# is "integer and other" (integer arithmetic, predicates, conversions,
# uniform-datapath work).
SASS_GROUPS = {
    "f32 add, mul, fma": ("FADD", "FMUL", "FFMA"),
    "compare, select, min/max": ("FSETP", "FSEL", "FMNMX", "FSET"),
    "MUFU, FCHK, FRND": ("MUFU", "FCHK", "FRND"),
    "bf16x2": ("HADD2", "HMUL2", "HFMA2"),
    "control": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BREAK", "WARPSYNC", "NOP", "BAR"),
    "loads, stores": ("LDS", "STS", "LDG", "STG", "LDL", "STL", "LDC"),
    "moves": ("MOV",),
    "f64": ("DFMA", "DMUL", "DADD", "DSETP"),
}


INSN = re.compile(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)")


def functions(obj: Path) -> dict:
    """The opcodes of each function in an object's SASS, by mangled name."""
    funcs, cur = {}, None
    for line in _sass_text(obj).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None and (m := INSN.match(line)):
            cur.append(m.group(1))
    return funcs


def grouped(ops) -> dict:
    """The opcodes `ops` counted by SASS_GROUPS, the rest as "integer and
    other", and in all ("total")."""
    first = collections.Counter(op.split(".")[0] for op in ops)
    sums = {g: sum(first[k] for k in members) for g, members in SASS_GROUPS.items()}
    return {"total": len(ops), **sums, "integer and other": len(ops) - sum(sums.values())}


def sass_mix(sources, parent: Path | None = None) -> None:
    """The static instruction mix of `sources` (this tree, and the `parent`
    csrc's where it has them): instructions in all, per opcode class and per
    group; for the op-mix probe (K9), per template round of each
    instantiation."""
    out = ROOT / "build" / "variants" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    trees = [("this", _build.CSRC)] + ([("parent", parent)] if parent else [])
    jobs = [(tag, tree, src) for tag, tree in trees for src in sources if (tree / src).exists()]
    _compile([(tree, src, out / f"mix_{tag}_{src}.o") for tag, tree, src in jobs])
    for tag, _, src in jobs:
        funcs = functions(out / f"mix_{tag}_{src}.o")
        ops = [op for f in funcs.values() for op in f]
        counts = {k: sum(1 for op in ops if op == k or op.startswith(k + ".")) for k in MIX}
        print(f"SASS mix {src} ({tag}): {len(ops)} instructions; "
              + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
        print(f"SASS groups {src} ({tag}): " + ", ".join(f"{g} {v}" for g, v in grouped(ops).items()), flush=True)
        for name, f_ops in funcs.items():
            variant = ck.variant_of(name)
            if variant is not None:
                rounds = variant[1] * variant[2]
                print(f"SASS groups per round K9 {variant} ({tag}): "
                      + ", ".join(f"{g} {v / rounds:.2f}" for g, v in grouped(f_ops).items()), flush=True)


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


def frame_cells(dev, rng):
    """The full-frame cells of the --frame group at 1920×1080 on the default
    scene → (scene, cam, prev, cfg, hd, hs): the camera of frame 1 and the
    one before it, and two seeded history channels on the previous frame's
    object IDs."""
    scene = default_scene(device=dev)
    prev = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.701), device=dev)
    cfg = RenderConfig(width=1920, height=1080, pipeline="fused", temporal_fusion="mono")
    oid = fk.frame_forward_plain(scene, prev, 0, cfg)["oid"]

    def channel():
        return Channel(rgb=torch.from_numpy(rng.uniform(0, 2, (1080, 1920, 3)).astype(np.float32)).to(dev),
                       cnt=torch.from_numpy(rng.integers(0, 17, (1080, 1920)).astype(np.float32)).to(dev),
                       oid=oid.clone())

    return scene, cam, prev, cfg, channel(), channel()


def _plain_anchors(scene, cam, cfg, ref) -> tuple:
    """The split frame's anchors (render/passes.py:reprojection_anchors) of
    K1's planes `ref` on `cam`, as tensor ops through names that `--turns`
    finds in an older checkout too → (hl, sl)."""
    from kylespathtracer_tpu_torch.render import passes
    from kylespathtracer_tpu_torch.render.camera import ray_dirs

    rd = ray_dirs(cam, cfg.width, cfg.height, cfg.fov)
    hl = cam.loc + rd * ref["depth"][..., None]
    return hl, passes.specular_anchor(scene, hl, rd, ref["curv"])


def k2_args(scene, cam, prev, cfg, hd, hs) -> tuple:
    """K2's arguments for the split frame's reprojection (the anchors of
    K1's frame 1 on `cam`, K = 8) → reproject_window(*args)."""
    ref = fk.frame_forward(scene, cam, 1, cfg)
    hl, sl = _plain_anchors(scene, cam, cfg, ref)
    return prev, hl, sl, ref["oid"], hd, hs, cfg.fov, 8


def k2_tail_call(scene, cam, prev, cfg, hd, hs):
    """The split frame's K2 launch after K1's frame 1 on `cam` (K = 8 as
    `k2_args`) → a function that makes it: `reproject_tail`, which builds
    the rays and anchors in the kernel. In a checkout whose `reproject_tail`
    takes the anchors (before the kernel built them), the function runs
    that checkout's split-frame route from K1's planes: the rays and the
    anchors as tensor ops, then its K2 with the tail."""
    import inspect

    cfg = dataclasses.replace(cfg, reproject_window=8)
    ref = fk.frame_forward(scene, cam, 1, cfg)
    if "scene" in inspect.signature(rk.reproject_tail).parameters:
        return lambda: rk.reproject_tail(scene, cam, prev, ref, hd, hs, cfg)
    return lambda: rk.reproject_tail(prev, cam.loc, *_plain_anchors(scene, cam, cfg, ref), ref, hd, hs, cfg)


def frame_times(dev, rng) -> callable:
    """The K1/K8 timing of one variant → a function that prints it."""
    scene, cam, prev, cfg, hd, hs = frame_cells(dev, rng)
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


def path_cells(dev) -> dict:
    """The cells of the --path group: K7 at bench.py's wavefront cell and on
    config 3, K4 on the default scene's G-buffer at 1920×1080 (the inputs of
    chip_smoke.py phase 19)."""
    scene = default_scene(device=dev)
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7), device=dev)
    cfg_p = RenderConfig(width=1920, height=1080, pipeline="pass", shade_backend="pallas")
    gb = gbuffer.geometry_pass(scene, cam, cfg_p)
    _, seed = passes._shade_common(scene, cfg_p, gb, cam, 3)
    return {"k7": (scene, cam, RenderConfig(width=1920, height=1080, spp=4, max_depth=6)), "k7_3": config3_case(dev),
            "k4": (scene, gb, cam, seed, cfg_p)}


def path_times(dev) -> callable:
    """The K7/K4 timing of one variant → a function that prints it."""
    cells = path_cells(dev)
    refs = {key: pk.pathtrace_plain(*cells[key], 0) for key in ("k7", "k7_3")}
    k4_ref = sk.dual_mis_plain(*cells["k4"])
    torch.cuda.synchronize()

    def run(variant, card):
        parts = variant.split("+")
        depth = next((int(v.split("=", 1)[1]) for v in parts if v.startswith("depth=")), 6)
        scene, cam, cfg = cells["k7"]
        cfg = dataclasses.replace(cfg, max_depth=depth)
        if "census" in parts:
            for line in pk.census_report(pk.census(scene, cam, cfg, 0), depth):
                print(f"[{variant}] census {line}", flush=True)
            return
        k7, img = pk.path_launch(scene, cam, cfg, 0)
        k7_3, img3 = pk.path_launch(*cells["k7_3"], 0)
        k4, (est_d, est_s) = sk.dual_mis_launch(*cells["k4"])
        times = (
            cuda_ms(k7, reps=10, warmup=2),
            cuda_ms(lambda: pk.pathtrace(scene, cam, cfg, 0), reps=10, warmup=1),
            cuda_ms(k7_3, reps=20, warmup=2),
            cuda_ms(lambda: pk.pathtrace(*cells["k7_3"], 0), reps=20, warmup=1),
            cuda_ms(k4, reps=20, warmup=2),
            cuda_ms(lambda: sk.dual_mis(*cells["k4"]), reps=20, warmup=1),
        )
        print(f"[{variant}] alone / with wrapper: K7 1920x1080 4 spp depth {depth} {times[0]:.4f} / "
              f"{times[1]:.4f} ms, K7 config 3 512x512 {times[2]:.4f} / {times[3]:.4f} ms, K4 1920x1080 "
              f"{times[4]:.4f} / {times[5]:.4f} ms [{card}]", flush=True)
        if depth == 6 and not {"no_box", "no_nee", "cull_all", "cull_free"} & set(parts):
            k4_err = max((est_d - k4_ref[0]).abs().max().item(), (est_s - k4_ref[1]).abs().max().item())
            print(f"[{variant}] K7 bitwise its plain version: 1080p {torch.equal(img, refs['k7'])} (max |d| "
                  f"{(img - refs['k7']).abs().max().item():.3g}), config 3 {torch.equal(img3, refs['k7_3'])} "
                  f"(max |d| {(img3 - refs['k7_3']).abs().max().item():.3g}); K4 max |d| from its plain version "
                  f"{k4_err:.3g}", flush=True)

    return run


# The cells of the --geometry group at 1920x1080, from the camera at
# VIEW_LOC: (a) bench.py's raycast view (chip_smoke.py phase 13), (b) a view
# aimed at the rounded box, (c) view (b) with two more boxes (THREE_BOXES:
# the default room's box, a thin slab with a wide rounding and a flat plate
# with a tight one; every box takes the default box's object ID, so the
# tables keep their sizes). chip_smoke.py and the tests take the views and
# the boxes from here.
VIEW_LOC = (3.0, 2.0, -3.0)
RAYCAST_VIEW = (0.0, 0.7)
BOX_AIMED = (-0.165, 2.356)
THREE_BOXES = [[7.5, 0.93, -7.5, 0.8, 0.8, 0.8, 0.1], [2.0, 1.0, 3.0, 0.3, 1.2, 0.5, 0.25],
               [-4.0, 2.5, 0.5, 1.5, 0.2, 0.9, 0.02]]


def geometry_cells(dev) -> dict:
    """The --geometry group's cells → {label: (scene, camera, config)}."""
    scene = default_scene(device=dev)
    boxes = dataclasses.replace(scene, boxes=torch.tensor(THREE_BOXES, dtype=torch.float32, device=dev),
                                box_ids=scene.box_ids.repeat(len(THREE_BOXES)))
    cfg = RenderConfig(width=1920, height=1080)
    cam_a = Camera.create(loc=VIEW_LOC, orient=RAYCAST_VIEW, device=dev)
    cam_b = Camera.create(loc=VIEW_LOC, orient=BOX_AIMED, device=dev)
    return {"(a) phase 13's view": (scene, cam_a, cfg), "(b) box-aimed": (scene, cam_b, cfg),
            "(c) three boxes": (boxes, cam_b, cfg)}


def geometry_times(dev) -> callable:
    """The K3 timing of one variant → a function that prints it: on each
    cell K3 alone (CUDA events around its launch) and with its wrapper, and
    whether its dict is bitwise its plain version's. Also prints, once, the
    plain version and the G-buffer module (`gbuffer.geometry_pass`, which
    the pass frame runs) on cells (a) and (b)."""
    cells = geometry_cells(dev)
    refs = {key: gk.geometry_pass_plain(scene, cam, 0, cfg) for key, (scene, cam, cfg) in cells.items()}
    for key in list(cells)[:2]:
        scene, cam, cfg = cells[key]
        plain = cuda_ms(lambda: gk.geometry_pass_plain(scene, cam, 0, cfg), reps=5)
        gbuf = cuda_ms(lambda: gbuffer.geometry_pass(scene, cam, cfg), reps=5)
        print(f"{key}: K3's plain version {plain:.4f} ms, gbuffer.geometry_pass {gbuf:.4f} ms "
              f"[{card_line()}]", flush=True)

    def run(variant, card):
        parts = []
        for key, (scene, cam, cfg) in cells.items():
            launch = gk.geometry_launch(scene, cam, 0, cfg)[0]
            alone = cuda_ms(launch, reps=50, warmup=3)
            burst = burst_ms(launch)
            wrapped = cuda_ms(lambda: gk.geometry_pass(scene, cam, 0, cfg), reps=50, warmup=3)
            out = gk.geometry_pass(scene, cam, 0, cfg)
            same = all(torch.equal(out[k], refs[key][k]) for k in ("depth", "curv", "normal", "oid"))
            parts.append(f"{key} {alone:.4f} / {burst:.4f} / {wrapped:.4f} ms (bitwise {same})")
        print(f"[{variant}] K3 1920x1080 alone / 50 back to back / with wrapper: " + ", ".join(parts)
              + f" [{card}]", flush=True)

    return run


def kernel_ms(fn, name: str, reps: int) -> float:
    """Device milliseconds per call of the CUDA kernels whose name holds
    `name`, from a torch.profiler trace of `reps` calls of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name)
    return us / reps / 1e3


def tree_times(group: str) -> dict:
    """The kernels of `group` ("path": K7 and K4; "frame": K1, K8 and K2 at
    full frame) of the checkout this process imports: with their wrappers
    (CUDA events) and alone (kernel_ms)."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    if group == "geometry":
        jobs = tuple((f"K3 {key}", lambda c=cell: gk.geometry_pass(c[0], c[1], 0, c[2]), "geometry_kernel", 50)
                     for key, cell in geometry_cells(dev).items())
    elif group == "path":
        cells = path_cells(dev)
        jobs = (("K7 1920x1080", lambda: pk.pathtrace(*cells["k7"], 0), "path_kernel", 10),
                ("K7 config 3", lambda: pk.pathtrace(*cells["k7_3"], 0), "path_kernel", 20),
                ("K4 1920x1080", lambda: sk.dual_mis(*cells["k4"]), "shade_kernel", 20))
    else:
        scene, cam, prev, cfg, hd, hs = frame_cells(dev, np.random.default_rng(1))
        k2 = k2_args(scene, cam, prev, cfg, hd, hs)
        jobs = (("K1 1920x1080", lambda: fk.frame_forward(scene, cam, 3, cfg), "frame_kernel", 20),
                ("K8 1920x1080", lambda: fh.frame_hist(scene, cam, prev, hd, hs, 1, cfg), "frame_hist_kernel", 20),
                ("K2 1920x1080", lambda: rk.reproject_window(*k2), "reproject_kernel", 50),
                ("K2 tail 1920x1080", k2_tail_call(scene, cam, prev, cfg, hd, hs), "reproject_kernel", 50))
    out = {"build_s": build_s, "tree": str(Path(pk.__file__).resolve().parents[2]), "times": {}}
    for key, fn, kernel, reps in jobs:
        out["times"][key] = {"with_wrapper": cuda_ms(fn, reps=reps, warmup=2), "alone": kernel_ms(fn, kernel, reps)}
    return out


def turns(root: Path, group: str, card: str) -> None:
    """tree_times of `root` and of this checkout in turns: root, this, this,
    root, each in a process of its own."""
    for tree in (root, ROOT, ROOT, root):
        env = dict(os.environ, PYTHONPATH=str(tree.resolve()))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), f"--{group}", "--tree-times"],
                              cwd=tree, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"adjoint_variants: --tree-times in {tree} failed:\n{proc.stdout}\n{proc.stderr}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[turns {'parent' if tree == root else 'this'}] {r['tree']}: built in {r['build_s']:.1f} s; "
              "with wrapper / alone: " + ", ".join(f"{k} {v['with_wrapper']:.4f} / {v['alone']:.4f} ms"
                                                   for k, v in r["times"].items()) + f" [{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="csrc directory of another checkout, for the SASS check")
    group_arg = ap.add_mutually_exclusive_group()
    group_arg.add_argument("--frame", action="store_true", help="the forward frame kernels K1 and K8")
    group_arg.add_argument("--path", action="store_true", help="the path kernel K7 and the shade kernel K4")
    group_arg.add_argument("--geometry", action="store_true", help="the geometry-pass kernel K3")
    ap.add_argument("--turns", type=Path, help="with --path, --frame or --geometry: time the group's kernels of checkout ROOT "
                                               "and of this one in turns")
    ap.add_argument("--tree-times", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("variants", nargs="*", default=["committed"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("adjoint_variants: needs a CUDA device")
    group = "frame" if args.frame else "path" if args.path else "geometry" if args.geometry else "adjoint"
    if args.tree_times:
        print(json.dumps(tree_times(group)), flush=True)
        return 0
    kernels, others = GROUPS[group][2:]
    card = card_line()
    print(f"card {card}", flush=True)
    if args.parent:
        same_sass(args.parent, others)
    if group != "adjoint":
        sass_mix([src for _, src in kernels], args.parent)
    if args.turns:
        turns(args.turns, group, card)

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    run = {"frame": lambda: frame_times(dev, rng), "adjoint": lambda: adjoint_times(dev, rng),
           "path": lambda: path_times(dev), "geometry": lambda: geometry_times(dev)}[group]()
    committed = (_build.CSRC, _build.BUILD_DIR)
    everything = (_build.SOURCES, _build._SIGNATURES)
    if group == "path":  # its variants build K7, K4 and K1 (whose source has kpt_error_string) alone
        _build.SOURCES = ("frame_kernel.cu", "path_kernel.cu", "shade_kernel.cu")
        _build._SIGNATURES = {k: everything[1][k] for k in ("kpt_frame_forward", "kpt_pathtrace", "kpt_dual_mis")}
    elif group == "geometry":  # K3 and K1 (kpt_error_string)
        _build.SOURCES = ("frame_kernel.cu", GEO)
        _build._SIGNATURES = {k: everything[1][k] for k in ("kpt_frame_forward", "kpt_geometry_pass")}
    built = {}  # the edits of a build → its csrc, so variants with the same sources share one build
    try:
        for variant in args.variants:
            key = repr(edits_of(variant, group))
            if key not in built:
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
                built[key] = csrc
            csrc = built[key]
            _build.CSRC, _build.BUILD_DIR, _build._lib = csrc, csrc.parent / "kernels", None
            run(variant, card)
        if group == "adjoint":
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
        _build.SOURCES, _build._SIGNATURES = everything
    return 0


if __name__ == "__main__":
    sys.exit(main())
