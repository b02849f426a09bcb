"""The card's rate for the frame kernel's op mix: the op-mix probe K9.

    python -m kylespathtracer_tpu_torch.bench_ceiling [--out PATH]

The port's counterpart of bench_ceiling.py. Needs a CUDA device. It builds
the kernels with the compiler's report, then for each variant of
ops/ceiling_kernel.py:SWEEP times K9 at 1080×1920 and prints one JSON line
with the JAX file's keys (template, chains, iters, live_planes, ops_per_px,
value in op/s, teraops), the time of one launch, the instantiation's
registers, stack frame and spills, and the card's name and power limit.
It then holds each variant's 1080×1920 output, as the timed launches left
it, to its plain version bit for bit (infinities and NaN in place; it
stops if one differs), times the fma probe that runs about half its steps
on finite values (INF_PROBE; the sweep's fma variants run almost wholly on
infinities) on these planes and on planes of +inf (every step on
infinities), and prints the summary: the best fma and frame_mix rates,
their ratio, and both against the rate without FMA (SMs × 128 f32 lanes ×
the maximum SM clock). The static instruction classes of each
instantiation are printed by `ops/adjoint_variants.py --frame`.

Time of one launch: the least-squares slope of CUDA-event totals over K
back-to-back launches, K in (16, 64, 112), each total the best of 4, as
bench.py's _timed_scan; launch overhead is the intercept and cancels.
Operations = H·W·iters·chains·TEMPLATE_OPS, counted as the JAX file counts
them.

`--out PATH` also writes the records and the summary as JSON to PATH, a new
file; it refuses one that exists.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from kylespathtracer_tpu_torch.ops import _build
from kylespathtracer_tpu_torch.ops import ceiling_kernel as ck
from kylespathtracer_tpu_torch.utils.metrics import card_line, slope_fit

KS = (16, 64, 112)
REPS = 4
# f32 lanes of one Hopper SM.
F32_LANES = 128


def no_fma_rate() -> float:
    """f32 operations a second when each is an instruction of its own (no
    FMA): SMs × 128 lanes × the card's maximum SM clock (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * F32_LANES * mhz * 1e6


def inputs(device, h: int = ck.H, w: int = ck.W):
    """The JAX probe's planes: x from 0.1 to 1.9 and y from 1.7 to 0.2,
    evenly over h·w elements."""
    x = torch.linspace(0.1, 1.9, h * w, dtype=torch.float32, device=device).reshape(h, w)
    y = torch.linspace(1.7, 0.2, h * w, dtype=torch.float32, device=device).reshape(h, w)
    return x, y


def infinite_planes(device):
    """Planes of +inf: every step of the fma templates on infinities."""
    return tuple(torch.full((ck.H, ck.W), float("inf"), device=device) for _ in range(2))


def slope_ms(launch, ks=KS, reps: int = REPS) -> tuple[float, dict]:
    """Milliseconds of one launch() as the slope of the best of `reps`
    CUDA-event totals over K back-to-back launches, K in `ks`, and the
    detail (totals, the slopes between neighbouring K, whether they agree
    within 20%)."""
    launch()
    torch.cuda.synchronize()
    totals = []
    for k in ks:
        best = float("inf")
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                launch()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        totals.append(best)
    slope, sub, linear = slope_fit(ks, totals)
    return slope, {"ks": list(ks), "totals_ms": totals, "sub_slopes_ms": sub, "linear_ok": linear}


def ops_of(variant, pixels: int) -> int:
    template, iters, chains, _ = variant
    return pixels * iters * chains * ck.TEMPLATE_OPS[template]


def sweep(device, variants=ck.SWEEP, planes=None) -> tuple[list, list]:
    """Time K9 for each variant at 1080×1920 on `planes` (default
    `inputs`) → one record each (the JAX file's keys, `ms` for one launch
    and the slope's detail), and each variant's output as the timed
    launches left it."""
    x, y = inputs(device) if planes is None else planes
    records, outs = [], []
    for variant in variants:
        template, iters, chains, live = variant
        launch, out = ck.mix_launch(x, y, *variant)
        outs.append(out)
        ms, detail = slope_ms(launch)
        rate = ops_of(variant, x.numel()) / (ms * 1e-3)
        records.append({"metric": "ceiling_ops_per_s", "template": template, "chains": chains, "iters": iters,
                        "live_planes": live, "ops_per_px": iters * chains * ck.TEMPLATE_OPS[template],
                        "value": rate, "teraops": rate / 1e12, "ms": ms, "timing": detail})
    return records, outs


def check(outs, planes, variants=ck.SWEEP) -> float:
    """Hold each of `sweep`'s outputs to `mix_plain` on the same planes, bit
    for bit (a NaN matching any NaN), → the largest |kernel − plain| over
    the finite elements; raise if any element differs."""
    x, y = planes
    err = 0.0
    for variant, out in zip(variants, outs, strict=True):
        ref = ck.mix_plain(x, y, *variant)
        off = ck.differing(out, ref)
        if off:
            raise AssertionError(f"K9 {variant} at {list(x.shape)}: {off} of {ref.numel()} elements differ from "
                                 "its plain version")
        finite = torch.isfinite(ref)
        if finite.any():
            err = max(err, (out[finite] - ref[finite]).abs().max().item())
    return err


def ptxas_by_variant(report: str) -> dict:
    """Registers, stack frame and spill bytes of each K9 instantiation in a
    verbose build's report (`_build.build(verbose=True)`)."""
    out = {}
    for part in report.split("Compiling entry function '")[1:]:
        variant = ck.variant_of(part.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", part)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", part)
        if variant is not None and regs and frame:
            out[variant] = {"registers": int(regs.group(1)), "stack": int(frame.group(1)),
                            "spill_stores": int(frame.group(2)), "spill_loads": int(frame.group(3))}
    return out


def summary(records: list, probe: dict, err: float, card: str) -> dict:
    best = {t: max(r["value"] for r in records if r["template"] == t) for t in ("fma", "frame_mix")}
    nominal = no_fma_rate()
    return {"metric": "ceiling_summary", "best_fma_teraops": best["fma"] / 1e12,
            "best_frame_mix_teraops": best["frame_mix"] / 1e12, "mix_vs_fma": best["frame_mix"] / best["fma"],
            "no_fma_teraops": nominal / 1e12, "fma_vs_no_fma": best["fma"] / nominal,
            "frame_mix_vs_no_fma": best["frame_mix"] / nominal, "inf_probe_teraops": probe["teraops"],
            "max_abs_err_vs_plain": err, "card": card}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="write the records and the summary as JSON to this new file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_ceiling: needs a CUDA device")
    if args.out is not None and args.out.exists():
        sys.exit(f"bench_ceiling: {args.out} exists; give a new path")
    card = card_line()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        _build.build(verbose=True)
    resources = ptxas_by_variant(report.getvalue())
    dev = torch.device("cuda")
    planes = inputs(dev)
    records, outs = sweep(dev, planes=planes)
    err = check(outs, planes)
    del outs
    for r in records:
        r.update(resources.get((r["template"], r["iters"], r["chains"], r["live_planes"]), {}), card=card)
        print(json.dumps(r), flush=True)
    probe, probe_inf = (sweep(dev, (ck.INF_PROBE,), on)[0][0] for on in (planes, infinite_planes(dev)))
    for rec, on in ((probe, "the probe's planes"), (probe_inf, "+inf")):
        rec.update(resources.get(ck.INF_PROBE, {}), metric="ceiling_inf_probe", planes=on, card=card)
        print(json.dumps(rec), flush=True)
    total = summary(records, probe, err, card)
    print(json.dumps(total), flush=True)
    if args.out is not None:
        with open(args.out, "x") as out:
            json.dump({"results": records, "inf_probe": [probe, probe_inf], "summary": total}, out, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
