"""Time the RECOVERY recipe several times in one fresh process, after one
of a few warm-ups, to find what makes the first recovery in a process slow.

    python3 tools/recovery_turns.py [--runs N] [--warm none|config4|optimizer|steps]

Needs a CUDA device. Builds (or finds) and loads the kernels, then warms
with `--warm`: nothing; `bench_configs.config4` (the 1080p fused and pass
frames, K3 and the classification, as `python -m
kylespathtracer_tpu_torch.bench_configs` runs it before config 5); one
`ClippedAdam` step on a tiny parameter (the optimizer's first step); or
`run_recovery` with 8 steps (every first call of the recipe's path). Then
it runs `run_recovery` with the RECOVERY recipe (10 spheres, 800 steps,
192×128, 5 views, 4 β phases) N times, each ended by a synchronize.
Prints the warm-up's seconds, one JSON line per run (wall seconds, ms per
step with the targets, the errors) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kylespathtracer_tpu_torch import bench_configs  # noqa: E402
from kylespathtracer_tpu_torch.diff import inverse  # noqa: E402
from kylespathtracer_tpu_torch.ops import _build  # noqa: E402
from kylespathtracer_tpu_torch.utils.metrics import card_line  # noqa: E402


RECIPE = dict(num_spheres=10, width=192, height=128, views=5, betas=(0.05, 0.02, 0.008, 0.003))


def warm(what: str, device) -> None:
    if what == "config4":
        bench_configs.config4(device)
    elif what == "optimizer":
        opt = inverse.ClippedAdam(1e-2, 10, 0.05, clip=1.0)
        params = {"x": torch.ones(4, device=device)}
        opt.update({"x": torch.ones(4, device=device)}, opt.init(params), params)
    elif what == "steps":
        inverse.run_recovery(steps=8, device=device, **RECIPE)
    torch.cuda.synchronize()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--warm", choices=("none", "config4", "optimizer", "steps"), default="none")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("recovery_turns: needs a CUDA device")
    card = card_line()
    device = torch.device("cuda")
    t0 = time.perf_counter()
    _build.load()
    torch.zeros((), device=device).item()
    t1 = time.perf_counter()
    warm(args.warm, device)
    print(json.dumps({"kernels_load_and_context_s": t1 - t0, "warm": args.warm,
                      "warm_s": time.perf_counter() - t1, "card": card}), flush=True)
    for run in range(args.runs):
        t0 = time.perf_counter()
        res = inverse.run_recovery(steps=800, device=device, **RECIPE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({"run": run, "warm": args.warm, "wall_s": wall, "ms_per_step": wall / res["steps"] * 1e3,
                          **{k: res[k] for k in ("err_position", "err_radius", "err_albedo")}, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
