"""The readings that the limits of `correct` are set from, on the card.

    python3 -m kpt_bench.calibrate --workload <cell> --seeds <n>... [--control <n>...]
        [--seconds S] [--out FILE]

In one process, to pay the set-up's fixed costs once: for each seed of
`--seeds`, the cell's set-up and a window of `--seconds` (none by default)
through the program, then its check (the program's readings, the lower end
of each limit); for each seed of `--control`, the same numbers with the
control in the program's place (the plain reference in bfloat16, the upper
end), and for a training cell the fault that the reference can stand in
for: half of the views left out, the mean taken over the rest, in the first
steps and in the window's last step. A state left unchanged reads 1 by the
training measure and needs no run. One JSON line per reading, on stdout
and appended to FILE. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from kpt_bench import harness
from kpt_bench.kinds import training


def temporal_control(kind) -> dict:
    """The control of the temporal cell: each kept frame from the program's
    previous history by the reference in bfloat16."""
    from kpt_bench.kinds.temporal import _hist_dict
    from kpt_bench.reference import frame as rf

    sc = rf.scene_tables(kind.tree, kind.device, torch.bfloat16)

    def program(prev, i, img, new):
        h = _hist_dict(prev)
        low = {k: ({f: (v.to(torch.bfloat16) if v.is_floating_point() else v) for f, v in h[k].items()}
                   if isinstance(h[k], dict) else h[k].to(torch.bfloat16)) for k in h}
        loc, orient = kind.locs[i % kind.loop], kind.ors[i % kind.loop]
        return rf.temporal_frame(sc, loc.to(torch.bfloat16), orient.to(torch.bfloat16), low,
                                 kind.frame_base + i, kind.rc)

    rows = kind.frames_compared(program)
    return {k: max(r[k] for r in rows) for k in rows[0]}


def training_faults(kind) -> dict:
    """The control and the fault of a training cell, read against the
    float32 reference: in the first steps (the check's first three numbers)
    and in the window's last step (the `window_` ones)."""
    half = lambda steps: [(f, views[: (len(views) + 1) // 2]) for f, views in steps]
    ref, wref = kind.reference(), kind.window_reference()
    sides = {"control": (kind.reference(torch.bfloat16), kind.window_reference(torch.bfloat16)),
             "half_views": (kind.reference(steps=half(kind.first_steps())),
                            kind.window_reference(steps=half(kind.last_step())))}
    return {side: {**training.gaps(first, ref), **{f"window_{k}": v for k, v in training.gaps(last, wref).items()}}
            for side, (first, last) in sides.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kpt_bench.calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in args.seeds + [s for s in args.control if s not in args.seeds]:
        t0 = time.time()
        kind = harness.kind_class(cell.traffic["kind"])(cell, seed, device)
        setup = time.time() - t0
        kind.window(args.seconds, 0)
        if seed in args.seeds:
            keep = list(kind.kept) if hasattr(kind, "kept") else None
            checks = kind.check()
            emit({"cell": args.workload, "seed": seed, "side": "program", "setup_s": setup,
                  **{c.name: c.value for c in checks}})
            if keep is not None:
                kind.kept = keep
        if seed in args.control:
            if cell.traffic["kind"] == "temporal":
                emit({"cell": args.workload, "seed": seed, "side": "control", **temporal_control(kind)})
            else:
                for side, nums in training_faults(kind).items():
                    emit({"cell": args.workload, "seed": seed, "side": side, **nums})
        del kind
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
