"""One rank of the launcher's and the row-sharded loop's tests, on the CPU:
the test starts rank 0 as `python -m kpt_bench.tests._rank_worker ...`, and
rank 0 starts the others through kpt_bench/ranks.py as a run does. The
ranks join one gloo process group through the program's launch contract
(parallel/multihost.py).

    stub <mode> <ranks> <limit_s>   a stand-in body: ok | fail | hang | raise
    rows <fault> <ranks>            the row-sharded cell at 64x32 through
                                    harness.run_cell, with `fault` planted
                                    (sound: none)

Every rank prints its pid on standard error as it joins; rank 0 prints the
result line last on standard output.
"""

from __future__ import annotations

import json
import os
import sys
import time

from kpt_bench import ranks

# The row-sharded cell, kept out of BENCHMARK.json (pending/<cell>.json).
ROWS = "inverse10_rows4.step1080"
SOUND = "sound"
FAULTS = ("grad_left_out", "params_changed", "state_left_unchanged", "half_tiles_left_out", "exchange_left_out")


def join_cpu(rank: int) -> None:
    from kylespathtracer_tpu_torch.parallel import multihost

    print(f"pid {os.getpid()} rank {rank}", file=sys.stderr, flush=True)
    if not multihost.initialize_from_env(device="cpu"):
        raise SystemExit("no process group in the environment")


def stub(mode: str, n: int, limit: float) -> int:
    def body(rank: int) -> dict:
        print(f"rank {rank} runs", flush=True)
        if rank == 1 and mode == "fail":
            raise SystemExit(3)
        if rank == 1 and mode == "hang":
            time.sleep(3600)
        if rank == 0 and mode == "raise":
            raise RuntimeError("rank 0's body failed")
        return {"rank": rank}

    def report(out: dict) -> int:
        print(json.dumps(out), flush=True)
        return 0

    cmd = [sys.executable, "-m", "kpt_bench.tests._rank_worker", "stub", mode, str(n), str(limit)]
    return ranks.run(n, cmd, limit, join_cpu, body, report)


def plant(fault: str) -> None:
    """Break the program underneath the loop."""
    import torch

    from kpt_bench.kinds import rows
    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.parallel import mesh as mesh_mod

    reduce = mesh_mod.Mesh.all_reduce_sum

    def grad_left_out(self, tensors):
        # This rank's loss joins the sum, its gradient does not.
        if self.rank == 1:
            tensors = [tensors[0], *(torch.zeros_like(t) for t in tensors[1:])]
        return reduce(self, tensors)

    def half_tiles_left_out(self, tensors):
        kept = self.size // 2
        if self.rank >= kept:
            tensors = [torch.zeros_like(t) for t in tensors]
        return [t * (self.size / kept) for t in reduce(self, tensors)]

    def exchange_left_out(self, tensors):
        return list(tensors)

    window = rows.Loop.window

    def params_changed(self, seconds, trace_steps):
        if self.mesh.rank == 1:
            with torch.no_grad():
                next(iter(self.params.values())).add_(1e-3)
        return window(self, seconds, trace_steps)

    update = inverse.ClippedAdam.update

    def state_left_unchanged(self, grads, state, params):
        before = {k: v.detach().clone() for k, v in state.params.items()}
        update(self, grads, state, params)
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(before[k])
        return state.params

    patch = {"grad_left_out": (mesh_mod.Mesh, "all_reduce_sum", grad_left_out),
             "half_tiles_left_out": (mesh_mod.Mesh, "all_reduce_sum", half_tiles_left_out),
             "exchange_left_out": (mesh_mod.Mesh, "all_reduce_sum", exchange_left_out),
             "params_changed": (rows.Loop, "window", params_changed),
             "state_left_unchanged": (inverse.ClippedAdam, "update", state_left_unchanged)}
    if fault != SOUND:
        owner, name, broken = patch[fault]
        setattr(owner, name, broken)


def loop(fault: str, n: int) -> int:
    from kpt_bench import harness
    from kpt_bench.tests._tiny import SEED, tiny_cell

    cell = tiny_cell(ROWS, width=64, height=32)
    plant(fault)

    def body(rank: int) -> dict:
        return harness.run_cell(cell, SEED, 0.3, False, "cpu", time.time())

    def report(out: dict) -> int:
        out.pop("_checks")
        print(json.dumps(out), flush=True)
        return 0

    cmd = [sys.executable, "-m", "kpt_bench.tests._rank_worker", "rows", fault, str(n)]
    return ranks.run(n, cmd, 300.0, join_cpu, body, report)


if __name__ == "__main__":
    what, arg, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
    sys.exit(stub(arg, n, float(sys.argv[4])) if what == "stub" else loop(arg, n))
