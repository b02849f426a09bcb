"""The row-sharded training step as a user's job on several cards runs it.

The recovery recipe's problem (scenes.recovery_problem, as kinds/fit.py)
on n ranks, one a card: each rank holds the whole scene and image rows
[rank·H/n, (rank+1)·H/n) of the targets, and every step is the program's
`parallel/shard.train_step_tiled`: the frame on the rank's rows (K1 in row
mode), its backward by autograd (K5 in row mode), one all-reduce of the
loss and the scene gradients over the ranks, and the same `ClippedAdam`
update on every rank. Step i fits view i mod V against its seed-paired
target, realization s = i mod S rendered at frame seed_base + s; each rank
renders its rows of the V·S targets with the plain reference at set-up.

Set-up takes the first `check_steps` steps, then `warm_steps` more that
rank 0 times to set the window's length: a fixed number of steps, sent to
every rank, that fills `seconds`. The window opens after a barrier and a
synchronize on every rank; rank 0 times it on its host clock and ends it
with a synchronize after the last step, whose all-reduce waits for the
slowest rank: `shard_step_ms` is the window over its steps.

Check (kinds/training.py, on rank 0's card): the reference follows set-up's
first steps on the whole image (the sharded loss is the whole image's mean
squared error), its targets rendered again whole, and the window's last
step from the program's state before it (its parameters and Adam's
moments, read through `AdamState.state_dict()`), as kinds/fit.py; and
`rank_param_gap`, the largest difference of any rank's parameters from
rank 0's once the window has closed, which an identical update on every
rank keeps at 0. Near the optimum the K1+K5 route parts from the plain
frame by more than the residual that is left, so the window's gaps swing
by orders of magnitude from seed to seed; their limits lie between the
program's largest and the control's (PERF.md).
"""

from __future__ import annotations

import time

import torch

from kpt_bench import harness, roofline, scenes
from kpt_bench.kinds import Kind, training
from kpt_bench.kinds.fit import phase_steps
from kpt_bench.reference import frame as rf

CHECKS = ("loss_gap", "grad_gap", "step_gap", "window_loss_gap", "window_grad_gap", "window_step_gap",
          "rank_param_gap")


class Loop(Kind):
    @classmethod
    def tiny(cls, cell) -> None:
        cell.config["optimizer"] = dict(cell.config["optimizer"], realizations=2)
        cell.traffic.update(warm_steps=2)

    def __init__(self, cell, seed: int, device):
        from kylespathtracer_tpu_torch.diff import inverse
        from kylespathtracer_tpu_torch.parallel import multihost, shard
        from kylespathtracer_tpu_torch.render.camera import Camera
        from kylespathtracer_tpu_torch.scene.types import scene_from_numpy

        self.cell, self.device, self.shard = cell, torch.device(device), shard
        self.mesh = multihost.global_mesh(device=self.device)
        cfg, tr = cell.config, cell.traffic
        self.opt_cfg = dict(cfg["optimizer"])
        sc = cfg["scene"]
        self.prob = scenes.recovery_problem(int(sc["num_spheres"]), int(sc["views"]), int(sc["layout_seed"]), seed,
                                            float(sc["perturb"]))
        betas = [float(b) for b in self.opt_cfg["betas"]]
        self.opt_cfg["decay_steps"] = sum(phase_steps(int(self.opt_cfg["steps"]), len(betas)))
        self.rc = dict(cell.render, width=tr["width"], height=tr["height"], soft_shadows=float(tr["beta"]))
        self.H = int(tr["height"])
        self.rows = self.H // self.mesh.size
        self.row0 = self.mesh.rank * self.rows
        self.S, self.base = int(self.opt_cfg["realizations"]), int(self.opt_cfg["seed_base"])
        self.locs = torch.as_tensor(self.prob["cam_loc"], device=self.device)
        self.ors = torch.as_tensor(self.prob["cam_orient"], device=self.device)
        self.V = self.locs.shape[0]
        t = time.perf_counter()
        self.tiles = self.make_tiles()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t = harness.note("set-up: the reference's targets, this rank's rows", t)
        # The program.
        self.start = scene_from_numpy(self.prob["start"], device=self.device)
        self.cameras = [Camera(loc=self.locs[v], orient=self.ors[v]) for v in range(self.V)]
        self.config = harness.port_config(self.rc)
        self.opt = inverse.ClippedAdam(float(self.opt_cfg["lr"]), int(self.opt_cfg["decay_steps"]),
                                       float(self.opt_cfg["alpha"]), clip=self.opt_cfg.get("clip"))
        keys = tuple(self.opt_cfg["keys"])
        self.p0 = {k: v.detach().clone().float() for k, v in inverse.extract_params(self.start, keys).items()}
        self.state = self.opt.init(inverse.extract_params(self.start, keys))
        self.params = self.state.params
        moment = training.FirstMoment(self.state.adam, list(self.state.params))
        self.count = 0  # the steps taken
        first = int(tr["check_steps"])
        losses = [self.step() for _ in range(first)]
        self.observed = {"losses": [float(x) for x in losses], "g1": moment.g1, "p0": self.p0,
                         "p3": {k: v.detach().clone().float() for k, v in self.params.items()}}
        t = harness.note(f"set-up: the program's first {first} steps", t)
        self.step_s = self.timed(int(tr["warm_steps"]))
        harness.note(f"set-up: {tr['warm_steps']} steps timed, {self.step_s * 1e3:.3f} ms a step", t)

    # ------------------------------------------------------------ the targets

    def render(self, v: int, frames: torch.Tensor, row0: int, rows: int) -> torch.Tensor:
        """The plain reference's single-frame images of view v at `frames`
        over image rows [row0, row0+rows) → f32[B, rows, W, 3], in blocks of
        `target_rows` from row0: a rank's rows and the whole image split
        into the same blocks, so they agree to the bit."""
        step = int(self.cell.traffic["target_rows"])
        if row0 % step or rows % step:
            raise ValueError(f"target_rows {step} does not divide rows [{row0}, {row0 + rows})")
        sc = rf.scene_tables(self.prob["truth"], self.device)
        parts = []
        with torch.no_grad():
            for r in range(row0, row0 + rows, step):
                img = rf.fresh_image_planes(rf.frame_planes(sc, self.locs[v], self.ors[v], frames, self.rc, r, step),
                                            float(self.rc["brightness"]))
                parts.append(torch.stack(torch.broadcast_tensors(*img), dim=-1).float())
        return torch.cat(parts, dim=-3)

    def make_tiles(self) -> torch.Tensor:
        """This rank's rows of every target: f32[V, S, rows, W, 3]."""
        frames = torch.arange(self.base, self.base + self.S, device=self.device)
        return torch.stack([self.render(v, frames, self.row0, self.rows) for v in range(self.V)])

    def target(self, v: int, s: int) -> torch.Tensor:
        """The whole target of view v, realization s, for the reference."""
        return self.render(v, torch.tensor([self.base + s], device=self.device), 0, self.H)[0]

    # ------------------------------------------------------------ the program

    def pair(self, i: int) -> tuple:
        """(view, realization) of step i."""
        return i % self.V, i % self.S

    def step(self) -> torch.Tensor:
        """One step of the program on every rank → the loss over the whole
        image (a tensor on the card; nothing waits for it)."""
        v, s = self.pair(self.count)
        self.params, self.state, loss = self.shard.train_step_tiled(
            self.params, self.state, self.opt, self.start, self.cameras[v], self.tiles[v, s], self.base + s,
            self.config, self.mesh)
        self.count += 1
        return loss

    def sync(self) -> None:
        """Every rank reaches this point, with its card idle."""
        import torch.distributed as dist

        if self.mesh.size > 1:
            dist.barrier()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, n: int) -> float:
        """n steps after a barrier → rank 0's seconds a step."""
        self.sync()
        t = time.perf_counter()
        for _ in range(n):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return (time.perf_counter() - t) / max(n, 1)

    def window_steps(self, seconds: float) -> int:
        """The window's steps: rank 0's count that fills `seconds` at set-up's
        pace, the same on every rank."""
        import torch.distributed as dist

        n = torch.tensor([max(1, round(seconds / max(self.step_s, 1e-9)))], dtype=torch.int64,
                         device=self.device if self.device.type == "cuda" else "cpu")
        if self.mesh.size > 1:
            dist.broadcast(n, 0)
        return int(n.item())

    def window(self, seconds: float, trace_steps: int) -> dict:
        from kpt_bench import trace as tr_mod

        n = max(self.window_steps(seconds), trace_steps + 1)
        out = {}
        self.sync()
        t0 = time.perf_counter()
        if trace_steps:
            # Every rank traces the same steps, so that each pays the
            # profiler's cost and none waits on another for it alone.
            with tr_mod.profiled(self.device) as tr:
                for _ in range(trace_steps):
                    self.step()
            out.update(traced=tr, traced_steps=trace_steps)
        for _ in range(n - trace_steps - 1):
            self.step()
        # The window's last step, with the program's state kept on both
        # sides of it for the check.
        self.last_pair, self.count_before = self.pair(self.count), self.count
        self.before = training.snapshot(self.state)
        self.last_loss = self.step()
        self.after = training.snapshot(self.state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        out.update(steps=n, metrics={"shard_step_ms": elapsed * 1e3 / n})
        return out

    # ------------------------------------------------------------ the check

    def rank_param_gap(self) -> float:
        """max over the ranks and entries of |p - rank 0's p| (on every rank)."""
        import torch.distributed as dist

        flat = torch.cat([p.detach().reshape(-1).float() for p in self.params.values()])
        if self.mesh.size == 1:
            return 0.0
        ref = flat.clone()
        dist.broadcast(ref, 0)
        gap = (flat - ref).abs().nan_to_num(nan=float("inf")).max().reshape(1)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        return float(gap.item())

    def first_steps(self) -> list:
        """Set-up's first steps' rows for the reference: (frame, [view])."""
        steps = []
        for i in range(int(self.cell.traffic["check_steps"])):
            v, s = self.pair(i)
            steps.append((self.base + s, [(self.locs[v], self.ors[v], self.target(v, s), 0)]))
        return steps

    def reference(self, dtype=torch.float32, rows=None, scale: float = 1.0) -> dict:
        """The reference's first steps from the program's start."""
        return training.follow(self.prob["start"], self.p0, self.first_steps(), lambda p: self.rc, self.opt_cfg,
                               self.device, dtype, int(self.cell.traffic["block_rows"]), rows=rows, scale=scale)

    def window_observed(self) -> dict:
        return training.step_observed(self.before, self.after, [float(self.last_loss)])

    def window_reference(self, dtype=torch.float32, rows=None, scale: float = 1.0) -> dict:
        """The reference's step from the program's state before the window's
        last step."""
        b, (v, s) = self.before, self.last_pair
        step = [(self.base + s, [(self.locs[v], self.ors[v], self.target(v, s), 0)])]
        return training.follow(self.prob["start"], b["p"], step, lambda p: self.rc, self.opt_cfg, self.device, dtype,
                               int(self.cell.traffic["block_rows"]), moments=(b["m"], b["v"]),
                               count=self.count_before, rows=rows, scale=scale)

    def free(self) -> None:
        self.params = self.state = self.tiles = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        lim = self.cell.traffic["limits"]
        gap = self.rank_param_gap()
        self.free()
        if self.mesh.rank:
            # The reference runs on rank 0's card alone.
            return [harness.Check("rank_param_gap", gap, float(lim["rank_param_gap"]))]
        g = training.check_gaps(self)
        g["rank_param_gap"] = gap
        self._shaded = self.shaded()
        return [harness.Check(k, g[k], float(lim[k])) for k in CHECKS]

    def faults(self) -> dict:
        """The control and the faults that the reference stands in for, read
        against the float32 reference in the first steps and in the window's
        last step (kpt_bench/calibrate.py): the reference in bfloat16; one
        tile's loss and gradient alone, the exchange between the cards left
        out; half of the tiles left out, the mean taken over the rest. A tile
        is H over the cards the cell asks for. Rank 0 only."""
        if self.mesh.rank:
            return {}
        tile = self.H // int(self.cell.chips)
        sides = {"control": {"dtype": torch.bfloat16}, "one_tile": {"rows": (0, tile)},
                 "half_tiles": {"rows": (0, self.H // 2), "scale": 2.0}}
        return training.faults(self, {side: (kw, kw) for side, kw in sides.items()})

    def shaded(self) -> int:
        """Shaded pixels of this rank's rows at the start, the mean over the
        views (the steps cycle through them), from the reference."""
        sc = rf.scene_tables(self.prob["start"], self.device)
        step = int(self.cell.traffic["block_rows"])
        n = 0
        with torch.no_grad():
            for v in range(self.V):
                for r in range(self.row0, self.row0 + self.rows, step):
                    k = min(step, self.row0 + self.rows - r)
                    n += roofline.shaded_pixels(rf.frame_planes(sc, self.locs[v], self.ors[v], self.base, self.rc, r,
                                                                k)["oid"])
        return n // self.V

    def facts(self) -> dict:
        px = int(self.rc["width"]) * self.rows
        return {"tree": self.prob["start"], "rc": self.rc, "pixels": px, "shaded": getattr(self, "_shaded", px),
                "per_step": {"k1": 1, "k5": 1}}
