"""Inverse rendering as a user runs it: a closed loop of optimizer steps.

The problem of the recovery recipe (scenes.recovery_problem): a
ground-truth scene of N spheres, a perturbed start, V cameras on an arc.
The benchmark renders the seed-paired targets with its own plain
reference, S realizations a view at frames seed_base + s, and hands them to
the program's `diff/inverse.fit` with one `ClippedAdam` across every call,
as `run_recovery` would. On the card each step is one fused
loss-and-gradient kernel (K6) per view, the views' gradients averaged,
then the optimizer. The window runs one β phase steadily, `chunk_steps`
steps a `fit` call.

Check (kinds/training.py): the reference follows the first three steps,
which set-up takes through `fit`; and it follows the window's last `fit`
call, one step, from the program's state just before it (its parameters
and Adam's moments, read through `AdamState.state_dict()`, the
checkpoint's interface): the step's loss, the gradient as the optimizer got
it (the change of Adam's first moment over 1 - β1) and the update.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kpt_bench import harness, roofline, scenes
from kpt_bench.kinds import Kind
from kpt_bench.kinds import training
from kpt_bench.reference import frame as rf


CHECKS = ("loss_gap", "grad_gap", "step_gap", "window_loss_gap", "window_grad_gap", "window_step_gap")


def phase_steps(steps: int, n_phases: int) -> list:
    """run_recovery's steps per β phase: weighted toward the sharp phases."""
    w = np.linspace(1.0, 1.6, n_phases)
    return [max(1, int(steps * wi / w.sum())) for wi in w]


class Loop(Kind):
    @classmethod
    def tiny(cls, cell) -> None:
        cell.config["optimizer"] = dict(cell.config["optimizer"], realizations=2)
        cell.traffic.update(chunk_steps=2)

    def __init__(self, cell, seed: int, device):
        from kylespathtracer_tpu_torch.diff import inverse
        from kylespathtracer_tpu_torch.render.camera import Camera
        from kylespathtracer_tpu_torch.scene.types import scene_from_numpy

        self.cell, self.device, self.inv = cell, torch.device(device), inverse
        cfg, tr = cell.config, cell.traffic
        self.opt_cfg = dict(cfg["optimizer"])
        sc = cfg["scene"]
        self.prob = scenes.recovery_problem(int(sc["num_spheres"]), int(sc["views"]), int(sc["layout_seed"]), seed,
                                            float(sc["perturb"]))
        betas = [float(b) for b in self.opt_cfg["betas"]]
        self.phases = [betas.index(float(tr["beta"]))]
        self.steps_of = phase_steps(int(self.opt_cfg["steps"]), len(betas))
        self.opt_cfg["decay_steps"] = sum(self.steps_of)
        self.rc = {p: dict(cell.render, width=tr["width"], height=tr["height"], soft_shadows=betas[p])
                   for p in self.phases}
        self.S, self.base = int(self.opt_cfg["realizations"]), int(self.opt_cfg["seed_base"])
        self.locs = torch.as_tensor(self.prob["cam_loc"], device=self.device)
        self.ors = torch.as_tensor(self.prob["cam_orient"], device=self.device)
        self.V = self.locs.shape[0]
        t = time.perf_counter()
        self.targets = self.make_targets()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t = harness.note("set-up: the reference's targets", t)
        # The program.
        self.start = scene_from_numpy(self.prob["start"], device=self.device)
        self.cameras = Camera(loc=self.locs, orient=self.ors)
        self.configs = {p: harness.port_config(self.rc[p]) for p in self.phases}
        self.opt = inverse.ClippedAdam(float(self.opt_cfg["lr"]), int(self.opt_cfg["decay_steps"]),
                                       float(self.opt_cfg["alpha"]), clip=self.opt_cfg.get("clip"))
        self.keys = tuple(self.opt_cfg["keys"])
        self.p0 = {k: v.detach().clone().float() for k, v in inverse.extract_params(self.start, self.keys).items()}
        self.state = self.opt.init(inverse.extract_params(self.start, self.keys))
        moment = training.FirstMoment(self.state.adam, list(self.state.params))
        first = int(cell.traffic["check_steps"])
        self.scene, losses, self.state = inverse.fit(
            self.start, self.targets[self.phases[0]], self.cameras, self.configs[self.phases[0]],
            keys=self.keys, steps=first, opt=self.opt, opt_state=self.state, return_state=True)
        self.observed = {"losses": losses, "g1": moment.g1, "p0": self.p0,
                         "p3": {k: v.detach().clone().float() for k, v in self.state.params.items()}}
        harness.note(f"set-up: the program's first {first} steps", t)
        self.count = first  # the optimizer's steps so far

    def make_targets(self) -> dict:
        """{phase: f32[V, S, H, W, 3]} rendered by the plain reference from the
        ground truth, realization s at frame seed_base + s."""
        sc = rf.scene_tables(self.prob["truth"], self.device)
        frames = torch.arange(self.base, self.base + self.S, device=self.device)
        rows = int(self.cell.traffic["target_rows"])
        return {p: torch.stack([rf.fresh_image(sc, self.locs[v], self.ors[v], frames, self.rc[p], rows)
                                for v in range(self.V)]) for p in self.phases}

    def run_fit(self, steps: int) -> list:
        p = self.phases[0]
        self.scene, losses, self.state = self.inv.fit(
            self.scene, self.targets[p], self.cameras, self.configs[p], keys=self.keys, steps=steps,
            opt=self.opt, opt_state=self.state, return_state=True)
        self.count += steps
        return losses

    def window(self, seconds: float, trace_steps: int) -> dict:
        from kpt_bench import trace as tr_mod

        out, n, chunk = {}, 0, int(self.cell.traffic["chunk_steps"])
        t0 = time.perf_counter()
        if trace_steps:
            with tr_mod.profiled(self.device) as traced:
                self.run_fit(min(chunk, trace_steps))
            n += min(chunk, trace_steps)
            out.update(traced=traced, traced_steps=min(chunk, trace_steps))
        while time.perf_counter() - t0 < seconds:
            self.run_fit(chunk)
            n += chunk
        # The window's last call, one step, with the program's state kept on
        # both sides of it for the check.
        self.before, self.count_before = training.snapshot(self.state), self.count
        self.last_loss = self.run_fit(1)
        self.after = training.snapshot(self.state)
        n += 1
        out.update(steps=n, metrics={"step_ms": (time.perf_counter() - t0) * 1e3 / n})
        return out

    def first_steps(self) -> list:
        """The first steps' rows for the reference: (frame, views)."""
        p = self.phases[0]
        return [(self.base + s % self.S, [(self.locs[v], self.ors[v], self.targets[p][v, s % self.S], p)
                                          for v in range(self.V)])
                for s in range(int(self.cell.traffic["check_steps"]))]

    def reference(self, dtype=torch.float32, steps=None) -> dict:
        """The reference's first steps (`steps`, the first steps' rows, by
        default) from the program's start."""
        return training.follow(self.prob["start"], self.p0, steps or self.first_steps(), lambda p: self.rc[p],
                               self.opt_cfg, self.device, dtype, int(self.cell.traffic["block_rows"]))

    def last_step(self) -> list:
        """The window's last step's rows: a one-step `fit` call pairs
        realization 0 with frame seed_base."""
        p = self.phases[0]
        return [(self.base, [(self.locs[v], self.ors[v], self.targets[p][v, 0], p) for v in range(self.V)])]

    def window_observed(self) -> dict:
        return training.step_observed(self.before, self.after, self.last_loss)

    def window_reference(self, dtype=torch.float32, steps=None) -> dict:
        """The reference's step from the program's state before the window's
        last call (`steps`: that step's rows by default)."""
        b = self.before
        return training.follow(self.prob["start"], b["p"], steps or self.last_step(), lambda p: self.rc[p],
                               self.opt_cfg, self.device, dtype, int(self.cell.traffic["block_rows"]),
                               moments=(b["m"], b["v"]), count=self.count_before)

    def shaded(self) -> int:
        """Shaded pixels of the first view at the start, from the reference."""
        p = self.phases[0]
        sc = rf.scene_tables(self.prob["start"], self.device)
        rc = self.rc[p]
        n = 0
        with torch.no_grad():
            for r0 in range(0, int(rc["height"]), int(self.cell.traffic["block_rows"])):
                rows = min(int(self.cell.traffic["block_rows"]), int(rc["height"]) - r0)
                n += roofline.shaded_pixels(rf.frame_planes(sc, self.locs[0], self.ors[0], self.base, rc, r0,
                                                            rows)["oid"])
        return n

    def free(self) -> None:
        self.scene = self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        self.free()
        g = training.check_gaps(self)
        self._shaded = self.shaded()
        lim = self.cell.traffic["limits"]
        return [harness.Check(k, g[k], float(lim[k])) for k in CHECKS]

    def faults(self) -> dict:
        """The control and the fault that the reference stands in for, read
        against the float32 reference (kpt_bench/calibrate.py): the reference
        in bfloat16; half of the views left out, the mean taken over the
        rest."""
        half = lambda steps: [(f, views[: (len(views) + 1) // 2]) for f, views in steps]
        bf16 = {"dtype": torch.bfloat16}
        return training.faults(self, {"control": (bf16, bf16),
                                      "half_views": ({"steps": half(self.first_steps())},
                                                     {"steps": half(self.last_step())})})

    def facts(self) -> dict:
        rc = self.rc[self.phases[0]]
        px = int(rc["width"]) * int(rc["height"])
        return {"tree": self.prob["start"], "rc": rc, "pixels": px, "shaded": getattr(self, "_shaded", px),
                "per_step": {"k6": self.V}}
