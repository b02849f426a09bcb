"""The check of a training loop: the reference follows its first three steps,
and a step of the window from the program's state before it.

Set-up drives the program's optimizer state from the seed through its
first steps, on rows (views and sample seeds) that all differ, and hands
that same state to the window. The reference repeats the three steps in
plain PyTorch from the same start: each step's loss and gradient by
autograd through the plain frame (reference/frame.py), then the clipped,
cosine-decayed Adam of reference/adam.py. Compared, each by the worst
leaf, a leaf being one row of a parameter table (a sphere, a material):

  loss_gap    max over the steps of |loss - loss_ref| / loss_ref
  grad_gap    the first gradient as the optimizer got it (its first moment
              after one step, over 1 - β1), the gap between the norms of
              program and reference, over the larger of the reference's
              norm of that row and of the median row
  step_gap    the same for the parameters' change over the three steps;
              rows whose reference gradient is under a thousandth of the
              median row's are left out (Adam moves them by round-off)

The same three numbers, of one step that follows the program's parameters
and Adam's moments (`follow`'s `moments`), are the window's step's.
"""

from __future__ import annotations

import torch

from kpt_bench.reference import adam as ref_adam
from kpt_bench.reference import frame as rf

BETA1 = ref_adam.BETA1


def rows(d: dict) -> dict:
    """{(key, row): tensor} over the rows of each table."""
    return {(k, i): d[k][i] for k in sorted(d) for i in range(d[k].shape[0])}


def norm_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over the rows in `keep` (all by default) of |‖p‖ - ‖r‖| / max(‖r‖,
    the median row's ‖r‖)."""
    rp, rr = rows(prog), rows(ref)
    keys = [k for k in rr if keep is None or k in keep]
    rn = {k: float(rr[k].float().norm()) for k in keys}
    med = float(torch.tensor(list(rn.values())).median())
    return max(abs(float(rp[k].float().norm()) - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def moving_rows(g1: dict) -> set:
    """Rows whose reference gradient is at least a thousandth of the median
    row's."""
    rn = {k: float(v.float().norm()) for k, v in rows(g1).items()}
    med = float(torch.tensor(list(rn.values())).median())
    return {k for k, v in rn.items() if v >= 1e-3 * med}


def follow(tree: dict, params0: dict, steps: list, rc_of, opt_cfg: dict, device, dtype=torch.float32,
           block_rows: int = 270, moments=None, count: int = 0, rows=None, scale: float = 1.0) -> dict:
    """The reference's steps from `params0` → {"losses", "g1", "p0", "p3"}
    in the program's form ("g1": the first step's clipped gradient, "p3":
    the parameters after the last). `steps` lists, per step, the frame and
    the views as (cam_loc, cam_orient, target, phase); `rc_of(phase)` gives
    the render knobs. `moments` (Adam's first and second, by key) and
    `count` (the steps taken) resume the optimizer from a state; a fresh
    one by default. With dtype=bfloat16 this is the control. `rows` (image
    rows [start, stop)) and `scale` stand the reference in for a program
    that loses rows: each view's loss and gradient over those rows alone,
    times `scale`."""
    # The optimizer keeps float32 in the control too: the control lowers the
    # precision of the frame, the loss and the gradient.
    opt = ref_adam.Adam({k: v.float() for k, v in params0.items()}, float(opt_cfg["lr"]),
                        int(opt_cfg["decay_steps"]), float(opt_cfg["alpha"]), opt_cfg.get("clip"))
    if moments is not None:
        opt.resume(*moments, count)
    losses = []
    for frame, views in steps:
        total, grads = 0.0, {k: torch.zeros_like(v, dtype=torch.float32) for k, v in opt.params.items()}
        for loc, orient, target, phase in views:
            sc = rf.scene_tables(tree, device, dtype, grad_keys=tuple(opt.params), params=opt.params)
            lval, g = rf.mse_loss_and_grad(sc, loc.to(dtype), orient.to(dtype), frame, rc_of(phase),
                                           target.to(dtype), block_rows, rows)
            total += float(lval) * scale
            for k in grads:
                grads[k] += g[k] * scale
        n = len(views)
        losses.append(total / n)
        opt.update({k: (v / n) for k, v in grads.items()})
    return {"losses": losses, "g1": {k: v.float() for k, v in opt.first_grad.items()},
            "p0": {k: v.float() for k, v in params0.items()}, "p3": {k: v.float() for k, v in opt.params.items()}}


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers compared, between the program's readings `prog` and
    the reference's `ref` (both as `follow` returns them)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    dp = {k: prog["p3"][k] - prog["p0"][k] for k in ref["p0"]}
    dr = {k: ref["p3"][k] - ref["p0"][k] for k in ref["p0"]}
    return {"loss_gap": loss, "grad_gap": norm_gap(prog["g1"], ref["g1"]),
            "step_gap": norm_gap(dp, dr, keep=moving_rows(ref["g1"]))}


def snapshot(state) -> dict:
    """The program's parameters and Adam's moments, by key, through
    `AdamState.state_dict()` (Adam's state is keyed by the parameters'
    order)."""
    sd = state.state_dict()
    adam = sd["adam"]["state"]
    keys = list(sd["params"])
    return {"p": {k: sd["params"][k].detach().float().clone() for k in keys},
            "m": {k: adam[i]["exp_avg"].detach().float().clone() for i, k in enumerate(keys)},
            "v": {k: adam[i]["exp_avg_sq"].detach().float().clone() for i, k in enumerate(keys)}}


def step_observed(before: dict, after: dict, losses: list) -> dict:
    """One step of the program in the form of `follow`, from the snapshots
    on both sides of it: its loss, the gradient Adam got (the first moment's
    change over 1 - β1), the parameters before and after."""
    g = {k: (after["m"][k] - BETA1 * before["m"][k]) / (1.0 - BETA1) for k in before["m"]}
    return {"losses": losses, "g1": g, "p0": before["p"], "p3": after["p"]}


def check_gaps(kind) -> dict:
    """A training loop's six numbers: its first steps' against
    `kind.reference()`, its window's last step's (`window_`) against
    `kind.window_reference()`."""
    g = gaps(kind.observed, kind.reference())
    g.update({f"window_{k}": v for k, v in gaps(kind.window_observed(), kind.window_reference()).items()})
    return g


def faults(kind, sides: dict) -> dict:
    """{side: its six numbers}, each side the reference put in the program's
    place: `sides` gives, by side, the arguments of `kind.reference` and of
    `kind.window_reference`, read against both at float32."""
    ref, wref = kind.reference(), kind.window_reference()
    return {side: {**gaps(kind.reference(**first), ref),
                   **{f"window_{k}": v for k, v in gaps(kind.window_reference(**last), wref).items()}}
            for side, (first, last) in sides.items()}


class FirstMoment:
    """Keeps the first gradient a torch Adam got: its first moment after the
    first step over (1 - β1), read by an optimizer step hook."""

    def __init__(self, adam: torch.optim.Optimizer, names: list):
        self.g1 = None
        self._names = names
        self._handle = adam.register_step_post_hook(self._hook)

    def _hook(self, opt, args, kwargs):
        if self.g1 is None:
            ps = [p for group in opt.param_groups for p in group["params"]]
            b1 = opt.param_groups[0]["betas"][0]
            self.g1 = {n: (opt.state[p]["exp_avg"] / (1.0 - b1)).detach().float().clone()
                       for n, p in zip(self._names, ps)}
            self._handle.remove()
