"""Checkpoint / resume.

Port of kylespathtracer_tpu/utils/checkpoint.py, on `torch.save` in place of
Orbax (the file format differs). A state is nested dicts, lists and tuples
of tensors and numbers; the port's dataclasses (`History`, `Camera`,
`Channel`, `ControllerState`) are saved as dicts of their fields, and an
object with `state_dict()` (`diff.inverse.AdamState`, a torch optimizer) as
its state dict. Files are read with `torch.load(weights_only=True)`, so a
checkpoint never unpickles an object. Each step is one file,
`directory/step_{step}`, written under a temporary name and moved into
place, so a kill during the write leaves no `step_{step}`.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import torch


def as_tree(state):
    """`state` as it is saved: nested dicts, lists and tuples of tensors and
    numbers."""
    if isinstance(state, torch.Tensor):
        return state.detach()
    if hasattr(state, "state_dict"):
        return as_tree(state.state_dict())
    if dataclasses.is_dataclass(state):
        return {f.name: as_tree(getattr(state, f.name)) for f in dataclasses.fields(state)}
    if isinstance(state, dict):
        return {k: as_tree(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(as_tree(v) for v in state)
    return state


def _rebuild(tree, like):
    """`tree` in the structure of `like`: tensors on the device of `like`'s,
    dataclasses rebuilt, an object with `load_state_dict` loaded in place."""
    if like is None:
        return tree
    if isinstance(like, torch.Tensor):
        return tree.to(like.device)
    if hasattr(like, "load_state_dict"):
        like.load_state_dict(tree)
        return like
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild(tree[f.name], getattr(like, f.name)) for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _rebuild(v, like.get(k)) for k, v in tree.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, l) for v, l in zip(tree, like))
    return tree


def save(directory, step: int, state) -> str:
    """Serialize `state` under `directory/step_{step}`; returns the path."""
    root = Path(directory).resolve()
    root.mkdir(parents=True, exist_ok=True)
    path = root / f"step_{step}"
    tmp = root / f".step_{step}.{os.getpid()}.tmp"
    torch.save(as_tree(state), tmp)
    os.replace(tmp, path)
    return str(path)


def steps(directory) -> list[int]:
    """The steps saved under `directory`, ascending."""
    root = Path(directory)
    return sorted(int(p.name.split("_", 1)[1]) for p in root.glob("step_*")
                  if p.name.split("_", 1)[1].isdigit())


def restore(directory, step: int | None = None, like=None):
    """Restore `(step, state)`; the newest step if not given. Without `like`
    the state is the saved tree on the CPU; with `like` (a state of the
    expected structure) it is rebuilt onto `like`'s devices, and an object
    in `like` with `load_state_dict` (an `AdamState` from `opt.init`) is
    loaded in place."""
    root = Path(directory).resolve()
    if step is None:
        saved = steps(root)
        if not saved:
            raise FileNotFoundError(f"no checkpoints under {root}")
        step = saved[-1]
    tree = torch.load(root / f"step_{step}", map_location="cpu", weights_only=True)
    return step, _rebuild(tree, like)
