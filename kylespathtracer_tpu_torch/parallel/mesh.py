"""The 1-D "data" mesh of the sharded renderer and trainer.

Port of kylespathtracer_tpu/parallel/mesh.py on torch.distributed. The JAX
package shards image rows over a `jax.sharding.Mesh` and XLA places the
collectives. Here every process is one rank of a torch.distributed process
group: it renders its own block of image rows on its own device (SPMD),
and parallel/shard.py calls the collectives itself. A `Mesh` names this
rank, the default process group's size and the rank's device.

Collectives on tensors of a CUDA device go through NCCL when the group's
backend is NCCL. Gloo has no send/recv, gather or all-gather for CUDA
tensors, so with gloo and a CUDA device (several ranks sharing one card)
the collectives here copy their tensors to host memory, exchange them
there and copy the result back (`Mesh.staged`); the rendering stays on the
card.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    rank: int
    size: int
    device: torch.device

    @property
    def staged(self) -> bool:
        """Whether collectives pass through host memory: a CUDA device under
        a backend other than NCCL (gloo)."""
        return self.size > 1 and self.device.type == "cuda" and dist.get_backend() != "nccl"

    def stage(self, t: torch.Tensor) -> torch.Tensor:
        """`t` where the collectives can take it: a host copy when they are
        staged, else `t` itself."""
        return t.cpu() if self.staged else t

    def all_reduce_sum(self, tensors: list) -> list:
        """The elementwise sums over the ranks of `tensors` (one f32
        all-reduce of them packed), each on its own device."""
        if self.size == 1:
            return list(tensors)
        flat = self.stage(torch.cat([t.detach().reshape(-1).float() for t in tensors]))
        dist.all_reduce(flat)
        out, pos = [], 0
        for t in tensors:
            out.append(flat[pos:pos + t.numel()].reshape(t.shape).to(t.device, t.dtype))
            pos += t.numel()
        return out


def local_device(rank: int) -> torch.device:
    """The card of a rank: `cuda:<rank modulo the cards visible>`."""
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def make_mesh(device=None) -> Mesh:
    """1-D data mesh over the ranks of the default process group (a single
    rank when torch.distributed is not initialized). `device` is this
    rank's device: `local_device(rank)` by default, "cpu" when asked."""
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    device = local_device(rank) if device is None else torch.device(device)
    return Mesh(rank=rank, size=size, device=device)


def _tree_map(fn, tree):
    """fn over the tensors of a tree of dataclasses, dicts, lists and
    tuples; other leaves stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def shard_image_pytree(tree, mesh: Mesh, height: int):
    """This rank's rows of every tensor whose leading dim is `height` (image
    rows [rank·h, (rank+1)·h), h = height / size), on the mesh's device;
    the other leaves (cameras, scalars) stay as they are."""
    if height % mesh.size:
        raise ValueError(f"height {height} does not divide over {mesh.size} ranks")
    rows = height // mesh.size
    row0 = mesh.rank * rows

    def place(x):
        if x.ndim >= 1 and x.shape[0] == height:
            return x[row0:row0 + rows].to(mesh.device)
        return x

    return _tree_map(place, tree)


def gather_rows(tree, mesh: Mesh, rows: int):
    """The whole image on every rank: each tensor whose leading dim is
    `rows` (this rank's rows) becomes the ranks' rows stacked in rank
    order, on the mesh's device; the other leaves stay as they are."""
    def gather(x):
        if mesh.size == 1 or x.ndim < 1 or x.shape[0] != rows:
            return x
        src = mesh.stage(x.contiguous())
        parts = [torch.empty_like(src) for _ in range(mesh.size)]
        dist.all_gather(parts, src)
        return torch.cat(parts).to(mesh.device)

    return _tree_map(gather, tree)
