"""Multi-process launch of the sharded renderer and trainer.

Port of kylespathtracer_tpu/parallel/multihost.py. Every process runs the
same program; `initialize_from_env` joins them into one torch.distributed
process group, and the mesh and shard code (parallel.mesh, parallel.shard)
then spans them. Launch contract, read from the environment so the same
code runs under any scheduler:

    KPT_COORDINATOR   host:port of process 0          (required on >1 host)
    KPT_NUM_PROCESSES total process count             (required on >1 host)
    KPT_PROCESS_ID    this process's rank             (required on >1 host)

With none of them the process runs alone. (The JAX package's
KPT_MULTIHOST=auto, which lets `jax.distributed.initialize` read a TPU
pod's own environment, has no counterpart here: a torch.distributed group
is joined through the three variables above.) A 2-process CPU test lives
in tests/test_torch_multihost.py.

The backend follows the ranks' device: NCCL when each rank drives a card of
its own, gloo on the CPU. NCCL refuses two ranks on one card, so a caller
that puts several ranks on one card names gloo, whose collectives then pass
through host memory (parallel/mesh.py).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from kylespathtracer_tpu_torch import DEFAULT_DEVICE
from kylespathtracer_tpu_torch.parallel import mesh as mesh_mod


def initialize_from_env(device=DEFAULT_DEVICE, backend: str | None = None) -> bool:
    """Initialize the process group if the environment asks for it.

    Returns True when running multi-process (after initializing), False for
    the ordinary single-process case. Safe to call more than once. The
    backend is `backend`, or NCCL for a CUDA `device` and gloo for the
    CPU."""
    if dist.is_initialized():
        return True

    coord = os.environ.get("KPT_COORDINATOR")
    nproc = os.environ.get("KPT_NUM_PROCESSES")
    pid = os.environ.get("KPT_PROCESS_ID")
    if backend is None:
        backend = "gloo" if torch.device(device).type == "cpu" else "nccl"

    if coord is None and nproc is None:
        return False

    if not (coord and nproc and pid is not None):
        raise ValueError(
            "multi-host launch needs KPT_COORDINATOR, KPT_NUM_PROCESSES and "
            "KPT_PROCESS_ID (or none of them)"
        )
    if backend == "nccl":
        # NCCL binds a rank to the current card.
        torch.cuda.set_device(mesh_mod.local_device(int(pid)))
    dist.init_process_group(backend=backend, init_method=f"tcp://{coord}", world_size=int(nproc), rank=int(pid))
    return True


def process_info() -> dict:
    """Process topology for logs and metrics. Each rank drives one device,
    so the devices are the ranks."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": size,
        "local_devices": 1,
        "global_devices": size,
        "backend": dist.get_backend() if dist.is_initialized() else None,
    }


def global_mesh(device=None) -> mesh_mod.Mesh:
    """1-D "data" mesh over every rank (call after initialize_from_env)."""
    return mesh_mod.make_mesh(device)
