"""The sharded witness: the tiled renderer and trainer on n ranks against the
unsharded computation.

    python -m kylespathtracer_tpu_torch.dryrun [--ranks N] [--device cuda|cpu]

The port's counterpart of __graft_entry__.dryrun_multichip. `dryrun_multichip`
starts n processes of this module joined into one torch.distributed group
through the KPT_* launch contract (parallel/multihost.py): gloo on the CPU
or when the ranks share one card (NCCL refuses two ranks on one card),
NCCL when the machine has n cards. At the JAX dryrun's size (64 × 8n, 8
rows a rank) and on its two-sphere scenes, every rank checks, with the JAX
tolerances (atol 1e-4·max|ref|, 1e-3·max for images, rtol 1e-3):

  * the pass pipeline's `train_step_tiled` (the tile's loss and gradient,
    one all-reduce, the Adam update) against the unsharded loss, gradient
    and update (`inverse.train_step`'s): loss, the all-reduced gradient
    (which the JAX dryrun does not hold) and the updated parameters;
  * the pass pipeline's tiled forward frame (`render_frame_tiled`, halo
    exchange) against `render_frame`;
  * the fused temporal frame tiled over two moving frames (K1's row mode
    and K2's tile mode on the card), the fallback warning an error;
  * the fused tiled train step (K1 and K5 in row mode) against `train_step`.

The JAX dryrun's GSPMD train step (its check 1) has no counterpart: XLA
placed that path's collectives, and it is not ported. A rank that hangs
does not hang the caller: the ranks get `timeout` seconds, then are killed
and the call raises. `__graft_entry__.entry()` returns a jittable
single-chip frame function; that has no meaning in torch, and
chip_smoke.py fills its role.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from kylespathtracer_tpu_torch import DEFAULT_DEVICE

ROOT = Path(__file__).resolve().parents[1]
WIDTH = 64
ROWS_PER_RANK = 8
TIMEOUT_S = 600.0
KPT_ENV = ("KPT_COORDINATOR", "KPT_NUM_PROCESSES", "KPT_PROCESS_ID")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def backend_for(n: int, device: torch.device) -> str:
    """gloo on the CPU and for ranks that share a card; NCCL with a card per
    rank."""
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def dryrun_multichip(n: int, device=DEFAULT_DEVICE, timeout: float = TIMEOUT_S) -> dict:
    """Run the witness on `n` ranks of `device`'s type → rank 0's report
    (the checks and their largest errors, the kernels' launches per rank,
    the summary line, which it also prints). Raises if a check fails, a
    rank fails, or the ranks do not end within `timeout` seconds."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: needs a CUDA device")
        from kylespathtracer_tpu_torch.ops import _build

        _build.build()  # once here: the ranks only load it
    elif device.type != "cpu":
        raise ValueError(f"dryrun_multichip: unsupported device {device}")
    backend = backend_for(n, device)
    port = _free_port()
    threads = str(max(1, (os.cpu_count() or 1) // n))
    procs = []
    try:
        for rank in range(n):
            env = {k: v for k, v in os.environ.items() if k not in KPT_ENV}
            env.update(KPT_COORDINATOR=f"127.0.0.1:{port}", KPT_NUM_PROCESSES=str(n), KPT_PROCESS_ID=str(rank),
                       GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS=threads,
                       PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kylespathtracer_tpu_torch.dryrun", "--rank-worker", device.type, backend],
                env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        deadline = time.monotonic() + timeout
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0)) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        said = "\n".join(f"rank {r}: {out[-1500:]}\n{err[-1500:]}"
                         for r, (out, err) in enumerate(p.communicate() for p in procs))
        raise RuntimeError(f"dryrun_multichip: the {n} {backend} ranks did not end within {timeout} s:\n{said}") \
            from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun_multichip: rank {rank} failed ({p.returncode}):\n{out[-3000:]}\n"
                               f"{err[-3000:]}")
    line = next(ln for ln in outs[0][0].splitlines() if ln.startswith("DRYRUN "))
    report = json.loads(line[len("DRYRUN "):])
    print(report["summary"], flush=True)
    return report


class Checks:
    """check_close of the JAX dryrun, recording instead of raising: a rank
    that raised between two collectives would leave the others waiting."""

    def __init__(self):
        self.errors: list[tuple[str, float]] = []
        self.failed: list[str] = []

    def close(self, a, b, what: str, atol: float = 1e-4) -> None:
        a, b = (np.asarray(torch.as_tensor(x).detach().cpu()) for x in (a, b))
        scale = np.abs(a).max() + 1e-8
        err = float(np.abs(a - b).max())
        self.errors.append((what, err))
        if not np.allclose(a, b, atol=atol * scale, rtol=1e-3):
            self.failed.append(f"{what} mismatch: max abs err {err:.3e} vs scale {scale:.3e}")


def rank_worker(device_type: str, backend: str) -> int:
    """One rank: the checks of the module docstring; rank 0 prints its
    report as one line, DRYRUN <json>. Exits non-zero if a check failed."""
    from kylespathtracer_tpu_torch.diff import inverse
    from kylespathtracer_tpu_torch.ops import frame_grad as fg
    from kylespathtracer_tpu_torch.ops import frame_kernel as fk
    from kylespathtracer_tpu_torch.ops import reproject_kernel as rk
    from kylespathtracer_tpu_torch.parallel import mesh as mesh_mod
    from kylespathtracer_tpu_torch.parallel import multihost, shard
    from kylespathtracer_tpu_torch.render.camera import Camera
    from kylespathtracer_tpu_torch.render.pipeline import init_history, render_frame
    from kylespathtracer_tpu_torch.scene.scene import sphere_scene
    from kylespathtracer_tpu_torch.utils.config import RenderConfig

    if not multihost.initialize_from_env(device=device_type, backend=backend):
        raise SystemExit("dryrun rank: the environment asks for no process group")
    shared_card = device_type == "cuda" and backend != "nccl"
    mesh = multihost.global_mesh(device="cuda:0" if shared_card else None if device_type == "cuda" else "cpu")
    dev, n = mesh.device, mesh.size
    config = RenderConfig(width=WIDTH, height=ROWS_PER_RANK * n)
    rows = ROWS_PER_RANK
    r0 = mesh.rank * rows
    scene = sphere_scene([[0.0, 1.0, 6.0], [2.0, 1.0, 7.0]], [1.0, 0.8], [[0.6, 0.3, 0.2], [0.2, 0.5, 0.6]],
                         device=dev)
    camera = Camera.create(loc=(0.0, 2.0, 0.0), orient=(0.0, 0.0), device=dev)
    frame = 0
    # A real target (the ground-truth scene, unsharded) and a perturbed
    # start, so the loss and gradients are not trivial.
    target = inverse.render_once(scene, camera, config, frame)
    start = sphere_scene([[0.3, 1.1, 6.2], [1.8, 0.9, 6.8]], [0.9, 0.85], [[0.5, 0.4, 0.3], [0.3, 0.4, 0.5]],
                         device=dev)
    params = inverse.extract_params(start)
    # optax.adam(1e-2): a cosine decay with alpha 1 keeps the rate constant.
    opt = inverse.ClippedAdam(1e-2, 1, 1.0)
    checks = Checks()

    def train_checks(cfg, what: str) -> None:
        """The unsharded loss, gradient and Adam update (inverse.train_step's)
        against the tiles' all-reduced gradient and train_step_tiled."""
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        ref_loss = inverse.loss_fn(p, start, camera, target, frame, cfg)
        ref_grads = dict(zip(p, torch.autograd.grad(ref_loss, list(p.values()))))
        ref_params = opt.update(ref_grads, opt.init(params), params)
        if not torch.isfinite(ref_loss):
            checks.failed.append(f"{what}: non-finite reference loss {ref_loss.item()}")
        # Adam's first step moves each parameter by ~lr·sign(g), so the
        # update alone barely sees the gradient: hold the gradient too.
        _, grads = shard.tile_loss_and_grad(params, start, camera, target[r0:r0 + rows], frame, cfg, r0, rows)
        for k, g in zip(grads, mesh.all_reduce_sum(list(grads.values()))):
            checks.close(ref_grads[k], g, f"{what} grads[{k}]")
        t_params, _, t_loss = shard.train_step_tiled(params, opt.init(params), opt, start, camera,
                                                     target[r0:r0 + rows], frame, cfg, mesh)
        checks.close(ref_loss, t_loss, f"{what} loss")
        for k in params:
            checks.close(ref_params[k], t_params[k], f"{what} params[{k}]")

    def tiled_frames(cfg, cams: list):
        """render_frame and render_frame_tiled over `cams` (frames 0, 1, ...)
        from a zero history → (the unsharded image, the gathered tiles)."""
        hist = init_history(cfg, camera, device=dev)
        tiles = mesh_mod.shard_image_pytree(hist, mesh, cfg.height)
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message="fused tiled path")
            for i, cam in enumerate(cams):
                img, hist = render_frame(start, cam, hist, i, cfg)
                img_t, tiles = shard.render_frame_tiled(start, cam, tiles, i, cfg, mesh)
        return img, mesh_mod.gather_rows(img_t, mesh, rows)

    # The pass pipeline: the tiled train step, then the tiled forward frame.
    train_checks(config, "pass train_step_tiled")
    checks.close(*tiled_frames(config, [camera]), "tiled forward image", atol=1e-3)

    # The fused pipeline: the temporal frame over two moving frames, so the
    # second reprojects history across the tiles' edges, then the step.
    fconfig = dataclasses.replace(config, pipeline="fused")
    cam2 = Camera(loc=camera.loc + torch.tensor([0.01, -0.005, 0.01], device=dev),
                  orient=camera.orient + torch.tensor([0.002, -0.003], device=dev))
    fk.ROW_LAUNCHES = rk.TILE_LAUNCHES = fg.ROW_LAUNCHES = 0
    checks.close(*tiled_frames(fconfig, [camera, cam2]), "tiled fused temporal image", atol=1e-3)
    train_checks(fconfig, "fused train_step_tiled")
    launches = {"frame_forward (rows)": fk.ROW_LAUNCHES, "reproject_window (tile)": rk.TILE_LAUNCHES,
                "frame_backward (rows)": fg.ROW_LAUNCHES}
    if device_type == "cuda" and min(launches.values()) < 1:
        checks.failed.append(f"the fused tiles did not run through the row and tile kernels: {launches}")
    torch.distributed.destroy_process_group()

    worst = max(checks.errors, key=lambda c: c[1])
    summary = (
        f"dryrun_multichip {'FAILED' if checks.failed else 'OK'}: {n} ranks ({backend}, {dev}), "
        f"{len(checks.errors)} numeric checks across both pipelines — pipeline='pass' (train_step_tiled, tiled "
        f"forward) and pipeline='fused' (temporal_fusion='{fconfig.temporal_fusion}': tiled temporal frame over a "
        f"2-frame moving sequence, tiled train step with its all-reduce); the JAX dryrun's GSPMD train step has no "
        f"counterpart (not to be ported); worst |err| {worst[1]:.2e} ({worst[0]}); kernel launches on rank "
        f"{mesh.rank}: {launches}")
    if mesh.rank == 0:
        print("DRYRUN " + json.dumps({"ok": not checks.failed, "ranks": n, "backend": backend, "device": str(dev),
                                      "checks": checks.errors, "failed": checks.failed, "launches": launches,
                                      "summary": summary}), flush=True)
    if checks.failed:
        print("\n".join(checks.failed), file=sys.stderr, flush=True)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8, help="ranks to start (the image is 64 × 8·ranks)")
    ap.add_argument("--device", default=DEFAULT_DEVICE, help="cuda (default) or cpu")
    ap.add_argument("--rank-worker", nargs=2, metavar=("DEVICE_TYPE", "BACKEND"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_worker:
        return rank_worker(*args.rank_worker)
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
