"""The ranks of a run on more than one card.

The process the driver started is rank 0. It starts ranks 1..n-1 as copies
of itself (the same command and arguments), each with the launch contract
of the program's parallel/multihost.py in its environment
(KPT_COORDINATOR on a free port of 127.0.0.1, KPT_NUM_PROCESSES,
KPT_PROCESS_ID) and, where the environment leaves it unset,
OMP_NUM_THREADS=1, as torchrun sets it for several processes on one host:
four ranks that each keep a thread per core of the host would contend for
its cores. Every rank joins the process group and runs the same body
(SPMD); only rank 0 reports. The other ranks write to standard error only
(their standard output is sent there) and exit 0, or 3 if they loaded a
banned module, which voids the run.

Rank 0 watches the others: if one exits non-zero, or they are not done
within `limit_s(seconds)` of their start, it kills them, prints no result
and exits EXIT_FAILED; it kills them too when its own body fails (a
`finally`). A rank whose rank 0 has gone ends itself. So no process
outlives a run.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time

EXIT_FAILED = 4
EXIT_BANNED = 3
# A run's ranks have to be done within START_S + PER_SECOND × its --seconds
# of their start: a cold build of the kernels in a fresh checkout (one
# nvcc run, ~40-90 s), the ranks' start and NCCL, the reference's targets,
# the set-up steps, the window and the check, with room to spare; a warm
# run takes well under half of it.
START_S = 600.0
PER_SECOND = 4.0
POLL_S = 0.25


def limit_s(seconds: float) -> float:
    return START_S + PER_SECOND * float(seconds)


def rank() -> int:
    """This process's rank: KPT_PROCESS_ID, 0 where unset."""
    return int(os.environ.get("KPT_PROCESS_ID", "0"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """Ranks 1..n-1, started by rank 0 with `cmd`, and the watchdog that
    ends the run when one of them fails or time runs out."""

    def __init__(self, cmd: list, n: int, limit: float, cwd=None):
        import torch

        os.environ.update(KPT_COORDINATOR=f"127.0.0.1:{free_port()}", KPT_NUM_PROCESSES=str(n),
                          KPT_PROCESS_ID="0")
        if "OMP_NUM_THREADS" not in os.environ:
            os.environ["OMP_NUM_THREADS"] = "1"
            torch.set_num_threads(1)  # rank 0's pool: torch read the variable at its import
        self.limit, self.procs = float(limit), []
        self._lock, self._done = threading.Lock(), False
        try:
            for r in range(1, n):
                # A session of its own, so that a kill reaches whatever the
                # rank started; its standard output goes to standard error.
                self.procs.append(subprocess.Popen(cmd, env=dict(os.environ, KPT_PROCESS_ID=str(r)), cwd=cwd,
                                                   stdin=subprocess.DEVNULL, stdout=2, start_new_session=True))
        except BaseException:
            self._kill()
            raise
        self.deadline = time.monotonic() + self.limit
        self._watch = threading.Thread(target=self._watchdog, name="kpt_bench.ranks", daemon=True)
        self._watch.start()

    def _watchdog(self) -> None:
        while True:
            time.sleep(POLL_S)
            for r, p in enumerate(self.procs, start=1):
                if p.poll() not in (None, 0):
                    self._fail(f"rank {r} exited with code {p.returncode}")
            if time.monotonic() > self.deadline:
                self._fail(f"the ranks were not done within {self.limit:.0f} s")
            with self._lock:
                if self._done:
                    return

    def _fail(self, why: str) -> None:
        """Kill the ranks and end this process without a result, unless rank
        0 is already past `wait`."""
        with self._lock:
            if self._done:
                return
            print(f"kpt_bench: {why}; no result", file=sys.stderr, flush=True)
            self._kill()
            os._exit(EXIT_FAILED)

    def wait(self) -> None:
        """Wait for ranks 1..n-1 to end; raise unless each exited 0. (The
        watchdog ends the run before this returns if one fails or time runs
        out.)"""
        for p in self.procs:
            p.wait()
        with self._lock:
            self._done = True
        bad = [(r, p.returncode) for r, p in enumerate(self.procs, start=1) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with {bad}")

    def stop(self) -> None:
        """Stop the watchdog, then kill every rank still running."""
        with self._lock:
            self._done = True
        self._kill()

    def _kill(self) -> None:
        """Kill every rank still running, with what it started, and reap it."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        for p in self.procs:
            p.wait()


def watch_parent() -> None:
    """On a rank other than 0: end this process when rank 0 has gone."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(POLL_S)
            if os.getppid() != parent:
                os._exit(EXIT_FAILED)

    threading.Thread(target=watch, name="kpt_bench.parent", daemon=True).start()


def finish() -> None:
    """Every rank, once its body is done: wait for the others, then leave
    the process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def run(n: int, cmd: list, limit: float, join, body, report, cwd=None) -> int:
    """This process's part of an n-rank run → its exit code. Rank 0 starts
    the others with `cmd`; every rank calls `join(rank)` (joining the
    process group), `body(rank)` and `finish()`; rank 0 then waits for the
    others and returns `report(body's result)`."""
    from kpt_bench import harness

    r = rank()
    if r:
        watch_parent()
        join(r)
        body(r)
        finish()
        bad = harness.banned_modules()
        if bad:
            print(f"kpt_bench: rank {r} loaded {bad}", file=sys.stderr, flush=True)
            return EXIT_BANNED
        return 0
    ranks = Ranks(cmd, n, limit, cwd)
    try:
        join(0)
        out = body(0)
        finish()
        ranks.wait()
    finally:
        ranks.stop()
    return report(out)
