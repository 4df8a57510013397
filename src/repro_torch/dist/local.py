"""One ``torch.distributed`` group of processes on this host.

The reference tests its distributed layer on emulated devices inside one
process; the port runs real ranks.  :class:`LocalGroup` spawns ``world``
processes that join one group (``FileStore`` rendezvous in a temporary
directory, so concurrent groups never collide on a port) and then run the
jobs sent to them::

    with LocalGroup(4, backend="gloo", device="cpu") as group:
        outs = group.run(fn, *args)   # fn(*args) on every rank, in step

``fn`` must be importable by module path (it is pickled by reference, as
are its arguments and results).  A rank that raises or dies, or a job
that does not finish within twice ``timeout_s``, fails the call: the
group is closed and the error names every rank's traceback.  Every process the group starts
is stopped by :meth:`LocalGroup.close` (or leaving the ``with`` block).
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class RankFailed(RuntimeError):
    """A rank of a :class:`LocalGroup` raised, died or timed out."""


def _worker(rank, world, store_path, backend, device, threads, timeout_s,
            jobs, results):
    torch.set_num_threads(threads)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception:  # noqa: BLE001 — reported to the parent, which fails
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            fn, args, kwargs = job
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except Exception:  # noqa: BLE001 — reported, the call fails
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class LocalGroup:
    """``world`` spawned ranks of one process group on this host.

    ``backend`` is ``"gloo"`` or ``"nccl"``; ``device`` is ``"cpu"`` or
    ``"cuda"`` (rank r on ``cuda:<r % device_count>``).  ``threads`` caps
    each rank's intra-op threads.  ``timeout_s`` bounds each job and each
    collective inside it.
    """

    def __init__(self, world: int, *, backend: str = "gloo",
                 device: str = "cpu", threads: int = 1,
                 timeout_s: float = 120.0):
        self.world, self.backend, self.device = world, backend, device
        self.timeout_s = timeout_s
        self._dir = tempfile.TemporaryDirectory(prefix="repro_torch_group_")
        ctx = mp.get_context("spawn")
        self._jobs = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        store = os.path.join(self._dir.name, "store")
        self._procs = [ctx.Process(
            target=_worker, daemon=True,
            args=(r, world, store, backend, device, threads, timeout_s,
                  self._jobs[r], self._results)) for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; the results in rank
        order.  Raises :class:`RankFailed` (and closes the group) when a
        rank raises, dies or passes the timeout."""
        if not self._procs:
            raise RankFailed("the group is closed")
        for q in self._jobs:
            q.put((fn, args, kwargs))
        out, errors, pending = [None] * self.world, [], self.world
        # a rank whose peer failed waits out its collective's timeout
        deadline = time.monotonic() + 2 * self.timeout_s
        while pending:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                codes = {r: p.exitcode for r, p in enumerate(self._procs)
                         if not p.is_alive()}
                if codes:
                    errors.append((None, f"ranks died (exit codes {codes})"))
                    break
                if time.monotonic() > deadline:
                    if not errors:
                        errors.append((None, "no result after "
                                       f"{2 * self.timeout_s:g}s"))
                    break
                continue
            pending -= 1
            if ok:
                out[rank] = value
            else:
                errors.append((rank, value))
                # its peers may wait in a collective it never joined: give
                # them a few seconds to report, not the whole timeout
                deadline = min(deadline, time.monotonic() + 5.0)
        if errors:
            self.close()
            raise RankFailed(f"{getattr(fn, '__name__', fn)} failed:\n"
                             + "\n".join(f"-- rank {r}:\n{tb}"
                                         for r, tb in errors))
        return out

    def close(self) -> None:
        """Stop every rank (a clean exit, then a kill after 10 s)."""
        for p, q in zip(self._procs, self._jobs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
        self._procs = []
        self._dir.cleanup()

    def __enter__(self) -> "LocalGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
