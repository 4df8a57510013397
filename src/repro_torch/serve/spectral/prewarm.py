"""Startup pre-warm: every configured bucket runs once before "ready"
(counterpart of :mod:`repro.serve.spectral.prewarm`).

Two levels:

1. **Plan resolution** through :func:`repro_torch.core.plan.warm` (the
   shared "resolve these plans now or degrade" path): wisdom from
   ``$REPRO_TORCH_FFT_WISDOM`` has already auto-loaded tuned winners at
   import, so every bucket's (algo, backend, block_batch) is decided before
   the first request.  The ``serve.prewarm`` fault site fires per bucket
   inside ``warm``: an injected failure degrades that bucket to its torch
   twin instead of killing startup.
2. **First execution**: each bucket's dispatch function runs once on zeros
   of its fixed ``(max_batch, *shape)`` geometry and the device is
   synchronized, so no client request pays the first launch.  On the card
   this is also where a kernel library is built and loaded if it is not
   yet (:mod:`repro_torch.kernels._build`), and where the twiddle tables
   are copied to the device.  A failure degrades the bucket (torch twin,
   run again) rather than raising; if even the twin fails, the bucket is
   recorded as failed in the report and the runtime degrade path retries
   at first dispatch.  On the card only an injected fault degrades: a
   kernel that fails to build or launch raises, and the server does not
   start.

:func:`compile_states` returns a :class:`PrewarmReport` with per-bucket
seconds (``compile_s``, the reference's name) and degrade reasons.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

import repro_torch
from repro_torch.core import plan as plan_lib
from repro_torch.resilience.executor import recoverable

from .executor import BucketState, make_fn, zeros_input


@dataclasses.dataclass(frozen=True)
class PrewarmEntry:
    label: str
    backend: str                  # the backend that will actually serve
    algo: str
    block_batch: int
    max_batch: int
    tuned: bool
    degraded: bool
    reason: Optional[str]
    compile_s: float


@dataclasses.dataclass(frozen=True)
class PrewarmReport:
    entries: List[PrewarmEntry]
    wisdom_entries: int           # plans installed from the wisdom variable
    total_s: float

    @property
    def degraded(self) -> List[str]:
        return [e.label for e in self.entries if e.degraded]


def _run_once(state: BucketState, x, dev: torch.device) -> None:
    state.fn = make_fn(state)
    state.fn(x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def compile_states(states: Dict[str, BucketState], metrics=None,
                   device="cuda") -> PrewarmReport:
    """Run every bucket's dispatch function once on zeros on ``device``.

    Buckets whose plan resolution already degraded run their torch twin; a
    failure of a healthy cuda plan degrades it here, the same never-crash
    contract as :func:`repro_torch.core.plan.warm`.  On the card only an
    injected fault degrades (:func:`repro_torch.resilience.executor.
    recoverable`): a kernel that fails to build or launch at pre-warm
    raises, and the server does not start on its torch twin."""
    dev = repro_torch.device(device)
    t_start = time.perf_counter()
    entries = []
    for label, state in states.items():
        t0 = time.perf_counter()
        x = zeros_input(state.cfg, state.cfg.max_batch, dev)
        try:
            _run_once(state, x, dev)
        except Exception as e:      # noqa: BLE001 — degrade, never crash
            if not recoverable(e, dev.type == "cuda"):
                raise
            reason = f"{type(e).__name__}: {e}"
            try:
                cfg = state.cfg
                state.plan = plan_lib.get_plan(
                    cfg.shape, dtype=cfg.dtype, inverse=cfg.inverse,
                    kind=cfg.kind, backend="torch")
                state.degraded = True
                state.reason = reason
                _run_once(state, x, dev)
            except Exception as e2:  # noqa: BLE001 — still never crash
                # even the torch twin failed: record the bucket as failed
                # and keep starting up — the runtime degrade path retries
                # at first dispatch
                state.degraded = True
                state.reason = (f"{reason}; torch twin failed: "
                                f"{type(e2).__name__}: {e2}")
                state.fn = None
        compile_s = time.perf_counter() - t0
        entry = PrewarmEntry(
            label=label, backend=state.plan.backend, algo=state.plan.algo,
            block_batch=state.plan.block_batch,
            max_batch=state.cfg.max_batch, tuned=state.plan.tuned,
            degraded=state.degraded, reason=state.reason,
            compile_s=compile_s)
        entries.append(entry)
        if metrics is not None:
            metrics.annotate(label, plan_backend=state.plan.backend,
                             plan_algo=state.plan.algo,
                             block_batch=state.plan.block_batch,
                             max_batch=state.cfg.max_batch,
                             degraded=state.degraded,
                             degrade_reason=state.reason,
                             prewarm_compile_s=compile_s)
    return PrewarmReport(entries=entries,
                         wisdom_entries=plan_lib.WISDOM_AUTOLOADED,
                         total_s=time.perf_counter() - t_start)
