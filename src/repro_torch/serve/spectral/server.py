"""The spectral server: admission → shape buckets → pipelined executor
(counterpart of :mod:`repro.serve.spectral.server`).

:class:`SpectralServer` composes the subsystem on ``device`` (default
``"cuda"``; tests pass ``device="cpu"``, where the kernel wrappers run their
plain versions):

- :class:`~repro_torch.serve.spectral.scheduler.ShapeBucketScheduler` admits
  ragged requests into plan-registry shape buckets (reject or pad-up,
  deadlines, priority aging, bounded queue backpressure);
- :func:`repro_torch.core.plan.warm` resolves every bucket's plan up
  front (wisdom-aware, degrade-to-torch on failure — the ``serve.prewarm``
  fault site lives inside it);
- :mod:`~repro_torch.serve.spectral.prewarm` runs each bucket's
  fixed-shape dispatch function once before the server reports ready
  (skippable with ``prewarm=False`` to measure cold starts);
- :class:`~repro_torch.serve.spectral.executor.PipelinedExecutor` runs
  staging/dispatch/drain, threaded (production) or inline (deterministic
  tests);
- :class:`~repro_torch.serve.spectral.metrics.Metrics` snapshots it all as
  JSON.

Request lifecycle: ``submit`` → queued → in-flight → exactly one terminal
record (completed / timed_out_queued / timed_out_inflight / error), never
more, never none — ``drain()`` + ``close()`` guarantee zero orphans on
shutdown.  ``result(rid)`` blocks until that terminal record exists, then
consumes it (records are evicted once read — no per-request leak).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

import repro_torch
from repro_torch.core import plan as plan_lib
from repro_torch.core.complexmath import SplitComplex
from repro_torch.resilience import executor as _rexec

from . import prewarm as prewarm_mod
from .executor import BucketState, PipelinedExecutor, derive_max_batch
from .metrics import Metrics, start_http
from .scheduler import (BucketConfig, NoBucketError, Request,
                        ShapeBucketScheduler)

TERMINAL = ("completed", "timed_out_queued", "timed_out_inflight", "error")


@dataclasses.dataclass
class RequestRecord:
    """One request's terminal state."""
    rid: object
    status: str                   # one of TERMINAL
    value: object = None          # SplitComplex / ndarray (host) when
    #                               completed
    bucket: Optional[str] = None
    padded: bool = False
    latency_s: float = 0.0        # admission -> terminal, on server clock
    error: Optional[BaseException] = None


class SpectralServer:
    def __init__(self, buckets, *, unmatched: str = "reject",
                 max_queue: int = 1024, aging_rate: float = 1.0,
                 depth: int = 2, threaded: bool = True, prewarm: bool = True,
                 tune: bool = False, tune_batch: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda"):
        self.device = repro_torch.device(device)
        self.metrics = Metrics()
        self._clock = clock
        self._lock = threading.Lock()
        self._records: Dict[object, RequestRecord] = {}
        self._done: Dict[object, threading.Event] = {}
        self._outstanding = 0
        self._accepting = True
        self._httpd = None

        # resolve every bucket's plan through the shared warm-or-degrade
        # path (one bulk call; serve.prewarm faults fire per key inside;
        # tuning measures on the serving device)
        buckets = [b if isinstance(b, BucketConfig) else BucketConfig(*b)
                   for b in buckets]
        specs = [b.plan_spec() for b in buckets]
        if tune:
            for b, s in zip(buckets, specs):
                s["tune_batch"] = tune_batch or derive_max_batch(
                    b, plan_lib.get_plan(b.shape, dtype=b.dtype,
                                         kind=b.kind, inverse=b.inverse,
                                         backend="torch"))
        results = plan_lib.warm(specs, tune=tune, device=self.device)
        self.states: Dict[str, BucketState] = {}
        resolved = []
        for b, wr in zip(buckets, results):
            cfg = dataclasses.replace(b,
                                      max_batch=derive_max_batch(b, wr.plan))
            state = BucketState(cfg=cfg, plan=wr.plan,
                                requested_backend=wr.requested_backend,
                                degraded=wr.degraded, reason=wr.reason)
            self.states[cfg.label] = state
            resolved.append(cfg)
            self.metrics.annotate(
                cfg.label, plan_backend=wr.plan.backend,
                plan_algo=wr.plan.algo, block_batch=wr.plan.block_batch,
                max_batch=cfg.max_batch, degraded=wr.degraded,
                degrade_reason=wr.reason,
                demote_reason=wr.plan.demote_reason)

        self.scheduler = ShapeBucketScheduler(
            resolved, unmatched=unmatched, max_queue=max_queue,
            aging_rate=aging_rate, clock=clock,
            on_timeout=self._queued_timeout)
        self.executor = PipelinedExecutor(
            self.states, self.scheduler, self.metrics, self._finish,
            depth=depth, threaded=threaded, clock=clock,
            device=self.device)

        self.prewarm_report = None
        if prewarm:
            self.prewarm_report = prewarm_mod.compile_states(
                self.states, metrics=self.metrics, device=self.device)
        self.ready = True
        self.executor.start()

    # -- introspection -------------------------------------------------------

    @property
    def degraded_buckets(self):
        return sorted(lbl for lbl, s in self.states.items() if s.degraded)

    def snapshot(self) -> dict:
        """Metrics snapshot + kernel-path health: each cuda bucket's
        guarded-executor counters (attempts/failures/fallbacks) ride along
        under ``resilience``."""
        snap = self.metrics.snapshot()
        for lbl, state in self.states.items():
            if state.requested_backend != "cuda":
                continue
            key = plan_lib._plan_key(state.cfg.shape, state.cfg.dtype,
                                     state.cfg.inverse, "cuda",
                                     state.cfg.kind)
            snap["buckets"].setdefault(lbl, {})["resilience"] = \
                _rexec.stats(key)
        snap["pending"] = self.scheduler.pending()
        snap["degraded_buckets"] = self.degraded_buckets
        return snap

    def metrics_json(self) -> str:
        import json
        return json.dumps(self.snapshot(), indent=2, sort_keys=True,
                          default=str)

    def serve_metrics_http(self, port: int = 0) -> int:
        """Expose ``GET /metrics`` on a daemon thread; returns the port."""
        self._httpd, port = start_http(self.metrics, port)
        return port

    # -- request lifecycle ---------------------------------------------------

    def submit(self, rid, payload, *, kind: str = "c2c",
               inverse: bool = False, deadline_s: Optional[float] = None,
               priority: float = 0.0) -> bool:
        """Admit one request.  Returns False under backpressure (queue
        bound hit — nothing recorded, retry later); raises
        :class:`NoBucketError` when no bucket serves the shape (the
        ``rejected_nobucket`` counter still ticks); True on admission."""
        if not self._accepting:
            return False
        shape = self._payload_shape(payload, kind, inverse)
        req = Request(rid=rid, payload=payload, kind=kind, inverse=inverse,
                      shape=shape, priority=priority)
        if deadline_s is not None:
            req.deadline = self._clock() + deadline_s
        # the done-event must exist BEFORE admission: a running executor
        # thread may complete the request the instant it is enqueued
        with self._lock:
            if rid in self._done:
                raise ValueError(f"duplicate request id {rid!r}")
            self._done[rid] = threading.Event()
            self._outstanding += 1
        try:
            admitted = self.scheduler.admit(req)
        except NoBucketError:
            with self._lock:
                del self._done[rid]
                self._outstanding -= 1
            self.metrics.inc("_unmatched", "rejected_nobucket")
            raise
        if not admitted:
            with self._lock:
                del self._done[rid]
                self._outstanding -= 1
            self.metrics.inc(req.bucket_label or "_unmatched",
                             "rejected_backpressure")
            return False
        lbl = req.bucket_label
        self.metrics.inc(lbl, "admitted")
        if req.padded:
            self.metrics.inc(lbl, "padded_up")
        self.metrics.sample(lbl, "queue_depth", self.scheduler.pending())
        self.executor.poke()
        return True

    @staticmethod
    def _payload_shape(payload, kind: str, inverse: bool):
        if isinstance(payload, SplitComplex):
            arr_shape = payload.shape
        elif isinstance(payload, torch.Tensor):
            if kind == "rfft" and not inverse and payload.is_complex():
                raise ValueError("rfft forward requests take real payloads")
            arr_shape = tuple(payload.shape)
        else:
            arr = np.asarray(payload)
            if kind == "rfft" and not inverse and np.iscomplexobj(arr):
                raise ValueError("rfft forward requests take real payloads")
            arr_shape = arr.shape
        if len(arr_shape) not in (1, 2):
            raise ValueError(f"requests are single 1-D or 2-D transforms "
                             f"(no batch dims), got payload shape "
                             f"{tuple(arr_shape)}")
        shape = tuple(int(d) for d in arr_shape)
        if kind == "rfft" and inverse:
            # payload is the (h, w/2+1) half spectrum; the transform
            # shape is the real-output shape the bucket is keyed on
            shape = shape[:-1] + (2 * (shape[-1] - 1),)
        return shape

    def _finish(self, req: Request, status: str, value, now: float) -> None:
        rec = RequestRecord(
            rid=req.rid, status=status,
            value=value if status == "completed" else None,
            bucket=req.bucket_label, padded=req.padded,
            latency_s=now - req.t_submit,
            error=value if status == "error" else None)
        with self._lock:
            self._records[req.rid] = rec
            self._outstanding -= 1
            ev = self._done.get(req.rid)
        if ev is not None:
            ev.set()

    def _queued_timeout(self, req: Request) -> None:
        self.metrics.inc(req.bucket_label, "timed_out_queued")
        self.metrics.observe(req.bucket_label, "e2e",
                             self._clock() - req.t_submit)
        self._finish(req, "timed_out_queued", None, self._clock())

    def result(self, rid, timeout: Optional[float] = None
               ) -> Optional[RequestRecord]:
        """Block until ``rid`` reaches a terminal state; its record (None
        on wall-clock timeout — the request itself is still in flight).

        Returning the terminal record *consumes* it: the server evicts the
        bookkeeping (a long-lived server would otherwise leak one record —
        potentially a full result array — plus an Event per request), and
        the rid becomes reusable for a fresh submit."""
        with self._lock:
            ev = self._done.get(rid)
        if ev is None:
            raise KeyError(f"unknown request id {rid!r}")
        if not ev.wait(timeout):
            return None
        with self._lock:
            self._done.pop(rid, None)
            return self._records.pop(rid)

    def _n_outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    # -- shutdown ------------------------------------------------------------

    def drain(self, timeout_s: Optional[float] = 60.0) -> bool:
        """Complete every admitted request (terminal records for all)."""
        return self.executor.run_pending(self._n_outstanding, timeout_s)

    def close(self, timeout_s: Optional[float] = 60.0) -> bool:
        """Drain-on-shutdown: stop admission, complete all admitted work,
        then stop the pipeline threads.  Returns False if the drain timed
        out (threads are stopped regardless)."""
        self._accepting = False
        ok = self.drain(timeout_s)
        self.executor.shutdown()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        return ok

    def __enter__(self) -> "SpectralServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
