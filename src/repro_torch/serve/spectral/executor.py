"""Async host<->device pipelining: staging -> dispatch -> drain
(counterpart of :mod:`repro.serve.spectral.executor`).

Three stages, double-buffered through bounded queues, so device dispatch
never waits on host-side batch assembly:

1. **Staging** (host): pull a batch from the scheduler, stack/pad payloads
   into the bucket's fixed ``(max_batch, *shape)`` geometry in pinned host
   memory, and copy the planes to the card on a side stream
   (``non_blocking``), recording an event when they have landed.  Runs on
   the :class:`repro_torch.data.pipeline.Prefetcher` thread with ``depth``
   in-flight batches (2 = double buffering), so backpressure propagates
   from the device up to admission.
2. **Dispatch**: consult the ``serve.step`` fault site, then run the
   bucket's plan on the compute stream, which first waits on the staging
   event (the input tensors are marked as used by the compute stream, so
   the allocator cannot hand their memory back to staging early).  Kernel
   launches are asynchronous, so this thread records a done event and hands
   the in-flight batch straight to the drain queue.
3. **Drain** (host): synchronize on the done event, copy the live rows'
   results back as numpy, check in-flight deadlines, and complete each
   request.

Every batch is padded to the bucket's ``max_batch``, so each dispatch of a
bucket launches the same kernels at the same shapes (occupancy is visible
in the ``batch_occupancy`` gauge).  The dispatch function is the plan's raw
``_execute``, without the per-call guard, as the reference's jitted
dispatch runs; a dispatch failure degrades the bucket to its torch twin
plan (once) and retries, mirroring the pre-warm degrade semantics.  On
the card only an injected fault degrades: a kernel that fails to build
or launch raises.

PyTorch's current stream is per thread: the staging and compute streams
are the executor's own, entered with ``torch.cuda.stream`` in each stage.
On the CPU there are no streams and the stages run the same code without
events.

``threaded=False`` runs the identical stage functions inline through
:meth:`PipelinedExecutor.step`, deterministic for the scheduler edge-case
tests (injectable clocks, fault sites).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import repro_torch
from repro_torch.core import plan as plan_lib
from repro_torch.core.complexmath import SplitComplex
from repro_torch.data.pipeline import Prefetcher
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.executor import on_card, recoverable

from .scheduler import BucketConfig, Request, ShapeBucketScheduler


@dataclasses.dataclass
class BucketState:
    """A bucket plus its resolved plan and dispatch function."""
    cfg: BucketConfig                  # max_batch resolved (never None)
    plan: plan_lib.FFTPlan
    requested_backend: str
    fn: Optional[Callable] = None      # built at pre-warm or first use
    degraded: bool = False
    reason: Optional[str] = None

    @property
    def label(self) -> str:
        return self.cfg.label


def derive_max_batch(cfg: BucketConfig, plan: plan_lib.FFTPlan) -> int:
    """The dispatch batch size: the configured ``max_batch``, or at least 8
    rounded up to a multiple of the plan's ``block_batch``."""
    if cfg.max_batch is not None:
        return cfg.max_batch
    bb = max(1, plan.block_batch)
    return ((max(8, bb) + bb - 1) // bb) * bb


def make_fn(state: BucketState) -> Callable:
    """The bucket's dispatch function: the plan's raw execution."""
    plan = state.plan
    return lambda x, p=plan: p._execute(x)


def _input_shape(cfg: BucketConfig) -> tuple:
    if cfg.kind == "rfft" and cfg.inverse:
        return cfg.shape[:-1] + (cfg.shape[-1] // 2 + 1,)
    return cfg.shape


def _input_is_complex(cfg: BucketConfig) -> bool:
    return cfg.kind == "c2c" or (cfg.kind == "rfft" and cfg.inverse)


def zeros_input(cfg: BucketConfig, max_batch: int, device="cuda"):
    """A zero input of the bucket's batch geometry on ``device`` (the
    pre-warm run)."""
    dev = repro_torch.device(device)
    shape = (max_batch,) + _input_shape(cfg)
    dt = getattr(torch, cfg.dtype)
    if _input_is_complex(cfg):
        return SplitComplex(torch.zeros(shape, dtype=dt, device=dev),
                            torch.zeros(shape, dtype=dt, device=dev))
    return torch.zeros(shape, dtype=dt, device=dev)


def _host(a) -> np.ndarray:
    """A payload or result plane as a host numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def _payload_planes(req: Request) -> List[np.ndarray]:
    """The host-side planes of a request payload: [re, im] for complex
    inputs, [x] for real ones."""
    p = req.payload
    if isinstance(p, SplitComplex):
        return [_host(p.re), _host(p.im)]
    arr = _host(p)
    if np.iscomplexobj(arr):
        return [np.ascontiguousarray(arr.real),
                np.ascontiguousarray(arr.imag)]
    return [arr]


def _tensors(x) -> tuple:
    return (x.re, x.im) if isinstance(x, SplitComplex) else (x,)


@dataclasses.dataclass
class Assembled:
    """One staged batch: device-resident input planes + its requests."""
    state: BucketState
    requests: List[Request]
    x: object                          # SplitComplex or tensor (device)
    t_staged: float = 0.0
    ready: Optional[object] = None     # torch.cuda.Event: planes landed


class PipelinedExecutor:
    """Drive scheduler batches through staging/dispatch/drain on
    ``device``.

    ``complete(req, status, value, t_done)`` is the server's completion
    callback (status: "completed" | "timed_out_inflight" | "error"); the
    executor never touches result bookkeeping itself.
    """

    def __init__(self, states: Dict[str, BucketState],
                 scheduler: ShapeBucketScheduler, metrics, complete,
                 *, depth: int = 2, threaded: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda"):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.states = states
        self.scheduler = scheduler
        self.metrics = metrics
        self.device = repro_torch.device(device)
        self._complete = complete
        self._depth = depth
        self._threaded = threaded
        self._clock = clock
        self._stop = False
        self._work = threading.Event()    # pokes the staging loop
        self._threads: List[threading.Thread] = []
        self._prefetch: Optional[Prefetcher] = None
        self._drainq: Optional[queue.Queue] = None
        on_card = self.device.type == "cuda"
        self._h2d = torch.cuda.Stream(self.device) if on_card else None
        self._compute = torch.cuda.Stream(self.device) if on_card else None

    # -- stage functions (shared by threaded and inline modes) ---------------

    def _assemble(self, bucket: BucketConfig,
                  reqs: List[Request]) -> Assembled:
        state = self.states[bucket.label]
        B = state.cfg.max_batch
        dt = getattr(torch, bucket.dtype)
        host_dt = torch.float32 if dt == torch.bfloat16 else dt
        shape = _input_shape(bucket)
        nplanes = 2 if _input_is_complex(bucket) else 1
        pin = self._h2d is not None
        host = [torch.zeros((B,) + shape, dtype=host_dt, pin_memory=pin)
                for _ in range(nplanes)]
        planes = [h.numpy() for h in host]
        for i, req in enumerate(reqs):
            src = _payload_planes(req)
            if len(src) < nplanes:            # real payload into a c2c slot
                src = src + [np.zeros_like(src[0])]
            for plane, s in zip(planes, src):
                # pad-to-bucket: a padded-up request lands in the leading
                # corner, zeros elsewhere (spectral interpolation)
                region = tuple(slice(0, d) for d in s.shape)
                plane[(i,) + region] = s
        ready = None
        if self._h2d is None:
            dev = [h.to(dt) for h in host]
        else:
            with torch.cuda.stream(self._h2d):
                dev = [h.to(self.device, dt, non_blocking=True)
                       for h in host]
                ready = torch.cuda.Event()
                ready.record(self._h2d)
        x = SplitComplex(*dev) if nplanes == 2 else dev[0]
        occupancy = len(reqs) / B
        self.metrics.inc(bucket.label, "batches")
        self.metrics.inc(bucket.label, "batch_items", len(reqs))
        self.metrics.inc(bucket.label, "batch_pad_slots", B - len(reqs))
        self.metrics.sample(bucket.label, "batch_occupancy", occupancy)
        now = self._clock()
        for req in reqs:
            self.metrics.observe(bucket.label, "queue", now - req.t_submit)
        return Assembled(state=state, requests=reqs, x=x, t_staged=now,
                         ready=ready)

    def _call_with_degrade(self, state: BucketState, x):
        """Dispatch on the bucket's plan; one failure degrades the bucket
        to its torch twin (registry lookup) and retries — the runtime
        mirror of the pre-warm degrade path.  On the card only an injected
        fault degrades (:func:`repro_torch.resilience.executor.
        recoverable`): a kernel that fails to build or launch raises."""
        if state.fn is None:
            state.fn = make_fn(state)
        try:
            return state.fn(x)
        except Exception as e:      # noqa: BLE001 — resilience boundary
            if (state.plan.backend == "torch"
                    or not recoverable(e, on_card(x))):
                raise               # nothing (allowed) to degrade to
            cfg = state.cfg
            state.plan = plan_lib.get_plan(
                cfg.shape, dtype=cfg.dtype, inverse=cfg.inverse,
                kind=cfg.kind, backend="torch")
            state.degraded = True
            state.reason = f"{type(e).__name__}: {e}"
            state.fn = make_fn(state)
            self.metrics.annotate(state.label, degraded=True,
                                  degrade_reason=state.reason)
            return state.fn(x)

    def _dispatch(self, asm: Assembled):
        """Run one staged batch; returns ``(y, done)`` where ``done`` is the
        compute stream's event after the batch (None on the CPU)."""
        _faults.check("serve.step", tag=asm.state.label)
        if self._compute is None:
            return self._call_with_degrade(asm.state, asm.x), None
        with torch.cuda.stream(self._compute):
            if asm.ready is not None:
                self._compute.wait_event(asm.ready)
            for t in _tensors(asm.x):
                t.record_stream(self._compute)
            y = self._call_with_degrade(asm.state, asm.x)
            done = torch.cuda.Event()
            done.record(self._compute)
        return y, done

    def _drain(self, asm: Assembled, y, done=None) -> None:
        if done is not None:
            done.synchronize()
        # copy back only the n live rows: the pad slots stay on the device
        n = len(asm.requests)
        if isinstance(y, SplitComplex):
            planes = [_host(y.re[:n]), _host(y.im[:n])]
            results = [SplitComplex(planes[0][i], planes[1][i])
                       for i in range(n)]
        else:
            host = _host(y[:n])
            results = [host[i] for i in range(n)]
        now = self._clock()
        lbl = asm.state.label
        fallback = asm.state.plan.backend != asm.state.requested_backend
        for req, val in zip(asm.requests, results):
            self.metrics.observe(lbl, "service", now - asm.t_staged)
            self.metrics.observe(lbl, "e2e", now - req.t_submit)
            if req.deadline is not None and now >= req.deadline:
                self.metrics.inc(lbl, "timed_out_inflight")
                self._complete(req, "timed_out_inflight", None, now)
                continue
            self.metrics.inc(lbl, "completed")
            if fallback:
                self.metrics.inc(lbl, "fallback_served")
            self._complete(req, "completed", val, now)

    # -- inline mode ---------------------------------------------------------

    def step(self) -> bool:
        """Run one batch through all three stages inline; False when the
        scheduler had nothing to hand out."""
        sel = self.scheduler.next_batch()
        if sel is None:
            return False
        asm = self._assemble(*sel)
        y, done = self._dispatch(asm)
        self._drain(asm, y, done)
        return True

    # -- threaded mode -------------------------------------------------------

    def _staged_batches(self):
        """Generator the staging Prefetcher thread consumes: blocks until
        the scheduler has work, yields assembled (device-resident)
        batches."""
        while not self._stop:
            sel = self.scheduler.next_batch()
            if sel is None:
                self._work.wait(timeout=0.005)
                self._work.clear()
                continue
            bucket, reqs = sel
            try:
                asm = self._assemble(bucket, reqs)
            except Exception as e:  # noqa: BLE001 — resilience boundary
                # assembly failed after the batch left the scheduler: the
                # requests must still terminate (exactly-one-terminal
                # guarantee), and staging must survive to serve the rest
                now = self._clock()
                for req in reqs:
                    self._complete(req, "error", e, now)
                continue
            yield asm

    def _dispatch_loop(self) -> None:
        try:
            for asm in self._prefetch:
                try:
                    y, done = self._dispatch(asm)
                except Exception as e:  # noqa: BLE001 — to drain
                    y, done = e, None
                self._drainq.put((asm, y, done))
        except Exception as e:  # noqa: BLE001 — staging died
            self.metrics.annotate(
                "_pipeline", staging_error=f"{type(e).__name__}: {e}")
        finally:
            # unconditional: a staging error the Prefetcher re-raises at
            # next() must still release the drain loop, or every queued
            # request orphans and shutdown() hangs on the joins
            self._drainq.put(None)

    def _drain_loop(self) -> None:
        while True:
            item = self._drainq.get()
            if item is None:
                return
            asm, y, done = item
            if isinstance(y, BaseException):
                # dispatch raised even after degrade: requests must still
                # terminate — nobody may wait forever on a crashed batch
                now = self._clock()
                for req in asm.requests:
                    self._complete(req, "error", y, now)
                continue
            self._drain(asm, y, done)

    def start(self) -> None:
        if not self._threaded or self._threads:
            return
        self._drainq = queue.Queue(maxsize=self._depth)
        self._prefetch = Prefetcher(self._staged_batches(),
                                    depth=self._depth)
        t_disp = threading.Thread(target=self._dispatch_loop, daemon=True,
                                  name="repro-torch-serve-dispatch")
        t_drain = threading.Thread(target=self._drain_loop, daemon=True,
                                   name="repro-torch-serve-drain")
        self._threads = [t_disp, t_drain]
        for t in self._threads:
            t.start()

    def poke(self) -> None:
        """Wake the staging loop (the server calls this on admission)."""
        self._work.set()

    def run_pending(self, outstanding: Callable[[], int],
                    timeout_s: Optional[float] = None) -> bool:
        """Drive until ``outstanding()`` hits zero.  Inline mode pumps
        :meth:`step`; threaded mode waits on the pipeline.  Returns False
        on timeout."""
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        while outstanding() > 0:
            if deadline is not None and time.monotonic() > deadline:
                return False
            if self._threaded:
                self.poke()
                time.sleep(0.002)
            else:
                if not self.step() and outstanding() > 0:
                    # nothing schedulable but work still outstanding can
                    # only mean a sweep retired it concurrently — re-check
                    if self.scheduler.pending() == 0 and outstanding() > 0:
                        return False
        return True

    def shutdown(self) -> None:
        """Stop the stage threads.  The stop flag ends the staging
        generator, which ends the Prefetcher (DONE), which ends the
        dispatch loop (drain sentinel), which ends the drain loop —
        already-staged batches still flow through and complete, so a
        shutdown can never orphan admitted work."""
        self._stop = True
        self._work.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
