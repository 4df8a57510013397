"""Shape-bucket continuous batching: admission, queueing, batch selection
(counterpart of :mod:`repro.serve.spectral.scheduler`).

Requests arrive ragged — any (kind, shape, direction) mix — and are
admitted into **buckets**, one per plan-registry key.  A bucket is the
serving-side face of a :class:`repro_torch.core.plan.FFTPlan`: its shape
fixes the batch geometry (batch padded to ``max_batch``, so every dispatch
of a bucket launches the same kernels at the same shapes) and the plan's
``block_batch`` sizes ``max_batch`` when none is given, so the scheduler's
admission decision IS the plan-registry dispatch decision.

Admission policy for a request matching no configured bucket:

- ``unmatched="reject"`` (default): raise :class:`NoBucketError` — the
  caller sees the rejection synchronously, nothing is queued.
- ``unmatched="pad_up"``: zero-pad the transform dims up to the smallest
  bucket that fits (forward transforms only — zero-padding is the standard
  spectral-interpolation semantic; an inverse half-spectrum has no such
  reading and still rejects).  The client receives the bucket-shape
  spectrum; ``Request.padded`` and the ``padded_up`` counter record it.

Queueing is priority-with-aging: a request's effective priority is
``priority + aging_rate * wait_seconds``, so old low-priority work
eventually outranks fresh high-priority work (no starvation).  For a fixed
``aging_rate`` the pairwise order of two queued requests never flips over
time, so each bucket keeps a heap on the time-invariant key
``priority - aging_rate * t_submit``; cross-bucket selection compares head
scores at "now".  Deadlines expire lazily: every :meth:`next_batch` sweep
retires queued requests past their deadline through the ``on_timeout``
callback before selecting, so a dead request never occupies a batch slot.

The clock is injectable (tests drive a fake clock through admission,
aging, and expiry deterministically).

Thread safety: in threaded serving, client threads call :meth:`admit`
while the staging thread calls :meth:`next_batch` — an internal lock
guards every queue/counter mutation (the expiry sweep's rebuild-and-heapify
would otherwise silently drop a concurrently pushed request, orphaning
it).  ``on_timeout`` callbacks fire *outside* the lock so they may safely
re-enter the scheduler or take the server's own lock.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.plan import PLAN_KINDS


class NoBucketError(ValueError):
    """No configured bucket can serve this request's (kind, shape)."""


@dataclasses.dataclass(frozen=True)
class BucketConfig:
    """One serving shape bucket == one plan-registry key.

    ``max_batch`` is the dispatch batch size (requests per dispatch, padded
    up to exactly this).  ``None`` derives it from the resolved plan's
    ``block_batch`` at server construction (at least 8, rounded up to a
    block_batch multiple)."""
    shape: Tuple[int, ...]
    kind: str = "c2c"                 # "c2c" | "rfft"
    inverse: bool = False
    dtype: str = "float32"
    backend: str = "cuda"
    max_batch: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "shape",
                           tuple(int(d) for d in self.shape))
        if self.kind not in PLAN_KINDS:
            raise ValueError(f"kind must be one of {PLAN_KINDS}, "
                             f"got {self.kind!r}")
        if len(self.shape) not in (1, 2):
            raise ValueError(f"1-D or 2-D buckets only, got {self.shape}")

    @property
    def label(self) -> str:
        d = "i" if self.inverse else "f"
        return f"{self.kind}/{d}/{'x'.join(map(str, self.shape))}"

    def plan_spec(self) -> dict:
        """The :func:`repro_torch.core.plan.warm` key spec for this
        bucket."""
        return {"shape": self.shape, "dtype": self.dtype, "kind": self.kind,
                "inverse": self.inverse, "backend": self.backend}


@dataclasses.dataclass
class Request:
    """One admitted transform request (host-side payload)."""
    rid: object
    payload: object                   # np ndarray / SplitComplex of ndarrays
    kind: str = "c2c"
    inverse: bool = False
    shape: Tuple[int, ...] = ()       # the payload's *transform* shape
    priority: float = 0.0
    deadline: Optional[float] = None  # absolute, on the scheduler clock
    t_submit: float = 0.0
    bucket_label: Optional[str] = None
    padded: bool = False
    seq: int = 0                      # admission order (FIFO tie-break)

    def score(self, now: float, aging_rate: float) -> float:
        return self.priority + aging_rate * (now - self.t_submit)


class ShapeBucketScheduler:
    """Admit ragged requests into shape buckets; hand out dispatch batches.

    ``on_timeout(request)`` fires for every queued request retired by a
    deadline sweep (the server completes it as ``timed_out_queued``).
    ``max_queue`` bounds total queued requests across buckets — admission
    past it returns ``False`` (backpressure; nothing is enqueued).
    """

    def __init__(self, buckets, *, unmatched: str = "reject",
                 max_queue: int = 1024, aging_rate: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_timeout: Optional[Callable[[Request], None]] = None):
        if unmatched not in ("reject", "pad_up"):
            raise ValueError(f'unmatched must be "reject" or "pad_up", '
                             f"got {unmatched!r}")
        self.buckets: Dict[str, BucketConfig] = {}
        for b in buckets:
            if b.label in self.buckets:
                raise ValueError(f"duplicate bucket {b.label}")
            if b.max_batch is not None and b.max_batch < 1:
                raise ValueError(f"max_batch must be >= 1, got "
                                 f"{b.max_batch} for {b.label}")
            self.buckets[b.label] = b
        self.unmatched = unmatched
        self.max_queue = max_queue
        self.aging_rate = aging_rate
        self._clock = clock
        self._on_timeout = on_timeout
        self._queues: Dict[str, List[tuple]] = {lbl: []
                                                for lbl in self.buckets}
        self._pending = 0
        self._seq = 0
        # guards _queues/_pending/_seq against admit()-vs-next_batch()
        # races in threaded serving (see module docstring)
        self._mutex = threading.Lock()

    # -- admission -----------------------------------------------------------

    def match(self, kind: str, shape, inverse: bool = False
              ) -> Tuple[Optional[BucketConfig], bool]:
        """(bucket, padded) serving this request shape; (None, False) when
        nothing matches under the configured policy."""
        shape = tuple(int(d) for d in shape)
        for b in self.buckets.values():
            if (b.kind, b.inverse, b.shape) == (kind, inverse, shape):
                return b, False
        if self.unmatched != "pad_up" or inverse:
            return None, False
        fits = [b for b in self.buckets.values()
                if b.kind == kind and not b.inverse
                and len(b.shape) == len(shape)
                and all(bd >= rd for bd, rd in zip(b.shape, shape))]
        if not fits:
            return None, False
        best = min(fits, key=lambda b: (_numel(b.shape), b.shape))
        return best, True

    def admit(self, req: Request) -> bool:
        """Enqueue ``req`` into its bucket.  Raises :class:`NoBucketError`
        when no bucket serves its shape; returns False (backpressure) when
        the global queue bound is hit; True on admission."""
        bucket, padded = self.match(req.kind, req.shape, req.inverse)
        if bucket is None:
            raise NoBucketError(
                f"no bucket serves kind={req.kind!r} shape={req.shape} "
                f"inverse={req.inverse} (policy={self.unmatched!r}; "
                f"configured: {sorted(self.buckets)})")
        req.bucket_label = bucket.label
        req.padded = padded
        with self._mutex:
            if self._pending >= self.max_queue:
                return False
            req.t_submit = self._clock()
            self._seq += 1
            req.seq = self._seq
            # time-invariant heap key: see module docstring
            key = (-(req.priority - self.aging_rate * req.t_submit),
                   req.seq)
            heapq.heappush(self._queues[bucket.label], (key, req))
            self._pending += 1
        return True

    # -- dispatch ------------------------------------------------------------

    def _sweep_expired_locked(self, now: float) -> List[Request]:
        """Retire queued past-deadline requests; the expired list (the
        caller fires ``on_timeout`` after releasing the lock)."""
        expired: List[Request] = []
        for q in self._queues.values():
            live = []
            for key, req in q:
                if req.deadline is not None and now >= req.deadline:
                    self._pending -= 1
                    expired.append(req)
                else:
                    live.append((key, req))
            if len(live) != len(q):
                q[:] = live
                heapq.heapify(q)
        return expired

    def next_batch(self) -> Optional[Tuple[BucketConfig, List[Request]]]:
        """Retire expired queued requests, then dequeue up to ``max_batch``
        requests from the bucket whose head scores highest right now.
        None when nothing is queued."""
        now = self._clock()
        sel = None
        with self._mutex:
            expired = self._sweep_expired_locked(now)
            best_lbl, best_rank = None, None
            for lbl, q in self._queues.items():
                if not q:
                    continue
                head = q[0][1]
                rank = (head.score(now, self.aging_rate), -head.t_submit,
                        -head.seq)
                if best_rank is None or rank > best_rank:
                    best_lbl, best_rank = lbl, rank
            if best_lbl is not None:
                bucket = self.buckets[best_lbl]
                cap = bucket.max_batch or 8
                q = self._queues[best_lbl]
                out = []
                while q and len(out) < cap:
                    out.append(heapq.heappop(q)[1])
                self._pending -= len(out)
                sel = (bucket, out)
        # outside the lock: the server's callback takes its own lock and
        # may re-enter the scheduler (metrics read queue depths)
        if self._on_timeout is not None:
            for req in expired:
                self._on_timeout(req)
        return sel

    def pending(self) -> int:
        with self._mutex:
            return self._pending

    def queue_depths(self) -> Dict[str, int]:
        with self._mutex:
            return {lbl: len(q) for lbl, q in self._queues.items()}


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
