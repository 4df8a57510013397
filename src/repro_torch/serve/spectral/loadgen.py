"""Load generation against a :class:`SpectralServer` (counterpart of
:mod:`repro.serve.spectral.loadgen`).

Two canonical disciplines:

- **Closed loop** (:func:`closed_loop`): a fixed window of outstanding
  requests; each completion immediately triggers the next submission.
  Measures *capacity* — sustained throughput at a given concurrency —
  which is what a batched-vs-serial A/B gates on.
- **Open loop** (:func:`open_loop`): seeded Poisson arrivals at an
  *offered* QPS, submitted on the wall clock regardless of completions —
  the regime a real front door sees, where queueing delay shows up in
  p99 instead of silently throttling the generator (the closed-loop
  coordinated-omission blind spot).

Both draw requests from a seeded shape ``mix`` (ragged by construction)
and report achieved throughput plus p50/p99 latency computed from exact
per-request records — the server's histograms are the production path;
the generator keeps exact samples since it only lives for a benchmark.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.complexmath import SplitComplex

from .scheduler import NoBucketError
from .server import SpectralServer


@dataclasses.dataclass(frozen=True)
class MixItem:
    """One request archetype in the offered mix."""
    shape: tuple
    kind: str = "c2c"
    inverse: bool = False
    weight: float = 1.0


def make_payload(rng: np.random.Generator, item: MixItem,
                 dtype=np.float32):
    """A seeded payload of ``item``'s archetype."""
    shape = tuple(item.shape)
    if item.kind == "rfft" and not item.inverse:
        return rng.standard_normal(shape).astype(dtype)
    if item.kind == "rfft" and item.inverse:
        half = shape[:-1] + (shape[-1] // 2 + 1,)
        return SplitComplex(rng.standard_normal(half).astype(dtype),
                            rng.standard_normal(half).astype(dtype))
    return SplitComplex(rng.standard_normal(shape).astype(dtype),
                        rng.standard_normal(shape).astype(dtype))


def _pick(rng: np.random.Generator, mix: Sequence[MixItem]) -> MixItem:
    w = np.asarray([m.weight for m in mix], float)
    return mix[int(rng.choice(len(mix), p=w / w.sum()))]


def _summarize(lat_s: List[float], *, wall_s: float, completed: int,
               timed_out: int, rejected: int, offered_qps: Optional[float]
               ) -> dict:
    lat = np.asarray(sorted(lat_s)) if lat_s else np.asarray([0.0])
    return {
        "offered_qps": offered_qps,
        "achieved_qps": completed / wall_s if wall_s > 0 else 0.0,
        "completed": completed, "timed_out": timed_out,
        "rejected": rejected, "wall_s": wall_s,
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "mean_ms": float(lat.mean() * 1e3),
    }


def closed_loop(server: SpectralServer, mix: Sequence[MixItem], *,
                requests: int, concurrency: int = 16, seed: int = 0,
                deadline_s: Optional[float] = None,
                rid_prefix: str = "cl") -> dict:
    """Submit ``requests`` total with at most ``concurrency`` outstanding
    (wait on the oldest, FIFO); returns the summary dict."""
    rng = np.random.default_rng(seed)
    lat, timed_out, rejected, completed = [], 0, 0, 0
    window: List[object] = []
    t0 = time.perf_counter()

    def reap(rid):
        nonlocal timed_out, completed
        rec = server.result(rid)
        if rec.status == "completed":
            completed += 1
            lat.append(rec.latency_s)
        else:
            timed_out += 1

    for i in range(requests):
        item = _pick(rng, mix)
        rid = f"{rid_prefix}-{seed}-{i}"
        payload = make_payload(rng, item)
        while not server.submit(rid, payload, kind=item.kind,
                                inverse=item.inverse,
                                deadline_s=deadline_s):
            if window:                 # backpressure: reap before retrying
                reap(window.pop(0))
            else:
                time.sleep(0.001)
        window.append(rid)
        while len(window) >= concurrency:
            reap(window.pop(0))
    while window:
        reap(window.pop(0))
    wall = time.perf_counter() - t0
    return _summarize(lat, wall_s=wall, completed=completed,
                      timed_out=timed_out, rejected=rejected,
                      offered_qps=None)


def open_loop(server: SpectralServer, mix: Sequence[MixItem], *,
              qps: float, duration_s: float, seed: int = 0,
              deadline_s: Optional[float] = None,
              rid_prefix: str = "ol") -> dict:
    """Seeded Poisson arrivals at ``qps`` for ``duration_s`` wall seconds;
    drains outstanding work before summarizing.  Backpressured and
    unmatched submissions count as ``rejected`` (the generator never
    retries — open loop measures the server, not the client's patience)."""
    rng = np.random.default_rng(seed)
    rids: List[object] = []
    rejected = 0
    t0 = time.perf_counter()
    next_at = t0
    i = 0
    while True:
        now = time.perf_counter()
        if now - t0 >= duration_s:
            break
        if now < next_at:
            time.sleep(min(next_at - now, 0.01))
            continue
        next_at += rng.exponential(1.0 / qps)
        item = _pick(rng, mix)
        rid = f"{rid_prefix}-{seed}-{i}"
        i += 1
        try:
            if server.submit(rid, make_payload(rng, item), kind=item.kind,
                             inverse=item.inverse, deadline_s=deadline_s):
                rids.append(rid)
            else:
                rejected += 1
        except NoBucketError:
            rejected += 1
    server.drain()
    wall = time.perf_counter() - t0
    lat, timed_out, completed = [], 0, 0
    for rid in rids:
        rec = server.result(rid)
        if rec.status == "completed":
            completed += 1
            lat.append(rec.latency_s)
        else:
            timed_out += 1
    return _summarize(lat, wall_s=wall, completed=completed,
                      timed_out=timed_out, rejected=rejected,
                      offered_qps=qps)
