"""Per-bucket serving metrics: counters, latency histograms, gauges, and a
JSON snapshot endpoint (a copy of :mod:`repro.serve.spectral.metrics`:
the metric names and ``snapshot()`` keys are the reference's).

Latencies land in fixed log-spaced histograms (10 buckets per decade from
10us to 2min) so p50/p99 come from bucket edges without storing samples —
bounded memory at any request rate.  Three histograms per bucket: ``queue``
(admission → dispatch), ``service`` (dispatch → results on host) and
``e2e`` (admission → terminal).  Gauges (queue depth at admission, batch
occupancy at dispatch) keep count/sum/max running stats.

The snapshot is a plain JSON-able dict; :func:`start_http` serves it at
``GET /metrics`` from a daemon thread (port 0 = ephemeral) so a load
generator — or a human — can watch a running server without touching its
dispatch path.  Kernel-path health comes from
:func:`repro_torch.resilience.executor.stats`: the server folds each cuda
bucket's attempt/failure/fallback counters into its snapshot section.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict

HIST_NAMES = ("queue", "service", "e2e")

COUNTERS = ("admitted", "rejected_nobucket", "rejected_backpressure",
            "padded_up", "completed", "timed_out_queued",
            "timed_out_inflight", "fallback_served", "batches",
            "batch_items", "batch_pad_slots")


class LatencyHistogram:
    """Fixed log-spaced latency histogram with edge-quantile estimation."""

    def __init__(self, lo_s: float = 1e-5, hi_s: float = 120.0,
                 per_decade: int = 10):
        decades = math.log10(hi_s / lo_s)
        n = int(round(decades * per_decade))
        self.edges = [lo_s * 10 ** (i / per_decade) for i in range(n + 1)]
        self.counts = [0] * (n + 2)          # +underflow, +overflow
        self.total = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    def record(self, seconds: float) -> None:
        s = max(0.0, float(seconds))
        lo = 0
        hi = len(self.edges)
        while lo < hi:                       # first edge > s
            mid = (lo + hi) // 2
            if self.edges[mid] > s:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.total += 1
        self.sum_s += s
        self.max_s = max(self.max_s, s)

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-quantile (seconds),
        capped at the exact observed max so p100 is truthful."""
        if self.total == 0:
            return 0.0
        want = max(1, math.ceil(p / 100.0 * self.total))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= want:
                upper = self.edges[i] if i < len(self.edges) else self.max_s
                return min(upper, self.max_s)
        return self.max_s

    def snapshot(self) -> dict:
        return {"count": self.total,
                "mean_ms": (self.sum_s / self.total * 1e3 if self.total
                            else 0.0),
                "p50_ms": self.percentile(50) * 1e3,
                "p99_ms": self.percentile(99) * 1e3,
                "max_ms": self.max_s * 1e3}


class _Gauge:
    __slots__ = ("count", "sum", "max")

    def __init__(self):
        self.count, self.sum, self.max = 0, 0.0, 0.0

    def sample(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.max = max(self.max, v)

    def snapshot(self) -> dict:
        return {"samples": self.count,
                "mean": self.sum / self.count if self.count else 0.0,
                "max": self.max}


class Metrics:
    """Thread-safe per-bucket counters + histograms + gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[str, int]] = {}
        self._hists: Dict[str, Dict[str, LatencyHistogram]] = {}
        self._gauges: Dict[str, Dict[str, _Gauge]] = {}
        self._extra: Dict[str, dict] = {}     # per-bucket static info

    def _bucket(self, label: str):
        if label not in self._counters:
            self._counters[label] = {name: 0 for name in COUNTERS}
            self._hists[label] = {n: LatencyHistogram() for n in HIST_NAMES}
            self._gauges[label] = {"queue_depth": _Gauge(),
                                   "batch_occupancy": _Gauge()}

    def inc(self, label: str, name: str, n: int = 1) -> None:
        with self._lock:
            self._bucket(label)
            self._counters[label][name] = \
                self._counters[label].get(name, 0) + n

    def observe(self, label: str, hist: str, seconds: float) -> None:
        with self._lock:
            self._bucket(label)
            self._hists[label][hist].record(seconds)

    def sample(self, label: str, gauge: str, value: float) -> None:
        with self._lock:
            self._bucket(label)
            self._gauges[label][gauge].sample(value)

    def annotate(self, label: str, **info) -> None:
        """Attach static per-bucket facts (plan config, degrade state)."""
        with self._lock:
            self._bucket(label)
            self._extra.setdefault(label, {}).update(info)

    def counter(self, label: str, name: str) -> int:
        with self._lock:
            return self._counters.get(label, {}).get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            out = {"buckets": {}, "totals": {n: 0 for n in COUNTERS}}
            for lbl in self._counters:
                sec = {"counters": dict(self._counters[lbl]),
                       "latency": {n: h.snapshot()
                                   for n, h in self._hists[lbl].items()},
                       "gauges": {n: g.snapshot()
                                  for n, g in self._gauges[lbl].items()}}
                sec.update(self._extra.get(lbl, {}))
                out["buckets"][lbl] = sec
                for n in COUNTERS:
                    out["totals"][n] += self._counters[lbl].get(n, 0)
            return out

    def to_json(self, **extra) -> str:
        snap = self.snapshot()
        snap.update(extra)
        return json.dumps(snap, indent=2, sort_keys=True)


def start_http(metrics: Metrics, port: int = 0, host: str = "127.0.0.1"):
    """Serve ``GET /metrics`` (JSON snapshot) from a daemon thread.

    Returns ``(httpd, port)``; ``httpd.shutdown()`` stops it.  Port 0
    binds an ephemeral port (tests)."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):               # noqa: N802 — stdlib API
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = metrics.to_json().encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):      # keep the server's stdout clean
            pass

    httpd = HTTPServer((host, port), Handler)
    th = threading.Thread(target=httpd.serve_forever, daemon=True,
                          name="repro-torch-serve-metrics")
    th.start()
    return httpd, httpd.server_address[1]
