"""repro_torch.serve.spectral — production serving for FFT requests
(counterpart of :mod:`repro.serve.spectral`).

Continuous batching of ragged transform requests into plan-registry shape
buckets (:mod:`scheduler`), async host↔device pipelining with bounded
queues (:mod:`executor`), startup wisdom pre-warm with degrade-to-torch
(:mod:`prewarm`), per-bucket latency/occupancy metrics with a JSON
snapshot endpoint (:mod:`metrics`), and open/closed-loop load generation
(:mod:`loadgen`).  :class:`SpectralServer` composes the pieces.
"""
from .scheduler import (BucketConfig, NoBucketError, Request,
                        ShapeBucketScheduler)
from .metrics import LatencyHistogram, Metrics
from .server import RequestRecord, SpectralServer
from .loadgen import MixItem, closed_loop, open_loop
from .prewarm import PrewarmReport
