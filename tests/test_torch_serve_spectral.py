"""The port's spectral server against the reference's, on the CPU: the
shape-bucket scheduler, metrics, the Prefetcher, the pipelined executor,
pre-warm and degrade, deadlines, drain-on-shutdown, the load generator and
the launcher, plus the data pipeline and ModelConfig the Prefetcher's
module brings.  Servers run on ``device="cpu"``, where the cuda backend's
kernel wrappers run their plain versions; the reference's pallas buckets
run their kernels in interpret mode, as its own tests run them.

Tolerances: served spectra within 1e-5 of max|X| against the reference's
and against float64 numpy (the 2-D bound of PERF.md §2); statuses, bucket
labels, padded flags, metric names and counters exactly; a degraded
server's spectra within 1e-6 relative of a healthy one's (the reference's
criterion).  Every blocking wait carries a timeout."""
import dataclasses
import functools
import io
import json
import threading
import time
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro import resilience as ref_resilience
from repro.core import plan as RP
from repro.core.complexmath import SplitComplex as RefSplit
from repro.data import pipeline as ref_pipeline
from repro.models.config import ModelConfig as RefModelConfig
from repro.resilience import faults as ref_faults
from repro.serve import spectral as ref_spectral
from repro_torch import resilience
from repro_torch.core import SplitComplex
from repro_torch.core import plan as P
from repro_torch.data import pipeline
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.launch import serve as launch_serve
from repro_torch.models.config import ModelConfig
from repro_torch.resilience import faults
from repro_torch.serve import spectral
from repro_torch.serve.spectral import (BucketConfig, MixItem, NoBucketError,
                                        Request, ShapeBucketScheduler,
                                        SpectralServer, closed_loop,
                                        open_loop)
from repro_torch.serve.spectral import metrics as metrics_mod
from repro_torch.serve.spectral.metrics import LatencyHistogram, Metrics

TOL = 1e-5
TIMEOUT = 60


@pytest.fixture(autouse=True)
def _isolate():
    for r, p in ((resilience, P), (ref_resilience, RP)):
        r.reset()
        p.clear_plan_cache()
    yield
    for r, p in ((resilience, P), (ref_resilience, RP)):
        r.reset()
        p.clear_plan_cache()


def _server(buckets, **kw):
    return SpectralServer(buckets, device="cpu", **kw)


def _c2c_payload(rng, shape):
    return SplitComplex(rng.standard_normal(shape).astype(np.float32),
                        rng.standard_normal(shape).astype(np.float32))


def _to_complex(sc):
    return np.asarray(sc.re, np.float64) + 1j * np.asarray(sc.im, np.float64)


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


class FakeClock:
    """Settable clock for deterministic deadline/aging tests."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# -- plan.warm through the server's specs ------------------------------------


def test_bucket_specs_and_labels_match_reference():
    for kw in (dict(shape=(64, 64)), dict(shape=(64, 64), kind="rfft",
                                          inverse=True),
               dict(shape=(1 << 20,), max_batch=4)):
        mine, ref = BucketConfig(**kw), ref_spectral.BucketConfig(**kw)
        assert mine.label == ref.label
        spec, rspec = mine.plan_spec(), ref.plan_spec()
        assert spec.pop("backend") == "cuda" and rspec.pop("backend") == \
            "pallas"
        assert spec == rspec
    with pytest.raises(ValueError, match="kind must be one of"):
        BucketConfig((8, 8), kind="bogus")
    with pytest.raises(ValueError, match="1-D or 2-D"):
        BucketConfig((8, 8, 8))


# -- scheduler (the reference's cases on the port's copy) --------------------


def _sched(clock=None, **kw):
    buckets = [BucketConfig((64, 64), max_batch=4),
               BucketConfig((128, 128), max_batch=4)]
    return ShapeBucketScheduler(buckets, clock=clock or time.monotonic,
                                **kw)


def test_scheduler_reject_unmatched():
    s = _sched()
    with pytest.raises(NoBucketError):
        s.admit(Request(rid=0, payload=None, shape=(48, 48)))
    assert s.pending() == 0
    with pytest.raises(ValueError, match="unmatched"):
        _sched(unmatched="drop")
    with pytest.raises(ValueError, match="duplicate"):
        ShapeBucketScheduler([BucketConfig((8, 8)), BucketConfig((8, 8))])


def test_scheduler_pad_up_picks_smallest_fitting():
    s = _sched(unmatched="pad_up")
    b, padded = s.match("c2c", (48, 48))
    assert padded and b.shape == (64, 64)
    b, padded = s.match("c2c", (100, 20))
    assert padded and b.shape == (128, 128)
    assert s.match("c2c", (48, 48), inverse=True) == (None, False)
    assert s.match("c2c", (256, 256)) == (None, False)


def test_scheduler_backpressure_bounded_queue():
    s = _sched(max_queue=2)
    assert s.admit(Request(rid=0, payload=None, shape=(64, 64)))
    assert s.admit(Request(rid=1, payload=None, shape=(64, 64)))
    r = Request(rid=2, payload=None, shape=(64, 64))
    assert not s.admit(r)
    assert r.bucket_label == "c2c/f/64x64"
    assert s.pending() == 2


def test_scheduler_priority_aging_no_starvation():
    clk = FakeClock()
    s = _sched(clock=clk, aging_rate=1.0)
    s.admit(Request(rid="old-low", payload=None, shape=(64, 64),
                    priority=0.0))
    clk.t = 5.0
    s.admit(Request(rid="new-high", payload=None, shape=(128, 128),
                    priority=2.0))
    assert [r.rid for r in s.next_batch()[1]] == ["old-low"]
    assert [r.rid for r in s.next_batch()[1]] == ["new-high"]


def test_scheduler_deadline_sweep_retires_queued():
    clk = FakeClock()
    retired = []
    s = _sched(clock=clk, on_timeout=retired.append)
    s.admit(Request(rid="dies", payload=None, shape=(64, 64), deadline=1.0))
    s.admit(Request(rid="lives", payload=None, shape=(64, 64)))
    clk.t = 2.0
    bucket, reqs = s.next_batch()
    assert [x.rid for x in reqs] == ["lives"]
    assert [x.rid for x in retired] == ["dies"]
    assert s.pending() == 0


def test_scheduler_on_timeout_fires_outside_lock():
    clk = FakeClock()
    seen = []
    s = ShapeBucketScheduler(
        [BucketConfig((64, 64), max_batch=4)], clock=clk,
        on_timeout=lambda r: seen.append((r.rid, s.pending(),
                                          s.queue_depths())))
    s.admit(Request(rid="t", payload=None, shape=(64, 64), deadline=1.0))
    clk.t = 2.0
    assert s.next_batch() is None
    assert seen == [("t", 0, {"c2c/f/64x64": 0})]


def test_scheduler_threaded_admit_vs_sweep_loses_nothing():
    timed_out = []
    s = ShapeBucketScheduler([BucketConfig((64, 64), max_batch=4)],
                             max_queue=100_000, on_timeout=timed_out.append)
    n_threads, n_req = 4, 250
    admitted = [0] * n_threads

    def producer(t):
        for i in range(n_req):
            dl = time.monotonic() if i % 2 else None
            if s.admit(Request(rid=(t, i), payload=None, shape=(64, 64),
                               deadline=dl)):
                admitted[t] += 1

    dispatched = []
    stop = threading.Event()

    def consumer():
        while not stop.is_set() or s.pending():
            sel = s.next_batch()
            if sel is not None:
                dispatched.extend(sel[1])

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(n_threads)]
    c = threading.Thread(target=consumer)
    c.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    stop.set()
    c.join(timeout=TIMEOUT)
    assert not c.is_alive()
    total = sum(admitted)
    rids = [r.rid for r in dispatched] + [r.rid for r in timed_out]
    assert len(rids) == len(set(rids)) == total
    assert s.pending() == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_batches_match_reference(seed):
    """A seeded ragged admission sequence under a fake clock: both
    schedulers hand out the same batches in the same order and retire the
    same requests."""
    shapes = [(64, 64), (128, 128), (48, 40), (100, 20), (256, 8)]
    out = []
    for mod in (spectral, ref_spectral):
        clk, retired = FakeClock(), []
        s = mod.ShapeBucketScheduler(
            [mod.BucketConfig((64, 64), max_batch=3),
             mod.BucketConfig((128, 128), max_batch=2),
             mod.BucketConfig((256, 8), max_batch=4)],
            unmatched="pad_up", aging_rate=0.5, clock=clk, max_queue=12,
            on_timeout=retired.append)
        r = np.random.default_rng(seed)
        log = []
        for i in range(30):
            clk.t += float(r.uniform(0, 0.5))
            shape = shapes[int(r.integers(len(shapes)))]
            dl = clk.t + float(r.uniform(0, 2)) if r.random() < 0.3 \
                else None
            req = mod.Request(rid=i, payload=None, shape=shape,
                              priority=float(r.integers(0, 3)), deadline=dl)
            log.append(("admit", i, s.admit(req), req.bucket_label,
                        req.padded))
            if r.random() < 0.4:
                sel = s.next_batch()
                log.append(("batch", None if sel is None else
                            (sel[0].label, [q.rid for q in sel[1]])))
        while s.pending():
            clk.t += 0.25
            sel = s.next_batch()
            log.append(("batch", None if sel is None else
                        (sel[0].label, [q.rid for q in sel[1]])))
        log.append(("retired", [q.rid for q in retired]))
        out.append(log)
    assert out[0] == out[1]


# -- metrics -----------------------------------------------------------------


def test_latency_histogram_percentiles_bracket_samples():
    h = LatencyHistogram()
    for ms in [1, 1, 1, 1, 1, 1, 1, 1, 1, 100]:
        h.record(ms / 1e3)
    snap = h.snapshot()
    assert snap["count"] == 10
    assert 0.9 <= snap["p50_ms"] <= 1.3
    assert 90 <= snap["p99_ms"] <= 100.0
    assert snap["max_ms"] == pytest.approx(100.0)
    ref = ref_spectral.LatencyHistogram()
    for ms in [1, 1, 1, 1, 1, 1, 1, 1, 1, 100]:
        ref.record(ms / 1e3)
    assert ref.snapshot() == snap
    assert LatencyHistogram().snapshot()["p99_ms"] == 0.0


def test_metrics_snapshot_totals_roll_up():
    m = Metrics()
    m.inc("a", "admitted", 3)
    m.inc("b", "admitted", 2)
    m.observe("a", "e2e", 0.01)
    m.annotate("a", plan_backend="cuda")
    m.sample("a", "batch_occupancy", 0.5)
    snap = m.snapshot()
    assert snap["totals"]["admitted"] == 5
    assert snap["buckets"]["a"]["counters"]["admitted"] == 3
    assert snap["buckets"]["a"]["plan_backend"] == "cuda"
    assert snap["buckets"]["a"]["latency"]["e2e"]["count"] == 1
    assert m.counter("a", "admitted") == 3 and m.counter("z", "x") == 0
    assert json.loads(m.to_json(extra=1))["extra"] == 1
    assert metrics_mod.COUNTERS == ref_spectral.metrics.COUNTERS
    assert metrics_mod.HIST_NAMES == ref_spectral.metrics.HIST_NAMES


# -- data.pipeline -----------------------------------------------------------


def test_prefetcher_preserves_order_and_exhausts():
    with Prefetcher(iter(range(100)), depth=4) as p:
        assert list(p) == list(range(100))
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter(()), depth=0)


def test_prefetcher_propagates_producer_error():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = iter(Prefetcher(gen(), depth=2))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetcher_inline_mode_is_passthrough():
    p = Prefetcher(iter([1, 2, 3]), depth=2, threaded=False)
    assert list(p) == [1, 2, 3]
    p.close()
    assert list(p) == []


def test_prefetcher_bounded_depth_backpressures_producer():
    produced = []

    def gen():
        for i in range(50):
            produced.append(i)
            yield i

    p = Prefetcher(gen(), depth=2)
    it = iter(p)
    assert next(it) == 0
    time.sleep(0.05)
    assert len(produced) <= 2 + 2 + 1
    p.close()
    p._thread.join(timeout=TIMEOUT)
    assert not p._thread.is_alive()


def _model_cfg(cls, **kw):
    return cls(name="tiny", family="dense", d_model=32, n_heads=4,
               n_kv_heads=2, d_ff=64, vocab_size=97,
               block_pattern=("attn_mlp",), repeat=2, **kw)


def test_model_config_is_the_references():
    mine = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(RefModelConfig)}
    assert mine.pop("fft_backend") == "torch"
    assert ref.pop("fft_backend") == "jnp"
    assert mine == ref
    a, b = _model_cfg(ModelConfig), _model_cfg(RefModelConfig)
    for prop in ("n_layers", "resolved_head_dim", "padded_vocab", "d_inner",
                 "ssm_heads"):
        assert getattr(a, prop) == getattr(b, prop), prop
    ra = dataclasses.asdict(a.reduced())
    rb = dataclasses.asdict(b.reduced())
    assert ra.pop("fft_backend") == "torch" and rb.pop("fft_backend") == "jnp"
    assert ra == rb


@pytest.mark.parametrize("mode", ["tokens", "embeddings"])
def test_synthetic_lm_matches_reference(mode):
    dcfg = DataConfig(seq_len=16, global_batch=4, seed=3)
    mine = SyntheticLM(dcfg, _model_cfg(ModelConfig, input_mode=mode),
                       device="cpu")
    ref = ref_pipeline.SyntheticLM(
        ref_pipeline.DataConfig(seq_len=16, global_batch=4, seed=3),
        _model_cfg(RefModelConfig, input_mode=mode))
    for step, host in ((0, 0), (5, 1)):
        got = mine.batch_at(step, host_id=host, num_hosts=2)
        want = ref.batch_at(step, host_id=host, num_hosts=2)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    with mine.iter_batches(2, num_steps=3, threaded=True) as it:
        steps = [(s, b["labels"]) for s, b in it]
    assert [s for s, _ in steps] == [2, 3, 4]
    assert torch.equal(steps[0][1], mine.batch_at(2)["labels"])
    assert SyntheticLM.restore_step(mine.checkpoint_state(7)) == 7
    assert not hasattr(pipeline, "make_batch_specs")     # ROADMAP item 14


# -- server: correctness through the full pipeline ---------------------------


def test_server_inline_serves_correct_spectra():
    rng = np.random.default_rng(0)
    buckets = [BucketConfig((64, 64)), BucketConfig((64, 64), kind="rfft"),
               BucketConfig((64, 64), kind="rfft", inverse=True)]
    with _server(buckets, threaded=False) as srv:
        x = _c2c_payload(rng, (64, 64))
        r = rng.standard_normal((64, 64)).astype(np.float32)
        half = np.fft.rfft2(rng.standard_normal((64, 64)))
        srv.submit("a", x)
        srv.submit("b", r, kind="rfft")
        srv.submit("c", SplitComplex(half.real.astype(np.float32),
                                     half.imag.astype(np.float32)),
                   kind="rfft", inverse=True)
        srv.submit("d", torch.from_numpy(r), kind="rfft")
        assert srv.drain(timeout_s=TIMEOUT)
        _close(_to_complex(srv.result("a").value),
               np.fft.fft2(_to_complex(x)))
        gotb = _to_complex(srv.result("b").value)
        assert gotb.shape == (64, 33)
        _close(gotb, np.fft.rfft2(r))
        _close(srv.result("c").value.astype(np.float64),
               np.fft.irfft2(half, s=(64, 64)))
        _close(_to_complex(srv.result("d").value), np.fft.rfft2(r))
        assert srv.metrics.counter("c2c/f/64x64", "fallback_served") == 0
        assert srv.states["c2c/f/64x64"].plan.backend == "cuda"


def test_server_pad_up_matches_zero_padded_fft():
    rng = np.random.default_rng(1)
    with _server([BucketConfig((64, 64))], threaded=False,
                 unmatched="pad_up") as srv:
        x = _c2c_payload(rng, (48, 40))
        srv.submit("p", x)
        assert srv.drain(timeout_s=TIMEOUT)
        rec = srv.result("p")
        assert rec.status == "completed" and rec.padded
        padded = np.zeros((64, 64), np.complex128)
        padded[:48, :40] = _to_complex(x)
        _close(_to_complex(rec.value), np.fft.fft2(padded))
        assert srv.metrics.counter("c2c/f/64x64", "padded_up") == 1


def test_server_rejects_unmatched_and_counts_it():
    rng = np.random.default_rng(2)
    with _server([BucketConfig((64, 64))], threaded=False) as srv:
        with pytest.raises(NoBucketError):
            srv.submit("nope", _c2c_payload(rng, (48, 48)))
        assert srv.metrics.counter("_unmatched", "rejected_nobucket") == 1
        with pytest.raises(KeyError):
            srv.result("nope")


def test_server_prime_size_rides_demoted_torch_plan():
    rng = np.random.default_rng(3)
    with _server([BucketConfig((61, 61))], threaded=False) as srv:
        st = srv.states["c2c/f/61x61"]
        assert st.requested_backend == "cuda"
        assert st.plan.backend == "torch" and st.plan.demote_reason
        x = _c2c_payload(rng, (61, 61))
        srv.submit("prime", x)
        assert srv.drain(timeout_s=TIMEOUT)
        rec = srv.result("prime")
        assert rec.status == "completed"
        _close(_to_complex(rec.value), np.fft.fft2(_to_complex(x)))
        assert srv.metrics.counter("c2c/f/61x61", "fallback_served") == 1
        assert srv.snapshot()["buckets"]["c2c/f/61x61"]["demote_reason"]


def test_server_backpressure_and_duplicate_rid():
    rng = np.random.default_rng(4)
    with _server([BucketConfig((64, 64))], threaded=False,
                 max_queue=1) as srv:
        assert srv.submit("a", _c2c_payload(rng, (64, 64)))
        assert not srv.submit("b", _c2c_payload(rng, (64, 64)))
        assert srv.metrics.counter("c2c/f/64x64",
                                   "rejected_backpressure") == 1
        with pytest.raises(ValueError, match="duplicate"):
            srv.submit("a", _c2c_payload(rng, (64, 64)))
        assert srv.drain(timeout_s=TIMEOUT)
        assert srv.result("a").status == "completed"


def test_server_rejects_batched_and_complex_rfft_payloads():
    rng = np.random.default_rng(5)
    with _server([BucketConfig((64, 64))], threaded=False) as srv:
        with pytest.raises(ValueError, match="batch"):
            srv.submit("x", rng.standard_normal((3, 64, 64)), kind="rfft")
        with pytest.raises(ValueError, match="real payloads"):
            srv.submit("y", np.ones((64, 64), np.complex64), kind="rfft")
        with pytest.raises(ValueError, match="real payloads"):
            srv.submit("z", torch.ones((64, 64), dtype=torch.complex64),
                       kind="rfft")


def test_server_requires_a_device_it_can_reach():
    if torch.cuda.is_available():
        return                        # the default device is valid here
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpectralServer([BucketConfig((8, 8))])


# -- deadlines: queued vs in-flight ------------------------------------------


def test_deadline_expires_queued_deterministic_clock():
    clk = FakeClock()
    rng = np.random.default_rng(6)
    with _server([BucketConfig((64, 64))], threaded=False,
                 clock=clk) as srv:
        srv.submit("dies", _c2c_payload(rng, (64, 64)), deadline_s=1.0)
        srv.submit("lives", _c2c_payload(rng, (64, 64)))
        clk.t = 2.0
        assert srv.drain(timeout_s=TIMEOUT)
        assert srv.result("dies").status == "timed_out_queued"
        assert srv.result("lives").status == "completed"
        assert srv.metrics.counter("c2c/f/64x64", "timed_out_queued") == 1
        assert srv.metrics.counter("c2c/f/64x64", "completed") == 1


def test_deadline_expires_inflight_under_step_hang(monkeypatch):
    """The step hangs past the deadline on the server's (fake) clock: the
    hang advances the clock by its duration instead of sleeping, so the
    request can only expire in flight, however slow the host is."""
    clk = FakeClock()
    site_check = faults.check

    def hang_on_fake_clock(site, tag=None):
        if site != "serve.step":
            return site_check(site, tag)
        spec = faults.fire(site, tag)
        if spec is not None and spec.kind == "hang":
            clk.t += spec.duration

    monkeypatch.setattr(faults, "check", hang_on_fake_clock)
    rng = np.random.default_rng(7)
    with _server([BucketConfig((64, 64))], threaded=False,
                 clock=clk) as srv:
        with faults.inject("serve.step", "hang", duration=0.25) as fp:
            srv.submit("late", _c2c_payload(rng, (64, 64)), deadline_s=0.05)
            assert srv.drain(timeout_s=TIMEOUT)
        assert fp.fired("serve.step") == 1 and clk.t == 0.25
        rec = srv.result("late")
        assert rec.status == "timed_out_inflight" and rec.value is None
        assert srv.metrics.counter("c2c/f/64x64", "timed_out_inflight") == 1
        assert srv.metrics.counter("c2c/f/64x64", "timed_out_queued") == 0


# -- the same ragged mix through both servers --------------------------------


BUCKETS = [dict(shape=(16, 16), max_batch=4),
           dict(shape=(16, 16), kind="rfft", max_batch=4),
           dict(shape=(16, 16), kind="rfft", inverse=True, max_batch=2),
           dict(shape=(64,), max_batch=4), dict(shape=(256,))]
MIX = [((16, 16), "c2c", False), ((12, 10), "c2c", False),
       ((16, 16), "rfft", False), ((9, 16), "rfft", False),
       ((16, 16), "rfft", True), ((64,), "c2c", False),
       ((40,), "c2c", False), ((256,), "c2c", False),
       ((32, 32), "c2c", False), ((16, 16), "c2c", True)]


def _payload(mod_split, rng, shape, kind, inverse):
    if kind == "rfft" and not inverse:
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "rfft":
        shape = shape[:-1] + (shape[-1] // 2 + 1,)
    return mod_split(rng.standard_normal(shape).astype(np.float32),
                     rng.standard_normal(shape).astype(np.float32))


def _run_mix(mod, split, seed, requests=24, specs=(), **kw):
    """Submit a seeded ragged mix to one package's inline server under a
    fake clock (deadlines on some requests, the clock advanced between
    submissions), drain, and return what a client sees."""
    clk = FakeClock()
    rng = np.random.default_rng(seed)
    extra = {"device": "cpu"} if mod is spectral else {}
    fmod = faults if mod is spectral else ref_faults
    fp = fmod.FaultPlan(seed=seed)
    for site, kind, skw in specs:
        fp.add(site, kind, **skw)
    with fp:
        srv = mod.SpectralServer([mod.BucketConfig(**b) for b in BUCKETS],
                                 threaded=False, unmatched="pad_up",
                                 clock=clk, **extra, **kw)
    events, inputs = [], {}
    with srv:
        for i in range(requests):
            shape, kind, inverse = MIX[int(rng.integers(len(MIX)))]
            payload = _payload(split, rng, shape, kind, inverse)
            dl = 0.3 if rng.random() < 0.4 else None
            try:
                ok = srv.submit(i, payload, kind=kind, inverse=inverse,
                                deadline_s=dl)
                events.append((i, "admitted" if ok else "backpressure"))
                inputs[i] = (payload, shape, kind, inverse)
            except mod.NoBucketError:
                events.append((i, "nobucket"))
            clk.t += float(rng.uniform(0.0, 0.3))
            if rng.random() < 0.2:
                srv.executor.step()
        assert srv.drain(timeout_s=TIMEOUT)
        records = {i: srv.result(i) for i in inputs}
        snap = srv.snapshot()
        degraded = srv.degraded_buckets
    return events, records, inputs, snap, degraded


def _shape_of(snap):
    """The snapshot's keys at every level (metric names), with values
    dropped."""
    if isinstance(snap, dict):
        return {k: _shape_of(v) for k, v in snap.items()}
    return None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ragged_mix_matches_reference(seed):
    r_events, r_recs, _, r_snap, r_deg = _run_mix(ref_spectral, RefSplit,
                                                  seed)
    m_events, m_recs, inputs, m_snap, m_deg = _run_mix(spectral,
                                                       SplitComplex, seed)
    assert m_events == r_events and m_deg == r_deg == []
    assert sorted(m_recs) == sorted(r_recs)
    statuses = set()
    for i, m in m_recs.items():
        r = r_recs[i]
        statuses.add(m.status)
        assert (m.status, m.bucket, m.padded) == (r.status, r.bucket,
                                                  r.padded)
        assert m.latency_s == pytest.approx(r.latency_s)
        if m.status != "completed":
            continue
        want = r.value
        got = m.value
        if isinstance(want, RefSplit):
            _close(_to_complex(got), _to_complex(want))
        else:
            _close(np.asarray(got, np.float64), np.asarray(want, np.float64))
    assert {"completed", "timed_out_queued"} <= statuses
    for lbl, sec in r_snap["buckets"].items():
        mine = m_snap["buckets"][lbl]
        assert mine["counters"] == sec["counters"], lbl
        for h in ("queue", "service", "e2e"):
            assert mine["latency"][h]["count"] == sec["latency"][h]["count"]
        for g in ("queue_depth", "batch_occupancy"):
            assert mine["gauges"][g] == sec["gauges"][g], (lbl, g)
        if "resilience" in sec:
            assert mine["resilience"] == sec["resilience"]
        for k in ("degraded", "max_batch", "block_batch", "plan_algo"):
            assert mine.get(k) == sec.get(k), (lbl, k)
    r_keys, m_keys = _shape_of(r_snap), _shape_of(m_snap)
    assert m_keys == r_keys
    assert m_snap["totals"] == r_snap["totals"]


def test_ragged_mix_spectra_match_numpy():
    _, recs, inputs, _, _ = _run_mix(spectral, SplitComplex, seed=4,
                                     requests=16)
    for i, rec in recs.items():
        if rec.status != "completed":
            continue
        payload, shape, kind, inverse = inputs[i]
        bshape = (16, 16) if len(shape) == 2 else \
            next(b["shape"] for b in BUCKETS if len(b["shape"]) == 1
                 and b["shape"][0] >= shape[0])
        if kind == "rfft" and inverse:
            half = _to_complex(payload)
            _close(rec.value.astype(np.float64),
                   np.fft.irfft2(half, s=bshape))
            continue
        x = np.zeros(bshape, np.complex128)
        src = _to_complex(payload) if isinstance(payload, SplitComplex) \
            else payload.astype(np.float64)
        x[tuple(slice(0, d) for d in src.shape)] = src
        if kind == "rfft":
            want = np.fft.rfft2(x.real)
        else:
            want = (np.fft.ifftn if inverse else np.fft.fftn)(x)
        _close(_to_complex(rec.value), want)


def test_prewarm_fault_mix_matches_reference():
    specs = [("serve.prewarm", "error", dict(tag="rfft/16x16",
                                             times=None))]
    r = _run_mix(ref_spectral, RefSplit, 5, requests=12, specs=specs)
    m = _run_mix(spectral, SplitComplex, 5, requests=12, specs=specs)
    assert m[4] == r[4] == ["rfft/f/16x16", "rfft/i/16x16"]
    assert m[0] == r[0]
    for lbl, sec in r[3]["buckets"].items():
        assert m[3]["buckets"][lbl]["counters"] == sec["counters"]


# -- prewarm + resilience ----------------------------------------------------


def test_prewarm_fault_degrades_with_identical_outputs():
    rng = np.random.default_rng(8)
    x = _c2c_payload(rng, (64, 64))
    with _server([BucketConfig((64, 64))], threaded=False) as ok:
        ok.submit("r", x)
        ok.drain(timeout_s=TIMEOUT)
        want = _to_complex(ok.result("r").value)
    with faults.inject("serve.prewarm", "error"):
        srv = _server([BucketConfig((64, 64))], threaded=False)
    with srv:
        assert srv.degraded_buckets == ["c2c/f/64x64"]
        st = srv.states["c2c/f/64x64"]
        assert st.plan.backend == "torch" and "FaultInjected" in st.reason
        assert srv.prewarm_report.degraded == ["c2c/f/64x64"]
        srv.submit("r", x)
        srv.drain(timeout_s=TIMEOUT)
        got = _to_complex(srv.result("r").value)
        assert srv.metrics.counter("c2c/f/64x64", "fallback_served") == 1
    assert np.max(np.abs(got - want)) <= 1e-6 * max(1.0, np.abs(want).max())


def test_prewarm_report_entries():
    with _server([BucketConfig((64, 64)),
                  BucketConfig((64, 64), kind="rfft")],
                 threaded=False) as srv:
        rep = srv.prewarm_report
        assert sorted(e.label for e in rep.entries) == \
            ["c2c/f/64x64", "rfft/f/64x64"]
        assert all(e.compile_s > 0 for e in rep.entries)
        assert rep.total_s >= max(e.compile_s for e in rep.entries)
        assert not rep.degraded and rep.wisdom_entries == 0
        assert all(e.backend == "cuda" and e.max_batch == 8
                   for e in rep.entries)
    with _server([BucketConfig((8, 8))], threaded=False,
                 prewarm=False) as cold:
        assert cold.prewarm_report is None
        assert cold.states["c2c/f/8x8"].fn is None


def test_prewarm_torch_twin_failure_never_crashes(monkeypatch):
    from repro_torch.serve.spectral import prewarm as prewarm_mod

    def broken(state):
        raise RuntimeError("no compile for you")

    monkeypatch.setattr(prewarm_mod, "make_fn", broken)
    rng = np.random.default_rng(15)
    with _server([BucketConfig((64, 64))], threaded=False) as srv:
        (entry,) = srv.prewarm_report.entries
        assert entry.degraded and "torch twin failed" in entry.reason
        st = srv.states["c2c/f/64x64"]
        assert st.fn is None and st.plan.backend == "torch"
        srv.submit("r", _c2c_payload(rng, (64, 64)))
        assert srv.drain(timeout_s=TIMEOUT)
        assert srv.result("r").status == "completed"


def test_dispatch_failure_degrades_bucket_once():
    """A dispatch that raises degrades the bucket to its torch twin and
    retries: the request completes, counted as fallback-served."""
    rng = np.random.default_rng(17)
    with _server([BucketConfig((32, 32))], threaded=False) as srv:
        st = srv.states["c2c/f/32x32"]

        def boom(x):
            raise RuntimeError("launch failed")

        st.fn = boom
        x = _c2c_payload(rng, (32, 32))
        srv.submit("r", x)
        assert srv.drain(timeout_s=TIMEOUT)
        rec = srv.result("r")
        assert rec.status == "completed"
        _close(_to_complex(rec.value), np.fft.fft2(_to_complex(x)))
        assert st.degraded and "launch failed" in st.reason
        assert srv.degraded_buckets == ["c2c/f/32x32"]
        assert srv.metrics.counter("c2c/f/32x32", "fallback_served") == 1


def test_dispatch_kernel_failure_on_the_card_raises(monkeypatch):
    """On the card a dispatch failure that is not an injected fault raises
    and leaves the bucket on its kernel: a broken kernel never serves from
    its torch twin.  ``on_card`` stands in for the card."""
    from repro_torch.serve.spectral import executor as executor_mod
    rng = np.random.default_rng(17)
    monkeypatch.setattr(executor_mod, "on_card", lambda x: True)
    with _server([BucketConfig((32, 32))], threaded=False) as srv:
        st = srv.states["c2c/f/32x32"]

        def boom(x):
            raise RuntimeError("CUDA error: launch failed")

        st.fn = boom
        srv.submit("r", _c2c_payload(rng, (32, 32)))
        with pytest.raises(RuntimeError, match="launch failed"):
            srv.drain(timeout_s=TIMEOUT)
        assert not st.degraded and st.plan.backend == "cuda"
        assert srv.degraded_buckets == []
        assert srv.metrics.counter("c2c/f/32x32", "fallback_served") == 0


def test_tuned_server_buckets():
    with _server([BucketConfig((16, 16)), BucketConfig((64,))],
                 threaded=False, tune=True, tune_batch=2) as srv:
        for st in srv.states.values():
            assert st.plan.tuned and "winner" in st.plan.tune_report
            assert st.cfg.max_batch == 8
        assert P.autotune_count((16, 16), backend="cuda") == 1


# -- threaded pipeline: drain-on-shutdown, zero orphans ----------------------


def test_threaded_drain_on_shutdown_zero_orphans():
    rng = np.random.default_rng(9)
    buckets = [BucketConfig((64, 64)), BucketConfig((64, 64), kind="rfft")]
    srv = _server(buckets, threaded=True)
    rids = []
    for i in range(30):
        rid = f"r{i}"
        if i % 2:
            ok = srv.submit(rid, rng.standard_normal((64, 64))
                            .astype(np.float32), kind="rfft")
        else:
            ok = srv.submit(rid, _c2c_payload(rng, (64, 64)))
        if ok:
            rids.append(rid)
    assert srv.close(timeout_s=TIMEOUT)
    for rid in rids:
        rec = srv.result(rid, timeout=0)
        assert rec is not None and rec.status == "completed"
    assert not srv.submit("late", _c2c_payload(rng, (64, 64)))
    snap = srv.snapshot()
    assert snap["pending"] == 0
    assert snap["totals"]["completed"] == len(rids)
    assert not any(t.is_alive() for t in srv.executor._threads)


def test_result_consumes_record_and_frees_rid():
    rng = np.random.default_rng(14)
    with _server([BucketConfig((64, 64))], threaded=False) as srv:
        x = _c2c_payload(rng, (64, 64))
        srv.submit("r", x)
        assert srv.drain(timeout_s=TIMEOUT)
        assert srv.result("r").status == "completed"
        assert srv._records == {} and srv._done == {}
        with pytest.raises(KeyError):
            srv.result("r")
        srv.submit("r", x)
        assert srv.drain(timeout_s=TIMEOUT)
        assert srv.result("r").status == "completed"


def test_threaded_step_error_terminates_requests():
    rng = np.random.default_rng(10)
    srv = _server([BucketConfig((64, 64))], threaded=True)
    try:
        with faults.inject("serve.step", "error", times=None):
            srv.submit("e", _c2c_payload(rng, (64, 64)))
            rec = srv.result("e", timeout=TIMEOUT)
        assert rec is not None and rec.status == "error"
        assert isinstance(rec.error, faults.FaultInjected)
    finally:
        assert srv.close(timeout_s=TIMEOUT)


def test_threaded_staging_crash_still_releases_pipeline():
    srv = _server([BucketConfig((64, 64))], threaded=True)
    threads = list(srv.executor._threads)

    def boom():
        raise RuntimeError("staging boom")

    srv.scheduler.next_batch = boom
    srv.executor.poke()
    # the staging thread has left the pipeline when the drain loop has its
    # sentinel: wait for that, not for wall time
    for t in threads:
        t.join(timeout=TIMEOUT)
    t0 = time.monotonic()
    srv.executor.shutdown()
    assert time.monotonic() - t0 < 5.0
    assert not any(t.is_alive() for t in threads)
    snap = srv.metrics.snapshot()
    assert "staging boom" in snap["buckets"]["_pipeline"]["staging_error"]


def test_threaded_assembly_error_terminates_requests_not_pipeline():
    rng = np.random.default_rng(16)
    srv = _server([BucketConfig((64, 64))], threaded=True)
    try:
        orig = srv.executor._assemble
        calls = {"n": 0}

        def flaky(bucket, reqs):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("assembly boom")
            return orig(bucket, reqs)

        srv.executor._assemble = flaky
        srv.submit("a", _c2c_payload(rng, (64, 64)))
        rec = srv.result("a", timeout=TIMEOUT)
        assert rec is not None and rec.status == "error"
        assert "assembly boom" in str(rec.error)
        srv.submit("b", _c2c_payload(rng, (64, 64)))
        rec = srv.result("b", timeout=TIMEOUT)
        assert rec is not None and rec.status == "completed"
    finally:
        assert srv.close(timeout_s=TIMEOUT)


# -- loadgen + metrics endpoint + launcher -----------------------------------


def test_closed_loop_completes_all():
    buckets = [BucketConfig((64, 64)), BucketConfig((128,))]
    mix = [MixItem((64, 64)), MixItem((128,), weight=0.5)]
    with _server(buckets, threaded=True) as srv:
        srv.result = functools.partial(srv.result, timeout=TIMEOUT)
        res = closed_loop(srv, mix, requests=24, concurrency=6, seed=0)
        assert res["completed"] == 24 and res["timed_out"] == 0
        assert res["achieved_qps"] > 0
        assert res["p99_ms"] >= res["p50_ms"] > 0


def test_open_loop_reports_offered_vs_achieved():
    with _server([BucketConfig((64, 64))], threaded=True) as srv:
        srv.result = functools.partial(srv.result, timeout=TIMEOUT)
        res = open_loop(srv, [MixItem((64, 64))], qps=100.0,
                        duration_s=0.3, seed=1)
        assert res["offered_qps"] == 100.0
        assert res["completed"] > 0


def test_loadgen_payloads_match_reference():
    from repro.serve.spectral import loadgen as ref_loadgen
    from repro_torch.serve.spectral import loadgen
    for item in (MixItem((8, 8)), MixItem((8, 8), "rfft"),
                 MixItem((8, 8), "rfft", inverse=True)):
        ref_item = ref_loadgen.MixItem(item.shape, item.kind, item.inverse)
        got = loadgen.make_payload(np.random.default_rng(3), item)
        want = ref_loadgen.make_payload(np.random.default_rng(3), ref_item)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w)


def test_metrics_http_endpoint_serves_snapshot():
    rng = np.random.default_rng(11)
    with _server([BucketConfig((64, 64))], threaded=False) as srv:
        port = srv.serve_metrics_http()
        srv.submit("m", _c2c_payload(rng, (64, 64)))
        srv.drain(timeout_s=TIMEOUT)
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read()
        snap = json.loads(body)
        assert snap["buckets"]["c2c/f/64x64"]["counters"]["admitted"] == 1
        json.loads(srv.metrics_json())


def test_launch_serve_spectral_and_lm():
    out = io.StringIO()
    with redirect_stdout(out):
        launch_serve.main(["--workload", "spectral", "--device", "cpu",
                           "--buckets", "16x16,32", "--requests", "6"])
    text = out.getvalue()
    assert "3 buckets pre-warmed" in text and "6 completed" in text
    with pytest.raises(NotImplementedError, match="item 14"):
        launch_serve.main(["--workload", "lm"])
    with pytest.raises(SystemExit):
        launch_serve.main(["--workload", "spectral", "--device", "cpu",
                           "--buckets", "2x2x2"])
