"""The port's LM decode engine (``repro_torch.serve.engine``) and
``launch.serve --workload lm`` on the CPU, against the reference's engine.

A tiny dense config (the reference's ``tests/test_serve.py`` one) with the
reference's weights carried across: the engine serves every request,
greedy output is deterministic and token for token the reference
engine's serving each request alone (each compared step's top-2 logit
margin exceeds the logits tolerance, so a mismatch is a fault, not
rounding; served together, the reference's idle rows write their caches,
fault F7), temperature sampling is reproducible under a seed; requests
of recurrent and hybrid configs give the same tokens served together as
alone; then the reference's engine checks from ``tests/test_resilience.py``
(pre-warm fault degrades, per-request deadlines) on the port, pre-warm on
the model's own FFT backend, and the CUDA default that never runs on the
CPU unasked."""
import dataclasses
import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import model as RM
from repro.models.config import ModelConfig as RConfig
from repro.serve.engine import Engine as REngine, ServeConfig as RServeConfig
import repro_torch.configs as TC
from repro_torch import resilience
from repro_torch.core import plan as P
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.resilience import faults
from repro_torch.serve.engine import (Engine, ServeConfig, decode_fn,
                                      prefill_fn)

TOL = 1e-4      # the model tests' logits tolerance, of max(1, max|logits|)
BASE = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
            head_dim=16, attn_chunk=16, vocab_pad_multiple=32)


@pytest.fixture(autouse=True)
def _isolate():
    resilience.reset()
    P.clear_plan_cache()
    yield
    resilience.reset()
    P.clear_plan_cache()


def _dense(**kw):
    return (RConfig(name="t", family="dense", block_pattern=("attn_mlp",),
                    repeat=2, **BASE, **kw),
            TConfig(name="t", family="dense", block_pattern=("attn_mlp",),
                    repeat=2, **BASE, **kw))


def _carried(rcfg, cfg, seed=0):
    rp = RM.init_params(jax.random.PRNGKey(seed), rcfg)
    return rp, TM.params_from_numpy(jax.tree.map(np.asarray, rp), cfg,
                                    device="cpu")


def _cpu(**kw):
    return ServeConfig(device="cpu", **kw)


def _requests(n, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=rng.integers(2, 9))
             .astype(np.int32)) for i in range(n)]


def test_engine_serves_all_requests():
    rcfg, cfg = _dense()
    _, p = _carried(rcfg, cfg)
    eng = Engine(cfg, _cpu(batch_size=2, max_len=64), p)
    out = eng.run(_requests(5), max_new=4)
    assert sorted(out) == [0, 1, 2, 3, 4]
    assert all(len(v) == 5 for v in out.values())     # 1 prompt tail + 4 new
    assert not any(s.active for s in eng.slots)


def test_engine_greedy_deterministic():
    rcfg, cfg = _dense()
    _, p = _carried(rcfg, cfg)
    prompt = np.asarray([5, 6, 7], np.int32)
    outs = [Engine(cfg, _cpu(batch_size=2, max_len=64), p)
            .run([(0, prompt)], max_new=6)[0] for _ in range(2)]
    assert outs[0] == outs[1]


def _reference_alone(rcfg, rp, reqs, max_new, margins):
    """The reference engine's greedy tokens, each request served on its
    own; each generated step's top-2 logit margin and logits bound are
    appended to ``margins``."""
    out = {}
    for req in reqs:
        ref_eng = REngine(rcfg, RServeConfig(batch_size=2, max_len=64), rp)
        in_step = [False]
        decode, step = ref_eng._decode, ref_eng.step

        def recording_decode(params, toks, cache, pos):
            logits, cache = decode(params, toks, cache, pos)
            if in_step[0]:
                lg = np.asarray(logits)
                bound = TOL * max(1.0, float(np.abs(lg).max()))
                for i in np.flatnonzero(np.asarray(pos) >= 0):
                    top2 = np.sort(lg[i])[-2:]
                    margins.append((top2[1] - top2[0], bound))
            return logits, cache

        def recording_step(max_new):
            in_step[0] = True
            try:
                step(max_new)
            finally:
                in_step[0] = False

        ref_eng._decode, ref_eng.step = recording_decode, recording_step
        out.update(ref_eng.run([req], max_new=max_new))
    return out


@pytest.mark.parametrize("window", [None, 8])
def test_greedy_tokens_match_reference_engine(window):
    """Five requests through two slots (so rows sit idle at the empty
    position and slots are reused), greedy, past a sliding window's
    ring, against the reference engine serving each request on its own:
    served together, the reference's idle rows overwrite a live row's
    cache slot (fault F7)."""
    rcfg, cfg = _dense(sliding_window=window)
    rp, p = _carried(rcfg, cfg)
    reqs = _requests(5, seed=1)
    margins = []
    want = _reference_alone(rcfg, rp, reqs, 12, margins)
    got = Engine(cfg, _cpu(batch_size=2, max_len=64), p).run(reqs,
                                                             max_new=12)
    assert len(margins) == 5 * 12
    assert all(m > b for m, b in margins), min(m - b for m, b in margins)
    assert got == want


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("arch", ["ssm_demo", "xlstm-350m", "zamba2-2.7b"])
def test_requests_served_together_match_served_alone(arch, batch):
    """Three requests through ``batch`` slots give the tokens each gives
    on its own: an idle row's recurrent state and KV cache stay as they
    were while another request prefills, and an admitted request starts
    from an empty cache row, not the previous request's state (F7)."""
    cfg = TC.get_config(arch).reduced()
    p = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    reqs = _requests(3, vocab=cfg.vocab_size, seed=2)
    alone = {}
    for req in reqs:
        alone.update(Engine(cfg, _cpu(batch_size=batch, max_len=32), p)
                     .run([req], max_new=6))
    together = Engine(cfg, _cpu(batch_size=batch, max_len=32), p).run(
        reqs, max_new=6)
    assert together == alone


def test_temperature_sampling_reproducible_under_seed():
    rcfg, cfg = _dense()
    _, p = _carried(rcfg, cfg)
    reqs = _requests(3, seed=2)

    def run(seed):
        return Engine(cfg, _cpu(batch_size=2, max_len=64, temperature=1.0,
                                seed=seed), p).run(reqs, max_new=8)

    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c
    assert all(0 <= t < cfg.vocab_size for v in a.values() for t in v)


def test_decode_and_prefill_fns_are_the_model_entry_points():
    rcfg, cfg = _dense()
    _, p = _carried(rcfg, cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 6)))
    with torch.no_grad():
        lg, _ = prefill_fn(cfg)(p, {"tokens": toks},
                                TM.init_cache(cfg, 2, 16, device="cpu"))
        cache = TM.init_cache(cfg, 2, 16, device="cpu")
        for t in range(6):
            step, cache = decode_fn(cfg)(p, toks[:, t], cache,
                                         torch.full((2,), t,
                                                    dtype=torch.int32))
    assert float((lg[:, -1] - step).abs().max()) < 2e-3


def _fourier_engine(clock=None, scfg=None):
    cfg = TC.get_config("fnet_demo").reduced()
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    return Engine(cfg, scfg or _cpu(batch_size=2, max_len=64), params,
                  clock=clock)


def test_engine_degrades_instead_of_crashing_on_prewarm_failure():
    with faults.inject("serve.prewarm", "error"):
        eng = _fourier_engine()
    assert eng.degraded
    assert "FaultInjected" in eng.degrade_reason
    out = eng.run([(0, np.asarray([5, 6, 7], np.int32))], max_new=2)
    assert list(out) == [0] and len(out[0]) == 3   # still serves


def test_engine_not_degraded_normally():
    eng = _fourier_engine()
    assert not eng.degraded and eng.degrade_reason is None


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_prewarms_the_models_fft_backend(backend):
    """Pre-warm resolves the (d_model,) plan on the backend the model's
    fourier mixers run (a CPU engine only resolves it)."""
    cfg = dataclasses.replace(TC.get_config("fnet_demo").reduced(),
                              d_model=512, fft_backend=backend)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    eng = Engine(cfg, _cpu(batch_size=2, max_len=64), params)
    assert not eng.degraded
    assert list(P._PLAN_CACHE) == [((512,), "float32", False, backend,
                                     "c2c")]


def test_engine_honours_per_request_deadlines():
    t = {"v": 0.0}
    eng = _fourier_engine(clock=lambda: t["v"])
    prompt = np.asarray([5, 6, 7], np.int32)
    assert eng.add_request(0, prompt, deadline_s=2.5)   # expires at t=2.5
    assert eng.add_request(1, prompt)                   # no deadline
    for _ in range(6):
        t["v"] += 1.0
        eng.step(max_new=6)
    assert eng.timed_out == {0}
    assert len(eng.finished[0]) < 1 + 6       # cut short, partial kept
    assert len(eng.finished[1]) == 1 + 6      # undeadlined ran to max_new


def test_engine_step_fault_site():
    eng = _fourier_engine()
    assert eng.add_request(0, np.asarray([1, 2], np.int32))
    with faults.inject("serve.step", "error"):
        with pytest.raises(faults.FaultInjected):
            eng.step(max_new=4)


def test_launch_serve_lm_reduced_danube():
    out = io.StringIO()
    with redirect_stdout(out):
        served = launch_serve.main(["--workload", "lm", "--arch",
                                    "h2o-danube-1.8b", "--reduced",
                                    "--device", "cpu"])
    assert sorted(served) == list(range(8))
    assert all(len(v) == 1 + 16 for v in served.values())
    assert "8 requests, 136 tokens" in out.getvalue()


def test_cuda_default_never_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeConfig()
    scfg = _cpu()
    scfg.device = "cuda"                     # an engine asked for the card
    rcfg, cfg = _dense()
    _, p = _carried(rcfg, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, scfg, p)
