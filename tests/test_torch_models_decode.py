"""The port's model stack on the serving path (``prefill`` and
``decode_step``) against the reference's, on the CPU.

Every config of the registry, ``reduced()`` (fp32), the reference's
weights carried across: bulk prefill of the same seeded tokens (or
embeddings), then 8 decode steps against the cache it left, logits and
caches within 1e-4 of max(1, max|ref|) (the reference under ``jax.jit``).
``ssm_demo`` is held to the reference's direct conv, which the reference's
decode shares: the reference's FFT conv branch convolves with the filter
reversed (ROADMAP §3 F6), so the port's FFT branch reverses it back
(``test_ssm_fft_conv_is_the_direct_conv`` runs the reference's Pallas conv
in interpret mode on the reversed filter).  Then the reference's own
checks on the port: decode matches forward, ring wraparound past the
window."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import model as RM
from repro.models import ssm as RSsm
from repro.models.config import ModelConfig as RConfig
import repro_torch.configs as TC
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSsm
from repro_torch.models.config import ModelConfig as TConfig

from _torch_model_parity import (ARCHS, B, S, STEPS, _caches_close, _close,
                                 _setup, _torch_inputs)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill S tokens, then decode 8 more against the cache it left."""
    rcfg, tcfg, rp, tp, inputs, steps = _setup(arch)
    max_len = S + STEPS
    pre = jax.jit(lambda p, c, **kw: RM.prefill(p, rcfg, cache=c, **kw))
    dec = jax.jit(lambda p, t, c, pos: RM.decode_step(p, rcfg, t, c, pos))
    ref_lg, ref_c = pre(rp, RM.init_cache(rcfg, B, max_len),
                        **{k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        cache = TM.init_cache(tcfg, B, max_len, device="cpu")
        got_lg, got_c = TM.prefill(tp, tcfg, cache=cache,
                                   **_torch_inputs(inputs))
    assert got_c is cache
    _close(got_lg, ref_lg, f"{arch} prefill logits")
    _caches_close(got_c, ref_c, f"{arch} prefill cache")
    for t in range(STEPS):
        pos = np.full((B,), S + t, np.int32)
        ref_lg, ref_c = dec(rp, jnp.asarray(steps[t]), ref_c,
                            jnp.asarray(pos))
        with torch.no_grad():
            got_lg, got_c = TM.decode_step(tp, tcfg,
                                           torch.from_numpy(steps[t]),
                                           got_c, torch.from_numpy(pos))
        _close(got_lg, ref_lg, f"{arch} decode step {t} logits")
    _caches_close(got_c, ref_c, f"{arch} cache after decode")


@pytest.mark.parametrize("arch", [a for a in RC.ASSIGNED
                                  if a not in RC.ENCODER_ONLY])
def test_decode_matches_forward(arch):
    """The reference's test_arch_smoke check on the port."""
    rcfg = RC.get_config(arch).reduced(capacity_factor=8.0)
    cfg = TC.get_config(arch).reduced(capacity_factor=8.0)
    params = TM.params_from_numpy(
        jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(0), rcfg)),
        cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, 8)))
    with torch.no_grad():
        cache = TM.init_cache(cfg, B, 32, device="cpu")
        outs = []
        for t in range(8):
            lg, cache = TM.decode_step(params, cfg, toks[:, t], cache,
                                       torch.full((B,), t, dtype=torch.int32))
            outs.append(lg)
        ref, _ = TM.forward(params, cfg, tokens=toks)
    assert float((torch.stack(outs, 1) - ref).abs().max()) < 5e-3, arch


def _dense(**kw):
    base = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab_size=256, head_dim=16, attn_chunk=16,
                vocab_pad_multiple=32)
    base.update(kw)
    return (RConfig(name="t", family="dense", block_pattern=("attn_mlp",),
                    repeat=2, **base),
            TConfig(name="t", family="dense", block_pattern=("attn_mlp",),
                    repeat=2, **base))


def test_sliding_window_ring_wraparound():
    """Decode far past the window: the ring cache stays right (the
    reference's test_serve check on the port, against both forwards)."""
    rcfg, cfg = _dense(sliding_window=8)
    rp = RM.init_params(jax.random.PRNGKey(0), rcfg)
    p = TM.params_from_numpy(jax.tree.map(np.asarray, rp), cfg, device="cpu")
    toks = np.random.default_rng(3).integers(0, 256, (1, 32)).astype(np.int32)
    ref, _ = RM.forward(rp, rcfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        own, _ = TM.forward(p, cfg, tokens=torch.from_numpy(toks))
        cache = TM.init_cache(cfg, 1, 32, device="cpu")
        assert cache["b0"]["k"].shape[2] == 8
        for t in range(32):
            lg, cache = TM.decode_step(p, cfg, torch.from_numpy(toks[:, t]),
                                       cache,
                                       torch.full((1,), t, dtype=torch.int32))
    assert float((own[:, -1] - lg).abs().max()) < 2e-3
    _close(lg, ref[:, -1], "ring decode vs the reference's forward")
    # every slot holds one of the last 8 positions
    assert sorted(cache["b0"]["pos"][0, 0].tolist()) == list(range(24, 32))


def test_ssm_fft_conv_is_the_direct_conv():
    """ssm_demo's conv branch on the port's FFT plan (cuda backend; the
    fused kernel's plain version on the CPU) equals the direct conv, and
    the reference's Pallas conv (interpret mode) on the reversed filter.
    The reference's FFT branch on the filter as given is the recorded
    fault F6: it disagrees with the reference's own direct conv."""
    rcfg = RC.get_config("ssm_demo").reduced()
    cfg = TC.get_config("ssm_demo").reduced()
    assert rcfg.use_fft_conv and rcfg.fft_backend == "pallas"
    assert cfg.use_fft_conv and cfg.fft_backend == "cuda"
    rng = np.random.default_rng(7)
    ch = cfg.d_inner + 2 * cfg.ssm_state
    u = rng.standard_normal((2, S, ch)).astype(np.float32)
    w = rng.standard_normal((cfg.ssm_conv, ch)).astype(np.float32)
    b = rng.standard_normal((ch,)).astype(np.float32)
    direct = dataclasses.replace(rcfg, use_fft_conv=False)
    want = RSsm._causal_conv(*map(jnp.asarray, (u, w, b)), direct)
    got = TSsm._causal_conv(*map(torch.from_numpy, (u, w, b)), cfg)
    _close(got, want, "port FFT conv vs reference direct conv")
    _close(TSsm._causal_conv(*map(torch.from_numpy, (u, w, b)),
                             dataclasses.replace(cfg, use_fft_conv=False)),
           want, "port direct conv")
    flipped = RSsm._causal_conv(*map(jnp.asarray, (u, w[::-1].copy(), b)),
                                rcfg)
    _close(got, flipped, "port FFT conv vs reference Pallas conv, reversed")
    fault = RSsm._causal_conv(*map(jnp.asarray, (u, w, b)), rcfg)
    assert float(jnp.abs(fault - want).max()) > 0.1 * float(
        jnp.abs(want).max())


def test_ssm_fft_prefill_matches_direct_prefill_and_decode():
    """On the port, ssm_demo's FFT-conv prefill and its direct-conv prefill
    agree, and so does stepwise decode (the reference's prefill does not
    agree with its own decode: F6).  Under inference mode, as a server
    runs it: the conv's spectrum caches take no inference tensor."""
    _, cfg, _, tp, inputs, _ = _setup("ssm_demo")
    toks = torch.from_numpy(inputs["tokens"])
    with torch.inference_mode():
        fft, _ = TM.prefill(tp, cfg, tokens=toks,
                            cache=TM.init_cache(cfg, B, S, device="cpu"))
        direct, _ = TM.prefill(tp, dataclasses.replace(cfg,
                                                       use_fft_conv=False),
                               tokens=toks,
                               cache=TM.init_cache(cfg, B, S, device="cpu"))
        cache = TM.init_cache(cfg, B, S, device="cpu")
        for t in range(S):
            lg, cache = TM.decode_step(tp, cfg, toks[:, t], cache,
                                       torch.full((B,), t, dtype=torch.int32))
    _close(fft, direct.numpy(), "FFT vs direct prefill")
    _close(lg, fft[:, -1].numpy(), "decode vs FFT prefill")
