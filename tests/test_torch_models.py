"""The port's model stack (``repro_torch.models``, ``repro_torch.configs``)
against the reference's, on the CPU: the registry and every config's
fields (backend names mapped), parameter trees and counts, and
``forward`` of every config ``reduced()`` (fp32) with the reference's
``init_params`` weights carried across by ``params_from_numpy``, on the
same seeded numpy tokens (or embeddings), within 1e-4 of max(1,
max|ref|) (the reference under ``jax.jit``; ``ssm_demo`` against the
reference's direct conv, ROADMAP §3 F6).  Then the reference's own model
checks on the port: vocab padding masked, MoE dropless exact, and MoE
with capacity below the group size independent of how top-k orders its
ties.  ``test_torch_models_decode.py`` holds prefill and decode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import model as RM
from repro.models import moe as RMoE
from repro.models.config import ModelConfig as RConfig
import repro_torch.configs as TC
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.config import ModelConfig as TConfig

from _torch_model_parity import (ARCHS, B, S, _close, _setup,
                                 _torch_inputs)


def test_registry_matches_reference():
    assert sorted(TC.REGISTRY) == sorted(RC.REGISTRY)
    assert TC.ASSIGNED == RC.ASSIGNED
    assert TC.SKIPPED_CELLS == RC.SKIPPED_CELLS
    assert {k: dataclasses.astuple(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in RC.SHAPES.items()}
    assert [(a, c.shape) for a, c in TC.all_cells(include_skipped=True)] == \
        [(a, c.shape) for a, c in RC.all_cells(include_skipped=True)]
    for arch in RC.ASSIGNED:
        assert [c.shape for c in TC.shapes_for(arch)] == \
            [c.shape for c in RC.shapes_for(arch)]
    with pytest.raises(KeyError):
        TC.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch):
    backends = {"pallas": "cuda", "jnp": "torch"}
    want = dataclasses.asdict(RC.get_config(arch))
    want["fft_backend"] = backends[want["fft_backend"]]
    assert dataclasses.asdict(TC.get_config(arch)) == want
    assert [f.name for f in dataclasses.fields(TConfig)] == \
        [f.name for f in dataclasses.fields(RConfig)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    rcfg, tcfg, rp, tp, _, _ = _setup(arch)
    assert jax.tree.map(lambda a: tuple(a.shape), rp) == \
        TM.tree_map(lambda t: tuple(t.shape), tp)
    assert TM.param_count(tp) == RM.param_count(rp)
    assert TM.active_param_count(tcfg, tp) == RM.active_param_count(rcfg, rp)
    # the full config's counts, on the reference's abstract tree
    full = RC.get_config(arch)
    tree = RM.abstract_params(full)
    assert TM.param_count(tree) == RM.param_count(tree)
    assert TM.active_param_count(TC.get_config(arch), tree) == \
        RM.active_param_count(full, tree)


def test_init_params_draws_the_reference_tree():
    cfg = TC.get_config("zamba2-2.7b").reduced()
    rcfg = RC.get_config("zamba2-2.7b").reduced()
    p = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    q = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref = RM.init_params(jax.random.PRNGKey(0), rcfg)
    assert TM.tree_map(lambda t: tuple(t.shape), p) == \
        jax.tree.map(lambda a: tuple(a.shape), ref)
    assert all(torch.equal(a, b) for a, b in
               zip(TM.tree_leaves(p), TM.tree_leaves(q)))
    # the reference's scale: 1/sqrt(fan-in) for a projection
    wq = p["shared"]["attn"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(wq.shape[0]) - 1.0) < 0.1
    if not torch.cuda.is_available():        # never a silent CPU model
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TM.init_params(torch.Generator(), cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    rcfg, tcfg, rp, tp, inputs, _ = _setup(arch)
    fwd = jax.jit(lambda p, **kw: RM.forward(p, rcfg, **kw))
    ref, ref_aux = fwd(rp, **{k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        got, aux = TM.forward(tp, tcfg, **_torch_inputs(inputs))
    assert got.shape == (B, S, tcfg.padded_vocab)
    _close(got, ref, f"{arch} forward logits")
    _close(aux, ref_aux, f"{arch} aux loss")


@pytest.mark.parametrize("vocab", [256, 250])
def test_vocab_padding_masked(vocab):
    """The reference's check (hubert reduced, 256 = its padded size) and a
    vocabulary that pads."""
    cfg = TC.get_config("hubert-xlarge").reduced(vocab_size=vocab)
    assert cfg.padded_vocab % cfg.vocab_pad_multiple == 0
    assert cfg.padded_vocab == 256
    p = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn((B, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        logits, _ = TM.forward(p, cfg, embeds=x)
    assert bool((logits[..., cfg.vocab_size:] < -1e20).all())
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())


def _moe_cfgs(**kw):
    base = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab_size=256, head_dim=16, attn_chunk=16,
                vocab_pad_multiple=32, n_experts=8, n_experts_active=2,
                moe_d_ff=32)
    base.update(kw)
    return (RConfig(name="m", family="moe", block_pattern=("attn_moe",),
                    repeat=1, **base),
            TConfig(name="m", family="moe", block_pattern=("attn_moe",),
                    repeat=1, **base))


def test_moe_dropless_decode_exact():
    """The reference's test_serve check on the port: dropless decode
    equals routing every token through its top-k experts densely."""
    rcfg, cfg = _moe_cfgs()
    rp = RMoE.moe_init(jax.random.PRNGKey(0), rcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 1, 64)).astype(np.float32))
    got, _ = TMoE.moe_apply(p, x, cfg, dropless=True)
    xf = x.reshape(4, 64)
    probs = torch.softmax(xf @ p["router"], -1)
    topw, topi = torch.topk(probs, 2)
    topw = topw / topw.sum(-1, keepdim=True)
    ref = torch.zeros_like(xf)
    for t in range(4):
        for j in range(2):
            e = int(topi[t, j])
            h = torch.nn.functional.silu(xf[t] @ p["wg"][e]) * \
                (xf[t] @ p["wi"][e])
            ref[t] += topw[t, j] * (h @ p["wo"][e])
    assert float((got.reshape(4, 64) - ref).abs().max()) < 1e-4


def _topk_ties_reversed(x, k, dim=-1, **kw):
    """``torch.topk`` with ties taken highest index first."""
    flipped = x.flip(dim)
    vals, idx = torch.sort(flipped, dim=dim, descending=True, stable=True)
    idx = x.shape[dim] - 1 - idx
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_moe_capacity_below_group_is_tie_independent(monkeypatch, mlp_type):
    """Capacity below the group size: the expert-side top-C picks zero
    weights (ties) for experts with fewer tokens than C.  The result
    matches the reference and does not move when ties are ordered the
    other way."""
    rcfg, cfg = _moe_cfgs(mlp_type=mlp_type)
    rp = RMoE.moe_init(jax.random.PRNGKey(5), rcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    x = np.random.default_rng(6).standard_normal((3, 24, 64)) \
        .astype(np.float32)
    cap = RMoE._capacity(rcfg, 24)
    assert cap == TMoE._capacity(cfg, 24) and cap < 24
    ref, ref_aux = RMoE.moe_apply(rp, jnp.asarray(x), rcfg)
    got, aux = TMoE.moe_apply(p, torch.from_numpy(x), cfg)
    _close(got, ref, "moe output")
    _close(aux, ref_aux, "moe aux")
    # some (group, expert) has fewer assigned tokens than C: zero picks
    probs = torch.softmax(torch.from_numpy(x) @ p["router"], -1)
    assigned = torch.zeros_like(probs).scatter(
        -1, torch.topk(probs, 2).indices, 1.0).sum(1)
    assert bool((assigned < cap).any()) and bool((assigned > cap).any())
    monkeypatch.setattr(torch, "topk", _topk_ties_reversed)
    again, _ = TMoE.moe_apply(p, torch.from_numpy(x), cfg)
    assert float((again - got).abs().max()) <= 1e-6
