"""The port's model layers (``repro_torch.models.layers``, ``.flash``,
``.cache``, ``.actsharding``) against the reference's, on the CPU.

The same seeded numpy inputs and weights through each layer function of
both packages: norms, qk-norm, RoPE, the three MLP types, the chunked
decode formula ``_attend_chunked``, the flash forward over window x
causal x chunk, full-sequence attention, bulk prefill into a cache, and
one-token ``attention_decode`` (the port's through
``ops.decode_attention``, the decode kernel's plain version on a CPU
tensor) on full caches, a ring past its window and a non-causal encoder.
Each agrees within 1e-5 of max|ref| (the reference's flash test bound)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import actsharding as r_act
from repro.models import cache as r_cache
from repro.models import flash as r_flash
from repro.models import layers as r_layers
from repro.models.config import ModelConfig as RConfig
from repro_torch.models import actsharding as t_act
from repro_torch.models import cache as t_cache
from repro_torch.models import flash as t_flash
from repro_torch.models import layers as t_layers
from repro_torch.models.config import ModelConfig as TConfig

TOL = 1e-5
BASE = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=256,
            head_dim=16, attn_chunk=16, vocab_pad_multiple=32)


def _cfgs(**kw):
    args = dict(name="t", family="dense", block_pattern=("attn_mlp",),
                repeat=1, **{**BASE, **kw})
    return RConfig(**args), TConfig(**args)


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(got.detach().double().numpy() - ref).max())
    assert err <= tol * float(np.abs(ref).max()), err


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _params(init, rcfg, seed=0):
    """Reference weights, randomised biases and scales included, on both
    sides."""
    rp = init(jax.random.PRNGKey(seed), rcfg)
    rng = np.random.default_rng(seed + 100)
    rp = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
        .astype(np.float32)), rp)
    return rp, jax.tree.map(_t, rp)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norm_apply(norm_type):
    rcfg, cfg = _cfgs(norm_type=norm_type)
    rp, p = _params(lambda k, c: r_layers.norm_init(c), rcfg)
    x = 3.0 * _rand((2, 5, 64), 1) + 1.0
    _close(t_layers.norm_apply(p, _t(x), cfg),
           r_layers.norm_apply(rp, jnp.asarray(x), rcfg))


def test_rms_head_norm():
    x, s = _rand((2, 5, 4, 16), 2), _rand((16,), 3)
    _close(t_layers.rms_head_norm(_t(x), _t(s)),
           r_layers.rms_head_norm(jnp.asarray(x), jnp.asarray(s)))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    x = _rand((2, 7, 4, 16), 4)
    pos = np.random.default_rng(5).integers(0, 4096, (2, 7)).astype(np.int32)
    _close(t_layers.apply_rope(_t(x), _t(pos), theta),
           r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("mlp_type,bias", [("swiglu", False),
                                           ("gelu", True), ("gelu", False),
                                           ("relu2", False)])
def test_mlp_apply(mlp_type, bias):
    rcfg, cfg = _cfgs(mlp_type=mlp_type, mlp_bias=bias)
    rp, p = _params(r_layers.mlp_init, rcfg)
    x = _rand((2, 5, 64), 6)
    _close(t_layers.mlp_apply(p, _t(x), cfg),
           r_layers.mlp_apply(rp, jnp.asarray(x), rcfg))


@pytest.mark.parametrize("tie", [True, False])
def test_embed_unembed(tie):
    rcfg, cfg = _cfgs(tie_embeddings=tie)
    rp, p = _params(r_layers.embedding_init, rcfg)
    toks = np.random.default_rng(7).integers(0, 256, (2, 5)).astype(np.int32)
    x = _rand((2, 5, 64), 8)
    _close(t_layers.embed(p, _t(toks), cfg),
           r_layers.embed(rp, jnp.asarray(toks), rcfg))
    _close(t_layers.unembed(p, _t(x), cfg),
           r_layers.unembed(rp, jnp.asarray(x), rcfg))


def _qkv(b=2, sq=40, skv=40, h=4, kv=2, d=16, seed=0):
    return (_rand((b, sq, h, d), seed), _rand((b, skv, kv, d), seed + 1),
            _rand((b, skv, kv, d), seed + 2))


@pytest.mark.parametrize("window,causal", [(None, True), (16, True),
                                           (None, False), (12, False)])
@pytest.mark.parametrize("chunk", [8, 16, 40, 64])
def test_flash_forward(window, causal, chunk):
    q, k, v = _qkv()
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    pos[1, -6:] = -1                        # padded tail on one row
    ref = r_flash.flash_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                  chunk, window, causal)
    got = t_flash.flash_attention(*map(_t, (q, k, v, pos, pos)), chunk,
                                  window, causal)
    _close(got, ref)
    out, lse = t_flash._flash_fwd_impl(*map(_t, (q, k, v, pos, pos)), chunk,
                                       window, causal)
    r_out, r_lse = r_flash._flash_fwd_impl(
        *map(jnp.asarray, (q, k, v, pos, pos)), chunk, window, causal)
    _close(out, r_out)
    _close(lse, r_lse)


@pytest.mark.parametrize("window,causal,chunk", [
    (None, True, 16), (None, True, 48), (8, True, 16), (None, False, 16),
    (8, False, 32)])
def test_attend_chunked(window, causal, chunk):
    """A few queries against a part-filled cache (empty slots -1), the
    cache not a multiple of the chunk."""
    rcfg, cfg = _cfgs(sliding_window=window, causal=causal, attn_chunk=chunk)
    q, k, v = _qkv(sq=3, skv=40, seed=9)
    kv_pos = np.where(np.arange(40) < 33, np.arange(40), -1)
    kv_pos = np.broadcast_to(kv_pos, (2, 40)).astype(np.int32)
    q_pos = np.array([[30, 31, 32], [20, 25, 32]], np.int32)
    ref = r_layers._attend_chunked(*map(jnp.asarray, (q, k, v)), rcfg,
                                   jnp.asarray(q_pos), jnp.asarray(kv_pos))
    got = t_layers._attend_chunked(*map(_t, (q, k, v)), cfg, _t(q_pos),
                                   _t(kv_pos))
    _close(got, ref)


@pytest.mark.parametrize("qk_norm,qkv_bias", [(False, False), (True, True)])
def test_attention_apply_and_prefill(qk_norm, qkv_bias):
    rcfg, cfg = _cfgs(qk_norm=qk_norm, qkv_bias=qkv_bias, sliding_window=12)
    rp, p = _params(r_layers.attention_init, rcfg)
    x = _rand((2, 20, 64), 10)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    _close(t_layers.attention_apply(p, _t(x), cfg, _t(pos)),
           r_layers.attention_apply(rp, jnp.asarray(x), rcfg,
                                    jnp.asarray(pos)))
    # prefill into a 12-slot ring (the window): the last 12 positions land
    ref, r_c = r_layers.attention_prefill(
        rp, jnp.asarray(x), rcfg, jnp.asarray(pos),
        r_cache.kv_init(rcfg, 2, 64))
    cache = t_cache.kv_init(cfg, 2, 64, device="cpu")
    got, c = t_layers.attention_prefill(p, _t(x), cfg, _t(pos), cache)
    assert c is cache
    _close(got, ref)
    for key in ("k", "v"):
        _close(c[key], r_c[key])
    np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(r_c["pos"]))


def _filled_cache(rcfg, cfg, b, max_len, fill, seed):
    """Both caches after ``fill[i]`` one-token updates of row i.  The
    port's rows are updated together, a row that stops early sitting at
    the empty position as the engine's idle rows do, which writes
    nothing; the reference's are updated each on its own, since its
    ``kv_update`` writes an idle row's slot at the floor remainder
    (fault F7)."""
    r_rows = [r_cache.kv_init(rcfg, 1, max_len) for _ in range(b)]
    c = t_cache.kv_init(cfg, b, max_len, device="cpu")
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    for t in range(max(fill)):
        k, v = _rand((b, kv, hd), seed + 2 * t), _rand((b, kv, hd),
                                                       seed + 2 * t + 1)
        pos = np.where(np.asarray(fill) > t, t, -1_000_000).astype(np.int32)
        for i in np.flatnonzero(pos >= 0):
            r_rows[i], *_ = r_cache.kv_update(
                r_rows[i], jnp.asarray(k[i:i + 1]), jnp.asarray(v[i:i + 1]),
                jnp.asarray(pos[i:i + 1]))
        c, *_ = t_cache.kv_update(c, _t(k), _t(v), _t(pos))
    r_c = jax.tree.map(lambda *rows: jnp.concatenate(rows), *r_rows)
    return r_c, c


@pytest.mark.parametrize("window,causal,max_len,fill", [
    (None, True, 32, [20, 7]),          # full caches, part filled
    (8, True, 32, [30, 19]),            # a ring of 8 past its window
    (None, False, 24, [24, 11]),        # non-causal (an encoder's decode)
])
def test_attention_decode(window, causal, max_len, fill):
    rcfg, cfg = _cfgs(sliding_window=window, causal=causal)
    rp, p = _params(r_layers.attention_init, rcfg, seed=3)
    r_c, c = _filled_cache(rcfg, cfg, 2, max_len, fill, seed=20)
    for kname in ("k", "v"):
        _close(c[kname], r_c[kname])
    np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(r_c["pos"]))
    x = _rand((2, 1, 64), 11)
    position = np.asarray(fill, np.int32)
    ref, r_c = r_layers.attention_decode(rp, jnp.asarray(x), rcfg, r_c,
                                         jnp.asarray(position))
    got, c2 = t_layers.attention_decode(p, _t(x), cfg, c, _t(position))
    assert c2 is c
    _close(got, ref)
    _close(c["k"], r_c["k"])
    np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(r_c["pos"]))


def test_kv_update_idle_row_lands_at_floor_remainder():
    """An idle row (negative position) leaves its floor-remainder slot as
    it was; the reference overwrites it with the empty position, so a
    live entry there is lost (fault F7)."""
    rcfg, cfg = _cfgs()
    slot = (-1_000_000) % 24
    k = _rand((2, 2, 16), 12)
    r_c, c = r_cache.kv_init(rcfg, 2, 24), t_cache.kv_init(cfg, 2, 24,
                                                          device="cpu")
    for pos in (np.array([slot, slot], np.int32),
                np.array([-1_000_000, 5], np.int32)):
        r_c, *_ = r_cache.kv_update(r_c, jnp.asarray(k), jnp.asarray(k),
                                    jnp.asarray(pos))
        c, *_ = t_cache.kv_update(c, _t(k), _t(k), _t(pos))
    assert c["pos"][:, slot].tolist() == [slot, slot]
    assert c["pos"][1, 5] == 5 and (c["pos"] >= 0).sum() == 3
    np.testing.assert_array_equal(c["k"][0, slot].numpy(), k[0])
    assert int(r_c["pos"][0, slot]) == -1_000_000
    r_pos = np.array(r_c["pos"])
    r_pos[0, slot] = slot
    np.testing.assert_array_equal(c["pos"].numpy(), r_pos)


@pytest.mark.parametrize("block", ["attn_mlp", "mamba2", "mlstm", "slstm",
                                   "fourier_mlp"])
def test_block_cache_init(block):
    rcfg, cfg = _cfgs(ssm_state=16, ssm_head_dim=16, sliding_window=8)
    ref = r_cache.block_cache_init(block, rcfg, 2, 32)
    got = t_cache.block_cache_init(block, cfg, 2, 32, device="cpu")
    ref_l, got_l = jax.tree.leaves(ref), jax.tree.leaves(
        got, is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert len(ref_l) == len(got_l)
    for r, g in zip(ref_l, got_l):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_actsharding_is_identity_on_one_card():
    x = torch.ones(2, 3)
    with t_act.activation_spec(None, ("data",), "model"):
        assert t_act.constrain(x) is x
        tree = {"a": x}
        assert t_act.constrain_tree(tree) is tree
    assert r_act.constrain(jnp.ones(2)).shape == (2,)    # the reference's
