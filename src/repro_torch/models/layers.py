"""Core transformer layers: norms, RoPE, GQA attention, MLPs, embeddings
(counterpart of :mod:`repro.models.layers`).

Plain functions on tensors and dicts of tensors, init/apply pairs.  Inits
draw from a :class:`torch.Generator` with the reference's scales (the draws
are not JAX's; :func:`repro_torch.models.model.params_from_numpy` carries
the reference's weights across).  Full-sequence attention runs the
streaming-softmax forward of :mod:`repro_torch.models.flash`; one-token
decode runs :func:`repro_torch.kernels.ops.decode_attention`, the
hand-written CUDA kernel on a card tensor and its plain version on a CPU
one.  :func:`_attend_chunked` is the reference's chunked decode formula,
kept as the plain twin the kernel is held against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import actsharding
from .config import ModelConfig

NEG_INF = -1e30
EMPTY_POS = -1_000_000     # position of a padded or unused slot


def _init(gen, shape, scale=None, dtype=torch.float32):
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def _ones(gen, n):
    return torch.ones((n,), dtype=torch.float32, device=gen.device)


def _zeros(gen, n):
    return torch.zeros((n,), dtype=torch.float32, device=gen.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(gen, cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    p = {"scale": _ones(gen, d)}
    if cfg.norm_type == "layernorm":
        p["bias"] = _zeros(gen, d)
    return p


def norm_apply(p, x, cfg: ModelConfig):
    """LayerNorm or RMSNorm over d; under a mesh the result has its whole
    sequence on every rank (:func:`~repro_torch.models.actsharding.
    whole_seq`), the layout every block's projections read."""
    dt = x.dtype
    x32 = x.float()
    if cfg.norm_type == "layernorm":
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        y = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:
        ms = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return actsharding.whole_seq(y.to(dt))


def rms_head_norm(x, scale, eps=1e-6):
    """Per-head RMS norm (qk-norm): x (..., head_dim)."""
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D), positions: (B, S) or (S,)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)           # (D/2,)
    ang = positions[..., None].float() * freqs             # (B, S, D/2)
    cos = torch.cos(ang)[..., None, :]                     # (B, S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_init(gen, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": _init(gen, (d, h * hd)),
        "wk": _init(gen, (d, kv * hd)),
        "wv": _init(gen, (d, kv * hd)),
        "wo": _init(gen, (h * hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros(gen, h * hd)
        p["bk"] = _zeros(gen, kv * hd)
        p["bv"] = _zeros(gen, kv * hd)
    if cfg.qk_norm:
        p["q_norm"] = _ones(gen, hd)
        p["k_norm"] = _ones(gen, hd)
    return p


def _project(p, x, cfg: ModelConfig):
    """q (B, S, H, D), k and v (B, S, KV, D) before RoPE."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = actsharding.split_last(q, h, hd)
    k = actsharding.split_last(k, kv, hd)
    v = actsharding.split_last(v, kv, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    return q, k, v


def _attend_chunked(q, k, v, cfg: ModelConfig, q_positions, kv_positions):
    """Streaming-softmax attention, the reference's decode formula.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D).  Loops over KV chunks with a
    running (max, denom, acc).  Causality and sliding windows are applied
    from positions; the cache is padded to whole chunks with empty slots.
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    chunk = min(cfg.attn_chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=EMPTY_POS)
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kvh, group, hd) * scale
    if not cfg.causal:
        q_positions = torch.full_like(q_positions, skv + 1)  # attend everywhere
    m = torch.full((b, sq, kvh, group), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, sq, kvh, group, hd), dtype=torch.float32,
                      device=q.device)
    for i in range(n_chunks):
        kb = k[:, i * chunk:(i + 1) * chunk]
        vb = v[:, i * chunk:(i + 1) * chunk]
        pb = kv_positions[:, i * chunk:(i + 1) * chunk]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg.float(), kb.float())
        mask = pb[:, None, :] <= q_positions[:, :, None]   # causal
        if cfg.sliding_window is not None:
            mask = mask & (pb[:, None, :] > q_positions[:, :, None]
                           - cfg.sliding_window)
        mask = mask & (pb[:, None, :] >= 0)                # padding
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", pexp, vb.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, hd).to(q.dtype)


_HEADS = ("batch", None, "model", None)    # (B, S, heads, D) on shards


def attention_apply(p, x, cfg: ModelConfig, positions):
    """Full-sequence attention (training / prefill) through the flash
    forward.  Under a mesh, RoPE and the attention run on each rank's
    batch rows and heads (the whole sequence), as
    :func:`~repro_torch.models.actsharding.on_shards` lays them out."""
    from .flash import flash_attention
    b, s, _ = x.shape

    def rope_attend(q, k, v, pos):
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        out = flash_attention(q, k, v, pos, pos, cfg.attn_chunk,
                              cfg.sliding_window, cfg.causal)
        return out.reshape(*out.shape[:2], -1)      # heads stay contiguous

    out = actsharding.on_shards(rope_attend, (*_project(p, x, cfg), positions),
                                (_HEADS, _HEADS, _HEADS, ("batch", None)),
                                ("batch", None, "model"))
    return out @ p["wo"]


def _rope_qk(q, k, positions, cfg: ModelConfig):
    """RoPE on q and k (B, S, heads, D) at positions (B, S), on each
    rank's batch rows and heads under a mesh."""
    return actsharding.on_shards(
        lambda q_, k_, p_: (apply_rope(q_, p_, cfg.rope_theta),
                            apply_rope(k_, p_, cfg.rope_theta)),
        (q, k, positions), (_HEADS, _HEADS, ("batch", None)),
        [_HEADS, _HEADS])


def _attend_cache(cfg: ModelConfig, slots: int, split: bool):
    """The decode attention of q (B, H, D) against a cache's k, v (B, S,
    KV, D) and positions (B, S) at q_pos (B,), as a block of each rank's
    shards.  ``split``: the cache's slots are split over the slot axes, so
    each rank attends over its own and the ranks' partial softmax states,
    and nothing else, are gathered and merged (``slots``, the cache's
    slots in all, weighs the mean of V of a row that sees none)."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.kernels import decode_attention as DA

    def attend(q, k, v, kv_pos, q_pos):
        q = q.contiguous()
        if not cfg.causal:
            q_pos = torch.full_like(q_pos, slots + 1)
        q_pos = q_pos.to(torch.int32).contiguous()
        if not split:
            # the kernel's split follows from its grid, so the whole cache
            # is one chunk (a ring of min(max_len, window) slots need not
            # be a multiple of attn_chunk)
            return ops.decode_attention(q, k, v, kv_pos, q_pos,
                                        window=cfg.sliding_window,
                                        chunk=k.shape[1])
        parts = ops.decode_attention_partial(q, k, v, kv_pos, q_pos,
                                             window=cfg.sliding_window)
        flat = torch.cat([t.reshape(-1) for t in parts])
        n = flat.numel()
        for group in actsharding.slot_groups():
            out = flat.new_empty((dist.get_world_size(group) * flat.numel(),))
            dist.all_gather_into_tensor(out, flat, group=group)
            flat = out
        b, h, d = q.shape
        kvh = k.shape[2]
        gathered = DA.unpack_partial(flat.view(-1, n), b, kvh, h // kvh, d)
        return ops.decode_attention_merge(*gathered, slots, q.dtype)
    return attend


_CACHE = ("batch", "slots", "model", None)    # (B, S, KV, D) on shards


def attention_decode(p, x, cfg: ModelConfig, cache, position):
    """One-token decode with a KV cache (see :mod:`.cache`), written in
    place.  The attention is :func:`repro_torch.kernels.ops.
    decode_attention`: the CUDA kernel on a card tensor, its plain version
    on a CPU one.  Under a mesh it runs on each rank's batch rows and KV
    heads (with their query heads); a cache whose slots are split over the
    data ranks (sequence-parallel) is attended rank by rank and the
    partial softmax states are merged (:func:`_attend_cache`)."""
    from . import cache as cache_lib
    b = x.shape[0]
    q, k, v = _project(p, x, cfg)
    q, k = _rope_qk(q, k, position[:, None], cfg)
    cache, k_all, v_all, kv_pos = cache_lib.kv_update(cache, k[:, 0], v[:, 0],
                                                      position)
    out = attend_cache(q[:, 0], k_all, v_all, kv_pos, position, cfg)
    return out.reshape(b, 1, -1) @ p["wo"], cache


def attend_cache(q, k, v, kv_pos, q_pos, cfg: ModelConfig):
    """The decode attention of q (B, H, D) at q_pos (B,) against a cache's
    k, v (B, S, KV, D) and positions (B, S): on each rank's batch rows
    and KV heads under a mesh, the cache's slot split kept (a split that
    cannot be kept raises, naming the cache)."""
    return actsharding.on_shards(
        _attend_cache(cfg, k.shape[1], actsharding.splits_slots(k, 1)),
        (q, k, v, kv_pos, q_pos),
        (("batch", "model", None), _CACHE, _CACHE, ("batch", "slots"),
         ("batch",)), ("batch", "model", None),
        keep={1: "k cache", 2: "v cache", 3: "pos cache"})


def attention_prefill(p, x, cfg: ModelConfig, positions, cache):
    """Bulk prefill: full-sequence attention + write K/V into the cache (in
    place).

    Only the last min(S, slots) positions are written (a sliding-window ring
    keeps just the window; later positions win by construction, no duplicate
    scatter indices).  Under a mesh the flash forward runs on each rank's
    batch rows and heads, and each rank writes the slots of its cache
    shards (:func:`~repro_torch.models.cache.write_positions`)."""
    from .flash import flash_attention
    from . import cache as cache_lib
    b, s, _ = x.shape
    q, k, v = _project(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)

    def attend(q, k, v, pos):
        out = flash_attention(q, k, v, pos, pos, cfg.attn_chunk,
                              cfg.sliding_window, cfg.causal)
        return out.reshape(*out.shape[:2], -1)      # heads stay contiguous

    out = actsharding.on_shards(attend, (q, k, v, positions),
                                (_HEADS, _HEADS, _HEADS, ("batch", None)),
                                ("batch", None, "model"))
    keep = min(s, cache["k"].shape[1])
    cache_lib.write_positions(cache, k[:, -keep:], v[:, -keep:],
                              positions[:, -keep:])
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg: ModelConfig, d_ff: Optional[int] = None):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.mlp_type == "swiglu":
        p = {"wi": _init(gen, (d, ff)), "wg": _init(gen, (d, ff)),
             "wo": _init(gen, (ff, d))}
    else:
        p = {"wi": _init(gen, (d, ff)), "wo": _init(gen, (ff, d))}
    if cfg.mlp_bias:
        p["bi"] = _zeros(gen, ff)
        p["bo"] = _zeros(gen, d)
    return p


def mlp_apply(p, x, cfg: ModelConfig):
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif cfg.mlp_type == "gelu":
        h = x @ p["wi"]
        if cfg.mlp_bias:
            h = h + p["bi"]
        h = F.gelu(h, approximate="tanh")         # jax.nn.gelu's default
    elif cfg.mlp_type == "relu2":                 # nemotron-4 squared-ReLU
        h = F.relu(x @ p["wi"]).square()
    else:
        raise ValueError(cfg.mlp_type)
    out = h @ p["wo"]
    if cfg.mlp_bias:
        out = out + p["bo"]
    return out


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------

def embedding_init(gen, cfg: ModelConfig):
    p = {"tok": _init(gen, (cfg.padded_vocab, cfg.d_model), scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = _init(gen, (cfg.d_model, cfg.padded_vocab))
    return p


def embed(p, tokens, cfg: ModelConfig):
    """tokens (B, S) -> (B, S, d).  Under a mesh the lookup is
    vocab-parallel (Megatron's ``VocabParallelEmbedding``): each rank looks
    its batch rows up in its V/``model`` slice of ``tok`` (gathered over
    the data axes only), ids outside the slice give zeros, and the result
    is a partial sum over ``model``.  The lookup's ``index_put`` gradient
    stays inside ``local_map`` (DTensor's own fails on torch 2.11)."""
    def lookup(t, tok):
        n = tok.shape[0]
        if n == cfg.padded_vocab:                # the table whole
            return tok[t]
        lo = actsharding.model_start(n)
        own = (t >= lo) & (t < lo + n)
        return tok[torch.where(own, t - lo, 0)] * own[..., None].to(tok.dtype)
    return actsharding.on_shards(
        lookup, (tokens, p["tok"]), (("batch", None), ("model", None)),
        actsharding.PartialSum("model", ("batch", None, None)),
        keep={1: "embed/tok"})


def unembed(p, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return x @ p["tok"].T
    return x @ p["head"]
