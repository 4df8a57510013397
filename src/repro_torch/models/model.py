"""The unified LM: config-driven assembly of every architecture in the pool
(counterpart of :mod:`repro.models.model`).

Depth is ``repeat`` copies of a super-block (``cfg.block_pattern``).
Parameters and caches are dicts of tensors with the reference's key paths,
each leaf of a repeated super-block stacked on a leading ``(repeat, ...)``
axis; the reference's ``lax.scan`` over that axis is a Python loop over
views of the stacked tensors.  Zamba2-style shared blocks live outside the
stack (one copy of the weights, applied every super-block).  Caches are
written in place: a decode or prefill returns the cache it was given.

Entry points:
  init_params / params_from_numpy       param trees (dict-of-dicts)
  forward(params, cfg, tokens=...)      logits, aux
  loss_fn(params, cfg, batch)           scalar loss, metrics
  init_cache / prefill / decode_step    serving path (one token, cached)
  param_count / active_param_count      N for MODEL_FLOPS = 6*N*D

With ``cfg.remat`` each super-block runs under
``torch.utils.checkpoint`` while grad mode is on: only its input is kept
for the backward pass, and the block is recomputed there.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

import repro_torch
from . import actsharding
from . import cache as cache_lib
from . import layers, moe, ssm, xlstm
from .config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype:
    """A config's dtype name (or a torch dtype) as a torch dtype."""
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of a tree of dicts and tuples; with ``rest``,
    ``fn(leaf, *matching nodes of rest)`` (``jax.tree.map`` over several
    trees, ``tree``'s structure leading)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_flatten_with_paths(tree, prefix=()) -> list:
    """``(path, leaf)`` pairs in ``tree_leaves`` order; a path is the
    tuple of dict keys and sequence indices (as strings) down to the
    leaf, as ``jax.tree_util.tree_flatten_with_path`` spells them."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_flatten_with_paths(v, prefix + (str(i),))]
    return [(prefix, tree)]


def tree_map_with_path(fn, tree, prefix=()):
    """``fn(path, leaf)`` on every leaf (paths as in
    :func:`tree_flatten_with_paths`), keeping the tree's structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _stack(trees):
    """One tree whose leaves stack the given trees' leaves on axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def _index(tree, r: int):
    """Views of repeat ``r`` of a stacked tree."""
    return tree_map(lambda t: t[r], tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(gen, blk: str, cfg: ModelConfig):
    if blk == "attn_mlp":
        return {"norm1": layers.norm_init(gen, cfg),
                "attn": layers.attention_init(gen, cfg),
                "norm2": layers.norm_init(gen, cfg),
                "mlp": layers.mlp_init(gen, cfg)}
    if blk == "attn_moe":
        return {"norm1": layers.norm_init(gen, cfg),
                "attn": layers.attention_init(gen, cfg),
                "norm2": layers.norm_init(gen, cfg),
                "moe": moe.moe_init(gen, cfg)}
    if blk == "fourier_mlp":
        return {"norm1": layers.norm_init(gen, cfg),
                "norm2": layers.norm_init(gen, cfg),
                "mlp": layers.mlp_init(gen, cfg)}
    if blk == "mamba2":
        return {"norm": layers.norm_init(gen, cfg),
                "mixer": ssm.mamba2_init(gen, cfg)}
    if blk == "mlstm":
        return {"norm": layers.norm_init(gen, cfg),
                "mixer": xlstm.mlstm_init(gen, cfg)}
    if blk == "slstm":
        return {"norm": layers.norm_init(gen, cfg),
                "mixer": xlstm.slstm_init(gen, cfg)}
    if blk == "shared_attn":
        return {}                       # weights live in params["shared"]
    raise ValueError(blk)


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device="cuda"):
    """Random weights at the reference's scales, drawn from ``generator``
    on ``device`` (a full-width model is made where it runs, never on the
    host first)."""
    dev = repro_torch.device(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"generator on {generator.device}, params asked "
                         f"for on {dev}")
    gen = generator
    params = {"embed": layers.embedding_init(gen, cfg)}
    blocks = []
    for _ in range(cfg.repeat):
        blocks.append({f"b{j}": _block_init(gen, blk, cfg)
                       for j, blk in enumerate(cfg.block_pattern)})
    params["blocks"] = _stack(blocks)
    del blocks
    if "shared_attn" in cfg.block_pattern:
        params["shared"] = {
            "norm1": layers.norm_init(gen, cfg),
            "attn": layers.attention_init(gen, cfg),
            "norm2": layers.norm_init(gen, cfg),
            "mlp": layers.mlp_init(gen, cfg)}
    params["final_norm"] = layers.norm_init(gen, cfg)
    dtype = torch_dtype(cfg.dtype)
    if dtype != torch.float32:
        params = tree_map(lambda a: a.to(dtype), params)
    return params


def _from_numpy(a, dev) -> torch.Tensor:
    a = np.array(a)                     # a writable copy
    if a.dtype.name == "bfloat16":      # ml_dtypes: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(a).to(dev)


def params_from_numpy(tree, cfg: ModelConfig, *, device="cuda"):
    """The reference's ``init_params`` tree, as numpy arrays
    (``jax.tree.map(np.asarray, p)``), as the port's tree on ``device``
    with dtypes kept."""
    want = {f"b{j}" for j in range(len(cfg.block_pattern))}
    if set(tree["blocks"]) != want:
        raise ValueError(f"tree blocks {sorted(tree['blocks'])} do not match "
                         f"the block pattern {cfg.block_pattern}")
    dev = repro_torch.device(device)
    return tree_map(lambda a: _from_numpy(a, dev), tree)


def param_count(tree) -> int:
    return int(sum(int(np.prod(x.shape)) for x in tree_leaves(tree)))


def active_param_count(cfg: ModelConfig, tree) -> int:
    """Params touched per token (MoE: active experts only)."""
    total = param_count(tree)
    if cfg.n_experts == 0:
        return total
    moe_total = sum(
        param_count({k: v for k, v in tree["blocks"][f"b{j}"]["moe"].items()
                     if k in ("wi", "wg", "wo")})
        for j, blk in enumerate(cfg.block_pattern) if blk == "attn_moe")
    inactive = moe_total * (1.0 - cfg.n_experts_active / cfg.n_experts)
    return int(total - inactive)


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------

# mixer blocks: (apply, prefill, decode)
_MIXERS = {
    "mamba2": (ssm.mamba2_apply, ssm.mamba2_prefill, ssm.mamba2_decode),
    "mlstm": (xlstm.mlstm_apply, xlstm.mlstm_prefill, xlstm.mlstm_decode),
    "slstm": (xlstm.slstm_apply, xlstm.slstm_prefill, xlstm.slstm_decode),
}


def _fourier_mlp(bp, x, cfg: ModelConfig):
    from repro_torch.core.spectral import fourier_mix
    # both FFT axes (seq, d_model) whole on the rank: batch rows only
    x = _add(x, actsharding.on_shards(
        lambda h: fourier_mix(h, backend=cfg.fft_backend),
        (layers.norm_apply(bp["norm1"], x, cfg),), (("batch", None, None),),
        ("batch", None, None)))
    return _add(x, layers.mlp_apply(bp["mlp"],
                                    layers.norm_apply(bp["norm2"], x, cfg),
                                    cfg))


def _add(x, y):
    """The residual add.  Under a mesh the block's output y first takes
    the residual's layout (``actsharding.constrain``), so its gradient
    comes back in y's own layout (whole sequence) to the block's
    projections."""
    return x + actsharding.constrain(y)


def _zero(x):
    """A float32 zero scalar beside the activation x (on its mesh)."""
    return actsharding.replicate_like(
        torch.zeros((), dtype=torch.float32, device=x.device), x)


def _block_apply(bp, shared, blk: str, x, cfg: ModelConfig, positions):
    aux = _zero(x)
    if blk in ("attn_mlp", "attn_moe", "shared_attn"):
        sp = shared if blk == "shared_attn" else bp
        x = _add(x, layers.attention_apply(
            sp["attn"], layers.norm_apply(sp["norm1"], x, cfg), cfg,
            positions))
        h = layers.norm_apply(sp["norm2"], x, cfg)
        if blk == "attn_moe":
            y, aux = moe.moe_apply(sp["moe"], h, cfg)
            x = _add(x, y)
        else:
            x = _add(x, layers.mlp_apply(sp["mlp"], h, cfg))
    elif blk == "fourier_mlp":
        x = _fourier_mlp(bp, x, cfg)
    elif blk in _MIXERS:
        x = _add(x, _MIXERS[blk][0](bp["mixer"],
                                    layers.norm_apply(bp["norm"], x, cfg),
                                    cfg))
    else:
        raise ValueError(blk)
    return x, aux


def _inputs(params, cfg: ModelConfig, tokens, embeds, positions):
    if tokens is not None:
        x = layers.embed(params["embed"], tokens, cfg)
        b, s = tokens.shape
    else:
        if embeds is None:
            raise ValueError("need tokens or embeds")
        x = embeds
        b, s = embeds.shape[:2]
    if positions is None:
        positions = actsharding.replicate_like(torch.arange(
            s, dtype=torch.int32, device=x.device).expand(b, s), x)
    return actsharding.constrain(x), positions


def hidden_states(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                  positions=None):
    """Trunk: embeddings -> super-blocks -> final norm.
    Returns (x (B,S,d), aux_loss)."""
    x, positions = _inputs(params, cfg, tokens, embeds, positions)
    shared = params.get("shared")

    def superblock(x, sbp):
        x = actsharding.constrain(x)
        aux = _zero(x)
        for j, blk in enumerate(cfg.block_pattern):
            x, a = _block_apply(sbp[f"b{j}"], shared, blk, x, cfg, positions)
            aux = aux + a
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for r in range(cfg.repeat):
        sbp = _index(params["blocks"], r)
        if remat:
            x, a = checkpoint(superblock, x, sbp, use_reentrant=False)
        else:
            x, a = superblock(x, sbp)
        auxs.append(a)
    x = layers.norm_apply(params["final_norm"], x, cfg)
    return x, torch.stack(auxs).sum()


def _logits(params, cfg: ModelConfig, x):
    """(B, S, V) logits, the padded vocab masked to -1e30.  Under a mesh
    the head is vocab-parallel: each rank's rows against its V/``model``
    slice of the head, the logits left split over V (a caller that needs
    them whole gathers them)."""
    name = "tok" if cfg.tie_embeddings else "head"

    def head(xb, w):
        logits = layers.unembed({name: w}, xb, cfg)
        n = logits.shape[-1]
        if cfg.padded_vocab != cfg.vocab_size:
            lo = actsharding.model_start(n) if n != cfg.padded_vocab else 0
            pad = torch.arange(lo, lo + n, device=xb.device) >= \
                cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        return logits
    return actsharding.on_shards(
        head, (x, params["embed"][name]),
        (("batch", None, None), ("model", None) if name == "tok"
         else (None, "model")), ("batch", None, "model"),
        keep={1: f"embed/{name}"})


def forward(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            positions=None):
    """Returns (logits, aux_loss).  tokens (B,S) or embeds (B,S,d); both
    kinds are accepted whatever ``cfg.input_mode`` says."""
    x, aux = hidden_states(params, cfg, tokens=tokens, embeds=embeds,
                           positions=positions)
    return _logits(params, cfg, x), aux


def _pad_bias(cfg: ModelConfig, dtype, device):
    return torch.where(torch.arange(cfg.padded_vocab, device=device)
                       < cfg.vocab_size, 0.0, -1e30).to(dtype)


class _VocabParallelLL(torch.autograd.Function):
    """Each token's log-likelihood of its label from logits split over the
    vocab (Megatron's vocab-parallel cross entropy): ``logits`` (..., n)
    are this rank's columns [lo, lo + n) of the (..., V) logits; the max,
    the sum of exponentials and the label's logit (from the rank that owns
    it) are all-reduced over ``group``, so every rank returns the whole
    result.  The backward is local: softmax minus the label's one-hot on
    this rank's columns (the collectives carry no gradient)."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        import torch.distributed as dist
        n = logits.shape[-1]
        m = logits.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        s = torch.exp(logits - m[..., None]).sum(dim=-1)
        dist.all_reduce(s, group=group)
        lse = m + torch.log(s)
        own = (labels >= lo) & (labels < lo + n)
        idx = torch.where(own, labels - lo, 0)
        picked = logits.gather(-1, idx[..., None])[..., 0] * own
        dist.all_reduce(picked, group=group)
        ctx.save_for_backward(logits, lse, idx, own)
        return picked - lse

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, own = ctx.saved_tensors
        grad = -torch.exp(logits - lse[..., None]) * g[..., None]
        grad.scatter_add_(-1, idx[..., None], (g * own)[..., None])
        return grad, None, None, None


# sequence-chunk size for the CE head: bounds the live (B, chunk, V) logits
# slab; the full (B, S, V) tensor is never materialised
LOSS_CHUNK = 512


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: dict(tokens|embeds, labels, [mask]).  Next-token CE, computed
    over sequence chunks, each recomputed in the backward pass.  Returns
    (loss, {"ce", "aux"})."""
    x, aux = hidden_states(params, cfg, tokens=batch.get("tokens"),
                           embeds=batch.get("embeds"))
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    b, s, d = x.shape
    c = min(LOSS_CHUNK, s)
    n_chunks = s // c if s % c == 0 else 1
    if s % c != 0:
        c = s

    names = sorted(params["embed"])
    # the head's vocab dim: tok (V, d) when tied, else head (d, V)
    vocab = [("model", None) if n == "tok" else (None, "model")
             for n in names]

    def ce_rows(xb, lb, mb, *emb):
        """Each row's masked log-likelihood sum over the chunk (B,).  On a
        V/``model`` slice of the head the logits stay split and the
        log-sum-exp is distributed (:class:`_VocabParallelLL`)."""
        logits = layers.unembed(dict(zip(names, emb)), xb, cfg)
        n = logits.shape[-1]
        lo = actsharding.model_start(n) if n != cfg.padded_vocab else 0
        bias = _pad_bias(cfg, logits.dtype, xb.device)[lo:lo + n]
        logits = (logits + bias).float()
        if n == cfg.padded_vocab:
            lse = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, lb[..., None].long())[..., 0] - lse
        else:
            ll = _VocabParallelLL.apply(logits, lb.long(), lo,
                                        actsharding.model_group())
        return torch.sum(ll * mb, dim=-1)

    def ce_chunk(xb, lb, mb):
        # on each rank's batch rows and its V/model slice of the head
        emb = [params["embed"][n] for n in names]
        return actsharding.on_shards(
            ce_rows, (xb, lb, mb, *emb),
            (("batch", None, None), ("batch", None), ("batch", None),
             *vocab), ("batch",),
            keep={3 + j: f"embed/{n}" for j, n in enumerate(names)}).sum()

    ce_sum = _zero(x)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        args = (x[:, sl], labels[:, sl], mask[:, sl])
        part = checkpoint(ce_chunk, *args, use_reentrant=False) \
            if torch.is_grad_enabled() else ce_chunk(*args)
        ce_sum = ce_sum - part
    ce = ce_sum / torch.clamp(mask.sum(), min=1.0)
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, *, device="cuda"):
    """Stacked (repeat, ...) caches matching the param stack."""
    dev = repro_torch.device(device)
    dtype = torch_dtype(dtype)
    one = {f"b{j}": cache_lib.block_cache_init(blk, cfg, batch, max_len,
                                               dtype, dev)
           for j, blk in enumerate(cfg.block_pattern)}
    return _stack([one] * cfg.repeat)


def _block_cached(bp, shared, blk: str, x, cfg: ModelConfig, cache,
                  positions, decode: bool):
    """One block of a prefill (positions (B, S)) or a decode step
    (positions (B,)), its cache written in place."""
    if blk in ("attn_mlp", "attn_moe", "shared_attn"):
        sp = shared if blk == "shared_attn" else bp
        h = layers.norm_apply(sp["norm1"], x, cfg)
        if decode:
            y, _ = layers.attention_decode(sp["attn"], h, cfg, cache,
                                           positions)
        else:
            y, _ = layers.attention_prefill(sp["attn"], h, cfg, positions,
                                            cache)
        x = _add(x, y)
        h = layers.norm_apply(sp["norm2"], x, cfg)
        if blk == "attn_moe":
            # decode: dropless; prefill: capacity with headroom (dropless
            # cap=Tg would materialise a (G,E,Tg,d) dispatch tensor)
            y, _ = moe.moe_apply(sp["moe"], h, cfg, dropless=True) if decode \
                else moe.moe_apply(sp["moe"], h, cfg,
                                   cap_scale=cfg.moe_prefill_cap_scale)
            x = _add(x, y)
        else:
            x = _add(x, layers.mlp_apply(sp["mlp"], h, cfg))
    elif blk == "fourier_mlp":
        if decode:
            # parameter-free mixing degenerates at S=1: identity on decode
            x = _add(x, layers.mlp_apply(
                bp["mlp"], layers.norm_apply(bp["norm2"], x, cfg), cfg))
        else:
            x = _fourier_mlp(bp, x, cfg)
    elif blk in _MIXERS:
        h = layers.norm_apply(bp["norm"], x, cfg)
        if decode:
            y, _ = _MIXERS[blk][2](bp["mixer"], h, cfg, cache,
                                   live=positions >= 0)
        else:
            y, _ = _MIXERS[blk][1](bp["mixer"], h, cfg, cache)
        x = _add(x, y)
    else:
        raise ValueError(blk)
    return x


def _run_cached(params, cfg: ModelConfig, x, cache, positions, decode):
    shared = params.get("shared")
    for r in range(cfg.repeat):
        sbp, sbc = _index(params["blocks"], r), _index(cache, r)
        x = actsharding.constrain(x)
        for j, blk in enumerate(cfg.block_pattern):
            x = _block_cached(sbp[f"b{j}"], shared, blk, x, cfg,
                              sbc[f"b{j}"], positions, decode)
    return layers.norm_apply(params["final_norm"], x, cfg)


def prefill(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            cache=None, positions=None):
    """Serving prefill: forward over the prompt, ``cache`` populated in
    place.  Returns (logits (B, S, V), cache).  On DTensors (params,
    batch and caches laid out by ``launch.sharding``, under the caller's
    ``actsharding.activation_spec``) every block runs on local shards and
    writes its cache shards; the logits stay split over V."""
    if cache is None:
        raise ValueError("prefill needs a cache (init_cache)")
    x, positions = _inputs(params, cfg, tokens, embeds, positions)
    x = _run_cached(params, cfg, x, cache, positions, decode=False)
    return _logits(params, cfg, x), cache


def decode_step(params, cfg: ModelConfig, tokens, cache, position):
    """One decode step.  tokens: (B,) int; position: (B,) int32 absolute
    position.  Returns (logits (B, V), cache), the cache updated in place.
    Embedding-input archs (vlm/audio) still decode over tokens.  On
    DTensors as :func:`prefill`."""
    x = layers.embed(params["embed"], tokens[:, None], cfg)
    x = _run_cached(params, cfg, actsharding.constrain(x), cache, position,
                    decode=True)
    return _logits(params, cfg, x)[:, 0], cache
