"""Decode-time state: KV caches (full + sliding-window ring), SSM and xLSTM
recurrent states (counterpart of :mod:`repro.models.cache`).

A cache is a dict of tensors (a tuple for sLSTM), stacked along a leading
``repeat`` axis by :func:`repro_torch.models.model.init_cache`.  KV caches
write at ``position`` (full) or ``position % window`` (ring) and carry an
explicit per-slot position plane: attention masking reads positions, never
pointer arithmetic, so ring wraparound falls out of the same position
predicates as training (sliding window, causality and emptiness).  Writes
are in place: a layer's cache is a view of the stacked tensors.

A cache of DTensors (laid out by ``launch.sharding.cache_shardings``) is
written on each rank's local shards: the new rows are brought to the
cache's batch and head split, and a rank writes only the slots it holds
(in the sequence-parallel layout, slot ``position % slots`` lives on one
rank).  No write gathers a cache.
"""
from __future__ import annotations

import torch

from .config import ModelConfig


def kv_init(cfg: ModelConfig, batch: int, max_len: int,
            dtype=torch.float32, device="cuda"):
    """KV cache for one attention layer.  Ring-sized for SWA archs."""
    slots = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, slots, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, slots, kv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, slots), -1, dtype=torch.int32,
                          device=device),
    }


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _slice_of(t, dim: int):
    """(lo, n): this rank's slice of the DTensor ``t`` along ``dim`` (the
    mesh dims that split it in order, the first major)."""
    from torch.distributed.tensor import Shard
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    k, parts = 0, 1
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            k = k * mesh.size(i) + coord[i]
            parts *= mesh.size(i)
    n = t.shape[dim] // parts
    return k * n, n


def _local_like(src, dst, dims: dict):
    """The local block of ``src`` redistributed so that its dim i is split
    as ``dst``'s dim ``dims[i]`` is, whole along every other dim (a plain
    ``src`` is taken as replicated)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    back = {v: k for k, v in dims.items()}
    pl = [Shard(back[p.dim]) if isinstance(p, Shard) and p.dim in back
          else Replicate() for p in dst.placements]
    mesh = dst.device_mesh
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    return src.redistribute(mesh, pl).to_local()


_KV_DIMS = {0: 0, 1: 2, 2: 3}          # (B, KV, D) into (B, S, KV, D)


def kv_update(cache, k_new, v_new, position):
    """Insert one token's K/V in place.  k_new/v_new: (B, KV, D); position:
    (B,).  A row decoded at a negative position (an unused engine slot)
    writes nothing: its slot at the floor remainder keeps what it held.

    Returns (cache, k_all, v_all, kv_positions) where kv_positions carries
    -1 for empty slots (masked off by the attention's position predicate).
    """
    if _is_dtensor(cache["k"]):
        _kv_update_local(cache, k_new, v_new, position)
        return cache, cache["k"], cache["v"], cache["pos"]
    slots = cache["k"].shape[1]
    b = k_new.shape[0]
    idx = torch.remainder(position, slots)
    rows = torch.arange(b, device=k_new.device)
    live = position >= 0
    for key, new in (("k", k_new), ("v", v_new), ("pos", position)):
        dst = cache[key]
        dst[rows, idx] = _where_rows(live, new.to(dst.dtype), dst[rows, idx])
    return cache, cache["k"], cache["v"], cache["pos"]


def _kv_update_local(cache, k_new, v_new, position):
    """:func:`kv_update` on each rank's shards: the rank that holds slot
    ``position % slots`` of a row writes it (one index a row, so no two
    writes meet)."""
    slots = cache["k"].shape[1]
    lo, n = _slice_of(cache["k"], 1)
    pos = _local_like(position, cache["pos"], {0: 0})
    idx = torch.remainder(pos, slots) - lo
    own = (pos >= 0) & (idx >= 0) & (idx < n)
    at = idx.clamp(0, n - 1)
    rows = torch.arange(pos.shape[0], device=pos.device)
    for key, new, dims in (("k", k_new, _KV_DIMS), ("v", v_new, _KV_DIMS),
                           ("pos", position, {0: 0})):
        dst = cache[key].to_local()
        src = _local_like(new, cache[key], dims).to(dst.dtype)
        dst[rows, at] = _where_rows(own, src, dst[rows, at])


def write_positions(cache, k, v, pos):
    """A prefill's K/V (B, T, KV, D) at positions ``pos`` (B, T), T <= the
    cache's slots and no two of a row's positions on one slot, written in
    place at ``pos % slots``.  On DTensors each rank fills the slots it
    holds from the steps that land there (a gather, so no two writes meet)."""
    slots = cache["k"].shape[1]
    idx = pos % slots
    if not _is_dtensor(cache["k"]):
        rows = torch.arange(k.shape[0], device=k.device)[:, None]
        cache["k"][rows, idx] = k.to(cache["k"].dtype)
        cache["v"][rows, idx] = v.to(cache["v"].dtype)
        cache["pos"][rows, idx] = pos.to(torch.int32)
        return cache
    lo, n = _slice_of(cache["k"], 1)
    idx = _local_like(idx, cache["pos"], {0: 0})
    b, t = idx.shape
    # the step that writes each slot of the row, -1 where none does
    step = torch.full((b, slots), -1, dtype=torch.long, device=idx.device)
    step.scatter_(1, idx.long(), torch.arange(t, device=idx.device)
                  .expand(b, t))
    step = step[:, lo:lo + n]
    has = step >= 0
    at = step.clamp(min=0)
    dims4 = {0: 0, 2: 2, 3: 3}
    for key, new, dims in (("k", k, dims4), ("v", v, dims4),
                           ("pos", pos, {0: 0})):
        dst = cache[key].to_local()
        src = _local_like(new, cache[key], dims).to(dst.dtype)
        tail = src.shape[2:]
        got = src.gather(1, at.view(b, n, *(1,) * len(tail))
                         .expand(b, n, *tail))
        dst.copy_(torch.where(has.view(b, n, *(1,) * len(tail)), got, dst))
    return cache


def _where_rows(live, new, old):
    return torch.where(live.view(-1, *(1,) * (new.dim() - 1)), new, old)


def write_rows(dst, src, live=None):
    """``dst.copy_(src)`` for the rows (leading axis) where ``live`` (B,)
    holds (every row with None): a recurrent decode leaves the state of a
    row decoded at a negative position (an unused engine slot) as it was.
    A DTensor ``dst`` is written on its local shards, ``src`` (and
    ``live``) first brought to its layout."""
    if _is_dtensor(dst):
        dims = {i: i for i in range(dst.ndim)}
        src = _local_like(src, dst, dims)
        live = None if live is None else _local_like(live, dst, {0: 0})
        dst = dst.to_local()
    src = src.to(dst.dtype)
    dst.copy_(src if live is None else _where_rows(live, src, dst))


def ssm_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device="cuda"):
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=torch.float32,
                           device=device),
    }


def mlstm_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cuda"):
    din = 2 * cfg.d_model
    nh = cfg.n_heads
    dh = din // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, 3, din), dtype=dtype, device=device),
        "c": torch.zeros((batch, nh, dh, dh), **f32),
        "n": torch.zeros((batch, nh, dh), **f32),
        "m": torch.full((batch, nh), -30.0, **f32),
    }


def slstm_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cuda"):
    nh = cfg.n_heads
    dh = cfg.slstm_head_dim or cfg.d_model // nh
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, nh, dh), **f32),
            torch.zeros((batch, nh, dh), **f32),
            torch.full((batch, nh, dh), -30.0, **f32),
            torch.zeros((batch, nh, dh), **f32))


def block_cache_init(block: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.float32, device="cuda"):
    if block in ("attn_mlp", "attn_moe", "shared_attn"):
        return kv_init(cfg, batch, max_len, dtype, device)
    if block == "mamba2":
        return ssm_state_init(cfg, batch, dtype, device)
    if block == "mlstm":
        return mlstm_state_init(cfg, batch, dtype, device)
    if block == "slstm":
        return slstm_state_init(cfg, batch, dtype, device)
    if block == "fourier_mlp":
        return {}                     # parameter-free mixer: no decode state
    raise ValueError(block)
