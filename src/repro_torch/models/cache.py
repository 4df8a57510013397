"""Decode-time state: KV caches (full + sliding-window ring), SSM and xLSTM
recurrent states (counterpart of :mod:`repro.models.cache`).

A cache is a dict of tensors (a tuple for sLSTM), stacked along a leading
``repeat`` axis by :func:`repro_torch.models.model.init_cache`.  KV caches
write at ``position`` (full) or ``position % window`` (ring) and carry an
explicit per-slot position plane: attention masking reads positions, never
pointer arithmetic, so ring wraparound falls out of the same position
predicates as training (sliding window, causality and emptiness).  Writes
are in place: a layer's cache is a view of the stacked tensors.
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


def kv_update(cache, k_new, v_new, position):
    """Insert one token's K/V in place.  k_new/v_new: (B, KV, D); position:
    (B,).  A row decoded at a negative position (an unused engine slot)
    writes nothing: its slot at the floor remainder keeps what it held.

    Returns (cache, k_all, v_all, kv_positions) where kv_positions carries
    -1 for empty slots (masked off by the attention's position predicate).
    """
    slots = cache["k"].shape[1]
    b = k_new.shape[0]
    idx = torch.remainder(position, slots)
    rows = torch.arange(b, device=k_new.device)
    live = position >= 0
    for key, new in (("k", k_new), ("v", v_new), ("pos", position)):
        dst = cache[key]
        dst[rows, idx] = _where_rows(live, new.to(dst.dtype), dst[rows, idx])
    return cache, cache["k"], cache["v"], cache["pos"]


def _where_rows(live, new, old):
    return torch.where(live.view(-1, *(1,) * (new.dim() - 1)), new, old)


def write_rows(dst, src, live):
    """``dst.copy_(src)`` for the rows (leading axis) where ``live`` (B,)
    holds: a recurrent decode leaves the state of a row decoded at a
    negative position (an unused engine slot) as it was."""
    dst.copy_(_where_rows(live, src.to(dst.dtype), dst))


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
