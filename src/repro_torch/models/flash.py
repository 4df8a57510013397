"""Streaming-softmax (flash) attention, forward (counterpart of
:mod:`repro.models.flash`).

Supports GQA grouping, causal masking, sliding windows and padding via
position predicates: the same semantics as the chunked decode formula in
:func:`repro_torch.models.layers._attend_chunked`.  The reference's
custom-VJP backward (saving only q, k, v, out and the log-sum-exp, and
recomputing the probability blocks) comes with training, ROADMAP 'Modules
to port' item 14b; until then a backward through :func:`flash_attention`
raises.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _mask(pb, qp, window, causal):
    m = pb[:, None, :] >= 0                       # padding
    if causal:
        m = m & (pb[:, None, :] <= qp[:, :, None])
    if window is not None:
        m = m & (pb[:, None, :] > qp[:, :, None] - window)
    return m                                      # (B, Sq, C)


def _flash_fwd_impl(q, k, v, q_pos, kv_pos, chunk, window, causal):
    """Returns (out (B, Sq, H, D) in q's dtype, lse (B, Sq, KV, G))."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    c = min(chunk, skv)
    nc = -(-skv // c)
    pad = nc * c - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    scale = 1.0 / math.sqrt(d)
    qg = (q * scale).reshape(b, sq, kvh, g, d).float()
    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, sq, kvh, g, d), dtype=torch.float32,
                      device=q.device)
    for i in range(nc):
        kb = k[:, i * c:(i + 1) * c].float()
        vb = v[:, i * c:(i + 1) * c].float()
        pb = kv_pos[:, i * c:(i + 1) * c]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb)
        msk = _mask(pb, q_pos, window, causal)
        s = torch.where(msk[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).reshape(b, sq, h, d).to(q.dtype)
    lse = m + torch.log(l_safe)                   # (B,Sq,KV,G)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, chunk, window, causal):
        out, _ = _flash_fwd_impl(q, k, v, q_pos, kv_pos, chunk, window,
                                 causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            "the flash attention backward comes with training: ROADMAP "
            "'Modules to port' item 14b")


def flash_attention(q, k, v, q_pos, kv_pos, chunk, window, causal):
    """q: (B,Sq,H,D); k,v: (B,Skv,KV,D); positions int32 (B,S*).
    Returns (B,Sq,H,D).  Forward only (see the module docstring)."""
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos, chunk, window,
                                 causal)
