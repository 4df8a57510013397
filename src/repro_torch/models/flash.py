"""Streaming-softmax (flash) attention with a hand-written backward
(counterpart of :mod:`repro.models.flash`).

Autograd through the chunk loop would save every per-chunk intermediate
for the backward pass.  The flash formulation saves only (q, k, v, out,
lse) and *recomputes* the probability blocks in the backward loop: the
FlashAttention-2 residual set, in plain PyTorch as the reference's is in
plain JAX (its kernel budget is the FFT hot spots).

Supports GQA grouping, causal masking, sliding windows and padding via
position predicates: the same semantics as the chunked decode formula in
:func:`repro_torch.models.layers._attend_chunked`.  A query with no
visible key keeps the reference's arithmetic: its running max stays at
``NEG_INF``, so every masked score gives ``p = 1`` (the mean of the
chunk's V forward, and the same ``p`` backward, where ``NEG_INF +
log(l)`` rounds back to ``NEG_INF``).
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


def _pad_chunks(k, v, kv_pos, chunk):
    """K/V and their positions padded to whole chunks (position -1)."""
    skv = k.shape[1]
    c = min(chunk, skv)
    nc = -(-skv // c)
    pad = nc * c - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    return k, v, kv_pos, c, nc


def _scores(qg, kb, pb, q_pos, window, causal):
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb.float())
    msk = _mask(pb, q_pos, window, causal)
    return torch.where(msk[:, :, None, None, :], s, NEG_INF)


def _flash_fwd_impl(q, k, v, q_pos, kv_pos, chunk, window, causal):
    """Returns (out (B, Sq, H, D) in q's dtype, lse (B, Sq, KV, G))."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    k, v, kv_pos, c, nc = _pad_chunks(k, v, kv_pos, chunk)
    scale = 1.0 / math.sqrt(d)
    qg = (q * scale).reshape(b, sq, kvh, g, d).float()
    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, sq, kvh, g, d), dtype=torch.float32,
                      device=q.device)
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        s = _scores(qg, k[:, sl], kv_pos[:, sl], q_pos, window, causal)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p,
                                                    v[:, sl].float())
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).reshape(b, sq, h, d).to(q.dtype)
    lse = m + torch.log(l_safe)                   # (B,Sq,KV,G)
    return out, lse


def _flash_bwd(q, k, v, q_pos, kv_pos, out, lse, dout, chunk, window,
               causal):
    """dq, dk, dv from the saved residuals, the probability blocks
    recomputed chunk by chunk: delta = rowsum(dout * out),
    p = exp(s - lse), ds = p * (dp - delta)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kp, vp, kv_pos, c, nc = _pad_chunks(k, v, kv_pos, chunk)
    scale = 1.0 / math.sqrt(d)
    qg = (q * scale).reshape(b, sq, kvh, g, d).float()
    dog = dout.reshape(b, sq, kvh, g, d).float()
    og = out.reshape(b, sq, kvh, g, d).float()
    delta = (dog * og).sum(dim=-1)                # (B,Sq,KV,G)
    dq = torch.zeros_like(qg)
    dk = qg.new_zeros((b, nc * c, kvh, d))
    dv = qg.new_zeros((b, nc * c, kvh, d))
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        kb, vb = kp[:, sl].float(), vp[:, sl].float()
        s = _scores(qg, kb, kv_pos[:, sl], q_pos, window, causal)
        p = torch.exp(s - lse[..., None])         # (B,Sq,KV,G,C)
        dv[:, sl] = torch.einsum("bqkgc,bqkgd->bckd", p, dog)
        dp = torch.einsum("bqkgd,bckd->bqkgc", dog, vb)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bqkgc,bckd->bqkgd", ds, kb)
        dk[:, sl] = torch.einsum("bqkgc,bqkgd->bckd", ds, qg)
    # the scale folds into qg: dL/dq = scale * dL/dqg; dk already uses qg
    dq = (dq * scale).reshape(b, sq, h, d).to(q.dtype)
    return dq, dk[:, :skv].to(k.dtype), dv[:, :skv].to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, chunk, window, causal):
        out, lse = _flash_fwd_impl(q, k, v, q_pos, kv_pos, chunk, window,
                                   causal)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.args = (chunk, window, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.saved_tensors, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, q_pos, kv_pos, chunk, window, causal):
    """q: (B,Sq,H,D); k,v: (B,Skv,KV,D); positions int32 (B,S*).
    Returns (B,Sq,H,D).  Differentiable in q, k, v."""
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos, chunk, window,
                                 causal)
