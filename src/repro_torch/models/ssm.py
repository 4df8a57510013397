"""Mamba2 (SSD) mixer block (counterpart of :mod:`repro.models.ssm`):
chunked parallel scan for training/prefill, O(1) recurrent state for
decode.

Follows the state-space-duality formulation (Dao & Gu, 2024): per head h,
    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t x_t^T     (state: P x N)
    y_t = C_t . h_t + D_h x_t
computed chunk-parallel: an intra-chunk quadratic term plus an inter-chunk
state scan.  The short causal conv on the (x, B, C) streams can run
through the FFT library (``cfg.use_fft_conv``): the port's
:func:`repro_torch.core.fftconv.fft_conv`, which on ``fft_backend="cuda"``
runs the fused spectral-convolution kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import actsharding
from .cache import write_rows
from .config import ModelConfig
from .layers import _init, _ones, _zeros


def mamba2_init(gen, cfg: ModelConfig):
    d = cfg.d_model
    din = cfg.d_inner
    ns = cfg.ssm_state
    nh = cfg.ssm_heads
    conv_ch = din + 2 * ns
    dev = gen.device
    return {
        # in_proj emits [z (gate), x, B, C, dt]
        "in_proj": _init(gen, (d, 2 * din + 2 * ns + nh)),
        "conv_w": _init(gen, (cfg.ssm_conv, conv_ch), scale=0.5),
        "conv_b": _zeros(gen, conv_ch),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "d_skip": _ones(gen, nh),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, nh,
                                                        device=dev))),
        "out_proj": _init(gen, (din, d)),
        "out_norm": _ones(gen, din),
    }


def _causal_conv(u, w, b, cfg: ModelConfig, init_state=None):
    """Depthwise causal conv along seq: u (B, S, C), w (K, C).  Under a
    mesh it runs on each rank's batch rows and channels (the whole
    sequence, so the conv kernel sees its FFT axis whole)."""
    if init_state is None:
        return actsharding.on_shards(
            lambda u_, w_, b_: _causal_conv_local(u_, w_, b_, cfg),
            (u, w, b), (("batch", None, "model"), (None, "model"),
                        ("model",)), ("batch", None, "model"))
    return _causal_conv_local(u, w, b, cfg, init_state)


def _causal_conv_local(u, w, b, cfg: ModelConfig, init_state=None):
    k = w.shape[0]
    if cfg.use_fft_conv and init_state is None:
        from repro_torch.core.fftconv import fft_conv
        # (B, S, C) -> (B, C, S) signals, depthwise kernels (C, K).  The
        # block's conv correlates (y[t] = sum_i w[i] u[t-K+1+i], as the
        # direct branch and mamba2_decode do) and fft_conv convolves, so
        # the filter goes in reversed; the reference passes it as is
        # (ROADMAP §3 F6)
        y = fft_conv(u.movedim(-1, -2), w.flip(0).T[None],  # broadcast batch
                     backend=cfg.fft_backend)
        y = y.movedim(-2, -1)
    else:
        if init_state is None:
            up = F.pad(u, (0, 0, k - 1, 0))
        else:
            up = torch.cat([init_state, u], dim=1)
        y = sum(up[:, i:i + u.shape[1]] * w[i] for i in range(k))
    return F.silu(y + b)


def _ssd_chunked(x, dt, a, b_in, c_in, d_skip, cfg: ModelConfig,
                 init_state=None):
    """Chunk-parallel SSD.

    x: (B, S, H, P); dt: (B, S, H); a: (H,) negative decay rates;
    b_in/c_in: (B, S, N).  Returns y (B, S, H, P) and final state
    (B, H, P, N).
    """
    bsz, s, nh, hp = x.shape
    ns = b_in.shape[-1]
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the SSM "
                         f"chunk {q}")
    nc = s // q

    da = dt * a                                            # (B, S, H) <= 0
    xc = x.reshape(bsz, nc, q, nh, hp).float()
    dtc = dt.reshape(bsz, nc, q, nh)
    dac = da.reshape(bsz, nc, q, nh)
    bc = b_in.reshape(bsz, nc, q, ns).float()
    cc = c_in.reshape(bsz, nc, q, ns).float()

    seg = torch.cumsum(dac, dim=2)                         # within-chunk csum
    # intra-chunk: L[t, u] = exp(seg_t - seg_u) for u <= t.  The mask
    # goes in before the exp: above the diagonal seg_t - seg_u > 0 and
    # overflows over a long chunk, and where(mask, exp(rel), 0)'s
    # backward then multiplies that inf by 0 (ROADMAP §3 F9)
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]    # (B,NC,q,q,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    l_mat = torch.exp(torch.where(tri[None, None, :, :, None], rel,
                                  -math.inf))
    cb = torch.einsum("bctn,bcun->bctu", cc, bc)           # (B,NC,q,q)
    dx = dtc[..., None] * xc                               # (B,NC,q,H,P)
    y_intra = torch.einsum("bctuh,bcuhp->bcthp", cb[..., None] * l_mat, dx)

    # chunk-final states: S_c = sum_u exp(seg_end - seg_u) B_u (dt_u x_u)
    decay_to_end = torch.exp(seg[:, :, -1:, :] - seg)      # (B,NC,q,H)
    state_c = torch.einsum("bcun,bcuhp->bchpn", bc,
                           decay_to_end[..., None] * dx)

    # inter-chunk scan: carry running state across chunks
    chunk_decay = torch.exp(seg[:, :, -1, :])              # (B,NC,H)
    h = (torch.zeros((bsz, nh, hp, ns), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + state_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (B,NC,H,P,N)

    # inter-chunk contribution: y_t += C_t . (decay_from_start_t * h_prev)
    decay_from_start = torch.exp(seg)                      # (B,NC,q,H)
    y_inter = torch.einsum("bctn,bchpn->bcthp", cc, h_prevs) \
        * decay_from_start[..., None]

    y = (y_intra + y_inter).reshape(bsz, s, nh, hp)
    y = y + d_skip[None, None, :, None] * x
    return y.to(x.dtype), h


def _split_proj(p, u, cfg: ModelConfig):
    din, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = u[..., :din]
    xbc = u[..., din:din + din + 2 * ns]
    dt_raw = u[..., -nh:]
    return z, xbc, dt_raw


def _gated_out(p, y, z, x_dtype):
    """silu gate, grouped RMS norm over the inner dim, output projection."""
    y = y * F.silu(z)
    y32 = y.float()
    ms = y32.square().mean(dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(ms + 1e-6) * p["out_norm"]).to(x_dtype)
    return y @ p["out_proj"]


def _mixer(p, x, cfg: ModelConfig):
    """The full-sequence mixer; returns (out, raw conv input, final SSM
    state)."""
    bsz, s, _ = x.shape
    din, ns, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    u = x @ p["in_proj"]
    z, xbc_raw, dt_raw = _split_proj(p, u, cfg)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"], cfg)
    xin = xbc[..., :din].reshape(bsz, s, nh, hp)
    b_in = xbc[..., din:din + ns]
    c_in = xbc[..., din + ns:]
    dt = F.softplus(dt_raw + p["dt_bias"])                 # (B,S,H)
    a = -torch.exp(p["a_log"])
    # on each rank's batch rows and heads; B and C are every head's
    y, h_last = actsharding.on_shards(
        lambda *t: _ssd_chunked(*t, cfg), (xin, dt, a, b_in, c_in,
                                           p["d_skip"]),
        (("batch", None, "model", None), ("batch", None, "model"),
         ("model",), ("batch", None, None), ("batch", None, None),
         ("model",)),
        [("batch", None, "model", None), ("batch", "model", None, None)])
    return _gated_out(p, y.reshape(bsz, s, din), z, x.dtype), xbc_raw, h_last


def mamba2_apply(p, x, cfg: ModelConfig):
    """Full-sequence mixer: x (B, S, d) -> (B, S, d)."""
    return _mixer(p, x, cfg)[0]


def mamba2_prefill(p, x, cfg: ModelConfig, state):
    """Full-sequence mixer that also returns decode state (conv tail + SSM),
    written into ``state`` in place (on each rank's shards under a mesh)."""
    s = x.shape[1]
    out, xbc_raw, h_last = _mixer(p, x, cfg)
    k = p["conv_w"].shape[0]
    tail = F.pad(xbc_raw, (0, 0, max(k - 1 - s, 0), 0))[:, -(k - 1):]
    write_rows(state["conv"], tail)
    write_rows(state["ssm"], h_last)
    return out, state


def _conv_step(conv, xbc, w, b):
    """One step of the depthwise conv from its ring state (B, K-1, C):
    the activated output (B, 1, C) and the whole window (B, K, C)."""
    conv_in = torch.cat([conv, xbc.to(conv.dtype)], dim=1)
    y = sum(conv_in[:, i:i + 1] * w[i] for i in range(w.shape[0]))
    return F.silu(y + b), conv_in


def _ssm_step(h, xin, b_in, c_in, dt, a, d_skip):
    """One SSM step of heads xin (B, H, P) from the state h (B, H, P, N):
    the output (B, H, P) and the new state."""
    g = torch.exp(dt * a)                                  # (B,H)
    h = h * g[..., None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", xin.float(), b_in.float(), dt.float())
    y = torch.einsum("bn,bhpn->bhp", c_in.float(), h)
    return y + d_skip[None, :, None] * xin, h


def mamba2_decode(p, x, cfg: ModelConfig, state, live):
    """One-token decode: x (B, 1, d); state dict w/ 'conv' and 'ssm',
    updated in place for the rows where ``live`` (B,) holds.  Under a mesh
    the conv runs on each rank's rows (its channels whole, as the state
    keeps them) and the SSM step on its rows and the heads its state
    holds."""
    bsz = x.shape[0]
    din, ns, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    u = x @ p["in_proj"]
    z, xbc, dt_raw = _split_proj(p, u, cfg)
    rows = ("batch", None, None)
    xbc, conv_in = actsharding.on_shards(
        _conv_step, (state["conv"], xbc, p["conv_w"], p["conv_b"]),
        (rows, rows, (None, None), (None,)), [rows, rows])
    xin = xbc[..., :din].reshape(bsz, nh, hp)
    b_in = xbc[:, 0, din:din + ns]
    c_in = xbc[:, 0, din + ns:]
    dt = F.softplus(dt_raw[:, 0] + p["dt_bias"])           # (B,H)
    a = -torch.exp(p["a_log"])
    hs = actsharding.model_split(state["ssm"], 1)
    y, h = actsharding.on_shards(
        _ssm_step, (state["ssm"], xin, b_in, c_in, dt, a, p["d_skip"]),
        (("batch", hs, None, None), ("batch", hs, None), ("batch", None),
         ("batch", None), ("batch", hs), (hs,), (hs,)),
        [("batch", hs, None), ("batch", hs, None, None)])
    write_rows(state["conv"], conv_in[:, 1:], live)
    write_rows(state["ssm"], h, live)
    return _gated_out(p, y.reshape(bsz, 1, din), z, x.dtype), state
