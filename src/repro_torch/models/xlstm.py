"""xLSTM blocks (counterpart of :mod:`repro.models.xlstm`): mLSTM (matrix
memory, chunkwise-parallel) and sLSTM (scalar memory, sequential).  Beck et
al. 2024 (arXiv:2405.04517).

mLSTM is a gated linear-attention recurrence:
    m_t = max(f~_t + m_{t-1}, i~_t)                       (stabilizer)
    C_t = e^{f~_t+m_{t-1}-m_t} C_{t-1} + e^{i~_t-m_t} k_t v_t^T
    n_t = e^{f~_t+m_{t-1}-m_t} n_{t-1} + e^{i~_t-m_t} k_t
    h_t = (C_t^T q_t) / max(|n_t . q_t|, e^{-m_t})
Training/prefill use the exact chunkwise form (intra-chunk QxQ decay matrix
+ inter-chunk state loop); decode updates (C, n, m) in O(1).

sLSTM has recurrent gate connections (h_{t-1} enters every gate), so it is
sequential: a Python loop over time with per-head block-diagonal recurrent
weights.  Decode states are written in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import actsharding
from .cache import write_rows
from .config import ModelConfig
from .layers import _init, _ones, _zeros

LOG_EPS = -30.0


def _rms_out(h, scale, dtype):
    h32 = h.float()
    ms = h32.square().mean(dim=-1, keepdim=True)
    return (h32 * torch.rsqrt(ms + 1e-6) * scale).to(dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen, cfg: ModelConfig):
    d = cfg.d_model
    din = 2 * d                                   # proj factor 2
    nh = cfg.n_heads
    return {
        "up": _init(gen, (d, 2 * din)),           # -> (x branch, z gate)
        "conv_w": _init(gen, (4, din), scale=0.5),
        "conv_b": _zeros(gen, din),
        "wq": _init(gen, (din, din)),
        "wk": _init(gen, (din, din)),
        "wv": _init(gen, (din, din)),
        "wi": _init(gen, (din, nh), scale=0.02),
        "bi": _zeros(gen, nh),
        "wf": _init(gen, (din, nh), scale=0.02),
        "bf": torch.full((nh,), 3.0, device=gen.device),  # open forget gates
        "out_norm": _ones(gen, din),
        "down": _init(gen, (din, d)),
    }


def _mlstm_chunked(q, k, v, ilog, flog, chunk, init_state=None):
    """q,k,v: (B,S,H,D); ilog/flog: (B,S,H) log-space gates.
    Returns h (B,S,H,D) and the final (C, n, m) state."""
    bsz, s, nh, dh = q.shape
    qc = min(chunk, s)
    if s % qc:
        raise ValueError(f"sequence {s} is not a multiple of the mLSTM "
                         f"chunk {qc}")
    nc = s // qc
    scale = 1.0 / math.sqrt(dh)

    def rs(t):
        return t.reshape(bsz, nc, qc, *t.shape[2:])

    qch, kch, vch = rs(q).float(), rs(k).float(), rs(v).float()
    ich, fch = rs(ilog), rs(flog)
    fcs = torch.cumsum(fch, dim=2)                       # F_t within chunk

    # intra-chunk log decay: D~[t,u] = F_t - F_u + i~_u  (u <= t)
    dlog = (fcs[:, :, :, None, :] - fcs[:, :, None, :, :]
            + ich[:, :, None, :, :])
    tri = torch.tril(torch.ones((qc, qc), dtype=torch.bool, device=q.device))
    dlog = torch.where(tri[None, None, :, :, None], dlog, -math.inf)

    if init_state is None:
        f32 = dict(dtype=torch.float32, device=q.device)
        c_prev = torch.zeros((bsz, nh, dh, dh), **f32)
        n_prev = torch.zeros((bsz, nh, dh), **f32)
        m_prev = torch.full((bsz, nh), LOG_EPS, **f32)
    else:
        c_prev, n_prev, m_prev = init_state

    hs = []
    for ci in range(nc):
        qb, kb, vb = qch[:, ci], kch[:, ci], vch[:, ci]
        db, fcb, ib = dlog[:, ci], fcs[:, ci], ich[:, ci]
        inter_log = fcb + m_prev[:, None, :]             # (B,qc,H)
        m_t = torch.maximum(db.amax(dim=2), inter_log)
        a = torch.exp(db - m_t[:, :, None, :])           # (B,qc,qc,H)
        qk = torch.einsum("bthd,buhd->btuh", qb, kb) * scale
        s_mat = a * qk
        numer = torch.einsum("btuh,buhd->bthd", s_mat, vb)
        inter_w = torch.exp(inter_log - m_t)             # (B,qc,H)
        numer = numer + inter_w[..., None] * torch.einsum(
            "bthd,bhde->bthe", qb * scale, c_prev)
        denom = s_mat.sum(dim=2) + inter_w * torch.einsum(
            "bthd,bhd->bth", qb * scale, n_prev)
        denom = torch.maximum(denom.abs(), torch.exp(-m_t))
        hs.append(numer / denom[..., None])
        # chunk-end state update
        f_end = fcb[:, -1, :]                            # (B,H)
        up_log = f_end[:, None, :] - fcb + ib            # (B,qc,H)
        m_new = torch.maximum(f_end + m_prev, up_log.amax(dim=1))
        w_up = torch.exp(up_log - m_new[:, None, :])
        decay = torch.exp(f_end + m_prev - m_new)
        c_prev = (decay[..., None, None] * c_prev
                  + torch.einsum("buhd,buhe->bhde", w_up[..., None] * kb, vb))
        n_prev = (decay[..., None] * n_prev
                  + torch.einsum("buh,buhd->bhd", w_up, kb))
        m_prev = m_new

    h = torch.stack(hs, dim=1).reshape(bsz, s, nh, dh)
    return h.to(q.dtype), (c_prev, n_prev, m_prev)


def _mlstm_qkv(p, x, cfg: ModelConfig, conv_state=None):
    """Shared projection path.  x: (B, S, d).  Returns q,k,v,ilog, the
    forget gate's pre-activation (``F.logsigmoid`` of it is flog), z and
    the updated conv ring state (for decode)."""
    bsz, s, _ = x.shape
    d = cfg.d_model
    din = 2 * d
    nh = cfg.n_heads
    dh = din // nh
    u = x @ p["up"]
    xb, z = u[..., :din], u[..., din:]
    kw = p["conv_w"].shape[0]
    if conv_state is None:
        xp = F.pad(xb, (0, 0, kw - 1, 0))
        new_conv = None
        xc = sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(kw))
        xc = F.silu(xc + p["conv_b"])
    else:
        # the ring state keeps its channels whole: the step on each
        # rank's rows
        from .ssm import _conv_step
        rows = ("batch", None, None)
        xc, xp = actsharding.on_shards(
            _conv_step, (conv_state, xb, p["conv_w"], p["conv_b"]),
            (rows, rows, (None, None), (None,)), [rows, rows])
        new_conv = xp[:, 1:]
    q = (xc @ p["wq"]).reshape(bsz, s, nh, dh)
    k = (xc @ p["wk"]).reshape(bsz, s, nh, dh)
    v = (xb @ p["wv"]).reshape(bsz, s, nh, dh)
    ilog = (xc @ p["wi"] + p["bi"]).float()
    fpre = (xc @ p["wf"] + p["bf"]).float()
    return q, k, v, ilog, fpre, z, new_conv


def _mlstm_out(p, h, z, cfg: ModelConfig):
    bsz, s = h.shape[:2]
    y = _rms_out(h.reshape(bsz, s, 2 * cfg.d_model), p["out_norm"], h.dtype)
    return (y * F.silu(z)) @ p["down"]


_HEADS = ("batch", None, "model", None)    # (B, S, H, D) on shards
_GATES = ("batch", None, "model")          # (B, S, H)


def mlstm_apply(p, x, cfg: ModelConfig):
    q, k, v, ilog, fpre, z, _ = _mlstm_qkv(p, x, cfg)
    h = actsharding.on_shards(
        lambda q_, k_, v_, i_, f_: _mlstm_chunked(
            q_, k_, v_, i_, F.logsigmoid(f_), cfg.mlstm_chunk)[0],
        (q, k, v, ilog, fpre), (_HEADS, _HEADS, _HEADS, _GATES, _GATES),
        _HEADS)
    return _mlstm_out(p, h, z, cfg)


def _mlstm_final(q, k, v, i, f, chunk):
    """:func:`_mlstm_chunked` on (shards of) log-space gate inputs: h and
    the final (C, n, m)."""
    h, (c, n, m) = _mlstm_chunked(q, k, v, i, F.logsigmoid(f), chunk)
    return h, c, n, m


def mlstm_prefill(p, x, cfg: ModelConfig, state):
    """Full-sequence mixer that also returns decode state (conv tail,
    C/n/m), written into ``state`` in place.  Under a mesh the chunkwise
    form runs on each rank's rows and heads, and each state is written on
    the rank's shards."""
    s = x.shape[1]
    din = 2 * cfg.d_model
    q, k, v, ilog, fpre, z, _ = _mlstm_qkv(p, x, cfg)
    h, c, n, m = actsharding.on_shards(
        lambda q_, k_, v_, i_, f_: _mlstm_final(q_, k_, v_, i_, f_,
                                                cfg.mlstm_chunk),
        (q, k, v, ilog, fpre), (_HEADS, _HEADS, _HEADS, _GATES, _GATES),
        [_HEADS, ("batch", "model", None, None), ("batch", "model", None),
         ("batch", "model")])
    xb = (x @ p["up"])[..., :din]
    kw = p["conv_w"].shape[0]
    tail = F.pad(xb, (0, 0, max(kw - 1 - s, 0), 0))[:, -(kw - 1):]
    for key, val in (("conv", tail), ("c", c), ("n", n), ("m", m)):
        write_rows(state[key], val)
    return _mlstm_out(p, h, z, cfg), state


def _mlstm_step(qb, kb, vb, il, fpre, c, n, m):
    """One mLSTM step of heads (B, H, D) from the state (C, n, m): h and
    the new state."""
    qb, kb, vb = qb.float(), kb.float(), vb.float()
    fl = F.logsigmoid(fpre)
    m_new = torch.maximum(fl + m, il)
    decay = torch.exp(fl + m - m_new)
    inw = torch.exp(il - m_new)
    c = decay[..., None, None] * c + inw[..., None, None] * (
        kb[..., :, None] * vb[..., None, :])
    n = decay[..., None] * n + inw[..., None] * kb
    scale = 1.0 / math.sqrt(qb.shape[-1])
    numer = torch.einsum("bhd,bhde->bhe", qb * scale, c)
    denom = torch.maximum(
        torch.einsum("bhd,bhd->bh", qb * scale, n).abs(), torch.exp(-m_new))
    return numer / denom[..., None], c, n, m_new


def mlstm_decode(p, x, cfg: ModelConfig, state, live):
    """One-token decode.  state: dict(conv, c, n, m), updated in place for
    the rows where ``live`` (B,) holds.  Under a mesh the step runs on each
    rank's rows and the heads its C state holds."""
    q, k, v, ilog, fpre, z, new_conv = _mlstm_qkv(p, x, cfg,
                                                  conv_state=state["conv"])
    hs = actsharding.model_split(state["c"], 1)
    heads, gates = ("batch", hs, None), ("batch", hs)
    h, c, n, m = actsharding.on_shards(
        _mlstm_step, (q[:, 0], k[:, 0], v[:, 0], ilog[:, 0], fpre[:, 0],
                      state["c"], state["n"], state["m"]),
        (heads, heads, heads, gates, gates, ("batch", hs, None, None),
         heads, gates),
        [heads, ("batch", hs, None, None), heads, gates])
    out = _mlstm_out(p, h[:, None].to(x.dtype), z, cfg)
    for key, val in (("conv", new_conv), ("c", c), ("n", n), ("m", m)):
        write_rows(state[key], val, live)
    return out, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen, cfg: ModelConfig):
    d = cfg.d_model
    nh = cfg.n_heads
    dh = cfg.slstm_head_dim or d // nh
    p = {}
    for g in "ifzo":
        p[f"w{g}"] = _init(gen, (d, nh * dh))
    for g in "ifzo":
        p[f"r{g}"] = _init(gen, (nh, dh, dh), scale=1.0 / math.sqrt(dh))
    for g in "ifzo":
        p[f"b{g}"] = (torch.full((nh * dh,), 3.0, device=gen.device)
                      if g == "f" else _zeros(gen, nh * dh))
    p["out_norm"] = _ones(gen, nh * dh)
    p["down"] = _init(gen, (nh * dh, d))
    return p


def _slstm_cell(p, xg, state, nh, dh):
    """One step.  xg: dict of per-gate input projections (B, nh, dh)."""
    c, n, m, h = state
    # one batched product for all four recurrent gates (batch dim = head)
    r_cat = torch.cat([p[f"r{g}"] for g in "ifzo"], dim=-1).float()
    rec_all = torch.bmm(h.float().transpose(0, 1), r_cat)  # (nh, B, 4*dh)
    rec_all = rec_all.transpose(0, 1)                    # (B, nh, 4*dh)
    rec = {g: rec_all[..., i * dh:(i + 1) * dh]
           for i, g in enumerate("ifzo")}
    il = xg["i"] + rec["i"]
    fl = xg["f"] + rec["f"]
    zv = torch.tanh(xg["z"] + rec["z"])
    ov = torch.sigmoid(xg["o"] + rec["o"])
    fl = F.logsigmoid(fl)                                # stabilized f~
    m_new = torch.maximum(fl + m, il)
    i_s = torch.exp(il - m_new)
    f_s = torch.exp(fl + m - m_new)
    c_new = f_s * c + i_s * zv
    n_new = f_s * n + i_s
    h_new = ov * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, m_new, h_new)


def _slstm_gates(p, x, cfg: ModelConfig):
    """The per-gate input projections, each (B, S, nh, dh)."""
    bsz, s, d = x.shape
    nh = cfg.n_heads
    dh = cfg.slstm_head_dim or d // nh
    return [(x @ p[f"w{g}"] + p[f"b{g}"]).reshape(bsz, s, nh, dh)
            for g in "ifzo"]


def _slstm_recur(rs, xs, state):
    """The recurrence over the time axis from ``state``: rs the four
    recurrent weights (nh, dh, dh), xs the four gates' projections (B, S,
    nh, dh); returns h (B, S, nh, dh) and the final state."""
    r = dict(zip((f"r{g}" for g in "ifzo"), rs))
    nh, dh = xs[0].shape[2:]
    hs = []
    for t in range(xs[0].shape[1]):
        state = _slstm_cell(r, {g: x[:, t] for g, x in zip("ifzo", xs)},
                            state, nh, dh)
        hs.append(state[3])
    return torch.stack(hs, dim=1), state


def _slstm_out(p, h, dtype):
    return _rms_out(h, p["out_norm"], dtype) @ p["down"]


def _slstm_heads(*t):
    """:func:`_slstm_recur` from the zero state on (shards of) the four
    gates' projections and recurrent weights; returns h."""
    xs, rs = t[:4], t[4:]
    bsz, _, nh, dh = xs[0].shape
    z0 = torch.zeros((bsz, nh, dh), dtype=torch.float32, device=xs[0].device)
    return _slstm_recur(rs, xs, (z0, z0, torch.full_like(z0, LOG_EPS),
                                 z0))[0]


def slstm_apply(p, x, cfg: ModelConfig):
    bsz, s, _ = x.shape
    # on each rank's batch rows and heads
    h = actsharding.on_shards(
        _slstm_heads, (*_slstm_gates(p, x, cfg),
                       *(p[f"r{g}"] for g in "ifzo")),
        (_HEADS,) * 4 + (("model", None, None),) * 4, _HEADS)
    return _slstm_out(p, h.reshape(bsz, s, -1), x.dtype)


def _slstm_from(*t):
    """:func:`_slstm_recur` on (shards of) the four gates' projections,
    the recurrent weights and the four state parts: h and the final
    state."""
    h, state = _slstm_recur(t[4:8], t[:4], tuple(t[8:]))
    return (h, *state)


def _slstm_cached(p, x, cfg: ModelConfig, state):
    """The recurrence over x from ``state`` (under a mesh on each rank's
    rows and the heads the state holds): the block's output and the final
    state."""
    bsz, s, _ = x.shape
    hs = actsharding.model_split(state[0], 1)
    gate, st = ("batch", None, hs, None), ("batch", hs, None)
    h, *final = actsharding.on_shards(
        _slstm_from, (*_slstm_gates(p, x, cfg),
                      *(p[f"r{g}"] for g in "ifzo"), *state),
        (gate,) * 4 + ((hs, None, None),) * 4 + (st,) * 4,
        [gate] + [st] * 4)
    return _slstm_out(p, h.reshape(bsz, s, -1), x.dtype), final


def slstm_prefill(p, x, cfg: ModelConfig, state):
    """Full-sequence sLSTM that also returns the final recurrent state,
    written into ``state`` in place."""
    out, final = _slstm_cached(p, x, cfg, state)
    for dst, src in zip(state, final):
        write_rows(dst, src)
    return out, state


def slstm_decode(p, x, cfg: ModelConfig, state, live):
    """One-token decode.  state: tuple (c, n, m, h), updated in place for
    the rows where ``live`` (B,) holds."""
    out, final = _slstm_cached(p, x, cfg, state)
    for dst, src in zip(state, final):
        write_rows(dst, src, live)
    return out, state
