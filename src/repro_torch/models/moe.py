"""Token-choice top-k MoE with GShard-style group-wise capacity dispatch
(counterpart of :mod:`repro.models.moe`).

Tokens route within *groups* (one sequence per group; decode folds the
batch into one group): each group has per-expert capacity
C = k * Tg * capacity_factor / E.  Per (group, expert) the top C
assignment scores over the group's tokens are gathered, the experts run as
one batched (G, E, C, d) product, and the weighted outputs are
scatter-added back.  Overflow tokens are dropped (capacity dropping);
``dropless=True`` (decode) sets C = Tg.  A top-C pick of a token the
expert was not assigned has weight 0 and is masked by ``live``, so the
result does not depend on how ``torch.topk`` orders ties.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import actsharding
from .config import ModelConfig
from .layers import _init


def moe_init(gen, cfg: ModelConfig):
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {"router": _init(gen, (d, e), scale=0.02)}
    p["wi"] = _init(gen, (e, d, ff))
    if cfg.mlp_type == "swiglu":
        p["wg"] = _init(gen, (e, d, ff))
    p["wo"] = _init(gen, (e, ff, d))
    return p


def _capacity(cfg: ModelConfig, tg: int) -> int:
    c = int(math.ceil(cfg.n_experts_active * tg * cfg.capacity_factor
                      / cfg.n_experts))
    return max(1, min(c, tg))


def moe_apply(p, x, cfg: ModelConfig, *, dropless: bool = False,
              cap_scale: float = 1.0):
    """x: (B, S, d) -> (B, S, d), aux_loss (scalar).

    Groups = sequences (B groups of S tokens); decode (S==1) folds the whole
    batch into one group.  ``dropless=True`` sets capacity = Tg (exact, for
    decode where Tg = B is small); prefill uses ``cap_scale`` headroom.
    Under a mesh (:func:`~repro_torch.models.actsharding.on_shards`) the
    router, its top-k and the capacity selection run on each rank's
    groups, their sequence whole, so the router's gradient is taken once;
    the experts run on each rank's E/``model`` slice of ``wi``, ``wg`` and
    ``wo`` (the per-(group, expert) selection is independent across
    experts, so the split computes what the whole does), and their output
    is a partial sum over ``model`` that the residual's ``constrain``
    reduce-scatters into its sequence split.
    """
    b, s, d = x.shape
    if s == 1:                                   # decode: one group of B
        g, tg = 1, b
    else:
        g, tg = b, s
    e, k = cfg.n_experts, cfg.n_experts_active
    cap = tg if dropless else min(tg, int(_capacity(cfg, tg) * cap_scale))
    xf = x.reshape(g, tg, d)
    rows = ("batch", None, None)
    probs, combine, sel_w, sel_idx = actsharding.on_shards(
        lambda xf, router: _route(router, xf, k, cap), (xf, p["router"]),
        (rows, (None, None)), [rows, rows, rows, rows])
    names = [n for n in _EXPERTS if n in p]
    picked = ("batch", "model", None)
    out = actsharding.on_shards(
        lambda xf, w, i, *ws: _experts(dict(zip(names, ws)), xf, w, i, cfg),
        (xf, sel_w, sel_idx, *(p[n] for n in names)),
        (rows, picked, picked, *((("model", None, None),) * len(names))),
        actsharding.PartialSum("model", rows),
        keep={3 + j: f"moe/{n}" for j, n in enumerate(names)})

    # Switch-style load-balance aux loss (per group, then averaged)
    me = probs.mean(dim=1)                                 # (G, E)
    ce = (combine != 0).float().mean(dim=1) * e / k
    aux = cfg.router_aux_weight * e * torch.mean(torch.sum(me * ce, dim=-1))
    return out.reshape(b, s, d).to(x.dtype), aux


_EXPERTS = ("wi", "wg", "wo")


def _route(router, xf, k: int, cap: int):
    """Top-k routing and the capacity selection on groups xf (G, Tg, d):
    probs and combine weights (G, Tg, E), and each (group, expert)'s top-C
    weights and token indices (G, E, C)."""
    g = xf.shape[0]
    logits = (xf @ router).float()                         # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)              # (G, Tg, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # per-token-per-expert combine weight (G, Tg, E), zero if not chosen
    combine = torch.zeros_like(probs).scatter(-1, topi, topw)

    # expert-side selection: top-C tokens per (group, expert)
    sel_w, sel_idx = torch.topk(combine.transpose(1, 2), cap, dim=-1)
    return probs, combine, sel_w, sel_idx


def _experts(p, xf, sel_w, sel_idx, cfg: ModelConfig):
    """The experts of ``p`` (E', ...) on their picked tokens: sel_w and
    sel_idx (G, E', C) index the groups xf (G, Tg, d); returns the
    weighted outputs scatter-added back, (G, Tg, d)."""
    g, tg, d = xf.shape
    live = sel_w > 0.0
    gidx = torch.arange(g, device=xf.device)[:, None, None]
    xe = xf[gidx, sel_idx]                                 # (G, E', C, d)

    if cfg.mlp_type == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["wg"])) * \
            torch.einsum("gecd,edf->gecf", xe, p["wi"])
    else:
        h = F.gelu(torch.einsum("gecd,edf->gecf", xe, p["wi"]),
                   approximate="tanh")
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"])        # (G, E', C, d)
    ye = ye * (sel_w * live)[..., None].to(ye.dtype)

    out = torch.zeros((g, tg, d), dtype=ye.dtype, device=xf.device)
    out.index_put_((gidx, sel_idx), ye, accumulate=True)
    return out
