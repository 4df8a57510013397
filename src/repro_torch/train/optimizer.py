"""Optimizers and schedules from scratch (counterpart of
:mod:`repro.train.optimizer`).

AdamW with decoupled weight decay, global-norm clipping, warmup-cosine
schedule, and optional bf16 moment storage (halves optimizer memory; the
update math still runs in fp32).  Trees are the model's dicts of tensors;
every function is pure (new tensors out, nothing updated in place), and
the step count, learning rate and norm stay on the tensors' device, so a
step needs no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.models.actsharding import replicate_like
from repro_torch.models.model import torch_dtype, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moments_dtype: str = "float32"   # "bfloat16" halves optimizer memory


def warmup_cosine(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or a tensor): linear warmup,
    then cosine decay to ``min_lr_ratio * lr``."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(cfg: AdamWConfig, params):
    """Zero moments laid out as their params (DTensor params: DTensor
    moments of the same placements); the step count a scalar (replicated
    on the params' mesh)."""
    mdt = torch_dtype(cfg.moments_dtype)
    first = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p, dtype=mdt)  # noqa: E731
    return {"step": replicate_like(torch.zeros(
                (), dtype=torch.int32, device=first.device), first),
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params)}


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, grads, state, params):
    """Returns (new_params, new_state, metrics).  ``grad_norm`` is the
    norm before clipping; the clip scales each gradient leaf as the update
    reads it, so no clipped copy of the whole tree is made."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    lr = warmup_cosine(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    mdt = torch_dtype(cfg.moments_dtype)

    def upd(p, g, m, v):
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.float()
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + torch.square(g32) * (1 - b2)
        step_val = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.ndim >= 2:
            step_val = step_val + cfg.weight_decay * p.float()
        newp = p.float() - lr * step_val
        return newp.to(p.dtype), m32.to(mdt), v32.to(mdt)

    with torch.no_grad():
        out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    return (pick(0), {"step": step, "m": pick(1), "v": pick(2)},
            {"grad_norm": gnorm, "lr": lr})
