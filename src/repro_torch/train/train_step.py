"""Train step: loss/grad/update with microbatch accumulation and optional
compressed gradient reduction (counterpart of
:mod:`repro.train.train_step`).

``make_train_step`` builds a (params, opt_state, batch) -> (params,
opt_state, metrics) function that returns new trees and leaves its inputs
as they were.  Gradients come from ``torch.autograd.grad`` over the param
tree's leaves (a leaf the loss does not reach gets zeros, as ``jax.grad``
gives).  Microbatching is a Python loop over slices of the batch summing
fp32 gradients (peak activation memory divides by ``microbatches``).
With ``compress="bf16"`` the accumulated gradients are cast to bf16, as
they would be before a data-parallel all-reduce, and the rounding error
is carried to the next step in ``opt_state["ef_residual"]`` (error
feedback).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from . import optimizer as opt_lib


def _grads_of(cfg: ModelConfig, params, batch):
    paths = [p for p, _ in M.tree_flatten_with_paths(params)]
    with torch.enable_grad():
        live = M.tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = M.loss_fn(live, cfg, batch)
        leaves = M.tree_leaves(live)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_path = {path: torch.zeros_like(p) if g is None else _like(g, p)
               for path, p, g in zip(paths, leaves, got)}
    grads = M.tree_map_with_path(lambda path, _: by_path[path], params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _like(g, p):
    """A DTensor param's gradient in the param's placements: a partial sum
    over ranks (each saw its batch rows) is reduced here, once a step."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, ocfg: opt_lib.AdamWConfig, *,
                    microbatches: int = 1,
                    compress: Optional[str] = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics)."""
    if compress not in (None, "bf16"):
        raise ValueError(f"compress must be None or 'bf16', got {compress!r}")

    def accumulate(params, batch):
        if microbatches == 1:
            return _grads_of(cfg, params, batch)
        for x in batch.values():
            if x.shape[0] % microbatches:
                raise ValueError(f"batch {x.shape[0]} does not split into "
                                 f"{microbatches} microbatches")
        loss_sum = None
        grads_sum = M.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        for i in range(microbatches):
            mb = {k: x.reshape(microbatches, x.shape[0] // microbatches,
                               *x.shape[1:])[i] for k, x in batch.items()}
            loss, _, grads = _grads_of(cfg, params, mb)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            grads_sum = M.tree_map(torch.add, grads_sum, grads)
            del grads
        inv = 1.0 / microbatches
        return loss_sum * inv, {}, M.tree_map(lambda g: g * inv, grads_sum)

    def train_step(params, opt_state, batch):
        loss, _, grads = accumulate(params, batch)
        if compress == "bf16":
            # cast as before a data-parallel all-reduce; the rounding
            # error is added back next step (error feedback)
            resid = opt_state.get("ef_residual")
            if resid is not None:
                grads = M.tree_map(lambda g, r: g + r.float(), grads, resid)
            q = M.tree_map(lambda g: g.to(torch.bfloat16), grads)
            new_resid = M.tree_map(
                lambda g, qq: (g - qq.float()).to(torch.bfloat16), grads, q)
            grads = M.tree_map(lambda qq: qq.float(), q)
        inner = {k: v for k, v in opt_state.items() if k != "ef_residual"}
        new_params, new_inner, metrics = opt_lib.adamw_update(
            ocfg, grads, inner, params)
        new_state = dict(new_inner)
        if compress == "bf16":
            new_state["ef_residual"] = new_resid
        metrics = dict(metrics, loss=loss)
        return new_params, new_state, metrics

    return train_step


def init_opt_state(cfg: ModelConfig, ocfg: opt_lib.AdamWConfig, params, *,
                   compress: Optional[str] = None):
    state = opt_lib.adamw_init(ocfg, params)
    if compress == "bf16":
        state["ef_residual"] = M.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.bfloat16), params)
    return state


def abstract_opt_state(cfg: ModelConfig, ocfg: opt_lib.AdamWConfig,
                       abstract_params, *, compress: Optional[str] = None):
    """The optimizer state's shapes and dtypes as meta tensors (no
    allocation), from a tree of (meta) parameter stand-ins."""
    meta = M.tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                            device="meta"), abstract_params)
    return init_opt_state(cfg, ocfg, meta, compress=compress)
