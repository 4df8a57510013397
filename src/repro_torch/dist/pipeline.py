"""GPipe pipeline parallelism as a rotation schedule over ranks
(counterpart of :mod:`repro.dist.pipeline`).

One stage per rank along a mesh axis; microbatches enter at stage 0, a
ring shift (the reference's ``ppermute``) rotates activations to the next
stage every tick, and the last stage accumulates outputs.  A run of M
microbatches over S stages takes M + S - 1 ticks (the classic GPipe
bubble).  The collectives carry gradients (:class:`_Shift`,
:class:`_SumReplicated`, :class:`_Replicated`), so ``backward()`` through
:func:`pipelined_apply` on every rank yields exactly the sequential
model's gradients — the backward pipeline emerges from autograd instead
of being hand-scheduled.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ._compat import axis_size, sendrecv


class _Shift(torch.autograd.Function):
    """The ring shift: send to the next rank of the axis, receive from the
    previous one; its backward sends the gradient the other way round."""

    @staticmethod
    def forward(ctx, y, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        p, i = axis_size(mesh, axis), mesh.get_local_rank(axis)
        return sendrecv(y, mesh, axis, dst=(i + 1) % p, src=(i - 1) % p)

    @staticmethod
    def backward(ctx, g):
        p, i = axis_size(ctx.mesh, ctx.axis), ctx.mesh.get_local_rank(ctx.axis)
        return sendrecv(g, ctx.mesh, ctx.axis, dst=(i - 1) % p,
                        src=(i + 1) % p), None, None


class _SumReplicated(torch.autograd.Function):
    """The reference's ``psum`` into a replicated result: all-reduce
    forward, identity backward.  Every rank differentiates the same loss
    of the replicated output, so the gradient arriving on a rank is
    already the whole cotangent of its summand.  This is why the port has
    its own Function: ``torch.distributed.nn.functional.all_reduce``
    all-reduces the gradient too (right when each rank's loss is a
    separate term), which would scale it by the number of ranks here."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """A replicated input: identity forward, all-reduce backward, so each
    rank's gradient of ``x`` sums every rank's use of it (the transpose
    of the reference's implicit broadcast of an unsharded input)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def pipelined_apply(mesh, axis: str, stage_fn: Callable, stage_weights,
                    x, n_microbatches: int = 1):
    """Apply ``stage_fn(w_s, x)`` for every stage s in pipeline order.

    Called on every rank of ``axis`` (one stage a rank, in axis order):
    ``stage_weights`` is this rank's own stage's weights and ``x`` the
    full (batch, ...) input, the same on every rank.  Returns the
    final-stage activations for the full batch on every rank —
    numerically identical to the sequential ``for s: x = stage_fn(w[s],
    x)`` loop, and differentiable with respect to each rank's
    ``stage_weights`` and to ``x`` (every rank gets the whole gradient of
    ``x``) when every rank backpropagates the same loss of the output.
    """
    n_stages = axis_size(mesh, axis)
    batch = x.shape[0]
    assert batch % n_microbatches == 0, (batch, n_microbatches)
    group = mesh.get_group(axis)
    idx = mesh.get_local_rank(axis)
    first = torch.tensor(idx == 0, device=x.device)
    last_stage = torch.tensor(idx == n_stages - 1, device=x.device)
    xs = _Replicated.apply(x, group).reshape(
        n_microbatches, batch // n_microbatches, *x.shape[1:])
    cur = torch.zeros_like(xs[0])
    bubble = torch.zeros_like(cur)
    outs = []
    ticks = n_microbatches + n_stages - 1
    for t in range(ticks):
        feed = xs[t] if t < n_microbatches else bubble
        cur = torch.where(first, feed, cur)         # stage 0 ingests
        y = stage_fn(stage_weights, cur)
        if t >= n_stages - 1:                       # last stage emits
            outs.append(y)
        if t < ticks - 1:                           # rotate to next stage
            cur = y if n_stages == 1 else _Shift.apply(y, mesh, axis)
    # only the last stage's buffer is the pipeline output; the sum after
    # masking replicates it (and cuts every other stage's grad path)
    stacked = torch.stack(outs)
    last = torch.where(last_stage, stacked, torch.zeros_like(stacked))
    out = _SumReplicated.apply(last, group)
    return out.reshape(batch, *out.shape[2:])
