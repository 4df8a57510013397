"""Activation-sharding hints (counterpart of :mod:`repro.models.actsharding`).

The reference pins the batch axis of activations with
``with_sharding_constraint`` at the trunk boundaries so the SPMD
partitioner keeps the batch sharded past the embedding gather.  Here the
launch layer installs a mesh and its axes with ``activation_spec(mesh,
batch_axes, model_axis)``, and ``constrain`` redistributes a DTensor
activation to that placement: the batch over the data axes and, for a
(B, S, d) hidden, the sequence over ``model`` when it divides
(Megatron-style sequence parallelism for the inter-block residuals).  A
plain tensor, or any tensor with no spec installed, passes through
unchanged (one card, unit tests).

Where the reference's partitioner places collectives around a block, the
sharded step here states them (one rule, two forms):

- :func:`on_shards` runs a block whose work is independent over batch
  rows (and heads, channels, experts or vocab rows) on each rank's local
  shards, under ``torch.distributed.tensor.experimental.local_map``: its
  inputs are redistributed to the stated placements, its tables and masks
  stay plain tensors, and a kernel inside it sees a plain local tensor
  whose FFT axis is whole on the rank.  A block over a split weight
  (experts over ``model``, the vocab-parallel embedding) returns a
  :class:`PartialSum`, which the residual's ``constrain`` reduces into
  its sequence split; a block that needs the sum inside (the
  vocab-parallel CE's log-sum-exp) reduces over :func:`model_group`
  itself;
- :func:`replicate_like` makes a constant built for a DTensor operand a
  replicated DTensor on that operand's mesh.

Serving adds a third symbol, "slots": the slot dim of a KV cache laid out
sequence-parallel (``cache_shardings``' SP layout, a batch that does not
divide the data ranks).  ``activation_spec(..., slots=data axes)``
installs it; :func:`on_shards` then keeps such a cache split, each rank
attending over its own slots, and the ranks' partial softmax states are
merged over :func:`slot_groups`.  A split that cannot be kept raises,
naming the cache: gathering the cache whole every token is what the
reference measured and refuted (its collective term 0.02 s -> 4.3 s).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

_STATE: dict = {"mesh": None, "batch": None, "model": None, "slots": None}


@contextlib.contextmanager
def activation_spec(mesh, batch_axes, model_axis: Optional[str] = None, *,
                    slots=None):
    """Install ``mesh`` and its axes: ``batch_axes`` pin the batch dim of
    activations (empty: no pin), ``model_axis`` splits heads, channels,
    experts and vocab rows, ``slots`` (axes, or None) the slot dim of a
    sequence-parallel KV cache."""
    old = dict(_STATE)
    _STATE.update(mesh=mesh, batch=batch_axes, model=model_axis, slots=slots)
    try:
        yield
    finally:
        _STATE.update(old)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *, kind: str = "batch"):
    """Redistribute a DTensor activation to the installed placement; any
    other value is returned as it is."""
    mesh = _STATE["mesh"]
    if mesh is None or getattr(x, "ndim", 0) == 0 or not _is_dtensor(x):
        return x
    from repro_torch.launch.sharding import _fit, placements
    model = _STATE["model"]
    batch = _STATE["batch"]
    if isinstance(batch, (tuple, list)):
        batch = tuple(batch) if len(batch) > 1 else \
            (batch[0] if batch else None)
    spec = [batch] + [None] * (x.ndim - 1)
    if x.ndim == 3 and model is not None and x.shape[1] > 1:
        spec[1] = model
    # an axis whose size does not divide its dim is dropped, as the
    # param and batch rules drop it
    return x.redistribute(mesh, placements(_fit(spec, x.shape, mesh), mesh))


def constrain_tree(tree, **kw):
    if _STATE["mesh"] is None:
        return tree
    from .model import tree_map
    return tree_map(lambda v: constrain(v, **kw), tree)


def whole_seq(x):
    """A (B, S, d) DTensor activation with its sequence gathered on every
    rank, the batch still split: after a norm, the residual's sequence
    split (``constrain``) is undone for the block's projections (a matmul
    flattens (B, S) into rows, which torch 2.11 refuses for a split
    sequence).  Any other value passes."""
    if not _is_dtensor(x) or x.ndim != 3:
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def split_last(t, n: int, size: int):
    """(..., n * size) -> (..., n, size).  A DTensor whose last dim is
    split over more ranks than evenly divide the n groups (heads) is
    gathered on that dim first."""
    if _is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        last = t.ndim - 1
        split = [i for i, p in enumerate(t.placements)
                 if isinstance(p, Shard) and p.dim == last]
        ranks = 1
        for i in split:
            ranks *= t.device_mesh.shape[i]
        if n % ranks:
            pl = [Replicate() if i in split else p
                  for i, p in enumerate(t.placements)]
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:-1], n, size)


def replicate_like(t, like):
    """``t`` (a constant: a table, a mask, a zero) as a replicated DTensor
    on ``like``'s mesh when ``like`` is a DTensor, else ``t`` itself."""
    if not _is_dtensor(like) or _is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


@dataclasses.dataclass(frozen=True)
class PartialSum:
    """An output form of :func:`on_shards`: the dims of ``spec`` as any
    out spec gives them, the value on each rank a partial sum over the
    mesh dims of the symbol ``over`` (each rank computed the part of its
    slice of a weight split over ``over``)."""
    over: str
    spec: tuple


def model_group():
    """The process group of the installed ``model`` mesh dim: the ranks a
    block run by :func:`on_shards` reduces over inside."""
    if _STATE["model"] is None:
        raise ValueError("no model mesh dim installed")
    return _STATE["mesh"].get_group(_STATE["model"])


def model_start(n: int) -> int:
    """Inside a block run by :func:`on_shards`: the first index of this
    rank's slice of ``n`` along a dim its spec splits over ``"model"``
    (the rank's coordinate on that mesh dim times n; 0 with no mesh)."""
    if _STATE["mesh"] is None or _STATE["model"] is None:
        return 0
    return _STATE["mesh"].get_local_rank(_STATE["model"]) * n


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    entry = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
    return tuple(a for a in entry if a is not None)


def slot_groups() -> list:
    """The process groups of the installed slot axes, minor first: an
    all-gather over each in turn brings every rank the parts of all the
    ranks that split a cache's slots."""
    mesh = _STATE["mesh"]
    return [mesh.get_group(a) for a in reversed(_axes_of(_STATE["slots"]))]


def splits_slots(t, dim: int) -> bool:
    """Whether the DTensor ``t`` has ``dim`` split over the installed slot
    axes (a sequence-parallel cache under a slot spec)."""
    axes = _axes_of(_STATE["slots"])
    if _STATE["mesh"] is None or not axes or not _is_dtensor(t):
        return False
    from torch.distributed.tensor import Shard
    names = list(t.device_mesh.mesh_dim_names)
    return any(isinstance(t.placements[names.index(a)], Shard)
               and t.placements[names.index(a)].dim == dim for a in axes)


def model_split(t, dim: int):
    """``"model"`` where the DTensor ``t`` has ``dim`` split over the
    installed model axis, else None: the spec of a block that follows a
    state's own layout (``cache_shardings`` splits recurrent heads over
    ``model`` in the sequence-parallel layout only)."""
    model = _STATE["model"]
    if _STATE["mesh"] is None or model is None or not _is_dtensor(t):
        return None
    from torch.distributed.tensor import Shard
    p = t.placements[list(t.device_mesh.mesh_dim_names).index(model)]
    return "model" if isinstance(p, Shard) and p.dim == dim else None


def _resolve(spec, shape, axes) -> tuple:
    """A block spec of "batch", "model" and None entries as a sharding
    spec: each symbol its mesh axes (``axes``), or None where they are
    off."""
    return tuple(None if e is None else axes[e] for e in spec) + \
        (None,) * (len(shape) - len(spec))


def on_shards(fn, args, in_specs, out_specs, *, keep=None):
    """``fn(*args)`` on each rank's local shards.

    ``in_specs`` gives each argument's dims as "batch" (split over the
    data axes), "model" (over the model axis), "slots" (a cache's slots
    over the installed slot axes) or None (whole); a None
    spec passes the argument as it is (a Python value, a plain tensor).
    ``out_specs`` does the same for the result: one spec for a tensor,
    a list of specs for a tuple of them; a :class:`PartialSum` marks a
    result that is a partial sum over its symbol's mesh dims.  "model"
    shards only when every dim that names it divides by the model axis,
    and "batch" likewise over the data axes; otherwise the block runs
    whole on those ranks (replicated).  ``keep`` maps argument indices to
    names: a split of such an argument that its spec names must be kept,
    and if the block cannot keep it (its symbol is off) the call raises
    naming the tensor rather than gather it whole.  The gradient of an
    input that a sharded symbol does not split (a weight against a batch
    split, shared B/C inputs against a head split, the tokens against an
    expert or vocab split) is a partial sum over that symbol's mesh dims:
    each rank saw only its part of the work.  With no mesh installed, or
    no DTensor argument, ``fn(*args)`` runs as it is."""
    mesh = _STATE["mesh"]
    if mesh is None or not any(_is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.launch.sharding import placements
    sizes = axis_sizes(mesh)
    groups = {"batch": _axes_of(_STATE["batch"]),
              "model": _axes_of(_STATE["model"]),
              "slots": _axes_of(_STATE["slots"])}
    on = {}
    for sym, names in groups.items():
        total = 1
        for a in names:
            total *= sizes[a]
        dims = [a.shape[d] for a, sp in zip(args, in_specs)
                if sp is not None and _is_dtensor(a)
                for d, e in enumerate(sp) if e == sym]
        on[sym] = bool(names) and total > 1 and bool(dims) and \
            all(n % total == 0 for n in dims)
    axes = {sym: (names if len(names) > 1 else names[0]) if on[sym]
            else None for sym, names in groups.items()}
    names = list(mesh.mesh_dim_names)
    for i, label in (keep or {}).items():
        a, sp = args[i], in_specs[i]
        for d, p in enumerate(a.placements if _is_dtensor(a) else ()):
            sym = sp[p.dim] if isinstance(p, Shard) and p.dim < len(sp) \
                else None
            if sym is not None and not (on[sym] and names[d] in groups[sym]):
                raise ValueError(
                    f"{getattr(fn, '__name__', 'block')}: {label} "
                    f"{tuple(a.shape)} is split over {names[d]!r} on dim "
                    f"{p.dim}, which this block cannot keep ({sym!r} is "
                    "off: a dim naming it does not divide by its ranks, or "
                    "the spec installs no such axis); refusing to gather "
                    "it whole")
    in_pl, grad_pl = [], []
    for a, sp in zip(args, in_specs):
        if sp is None or not _is_dtensor(a):
            in_pl.append(None)
            grad_pl.append(None)
            continue
        pl = placements(_resolve(sp, a.shape, axes), mesh)
        grad = list(pl)
        for sym in groups:
            if on[sym] and sym not in sp:
                for ax in groups[sym]:
                    i = names.index(ax)
                    if isinstance(grad[i], Replicate):
                        grad[i] = Partial()
        in_pl.append(pl)
        grad_pl.append(tuple(grad))

    def out_pl(spec):
        if isinstance(spec, PartialSum):
            pl = out_pl(spec.spec)
            for ax in groups[spec.over] if on[spec.over] else ():
                pl[names.index(ax)] = Partial()
            return pl
        return list(placements(_resolve(spec, spec, axes), mesh))
    # local_map reads a tuple as one placement list an output
    outs = (tuple(out_pl(sp) for sp in out_specs)
            if isinstance(out_specs, list) else out_pl(out_specs))
    return local_map(fn, out_placements=outs, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)
