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
"""
from __future__ import annotations

import contextlib
from typing import Optional

_STATE: dict = {"mesh": None, "batch": None, "model": None}


@contextlib.contextmanager
def activation_spec(mesh, batch_axes, model_axis: Optional[str] = None):
    old = dict(_STATE)
    _STATE.update(mesh=mesh, batch=batch_axes, model=model_axis)
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
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.launch.sharding import placements
    model = _STATE["model"]
    batch = _STATE["batch"]
    if isinstance(batch, (tuple, list)):
        batch = tuple(batch) if len(batch) > 1 else \
            (batch[0] if batch else None)
    spec = [batch] + [None] * (x.ndim - 1)
    if (x.ndim == 3 and model is not None
            and x.shape[1] % axis_sizes(mesh)[model] == 0 and x.shape[1] > 1):
        spec[1] = model
    return x.redistribute(mesh, placements(tuple(spec), mesh))


def constrain_tree(tree, **kw):
    if _STATE["mesh"] is None:
        return tree
    from .model import tree_map
    return tree_map(lambda v: constrain(v, **kw), tree)
