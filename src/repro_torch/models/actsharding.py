"""Activation-sharding hints (counterpart of :mod:`repro.models.actsharding`).

The reference pins the batch axis of activations with
``with_sharding_constraint`` so the SPMD partitioner keeps the batch
sharded past the embedding gather.  Eager PyTorch has no partitioner: a
tensor lives where it was made, so on one card the hints are no-ops.  The
signatures are kept so model code reads as the reference's does.
"""
from __future__ import annotations

import contextlib
from typing import Optional


@contextlib.contextmanager
def activation_spec(mesh, batch_axes, model_axis: Optional[str] = None):
    yield


def constrain(x, *, kind: str = "batch"):
    """Identity: placement is explicit in eager PyTorch."""
    return x


def constrain_tree(tree, **kw):
    return tree
