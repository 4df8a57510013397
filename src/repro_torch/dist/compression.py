"""Compressed collectives (counterpart of :mod:`repro.dist.compression`).

Data-parallel training is all-reduce bound at scale; these helpers trade
collective bytes for quantisation error.  ``psum_compressed`` simulates
the wire format faithfully — values really pass through the compressed
representation before the reduction — so the numerics match what a
bandwidth-optimised implementation would produce, while :func:`wire_bytes`
reports the bytes such an implementation would move.

Methods:

- ``"none"``  plain f32 all-reduce (4 B/elem on the wire).
- ``"bf16"``  cast to bfloat16 before the reduce (2 B/elem): ~3 decimal
  digits of mantissa, same range as f32.
- ``"int8"``  per-shard symmetric linear quantisation (1 B/elem + one scale
  per leaf per shard): q = round(x / s), s = max|x| / 127.  The scale is
  computed on the *local* shard so no extra collective is needed to agree
  on it; the reduce sums dequantised shards.

Every function here runs on one rank of a ``torch.distributed`` group and
reduces or exchanges over one axis of a mesh
(:func:`repro_torch.dist._compat.make_mesh`).  A tree is a tensor or a
(nested) tuple, list or dict of them; a :class:`SplitComplex` is a tuple.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ._compat import axis_size, concat_blocks, exchange_blocks

METHODS = ("none", "bf16", "int8")


def _check(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown compression method {method!r}; "
                         f"expected one of {METHODS}")


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))   # NamedTuple
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, its name (``"bfloat16"``) or a numpy dtype as the
    torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    named = getattr(torch, str(dtype), None)
    if isinstance(named, torch.dtype):
        return named
    return getattr(torch, np.dtype(dtype).name)


def _quantize(x: torch.Tensor):
    """int8 wire values and the shard's scale s = max|x| / 127."""
    scale = torch.clamp(x.abs().max() / 127.0,
                        min=torch.finfo(x.dtype).tiny)
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def _psum_one(x: torch.Tensor, group, method: str) -> torch.Tensor:
    if method == "none":
        wire = x.clone()
    elif method == "bf16":
        wire = x.to(torch.bfloat16).to(x.dtype)
    else:
        q, scale = _quantize(x)
        wire = q.to(x.dtype) * scale
    dist.all_reduce(wire, group=group)
    return wire


def psum_compressed(tree, mesh, axis: str, method: str = "none"):
    """All-reduce (sum) every leaf of ``tree`` over ``axis`` through the
    ``method`` wire format; the tree comes back with the same structure."""
    _check(method)
    group = mesh.get_group(axis)
    return _map(lambda x: _psum_one(x, group, method), tree)


def all_to_all_compressed(x: torch.Tensor, mesh, axis: str, split_axis: int,
                          concat_axis: int,
                          method: str = "none") -> torch.Tensor:
    """Tiled all_to_all of one tensor through the ``method`` wire format —
    the pencil-FFT exchange sibling of :func:`psum_compressed`.

    ``"bf16"`` casts to bfloat16 for the wire and back.  ``"int8"``
    quantises with one symmetric per-shard scale (q = round(x/s),
    s = max|x|/127); the p scales travel by an ``all_gather`` (O(p) bytes,
    not counted by :func:`wire_bytes`) and each received peer block is
    dequantised with its *sender's* scale — the wire really carries int8,
    exactly what :func:`wire_bytes` prices.
    """
    _check(method)
    if method == "none":
        return concat_blocks(exchange_blocks(x, mesh, axis, split_axis),
                             concat_axis)
    if method == "bf16":
        wire = exchange_blocks(x.to(torch.bfloat16), mesh, axis, split_axis)
        return concat_blocks(wire.to(x.dtype), concat_axis)
    q, scale = _quantize(x)
    qq = exchange_blocks(q, mesh, axis, split_axis)      # (p, ...) int8
    p = axis_size(mesh, axis)
    scales = [torch.empty_like(scale) for _ in range(p)]
    dist.all_gather(scales, scale, group=mesh.get_group(axis))
    # block b came from (and was scaled by) the rank at index b
    s = torch.stack(scales).reshape((p,) + (1,) * (qq.dim() - 1))
    return concat_blocks(qq.to(x.dtype) * s, concat_axis)


def wire_bytes(tree, method: str = "none") -> int:
    """Bytes per rank moved over the wire by one all-reduce of ``tree``.

    Leaves are tensors or numpy arrays.  ``"bf16"`` never *inflates* a leaf
    (a leaf already narrower than 16 bits stays at its own width);
    ``"int8"`` is 1 B/elem for every leaf (per-leaf scales are O(leaves),
    not counted).
    """
    _check(method)
    total = 0
    for leaf in _leaves(tree):
        n = int(np.prod(tuple(leaf.shape)))
        itemsize = torch_dtype(leaf.dtype).itemsize
        if method == "bf16":
            itemsize = min(itemsize, 2)
        elif method == "int8":
            itemsize = 1
        total += n * itemsize
    return total
