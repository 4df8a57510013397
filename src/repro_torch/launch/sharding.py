"""Logical sharding rules: param/optimizer/batch/cache partition specs per
architecture profile (counterpart of :mod:`repro.launch.sharding`).

A spec is the ``PartitionSpec`` counterpart: a tuple with one entry a
tensor dim, each ``None`` (replicated), a mesh axis name, or a tuple of
axis names (the dim split over their product, the first axis major).
:class:`NamedSharding` pairs a spec with a mesh, and :func:`placements`
turns a spec into DTensor placements on a ``DeviceMesh``.

Profiles:
- ``tp2d`` (default): Megatron-style tensor parallelism on the ``model``
  axis (column-parallel up-projections, row-parallel down-projections,
  vocab-parallel embeddings) combined with FSDP-style sharding of the other
  weight dim over ``data``.  Experts shard over ``model`` (EP).
- ``fsdp``: pure ZeRO-3, every large tensor sharded over the combined
  (data, model) axes on its largest divisible dim.

Every rule degrades gracefully: a mesh axis is dropped from a spec whenever
the corresponding tensor dim is not divisible by the axis size, so any config
lays out on any mesh (elastic rescaling).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import tree_map, tree_map_with_path
from . import mesh as mesh_lib

# the reference keeps a data-dim ZeRO-3 profile selectable and uses tp2d
# everywhere (its SPMD partitioner replicated activations under fsdp)
FSDP_ARCHS: set = set()

# param leaf names by parallelism role
_COL_PARALLEL = {"wq", "wk", "wv", "wi", "wg", "up", "in_proj", "router"}
_ROW_PARALLEL = {"wo", "down", "out_proj"}


def profile_for(cfg: ModelConfig) -> str:
    return "fsdp" if cfg.name in FSDP_ARCHS else "tp2d"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> tuple:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for ``spec``: a
    tensor dim over axes (a, b) is ``Shard(d)`` on both mesh dims, which
    must come in mesh order; every other mesh dim, and a mesh dim of one
    rank (nothing to split), is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = [int(s) for s in mesh.shape]
    out = [Replicate()] * len(names)
    used = set()
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {_axes(entry)} of dim {d} "
                             f"are not in mesh order {tuple(names)}")
        for i in idx:
            if i in used:
                raise ValueError(f"spec {spec} uses mesh axis {names[i]!r} "
                                 "twice")
            used.add(i)
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def shard_slices(shape, mesh, placements_) -> tuple:
    """This rank's block of a global array of ``shape`` laid out by
    ``placements_`` on ``mesh``: one slice a dim (evenly divided)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    k, n = [0] * len(shape), [1] * len(shape)
    for i, p in enumerate(placements_):
        if isinstance(p, Shard):
            size = int(mesh.shape[i])
            k[p.dim] = k[p.dim] * size + int(coord[i])
            n[p.dim] *= size
    for d, dim in enumerate(shape):
        if dim % n[d]:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly over {n[d]} ranks")
    return tuple(slice(k[d] * (dim // n[d]), (k[d] + 1) * (dim // n[d]))
                 for d, dim in enumerate(shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def distribute(self, full):
        """A DTensor of the global tensor ``full``, every rank keeping its
        own block (each rank holds ``full``; nothing is sent)."""
        from torch.distributed.tensor import DTensor
        pl = self.placements
        local = full[shard_slices(tuple(full.shape), self.mesh, pl)]
        return DTensor.from_local(local.contiguous(), self.mesh, pl,
                                  run_check=False, shape=full.shape,
                                  stride=full.contiguous().stride())


def _data(mesh):
    data = mesh_lib.data_axes(mesh)
    return data if len(data) > 1 else (data[0] if data else None)


def _fit(spec_axes, shape, mesh) -> tuple:
    """Drop mesh axes whose size does not divide the tensor dim."""
    sizes = mesh_lib.axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, spec_axes):
        if ax is None:
            out.append(None)
            continue
        total = math.prod(sizes[a] for a in _axes(ax))
        out.append(ax if dim % total == 0 else None)
    return tuple(out)


def _param_spec(path_keys, shape, cfg: ModelConfig, mesh,
                profile: str) -> tuple:
    name = path_keys[-1]
    in_moe = "moe" in path_keys
    data = _data(mesh)
    ndim = len(shape)

    if ndim <= 1:
        return (None,) * ndim

    if profile == "fsdp":
        # embeddings stay vocab-parallel on `model` even under fsdp so the
        # CE head's logits shard over vocab instead of replicating
        if name == "tok":
            return _fit(("model", data), shape, mesh)
        if name == "head":
            return _fit((data, "model"), shape, mesh)
        # ZeRO-3: biggest dim over every device
        all_axes = tuple(mesh_lib.axis_sizes(mesh))
        big = int(np.argmax(shape))
        spec = [None] * ndim
        spec[big] = all_axes
        fitted = _fit(spec, shape, mesh)
        if fitted[big] is not None:
            return fitted
        spec[big] = data                       # degrade: data axes only
        return _fit(spec, shape, mesh)

    # --- tp2d ---
    if in_moe and name in ("wi", "wg"):        # (R, E, d, ff): EP + FSDP
        return _fit((None, "model", data, None), shape, mesh)
    if in_moe and name == "wo":                # (R, E, ff, d)
        return _fit((None, "model", None, data), shape, mesh)
    if name == "tok":                          # (V, d) vocab-parallel
        return _fit(("model", data), shape, mesh)
    if name == "head":                         # (d, V)
        return _fit((data, "model"), shape, mesh)
    if name in _COL_PARALLEL:                  # (..., d_in, d_out)
        return _fit([None] * (ndim - 2) + [data, "model"], shape, mesh)
    if name in _ROW_PARALLEL:                  # (..., d_in, d_out)
        return _fit([None] * (ndim - 2) + ["model", data], shape, mesh)
    if name in ("bi", "bq", "bk", "bv"):       # column-parallel biases
        return _fit([None] * (ndim - 1) + ["model"], shape, mesh)
    if name in ("wi", "wf"):                   # mlstm gate projections
        return _fit([None] * (ndim - 2) + [data, None], shape, mesh)
    return (None,) * ndim


def param_shardings(cfg: ModelConfig, mesh, abstract_params: Any):
    """NamedSharding tree matching the param tree (leaves: anything with a
    ``shape``: tensors, meta tensors)."""
    profile = profile_for(cfg)
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, _param_spec(
            path, tuple(leaf.shape), cfg, mesh, profile)), abstract_params)


def opt_shardings(cfg: ModelConfig, mesh, abstract_opt: Any,
                  abstract_params: Any):
    """Optimizer moments shard like their params; scalars replicate."""
    pshard = param_shardings(cfg, mesh, abstract_params)
    return {k: NamedSharding(mesh, ()) if k == "step" else pshard
            for k in abstract_opt}


def batch_shardings(cfg: ModelConfig, mesh, batch_specs: Any):
    """Batch dim over (pod, data); model dim of stub embeddings unsharded."""
    data = _data(mesh)
    return tree_map(lambda leaf: NamedSharding(mesh, _fit(
        [data] + [None] * (len(leaf.shape) - 1), leaf.shape, mesh)),
        batch_specs)


def cache_shardings(cfg: ModelConfig, mesh, abstract_cache: Any,
                    batch: int):
    """Decode caches: batch over data when divisible, else SP: shard the
    cache's sequence (slots) dim over data; recurrent states shard their
    head dim over model."""
    data = _data(mesh)
    sizes = mesh_lib.axis_sizes(mesh)
    dsize = math.prod(sizes[a] for a in _axes(data))
    batch_ok = batch % dsize == 0 and batch >= dsize

    def one(path, leaf):
        name = path[-1]
        nd = len(leaf.shape)
        # the leading dim is the stacked repeat axis (from init_cache);
        # the tensor's own dims start at 1
        if batch_ok:
            spec = [None, data] + [None] * (nd - 2)
            if name in ("k", "v"):
                # kv heads that do not divide the model axis leave the
                # cache replicated over `model` (the reference measured
                # sharding the slots instead: an all-gather a token)
                spec = [None, data, None, "model", None][:nd]
            return NamedSharding(mesh, _fit(spec, leaf.shape, mesh))
        # SP: shard sequence/slots (dim 2 for k/v/pos), heads over model
        if name in ("k", "v"):
            spec = [None, None, data, "model", None][:nd]
        elif name == "pos":
            spec = [None, None, data][:nd]
        elif name in ("ssm", "c"):
            spec = [None, None, "model"] + [None] * (nd - 3)
        else:
            spec = [None] * nd
        return NamedSharding(mesh, _fit(spec, leaf.shape, mesh))

    return tree_map_with_path(one, abstract_cache)


def serve_spec(mesh, batch: int):
    """The activation spec a serving call of ``batch`` rows runs under,
    by ``cache_shardings``' rule: the batch pinned over the data axes when
    it divides them; else no batch pin (the reference's dry runs install
    none) and the caches' slots split over the data axes."""
    from repro_torch.models import actsharding
    data = mesh_lib.data_axes(mesh)
    dsize = math.prod(mesh_lib.axis_sizes(mesh)[a] for a in data)
    if batch % dsize == 0 and batch >= dsize:
        return actsharding.activation_spec(mesh, data, "model")
    return actsharding.activation_spec(mesh, (), "model", slots=data)


def replicated(mesh, tree: Any):
    return tree_map(lambda _: NamedSharding(mesh, ()), tree)


def lay_out(tree: Any, shardings: Any):
    """``tree`` with each leaf laid out by its :class:`NamedSharding`
    (``shardings`` has the tree's structure): a plain tensor distributed,
    every rank keeping its block of it (every rank holds it whole), a
    DTensor redistributed."""
    from torch.distributed.tensor import DTensor

    def one(leaf, sh):
        if isinstance(leaf, DTensor):
            return leaf.redistribute(sh.mesh, sh.placements)
        return sh.distribute(leaf)
    return tree_map(one, tree, shardings)
