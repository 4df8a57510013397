"""Op-level cost counts of a PyTorch program (counterpart of
:mod:`repro.analysis.hloparse`).

The reference parses XLA's optimized HLO.  Here the counts come from the
aten ops the program really issues: :class:`OpCount` is a
``TorchDispatchMode`` that runs under ``FakeTensorMode`` (nothing is
allocated; with a fake process group every collective is a no-op) or on
real tensors, and accumulates, on each rank's local tensors:

- ``flops``: matmul, bmm, einsum-lowered and convolution products from
  ``torch.utils.flop_counter``'s registry (2 x MACs), plus 1 flop per
  output element of every other compute op (``hloparse``'s convention);
- ``traffic``: operand plus result bytes at every aten op boundary.
  Eager PyTorch fuses nothing, so this is the program's op-boundary
  traffic as it runs, not a model of fusion.  Gathers and slices read
  their window (2 x result bytes), scatters write theirs (2 x update
  bytes), factories write their result, as ``hloparse`` counts them;
- ``collectives``: result bytes a rank per kind (``hloparse``'s kinds:
  the ``_c10d_functional`` ops DTensor issues and its
  ``_dtensor::shard_dim_alltoall``, which moves a split from one dim to
  another on a card mesh (a CPU mesh all-gathers instead), the ``c10d`` ops of
  ``torch.distributed``'s own calls, and the pipeline's receives as
  ``collective-permute``; a broadcast counts as an all-gather).

Views, ``wait_tensor``, ``prim`` and other metadata ops count zero.
An op with a DTensor argument is not counted itself: it is handed on to
DTensor, whose local ops and collectives are (the counts are a rank's).
DTensor's sharding propagation runs its shape-inference ops with the
dispatch modes switched off while an :class:`OpCount` is active, so
neither this mode nor a ``MemTracker`` beside it sees those global-shaped
shadows.  A Python loop over layers issues every layer's ops, so the
counts are loop-exact by construction.  ``log=True`` keeps every counted
op (name, operand and result shapes and dtypes), which :func:`count_log`
counts again (:mod:`repro_torch.analysis.reanalyze`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# collective ops: the functional ones count their result, the c10d ones
# (in place) the tensors of their first argument
_FUNCTIONAL = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_reduce_coalesced_": "all-reduce",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_c10d_functional::broadcast": "all-gather",
    "_c10d_functional::broadcast_": "all-gather",
    "_dtensor::shard_dim_alltoall": "all-to-all",
}
_C10D = {
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_coalesced_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::recv_": "collective-permute",
    "c10d::recv_any_source_": "collective-permute",
    "c10d::broadcast_": "all-gather",
}
# metadata and synchronisation: no flops, no traffic
_FREE = {"aten::detach", "aten::alias", "aten::lift_fresh", "aten::empty",
         "aten::empty_strided", "aten::empty_like", "aten::new_empty",
         "aten::new_empty_strided", "aten::_local_scalar_dense",
         "aten::set_", "aten::resize_", "aten::sym_size", "aten::sym_stride",
         "aten::sym_numel", "aten::sym_storage_offset", "aten::is_same_size",
         "aten::_unsafe_view",
         "_c10d_functional::wait_tensor",
         "_c10d_functional::_wrap_tensor_autograd", "c10d::send",
         "c10d::barrier", "c10d::monitored_barrier_"}
# data movement: traffic, no flops
_MOVE = {"aten::_to_copy", "aten::copy_", "aten::clone", "aten::cat",
         "aten::stack", "aten::constant_pad_nd", "aten::repeat",
         "aten::flip", "aten::roll", "aten::slice_scatter",
         "aten::select_scatter", "aten::expand_copy",
         "aten::split_with_sizes_copy", "aten::contiguous"}
# factories: write their result only
_FACTORY = {"aten::zeros", "aten::ones", "aten::full", "aten::zeros_like",
            "aten::ones_like", "aten::full_like", "aten::new_zeros",
            "aten::new_ones", "aten::new_full", "aten::arange",
            "aten::scalar_tensor", "aten::zero_", "aten::fill_",
            "aten::randn", "aten::rand", "aten::normal_", "aten::uniform_"}
# windowed reads (2 x the result) and writes (2 x the update)
_GATHER = {"aten::index", "aten::gather", "aten::index_select",
           "aten::embedding", "aten::take_along_dim"}
_SCATTER = {"aten::index_put", "aten::index_put_", "aten::_index_put_impl_",
            "aten::scatter", "aten::scatter_", "aten::scatter_add",
            "aten::scatter_add_", "aten::index_add", "aten::index_add_",
            "aten::scatter_reduce", "aten::scatter_reduce_"}


@dataclasses.dataclass(frozen=True)
class T:
    """A tensor as the counts see it: its shape and dtype."""
    shape: tuple
    dtype: str

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * dtype_bytes(self.dtype)


def dtype_bytes(dtype) -> int:
    """Bytes of one element of a torch dtype (or its name)."""
    return _itemsize(str(dtype).replace("torch.", ""))


@functools.lru_cache(maxsize=None)
def _itemsize(name: str) -> int:
    return torch.empty((), dtype=getattr(torch, name),
                       device="meta").element_size()


def shape_numel(shape) -> int:
    return T(tuple(shape), "float32").numel


def shape_bytes(shape, dtype) -> int:
    """Bytes of a tensor of ``shape`` and ``dtype`` (the counterpart of
    ``hloparse.shape_bytes`` for an HLO type string)."""
    return shape_numel(shape) * dtype_bytes(dtype)


def describe(x):
    """``x`` (an op's arguments or result) with every tensor as a
    :class:`T` and every other value JSON-able."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return T(tuple(int(d) for d in v.shape),
                     str(v.dtype).replace("torch.", ""))
        if v is None or isinstance(v, (bool, int, float, str, T)):
            return v
        if isinstance(v, (torch.SymInt, torch.SymFloat)):
            return int(v) if isinstance(v, torch.SymInt) else float(v)
        return str(v)
    return tree_map(one, x)


def to_json(x):
    """A described tree as JSON values (T as {"t": shape, "d": dtype})."""
    if isinstance(x, T):
        return {"t": list(x.shape), "d": x.dtype}
    if isinstance(x, (list, tuple)):
        return [to_json(v) for v in x]
    if isinstance(x, dict):
        return {k: to_json(v) for k, v in x.items()}
    return x


def from_json(x):
    if isinstance(x, dict) and set(x) == {"t", "d"}:
        return T(tuple(x["t"]), x["d"])
    if isinstance(x, list):
        return [from_json(v) for v in x]
    if isinstance(x, dict):
        return {k: from_json(v) for k, v in x.items()}
    return x


def _tensors(x) -> List[T]:
    return [v for v in tree_flatten(x)[0] if isinstance(v, T)]


@functools.lru_cache(maxsize=None)
def _overload(name: str):
    """The OpOverload of ``ns.op.overload`` (None if unknown)."""
    ns, op, overload = name.rsplit(".", 2) if name.count(".") >= 2 \
        else (name, "", "")
    try:
        return getattr(getattr(getattr(torch.ops, ns), op), overload)
    except (AttributeError, RuntimeError):
        return None


def _schema_name(name: str) -> str:
    """"ns::op" of "ns.op.overload" (the overload dropped)."""
    ov = _overload(name)
    return ov._schema.name if ov is not None else name


@dataclasses.dataclass
class Cost:
    """The counts (``hloparse.Cost``'s fields)."""
    flops: float = 0.0
    traffic: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in KINDS})
    count: int = 0                        # collective ops

    @property
    def collective_total(self) -> float:
        return sum(self.collectives.values())

    def loop_aware(self) -> dict:
        """The reference's ``loop_aware`` record block."""
        return {"flops": self.flops, "traffic_bytes": self.traffic,
                "collective_bytes": dict(self.collectives),
                "collective_total": self.collective_total}

    def collective_record(self) -> dict:
        """The reference's ``collectives`` record block (by kind, plus
        ``count`` and ``total``)."""
        return dict(self.collectives, count=self.count,
                    total=self.collective_total)


def op_cost(name: str, args, kwargs, out):
    """(flops, traffic bytes, collective kind or None, collective bytes)
    of one op ``name`` ("aten.mm.default") on described arguments."""
    schema = _schema_name(name)
    if schema in _FUNCTIONAL:
        b = sum(t.nbytes for t in _tensors(out))
        return 0.0, float(b), _FUNCTIONAL[schema], float(b)
    if schema in _C10D:
        b = sum(t.nbytes for t in _tensors(args[:1]))
        return 0.0, float(b), _C10D[schema], float(b)
    ov = _overload(name)
    if schema in _FREE or name.startswith("prim.") or \
            schema.startswith(("c10d::", "_c10d_functional::")) or \
            (ov is not None and ov.is_view):
        return 0.0, 0.0, None, 0.0
    outs = _tensors(out)
    out_b = sum(t.nbytes for t in outs)
    if schema in _FACTORY:
        return 0.0, float(out_b), None, 0.0
    if schema in _GATHER:
        return float(sum(t.numel for t in outs)), 2.0 * out_b, None, 0.0
    if schema in _SCATTER:
        # index_put(self, indices, values); scatter(self, dim, index, src)
        at = 2 if "index_put" in schema else 3
        upd = _tensors(args[at:at + 1]) or outs
        return float(sum(t.numel for t in upd)), \
            2.0 * sum(t.nbytes for t in upd), None, 0.0
    traffic = float(sum(t.nbytes for t in _tensors((args, kwargs))) + out_b)
    if schema in _MOVE:
        return 0.0, traffic, None, 0.0
    flops = _registry_flops(name, ov, args, kwargs, out)
    if flops is None:
        flops = float(sum(t.numel for t in outs))
    return flops, traffic, None, 0.0


def _registry_flops(name, ov, args, kwargs, out):
    from torch.utils.flop_counter import flop_registry
    if ov is None or ov.overloadpacket not in flop_registry:
        return None

    def size(v):
        return torch.Size(v.shape) if isinstance(v, T) else v
    a, k, o = tree_map(size, (args, kwargs, out))
    return float(flop_registry[ov.overloadpacket](*a, **k, out_val=o))


@contextlib.contextmanager
def quiet_propagation():
    """Run DTensor's sharding propagation (its global-shaped shape
    inference on fake tensors) with every dispatch mode switched off, so
    that only a rank's own ops reach the counting modes."""
    from torch.distributed.tensor import _sharding_prop as sp
    from torch.utils._python_dispatch import _disable_current_modes
    cls = sp.ShardingPropagator
    name = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta") if hasattr(cls, n))
    orig = getattr(cls, name)

    def quiet(self, *a, **kw):
        with _disable_current_modes():
            return orig(self, *a, **kw)
    setattr(cls, name, quiet)
    try:
        yield
    finally:
        setattr(cls, name, orig)


class OpCount(TorchDispatchMode):
    """Counts every op issued under it (see the module docstring); the
    totals are :attr:`cost`, the op log (``log=True``) :attr:`ops`."""

    def __init__(self, *, log: bool = False):
        super().__init__()
        self.cost = Cost()
        self.ops: list = [] if log else None
        self._quiet = None

    def __enter__(self):
        self._quiet = quiet_propagation()
        self._quiet.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._quiet.__exit__(None, None, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor issues the local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.add(str(func), describe(args), describe(kwargs),
                 describe(out))
        return out

    def add(self, name, args, kwargs, out):
        flops, traffic, kind, coll = op_cost(name, args, kwargs, out)
        c = self.cost
        c.flops += flops
        c.traffic += traffic
        if kind is not None:
            c.collectives[kind] += coll
            c.count += 1
        if self.ops is not None and (flops or traffic):
            self.ops.append({"op": name, "args": to_json(args),
                             "kwargs": to_json(kwargs),
                             "out": to_json(out)})


def count_log(entries) -> Cost:
    """The counts of an op log (``OpCount(log=True).ops`` or its JSON
    lines), counted again by :func:`op_cost`."""
    c = OpCount()
    for e in entries:
        c.add(e["op"], from_json(e["args"]), from_json(e["kwargs"]),
              from_json(e["out"]))
    return c.cost


def gathers(entries) -> List[dict]:
    """Each all-gather of an op log: its result shape and bytes (the
    functional op's result, a c10d op's output tensors)."""
    out = []
    for e in entries:
        _, _, kind, b = op_cost(e["op"], from_json(e["args"]),
                                from_json(e["kwargs"]), from_json(e["out"]))
        if kind == "all-gather":
            res = _tensors(from_json(e["out"])) if \
                _schema_name(e["op"]) in _FUNCTIONAL else \
                _tensors(from_json(e["args"])[:1])
            out.append({"shape": [list(t.shape) for t in res],
                        "bytes": b})
    return out
