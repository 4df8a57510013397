"""A process-group backend for card tensors on a gloo group of ranks that
share one card (NCCL refuses two ranks on one card).

gloo's own collectives take card tensors through ``all_reduce``,
``all_gather`` and ``all_to_all_single`` (``_compat``), but the
functional collectives DTensor issues (``all_gather_into_tensor``,
``reduce_scatter_tensor``) on card tensors crash a gloo rank (seen on the
card with torch 2.11: a segmentation fault in ``wait_tensor`` at the
sharded step's first redistribution).  :class:`HostStaged` runs every
collective of card tensors as gloo's CPU collective on host copies, then
copies the results back, synchronously: a collective's cost is its host
round trip.  :data:`SPENT` adds up the wall time spent in them, the
calls, and the bytes each brought the rank by collective kind (its
result, as :mod:`repro_torch.analysis.opcount` counts a rank's
collectives, so a dry run's counts can be checked against a real run's).
Point-to-point sends and receives (the pipeline's ring shift) go over
gloo as they are; a receive counts as ``collective-permute``.
Initialise a group with ``backend=NAME`` (``"gloo-host"``, which takes
host tensors too); importing :mod:`repro_torch.dist` registers it.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist
import torch._C._distributed_c10d as c10d
from torch._C._distributed_c10d import _create_work_from_future
from torch.futures import Future

NAME = "gloo-host"
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
# wall time inside the collectives, their calls, result bytes by kind
SPENT = {"seconds": 0.0, "calls": 0, "bytes": dict.fromkeys(KINDS, 0)}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _done(result):
    fut = Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu")


def _timed(fn, kind=None, result=None):
    """Count a collective's wall time, host copies included, in SPENT, and
    (``kind``) the bytes of its result tensors, ``result(*args)``."""
    def run(*args, **kw):
        if kind is not None:
            SPENT["bytes"][kind] += _nbytes(result(*args))
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            SPENT["seconds"] += time.perf_counter() - t0
            SPENT["calls"] += 1
    return run


class HostStaged(dist.ProcessGroup):
    """The collectives DTensor and the port issue, on host copies over a
    gloo group of the same ranks.  Each returns a completed work."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)

    def getBackendName(self):
        return NAME

    @property
    def group_name(self):
        return dist.distributed_c10d._world.pg_names[self]

    def _back(self, outs, hosts):
        with torch.no_grad():
            for o, h in zip(outs, hosts):
                o.copy_(h)
        return _done(outs)

    def allreduce(self, tensors, opts=c10d.AllreduceOptions()):
        hosts = [_host(t) for t in tensors]
        self._gloo.allreduce(hosts, opts).wait()
        return self._back(tensors, hosts)

    def allreduce_coalesced(self, tensors, opts=c10d.AllreduceOptions()):
        return self.allreduce(tensors, opts)

    def broadcast(self, tensors, opts=c10d.BroadcastOptions()):
        hosts = [_host(t) for t in tensors]
        self._gloo.broadcast(hosts, opts).wait()
        return self._back(tensors, hosts)

    def allgather(self, outputs, inputs, opts=c10d.AllgatherOptions()):
        hosts = [[torch.empty_like(_host(t)) for t in out] for out in outputs]
        self._gloo.allgather(hosts, [_host(t) for t in inputs]).wait()
        flat = [t for out in outputs for t in out]
        return self._back(flat, [h for out in hosts for h in out])

    def all_gather_single(self, output, input, opts=c10d.AllgatherOptions()):
        host = torch.empty(output.shape, dtype=output.dtype)
        self._gloo._allgather_base(host, _host(input)).wait()
        return self._back([output], [host])

    def all_gather_single_coalesced(self, outputs, inputs,
                                    opts=c10d.AllgatherOptions()):
        for o, i in zip(outputs, inputs):
            self.all_gather_single(o, i, opts)
        return _done(outputs)

    def allgather_into_tensor_coalesced(self, outputs, inputs,
                                        opts=c10d.AllgatherOptions()):
        return self.all_gather_single_coalesced(outputs, inputs, opts)

    def reduce_scatter(self, outputs, input_lists,
                       opts=c10d.ReduceScatterOptions()):
        hosts = [_host(t) for t in outputs]
        self._gloo.reduce_scatter(
            hosts, [[_host(t) for t in ins] for ins in input_lists],
            opts).wait()
        return self._back(outputs, hosts)

    def reduce_scatter_single(self, output, input,
                              opts=c10d.ReduceScatterOptions()):
        host = torch.empty(output.shape, dtype=output.dtype)
        self._gloo._reduce_scatter_base(host, _host(input), opts).wait()
        return self._back([output], [host])

    def reduce_scatter_single_coalesced(self, outputs, inputs,
                                        opts=c10d.ReduceScatterOptions()):
        for o, i in zip(outputs, inputs):
            self.reduce_scatter_single(o, i, opts)
        return _done(outputs)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs,
                                        opts=c10d.ReduceScatterOptions()):
        return self.reduce_scatter_single_coalesced(outputs, inputs, opts)

    def all_to_all_single(self, output, input, output_split_sizes,
                          input_split_sizes, opts=c10d.AllToAllOptions()):
        host = torch.empty(output.shape, dtype=output.dtype)
        self._gloo.alltoall_base(host, _host(input), output_split_sizes,
                                 input_split_sizes, opts).wait()
        return self._back([output], [host])

    def alltoall(self, outputs, inputs, opts=c10d.AllToAllOptions()):
        hosts = [torch.empty(t.shape, dtype=t.dtype) for t in outputs]
        self._gloo.alltoall(hosts, [_host(t) for t in inputs], opts).wait()
        return self._back(outputs, hosts)

    def scatter(self, outputs, input_lists, opts=c10d.ScatterOptions()):
        hosts = [_host(t) for t in outputs]
        self._gloo.scatter(hosts, [[_host(t) for t in ins]
                                   for ins in input_lists], opts).wait()
        return self._back(outputs, hosts)

    def gather(self, output_lists, inputs, opts=c10d.GatherOptions()):
        hosts = [[_host(t) for t in outs] for outs in output_lists]
        self._gloo.gather(hosts, [_host(t) for t in inputs], opts).wait()
        return self._back([t for outs in output_lists for t in outs],
                          [h for outs in hosts for h in outs])

    def send(self, tensors, dst, tag=0):
        return self._gloo.send([_host(t) for t in tensors], dst, tag)

    def recv(self, tensors, src, tag=0):
        hosts = [torch.empty(t.shape, dtype=t.dtype) for t in tensors]
        self._gloo.recv(hosts, src, tag).wait()
        return self._back(tensors, hosts)

    def barrier(self, opts=c10d.BarrierOptions()):
        self._gloo.barrier(opts).wait()
        return _done(None)


def _flat(lists):
    return [t for ts in lists for t in ts]


# the methods' result tensors: (self, outputs, ...) or (self, tensors, ...)
_COUNTED = {
    "allreduce": ("all-reduce", lambda self, ts, *a: ts),
    "broadcast": ("all-gather", lambda self, ts, *a: ts),
    "allgather": ("all-gather", lambda self, outs, *a: _flat(outs)),
    "all_gather_single": ("all-gather", lambda self, out, *a: [out]),
    "reduce_scatter": ("reduce-scatter", lambda self, outs, *a: outs),
    "reduce_scatter_single": ("reduce-scatter", lambda self, out, *a: [out]),
    "all_to_all_single": ("all-to-all", lambda self, out, *a: [out]),
    "alltoall": ("all-to-all", lambda self, outs, *a: outs),
    "recv": ("collective-permute", lambda self, ts, *a: ts),
}
for _name in ("allreduce", "broadcast", "allgather", "all_gather_single",
              "reduce_scatter", "reduce_scatter_single", "all_to_all_single",
              "alltoall", "scatter", "gather", "barrier", "send", "recv"):
    setattr(HostStaged, _name, _timed(getattr(HostStaged, _name),
                                      *_COUNTED.get(_name, (None, None))))
# the names torch's bindings call these by, too
for _name, _to in (("_allgather_base", "all_gather_single"),
                   ("_reduce_scatter_base", "reduce_scatter_single"),
                   ("alltoall_base", "all_to_all_single")):
    setattr(HostStaged, _name, getattr(HostStaged, _to))


def _create(store, rank, size, timeout):
    return HostStaged(store, rank, size, timeout)


def register() -> None:
    """Register the backend (once a process)."""
    if NAME not in dist.Backend.backend_list:
        dist.Backend.register_backend(NAME, _create, devices=["cpu", "cuda"])
