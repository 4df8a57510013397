"""Process groups, meshes and the tiled exchange of the distributed layer
(counterpart of :mod:`repro.dist._compat` and of ``make_mesh`` from
:mod:`repro.launch.mesh`).

The reference runs each distributed transform as one ``shard_map`` over a
mesh of emulated devices.  Here every rank is a process of a
``torch.distributed`` group, and each function of :mod:`repro_torch.dist`
*is* the per-rank body: it takes the rank's local block and returns the
rank's local block.  A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` with ``mesh_dim_names``
whose ranks are laid out row-major (rank ``r`` sits at
``numpy.unravel_index(r, shape)``); an axis name selects one of its groups,
and a rank's index along an axis (the reference's ``axis_index``) is
``mesh.get_local_rank(axis)``.  :func:`local_block` and :func:`assemble`
cut a global array into the blocks of a reference ``PartitionSpec`` and
put them back, given as tuples such as ``("data", None)`` or
``(("pod", "data"), None)``.

Backends: NCCL with one rank per card, gloo on the CPU.  NCCL refuses two
ranks on one card, so a host with fewer cards than ranks runs its ranks on
the shared card over gloo: the caller initialises the group with gloo and
passes ``make_mesh(backend="gloo")``, never as a retry after a failure.
Routes (checked on the card, torch 2.11): gloo's ``all_to_all_single``,
``all_reduce`` and ``all_gather`` take CUDA tensors (gloo copies them
through host memory itself), but its send and receive do not, so
point-to-point transfers on a gloo group that holds card tensors are
staged through pinned host buffers (:func:`p2p_route` says
``"gloo-host"``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              device="cuda", backend: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``names`` over the initialised
    default process group, ranks row-major.

    ``device`` is ``"cuda"`` (each rank's tensors on
    ``cuda:<rank % device_count>``) or ``"cpu"``.  ``backend`` names the
    backend the caller initialised the group with, and is checked against
    it; ``None`` accepts the group's.  NCCL with more ranks than cards is
    refused here rather than at the first collective: such a host runs its
    ranks over gloo.
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ "
                         "in length")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"make_mesh(backend={backend!r}) on a {have!r} "
                         "process group: initialise the group with the "
                         "backend the mesh is to use")
    dev = torch.device(device)
    if dev.type == "cuda" and have == "nccl" \
            and world > torch.cuda.device_count():
        raise ValueError(f"NCCL needs a card a rank: {world} ranks on "
                         f"{torch.cuda.device_count()} card(s); run the "
                         "ranks on the shared card over gloo")
    return DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Number of ranks along ``axis``."""
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def p2p_route(mesh: DeviceMesh, axis: str, device) -> str:
    """How a point-to-point transfer over ``axis`` moves a tensor on
    ``device``: ``"nccl"``, ``"gloo"`` or ``"gloo-host"`` (gloo's send and
    receive take CPU tensors only, so a gloo group holding card tensors,
    or a host-staged one, stages them through pinned host buffers)."""
    backend = dist.get_backend(mesh.get_group(axis))
    if backend in ("gloo", "gloo-host"):
        return "gloo-host" if torch.device(device).type == "cuda" \
            else "gloo"
    return backend


def exchange_blocks(x: torch.Tensor, mesh: DeviceMesh, axis: str,
                    split_axis: int) -> torch.Tensor:
    """The tiled exchange's wire step: cut ``x`` into p blocks along
    ``split_axis``, send block b to the rank at index b of ``axis`` and
    return the p received blocks stacked on a new leading dim, block b
    from the rank at index b."""
    p = axis_size(mesh, axis)
    if x.shape[split_axis] % p:
        raise ValueError(f"all_to_all over {axis!r} ({p} ranks) needs "
                         f"dim {split_axis} of {tuple(x.shape)} divisible "
                         f"by {p}")
    send = torch.stack(x.chunk(p, split_axis))       # (p, ...) contiguous
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group(axis))
    return recv


def concat_blocks(blocks: torch.Tensor, concat_axis: int) -> torch.Tensor:
    """Concatenate the stacked blocks of :func:`exchange_blocks` along
    ``concat_axis``, block-major (peer 0's block first)."""
    p = blocks.shape[0]
    moved = blocks.movedim(0, concat_axis)            # (..., p, c, ...)
    shape = list(blocks.shape[1:])
    shape[concat_axis] *= p
    return moved.reshape(shape)


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled all_to_all on one tensor: local ``split_axis`` shrinks by the
    axis size, ``concat_axis`` grows by it (peer-major order), as
    ``jax.lax.all_to_all(tiled=True)``."""
    return concat_blocks(exchange_blocks(x, mesh, axis, split_axis),
                         concat_axis)


def sendrecv(t: torch.Tensor, mesh: DeviceMesh, axis: str, *, dst: int,
             src: int) -> torch.Tensor:
    """Send ``t`` to the rank at index ``dst`` of ``axis`` and return what
    the rank at index ``src`` sent (one ``batch_isend_irecv`` pair; staged
    through pinned host buffers on a gloo group holding card tensors)."""
    group = mesh.get_group(axis)
    payload = t.contiguous()
    staged = p2p_route(mesh, axis, t.device) == "gloo-host"
    if staged:
        payload = payload.to("cpu").pin_memory()
    out = torch.empty_like(payload)
    ops = [dist.P2POp(dist.isend, payload,
                      dist.get_global_rank(group, dst), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src),
                      group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(t.device) if staged else out


def _layout(mesh):
    """(names, sizes) of a DeviceMesh, or of a dict {axis name: size} in
    mesh order (what a process outside the group passes)."""
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names), tuple(int(s) for s in mesh.shape)
    return tuple(mesh), tuple(int(s) for s in mesh.values())


def _block_slices(shape, mesh, spec, rank: int):
    names, sizes = _layout(mesh)
    coord = dict(zip(names, np.unravel_index(rank, sizes)))
    size = dict(zip(names, sizes))
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not match shape {shape}")
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        k, n = 0, 1
        for a in axes:                      # the first axis is the major
            k, n = k * size[a] + int(coord[a]), n * size[a]
        if dim % n:
            raise ValueError(f"dim {dim} of {shape} does not split over "
                             f"{axes} ({n} ranks)")
        out.append(slice(k * (dim // n), (k + 1) * (dim // n)))
    return tuple(out)


def local_block(x, mesh, spec, rank: Optional[int] = None):
    """The block of the global array ``x`` that ``rank`` (default: this
    process's) holds under the reference ``PartitionSpec`` ``spec``."""
    if rank is None:
        rank = dist.get_rank()
    return x[_block_slices(tuple(x.shape), mesh, spec, rank)]


def assemble(blocks, mesh, spec):
    """Inverse of :func:`local_block`: the global array from every rank's
    block (``blocks[r]`` from rank r), numpy arrays or tensors."""
    first = blocks[0]
    names, sizes = _layout(mesh)
    size = dict(zip(names, sizes))
    shape = []
    for dim, entry in zip(first.shape, spec):
        axes = () if entry is None else \
            ((entry,) if isinstance(entry, str) else tuple(entry))
        shape.append(dim * math.prod(size[a] for a in axes))
    if isinstance(first, torch.Tensor):
        out = first.new_empty(shape)
    else:
        out = np.empty(shape, np.asarray(first).dtype)
    for r, b in enumerate(blocks):
        out[_block_slices(tuple(shape), mesh, spec, r)] = b
    return out
