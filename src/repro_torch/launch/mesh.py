"""Production mesh construction (counterpart of :mod:`repro.launch.mesh`).

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` with
``mesh_dim_names`` over the initialised default process group, ranks
row-major (:func:`repro_torch.dist._compat.make_mesh`).  Defined as
functions, so importing this module touches no process group.  A mesh
whose size differs from the group's raises, as ``jax.make_mesh`` does
when the device count differs.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.dist import _compat


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         backend: Optional[str] = None):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device, backend=backend)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cuda",
              backend: Optional[str] = None):
    """Arbitrary named mesh over the process group."""
    return _compat.make_mesh(tuple(shape), tuple(axes), device=device,
                             backend=backend)


def axis_sizes(mesh) -> dict:
    """{axis name: size} in mesh order, of a ``DeviceMesh`` or of any mesh
    object with ``axis_names`` and a ``shape`` mapping (the reference's
    ``Mesh``, or a stand-in for one)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def data_axes(mesh) -> tuple:
    """The batch-sharding axes for this mesh ((pod, data) when present)."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def model_axis(mesh) -> str:
    return "model"
