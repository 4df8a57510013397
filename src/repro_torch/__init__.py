"""repro_torch — the FFT system of :mod:`repro` in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors ``repro``'s module names (``core.fft2d``, ``core.plan``,
``kernels.ops``, ...) so each module's counterpart is easy to find.  It
imports ``torch`` and numpy only: never ``jax`` and nothing of ``repro``.

Backend names: ``"cuda"`` (the hand-written kernels; on a CPU tensor each
kernel wrapper runs its plain PyTorch version) takes the place of
``"pallas"``, and ``"torch"`` (plain PyTorch algorithms) the place of
``"jnp"``.  Every function that allocates takes ``device=``, defaulting to
``"cuda"``; the CPU is used only when the caller asks for it.
"""
from __future__ import annotations

import torch


def device(name="cuda") -> torch.device:
    """Resolve ``name`` to a :class:`torch.device`, raising when a CUDA
    device is asked for and none is present (no silent CPU fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev
