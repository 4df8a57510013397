"""FNet-style Fourier token mixing (counterpart of
:mod:`repro.core.spectral`).

``fourier_mix`` replaces self-attention with Re(FFT_seq(FFT_model(x))): a
parameter-free O(S log S) token mixer (Lee-Thorp et al., FNet).  With
``algo="auto"`` both 1-D transforms route through the plan registry, so
the (d_model,) and (seq,) dispatch decisions are resolved once per
shape/dtype/backend.  ``backend="cuda"`` runs both axis transforms on the
1-D kernels; sizes with no kernel path demote to torch with the
registry's ``demote_reason``.
"""
from __future__ import annotations

import torch

from .complexmath import SplitComplex, from_real
from . import fft1d


def _fft_last(z: SplitComplex, *, algo: str, backend: str) -> SplitComplex:
    """Last-axis forward FFT honouring ``backend``: registry-routed for
    ``algo="auto"`` (the only path with a backend notion), direct
    otherwise."""
    if algo == "auto":
        from . import plan as _plan
        return _plan.get_plan((z.shape[-1],), dtype=z.dtype,
                              backend=backend)(z)
    return fft1d.fft(z, algo=algo)


def fourier_mix(x: torch.Tensor, *, algo: str = "auto",
                backend: str = "torch") -> torch.Tensor:
    """x: (..., seq, d_model) -> Re(FFT over d_model then over seq)."""
    z = from_real(x)
    z = _fft_last(z, algo=algo, backend=backend)    # over d_model (last axis)
    z = SplitComplex(z.re.transpose(-1, -2), z.im.transpose(-1, -2))
    z = _fft_last(z, algo=algo, backend=backend)    # over seq
    return z.re.transpose(-1, -2)
