"""Dispatch wrappers around the kernels (counterpart of
:mod:`repro.kernels.ops`).

Each wrapper flattens leading batch dims, guards the empty batch and then
decides by the tensor's device: on a CPU tensor it runs the kernel's plain
PyTorch version (what the CPU tests use); on a CUDA tensor it launches the
CUDA kernel or raises.  There is no fallback from the card to the plain
version.  CUDA kernels need no batch padding, so the complex wrappers
accept ``block_batch`` for plan parity and do not use it.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card (one count per call; a call issues several grid launches, see
PERF.md).  The radix-2 Stockham kernel counts apart from the radix-4 one.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.complexmath import SplitComplex
from . import fft_stockham as _stockham
from . import fft_fourstep as _fourstep
from . import fft2d_gemm as _gemm2d
from . import rfft2d_fused as _rfused2d

LAUNCHES = {"fft_stockham": 0, "fft_stockham_r2": 0, "fft_fourstep": 0,
            "fft2d_gemm": 0, "rfft2d_fused": 0, "irfft2d_fused": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_card(t: torch.Tensor) -> bool:
    dev = t.device
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {dev}")


def _flatten(x: SplitComplex):
    """(batch, n) planes, contiguous (the kernels take dense rows; the
    real-input paths hand in strided even/odd and transposed views)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    return SplitComplex(x.re.reshape(-1, n).contiguous(),
                        x.im.reshape(-1, n).contiguous()), lead


def _unflatten(x: SplitComplex, lead) -> SplitComplex:
    n = x.shape[-1]
    return SplitComplex(x.re.reshape(*lead, n), x.im.reshape(*lead, n))


def _flatten2d(x: SplitComplex):
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    return SplitComplex(x.re.reshape(-1, h, w),
                        x.im.reshape(-1, h, w)), lead


def fft_stockham(x: SplitComplex, *, inverse: bool = False, radix: int = 4,
                 block_batch: int = 8) -> SplitComplex:
    """Stockham FFT along the last axis: mixed radix-4/radix-2
    (``radix=4``) or pure radix-2 (``radix=2``, the oracle kernel)."""
    if radix not in (2, 4):
        raise ValueError(f"radix must be 2 or 4, got {radix}")
    flat, lead = _flatten(x)
    if flat.shape[0] == 0:
        return x                       # empty batch: nothing to transform
    if radix == 2:
        name, cuda = "fft_stockham_r2", _stockham.fft_stockham_r2_cuda
        plain = _stockham.fft_stockham_r2_plain
    else:
        name, cuda = "fft_stockham", _stockham.fft_stockham_cuda
        plain = _stockham.fft_stockham_plain
    if _on_card(flat.re):
        LAUNCHES[name] += 1
        out = cuda(flat, inverse=inverse)
    else:
        out = plain(flat, inverse=inverse)
    return _unflatten(out, lead)


def fft_fourstep(x: SplitComplex, *, inverse: bool = False,
                 block_batch: int = 4, n1: int = None) -> SplitComplex:
    """Bailey four-step FFT along the last axis."""
    flat, lead = _flatten(x)
    if flat.shape[0] == 0:
        return x
    if _on_card(flat.re):
        LAUNCHES["fft_fourstep"] += 1
        out = _fourstep.fft_fourstep_cuda(flat, inverse=inverse, n1=n1)
    else:
        out = _fourstep.fft_fourstep_plain(flat, inverse=inverse, n1=n1)
    return _unflatten(out, lead)


def fft2d_gemm(x: SplitComplex, *, inverse: bool = False,
               block_batch: int = 1, variant: str = "plain") -> SplitComplex:
    """GEMM-formulated 2-D FFT over the last two axes (any leading batch
    dims).  ``variant="compensated"`` raises until it is ported."""
    flat, lead = _flatten2d(x)
    h, w = flat.shape[-2:]
    if flat.shape[0] == 0:
        _gemm2d.check_variant(variant)
        return x
    if _on_card(flat.re):
        LAUNCHES["fft2d_gemm"] += 1
        out = _gemm2d.fft2d_gemm_cuda(flat, inverse=inverse, variant=variant)
    else:
        out = _gemm2d.fft2d_gemm_plain(flat, inverse=inverse, variant=variant)
    return SplitComplex(out.re.reshape(*lead, h, w),
                        out.im.reshape(*lead, h, w))


def rfft2d_fused(x: torch.Tensor) -> SplitComplex:
    """Real-input 2-D FFT over the last two axes (any leading batch dims):
    real (..., h, w) -> (..., h, w//2+1) half spectra."""
    h, w = x.shape[-2:]
    lead = tuple(x.shape[:-2])
    batch = math.prod(lead)
    if batch == 0:
        return SplitComplex(x.new_zeros((*lead, h, w // 2 + 1)),
                            x.new_zeros((*lead, h, w // 2 + 1)))
    flat = x.reshape(batch, h, w).contiguous()
    if _on_card(flat):
        LAUNCHES["rfft2d_fused"] += 1
        out = _rfused2d.rfft2d_fused_cuda(flat)
    else:
        out = _rfused2d.rfft2d_fused_plain(flat)
    return SplitComplex(out.re.reshape(*lead, h, w // 2 + 1),
                        out.im.reshape(*lead, h, w // 2 + 1))


def irfft2d_fused(xf: SplitComplex) -> torch.Tensor:
    """Inverse of :func:`rfft2d_fused`: (..., h, w/2+1) half spectra ->
    real (..., h, w)."""
    h, bins = xf.shape[-2:]
    w = 2 * (bins - 1)
    lead = tuple(xf.shape[:-2])
    batch = math.prod(lead)
    if batch == 0:
        return xf.re.new_zeros((*lead, h, w))
    flat = SplitComplex(xf.re.reshape(batch, h, bins).contiguous(),
                        xf.im.reshape(batch, h, bins).contiguous())
    if _on_card(flat.re):
        LAUNCHES["irfft2d_fused"] += 1
        out = _rfused2d.irfft2d_fused_cuda(flat)
    else:
        out = _rfused2d.irfft2d_fused_plain(flat)
    return out.reshape(*lead, h, w)
