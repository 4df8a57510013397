"""Dispatch wrappers around the kernels (counterpart of
:mod:`repro.kernels.ops`).

Each wrapper flattens leading batch dims, guards the empty batch and then
decides by the tensor's device: on a CPU tensor it runs the kernel's plain
PyTorch version (what the CPU tests use); on a CUDA tensor it launches the
CUDA kernel or raises.  There is no fallback from the card to the plain
version.  CUDA kernels need no batch padding, so ``block_batch`` is
accepted for plan parity and not used.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card (one count per call; a call issues several grid launches, see
PERF.md).
"""
from __future__ import annotations

from repro_torch.core.complexmath import SplitComplex
from . import fft_stockham as _stockham
from . import fft_fourstep as _fourstep
from . import fft2d_gemm as _gemm2d

LAUNCHES = {"fft_stockham": 0, "fft_fourstep": 0, "fft2d_gemm": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_card(x: SplitComplex) -> bool:
    dev = x.re.device
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {dev}")


def _flatten(x: SplitComplex):
    n = x.shape[-1]
    lead = x.shape[:-1]
    return SplitComplex(x.re.reshape(-1, n), x.im.reshape(-1, n)), lead


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
    """Mixed radix-4/radix-2 Stockham FFT along the last axis."""
    if radix != 4:
        raise NotImplementedError(
            "the radix-2 Stockham kernel (_stockham_kernel_r2) is not ported "
            "yet: ROADMAP 'TPU kernels to port' item 3")
    flat, lead = _flatten(x)
    if flat.shape[0] == 0:
        return x                       # empty batch: nothing to transform
    if _on_card(flat):
        LAUNCHES["fft_stockham"] += 1
        out = _stockham.fft_stockham_cuda(flat, inverse=inverse)
    else:
        out = _stockham.fft_stockham_plain(flat, inverse=inverse)
    return _unflatten(out, lead)


def fft_fourstep(x: SplitComplex, *, inverse: bool = False,
                 block_batch: int = 4, n1: int = None) -> SplitComplex:
    """Bailey four-step FFT along the last axis."""
    flat, lead = _flatten(x)
    if flat.shape[0] == 0:
        return x
    if _on_card(flat):
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
    if _on_card(flat):
        LAUNCHES["fft2d_gemm"] += 1
        out = _gemm2d.fft2d_gemm_cuda(flat, inverse=inverse, variant=variant)
    else:
        out = _gemm2d.fft2d_gemm_plain(flat, inverse=inverse, variant=variant)
    return SplitComplex(out.re.reshape(*lead, h, w),
                        out.im.reshape(*lead, h, w))
