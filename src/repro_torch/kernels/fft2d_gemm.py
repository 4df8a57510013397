"""GEMM-formulated complex 2-D FFT: the CUDA kernel and its plain PyTorch
version.

Replaces ``repro/kernels/fft2d_gemm.py::_fft2d_gemm_kernel``
(``variant="plain"``): a one-level four-step row pass
(:func:`~repro_torch.kernels.rfft2d_fused.fft_last_fourstep`), a column
pass of left-side contractions
(:func:`~repro_torch.kernels.rfft2d_fused.fft_col_fourstep`, no transpose
materialised) and one 1/(H*W) for the inverse, from 12 host-built tables.

The TPU kernel keeps one image in VMEM; a 1024^2 fp32 image is 8 MB and
the dense-leaf table (n <= 256) alone is 512 KB, against 227 KB of shared
memory per block.  ``csrc/fft2d_gemm.cu`` therefore runs each four-step
step as a launch of one tiled complex fp32 GEMM (``csrc/cgemm.cuh``),
chained through one scratch buffer that the wrapper allocates, with the
twiddles in GEMM epilogues.  What bounds it: the transform itself is
bound by bytes (16 per complex point in and out), but the four-step
method does 8*n*(n1+n2) flops per row and per column, 10x the FFT's
5*n*log2(n) at 1024^2, so this design is bound by those fp32 operations;
the HBM round trips between the steps are its known extra traffic.
"""
from __future__ import annotations

import torch

from repro_torch.core.complexmath import SplitComplex
from . import _build
from .rfft2d_fused import (fourstep_factors, fft_last_fourstep,
                           fft_col_fourstep, _check_dims, MAX_DIM)
from .rfft2d_fused import tables as gemm_tables  # the 12 table operands

VARIANTS = ("plain", "compensated")


def check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if variant == "compensated":
        raise NotImplementedError(
            'variant="compensated" (bf16 split tables) is not ported yet: '
            "ROADMAP 'Modules to port' item 8")


def fft2d_gemm_plain(x: SplitComplex, *, inverse: bool = False,
                     variant: str = "plain") -> SplitComplex:
    """The kernel's arithmetic in plain PyTorch on (batch, h, w) planes."""
    check_variant(variant)
    _, h, w = x.shape
    _check_dims(h, w)
    tabs = gemm_tables(h, w, inverse, x.dtype, x.device)
    re, im = fft_last_fourstep(x.re, x.im, tabs[:6], *fourstep_factors(w))
    re, im = fft_col_fourstep(re, im, tabs[6:], *fourstep_factors(h))
    if inverse:
        re, im = re * (1.0 / (h * w)), im * (1.0 / (h * w))
    return SplitComplex(re, im)


_ARGS = [_build.P] * 18 + [_build.L] + [_build.I] * 5 + [_build.P]


def fft2d_gemm_cuda(x: SplitComplex, *, inverse: bool = False,
                    variant: str = "plain") -> SplitComplex:
    """Launch the GEMM row and column passes on (batch, h, w) CUDA planes."""
    check_variant(variant)
    _build.check_operands(x, 3)
    batch, h, w = x.shape
    _check_dims(h, w)
    if h > MAX_DIM or w > MAX_DIM:
        raise ValueError(f"the CUDA 2-D kernel takes H, W <= {MAX_DIM}, "
                         f"got {(h, w)}")
    tabs = gemm_tables(h, w, inverse, torch.float32, x.device)
    out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    scratch = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    fn = _build.function("fft2d_gemm", "fft2d_gemm_f32", _ARGS)
    ptrs = [x.re, x.im, out.re, out.im, scratch.re, scratch.im, *tabs]
    _build.launch(fn, [p.data_ptr() for p in ptrs] + [
        batch, h, w, fourstep_factors(w)[0], fourstep_factors(h)[0],
        int(inverse)], "fft2d_gemm_f32", x.device)
    return out
