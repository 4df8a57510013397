"""Fused complex 3-D FFT: the CUDA kernel and its plain PyTorch version, in
float32, bfloat16 and float16.

Replaces ``repro/kernels/fft3d_fused.py::_fft3d_kernel`` (both variants).
The plain version keeps the reference's arithmetic: three one-level
four-step GEMM passes over a (batch, D, H, W) volume with no relayout
materialised:

- W pass: :func:`~repro_torch.kernels.rfft2d_fused.fft_last_fourstep` on
  the contiguous last axis;
- H pass: :func:`~repro_torch.kernels.rfft2d_fused.fft_col_fourstep` along
  axis -2, a left-side contraction;
- D pass: the same contraction on the (batch, D, H*W) view, so D is the
  contracted axis and the D-H-W relayout disappears the same way;

with one 1/(D*H*W) for the inverse, from 18 host-built tables (6 per axis,
W, H, then D) split by :func:`fourstep_factors3` (a dense DFT at
n <= :data:`FOURSTEP_LEAF3`).

The TPU kernel keeps a whole brick in VMEM.  On the card the method's
8*(n1 + n2) flops a point an axis bound it on the CUDA cores, while the
function is bound by bytes, so ``csrc/fft3d_fused.cu`` runs radix-16
Stockham FFTs in shared memory (``csrc/axis_fft.cuh``) in the fewest
passes over device memory (:func:`~repro_torch.kernels.axis_fft.plan3d`):
for h*w <= 16384 a plane launch (W and H on whole images) and the D FFT
on tiles of adjacent columns of the (batch, d, h*w) view, else W on rows,
H and D on columns; all but the first in place in the output.

bfloat16 and float16 follow :mod:`repro_torch.kernels.fft2d_gemm`'s
definitions: the compensated variant rounds the tile to the storage dtype
after the W and after the H pass (the kernel stores those boundaries so),
the plain variant after every GEMM step, the products on the tensor
cores (``csrc/dft_mma.cuh``: W on rows, H and D on tiles of columns, one
launch an axis).
"""
from __future__ import annotations

import torch

from repro_torch.core.complexmath import SplitComplex
from repro_torch.core.fft1d import _best_split
from . import _build, axis_fft, dft_mma
from .rfft2d_fused import (fourstep_tables_np, fft_last_fourstep,
                           fft_col_fourstep)
from .fft2d_gemm import (DTYPES, check_variant, check_dtype,
                         _operands,
                         compute_dtype, axis_tables, roundings, on_dft_mma)

# The fused brick runs three passes back to back, so its dense-leaf
# crossover sits one octave below the 2-D kernel's (the reference's
# constant, mirrored by its cost model).
FOURSTEP_LEAF3 = 128


def fourstep_factors3(n: int):
    """(n1, n2) for one axis of the fused 3-D kernel (n1 == 1 means a
    single dense DFT matmul)."""
    n1 = 1 if n <= FOURSTEP_LEAF3 else _best_split(n)
    return n1, n // n1


def _check_dims3(d: int, h: int, w: int):
    for n in (d, h, w):
        if n & (n - 1) or n < 2:
            raise ValueError("the fused 3-D kernel needs power-of-two "
                             f"dims >= 2, got {(d, h, w)}")


def gemm_tables3(d: int, h: int, w: int, inverse: bool, dtype,
                 variant: str) -> list:
    """The reference kernel's 18 table operands (6 per axis: W, H, then D),
    plain-cast or split-stacked per ``variant``, as CPU tensors."""
    tabs = (fourstep_tables_np(w, inverse, fourstep_factors3(w))
            + fourstep_tables_np(h, inverse, fourstep_factors3(h))
            + fourstep_tables_np(d, inverse, fourstep_factors3(d)))
    return _operands(tabs, dtype, variant)


def _tables3(d, h, w, inverse, dtype, variant, device) -> tuple:
    return sum((axis_tables(n, fourstep_factors3(n), inverse, dtype, variant,
                            device) for n in (w, h, d)), ())


def fft3d_fused_plain(x: SplitComplex, *, inverse: bool = False,
                      variant: str = "plain") -> SplitComplex:
    """The kernel's arithmetic in plain PyTorch on (batch, d, h, w)
    planes."""
    check_variant(variant)
    check_dtype(x.dtype)
    bb, d, h, w = x.shape
    _check_dims3(d, h, w)
    dt = x.dtype
    rnd, mid = roundings(dt, variant)
    tabs = _tables3(d, h, w, inverse, dt, variant, x.device)
    re, im = x.re.to(compute_dtype(dt)), x.im.to(compute_dtype(dt))
    re, im = fft_last_fourstep(re, im, tabs[:6], *fourstep_factors3(w),
                               mid=mid)                           # W pass
    re, im = rnd(re), rnd(im)
    re, im = fft_col_fourstep(re, im, tabs[6:12], *fourstep_factors3(h),
                              mid=mid)                            # H pass
    re, im = rnd(re), rnd(im)
    re, im = fft_col_fourstep(re.reshape(bb, d, h * w),
                              im.reshape(bb, d, h * w), tabs[12:],
                              *fourstep_factors3(d), mid=mid)     # D pass
    re, im = re.reshape(bb, d, h, w), im.reshape(bb, d, h, w)
    if inverse:
        re, im = re * (1.0 / (d * h * w)), im * (1.0 / (d * h * w))
    return SplitComplex(re.to(dt), im.to(dt))


def fft3d_fused_cuda(x: SplitComplex, *, inverse: bool = False,
                     variant: str = "plain") -> SplitComplex:
    """Launch the 3-D FFT on (batch, d, h, w) CUDA planes (float32,
    bfloat16 or float16): the planned shared-memory FFT passes, or the
    tensor-core DFT products for plain bf16 and float16."""
    return _fft3d_cuda(x, inverse=inverse, variant=variant)


def _fft3d_cuda(x: SplitComplex, *, inverse: bool = False,
                variant: str = "plain", planes=None) -> SplitComplex:
    """:func:`fft3d_fused_cuda`; ``planes`` picks the route where h*w
    allows both (:func:`~repro_torch.kernels.axis_fft.plan3d`), for
    timing them against each other."""
    check_variant(variant)
    check_dtype(x.dtype)
    _build.check_operands(x, 4, DTYPES)
    batch, d, h, w = x.shape
    _check_dims3(d, h, w)
    out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    if not on_dft_mma(x.dtype, variant):
        fn = _build.function("fft3d_fused", "fft3d_fused_pass", axis_fft.ARGS)
        axis_fft.run(fn, axis_fft.plan3d(batch, d, h, w, planes), x, out,
                     d * h * w, inverse, "fft3d_fused")
        return out
    fn = _build.function("fft3d_fused", "fft3d_fused_plain_pass",
                         dft_mma.ARGS)
    dft_mma.run(fn, (d, h, w), fourstep_factors3, x, out, inverse,
                "fft3d_fused")
    return out
