"""Complex 2-D FFT: the CUDA kernel and its plain PyTorch version, in
float32, bfloat16 and float16.

Replaces ``repro/kernels/fft2d_gemm.py::_fft2d_gemm_kernel`` (both
variants).  The plain version keeps the reference's arithmetic: a one-level
four-step row pass
(:func:`~repro_torch.kernels.rfft2d_fused.fft_last_fourstep`), a column
pass of left-side contractions
(:func:`~repro_torch.kernels.rfft2d_fused.fft_col_fourstep`, no transpose
materialised) and one 1/(H*W) for the inverse, from 12 host-built tables.

The TPU kernel keeps one image in VMEM and runs those DFT matmuls on its
matrix unit.  On the card the four-step method costs 8*(n1 + n2) flops a
point an axis on the CUDA cores, 10x the FFT's 5*log2(n) at 1024^2, while
the function is bound by bytes (16 per complex point in and out).  So
``csrc/fft2d_gemm.cu`` runs radix-16 Stockham FFTs in shared memory
(``csrc/axis_fft.cuh``) in the fewest passes over device memory
(:func:`~repro_torch.kernels.axis_fft.plan2d`): one launch holding whole
images for h*w <= 16384, else the W FFT on rows, then the H FFT on tiles
of adjacent columns, in place in the output; its twiddles come from one
fp32 table of n entries an axis
(:func:`~repro_torch.kernels.axis_fft.twiddle_table`).  It agrees with
the plain version to fp32 rounding.

bfloat16 and float16 storage (the reference's ``itemsize < 4`` dtypes):

- ``variant="compensated"``: the reference splits every table into a bf16
  pair ``hi + lo`` to fit VMEM and sums them in fp32 inside the kernel;
  ``fp32(hi) + fp32(lo)`` is exact, so the port builds that fp32 sum once
  per key (``core/twiddle.py``'s cache) for the plain version.  The input
  is widened to fp32, each pass computes in fp32, the tile is rounded to
  the storage dtype after the row pass (the kernel stores it so), and the
  output is cast to it.  This is the plans' variant for both dtypes.
- ``variant="plain"``: XLA rounds every einsum and every elementwise
  result to bf16, which a GEMM kernel cannot match op for op.  The port
  defines plain bf16 as: tables rounded to bf16 (the ``hi`` half), fp32
  accumulation inside each complex GEMM (twiddle included), and every
  GEMM step's output rounded to bf16.  A Stockham FFT has no such rounding
  points, so this variant runs the four-step products themselves, on the
  tensor cores (``csrc/dft_mma.cuh``, planned by
  :mod:`~repro_torch.kernels.dft_mma`): every operand is a bf16 value and
  mma.sync accumulates in fp32, so the kernel and the plain version agree
  to the order of the fp32 sums (bf16 rounding ties).  One launch an axis
  in bf16 through device memory, no fp32 scratch.  Plain float16 is the
  same in float16 (tables rounded to float16, every GEMM step's output
  rounded to float16, ``csrc/f16.cuh``, mma.sync's f16 form); no plan
  resolves to it.

Rounding is to nearest even, as torch's float -> bfloat16 and float ->
float16 casts do (``csrc/bf16.cuh``, ``csrc/f16.cuh``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.complexmath import SplitComplex
from repro_torch.core.twiddle import _cast
from . import _build, axis_fft, dft_mma
from .rfft2d_fused import (fourstep_factors, fourstep_tables_np,
                           fft_last_fourstep, fft_col_fourstep, _check_dims)

VARIANTS = ("plain", "compensated")
DTYPES = _build.FFT_DTYPES                   # what the CUDA kernels store


def check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def check_dtype(dtype: torch.dtype) -> None:
    """The GEMM transforms store float32, bfloat16 or float16 (float64 runs
    on the CPU only), the storage dtypes the reference's kernels take."""
    if dtype.itemsize < 4 and dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"the GEMM kernels take float32, bfloat16 or "
                        f"float16, got {dtype}")


def split_table_np(t: np.ndarray, dtype) -> torch.Tensor:
    """Stack the ``(hi, lo)`` split of a float64 table in storage dtype:
    ``hi`` is the direct rounding, ``lo`` the rounding of the residual, so
    ``hi + lo`` (accumulated in fp32) recovers the table to ~storage-eps^2
    accuracy from two narrow operands."""
    t = np.asarray(t, np.float64)
    hi = torch.from_numpy(t).to(dtype)
    lo = torch.from_numpy(t - hi.double().numpy()).to(dtype)
    return torch.stack([hi, lo])


def _operands(tabs, dtype, variant: str) -> list:
    if variant == "compensated":
        return [split_table_np(t, dtype) for t in tabs]
    return [torch.from_numpy(np.asarray(t)).to(dtype) for t in tabs]


def gemm_tables(h: int, w: int, inverse: bool, dtype, variant: str) -> list:
    """The reference kernel's 12 table operands (6 per axis, W then H),
    plain-cast or split-stacked per ``variant``, as CPU tensors."""
    tabs = fourstep_tables_np(w, inverse) + fourstep_tables_np(h, inverse)
    return _operands(tabs, dtype, variant)


def _unsplit(tabs, compensated: bool):
    if compensated:
        return tuple(t[0].float() + t[1].float() for t in tabs)
    return tuple(tabs)


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the arithmetic runs in: fp32 for sub-fp32 storage."""
    return torch.float32 if dtype.itemsize < 4 else dtype


def _axis_np(n: int, factors: tuple, inverse: bool, dtype_name: str,
             variant: str) -> tuple:
    """One axis' six tables as float64 planes holding exactly the values the
    kernels compute with: the float64 tables (cast later), or for sub-fp32
    storage the fp32 sum hi + lo (compensated) or the bf16 hi (plain)."""
    tabs = fourstep_tables_np(n, inverse, factors)
    dtype = getattr(torch, dtype_name)
    if dtype.itemsize >= 4 and variant == "plain":
        return tabs
    ops = _unsplit(_operands(tabs, dtype, variant), variant == "compensated")
    return tuple(t.double().numpy() for t in ops)


def axis_tables(n: int, factors, inverse: bool, dtype, variant: str,
                device) -> tuple:
    """One axis' six work tables in :func:`compute_dtype` on ``device``,
    cached per key."""
    name = str(dtype).replace("torch.", "")
    return _cast(_axis_np, (n, tuple(factors), bool(inverse), name, variant),
                 compute_dtype(dtype), torch.device(device))


def roundings(dtype: torch.dtype, variant: str):
    """(boundary, mid): the storage rounding between passes and, for the
    plain bf16 variant, after the first GEMM of a pass (None otherwise)."""
    if dtype.itemsize >= 4:
        return (lambda q: q), None

    def rnd(q):
        return q.to(dtype).to(torch.float32)
    return rnd, (rnd if variant == "plain" else None)


def fft2d_gemm_plain(x: SplitComplex, *, inverse: bool = False,
                     variant: str = "plain") -> SplitComplex:
    """The kernel's arithmetic in plain PyTorch on (batch, h, w) planes."""
    check_variant(variant)
    check_dtype(x.dtype)
    _, h, w = x.shape
    _check_dims(h, w)
    dt = x.dtype
    rnd, mid = roundings(dt, variant)
    fw, fh = fourstep_factors(w), fourstep_factors(h)
    re, im = x.re.to(compute_dtype(dt)), x.im.to(compute_dtype(dt))
    re, im = fft_last_fourstep(
        re, im, axis_tables(w, fw, inverse, dt, variant, x.device), *fw,
        mid=mid)
    re, im = rnd(re), rnd(im)
    re, im = fft_col_fourstep(
        re, im, axis_tables(h, fh, inverse, dt, variant, x.device), *fh,
        mid=mid)
    if inverse:
        re, im = re * (1.0 / (h * w)), im * (1.0 / (h * w))
    return SplitComplex(re.to(dt), im.to(dt))


def on_dft_mma(dtype: torch.dtype, variant: str) -> bool:
    """Whether the CUDA kernel runs the four-step products on the tensor
    cores (plain bf16 or float16) rather than the shared-memory FFTs."""
    return dtype in (torch.bfloat16, torch.float16) and variant == "plain"


def fft2d_gemm_cuda(x: SplitComplex, *, inverse: bool = False,
                    variant: str = "plain") -> SplitComplex:
    """Launch the 2-D FFT on (batch, h, w) CUDA planes (float32, bfloat16
    or float16): the planned shared-memory FFT passes, or the tensor-core
    DFT products for plain bf16 and float16."""
    check_variant(variant)
    check_dtype(x.dtype)
    _build.check_operands(x, 3, DTYPES)
    batch, h, w = x.shape
    _check_dims(h, w)
    out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    if not on_dft_mma(x.dtype, variant):
        fn = _build.function("fft2d_gemm", "fft2d_gemm_pass", axis_fft.ARGS)
        axis_fft.run(fn, axis_fft.plan2d(batch, h, w), x, out, h * w, inverse,
                     "fft2d_gemm")
        return out
    fn = _build.function("fft2d_gemm", "fft2d_gemm_plain_pass", dft_mma.ARGS)
    dft_mma.run(fn, (h, w), fourstep_factors, x, out, inverse, "fft2d_gemm")
    return out
