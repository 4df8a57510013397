"""Fused Stockham 2-D FFT (the ``algo="fused_stockham"`` oracle): the CUDA
kernel and its plain PyTorch version.

Replaces ``repro/kernels/fft2d_fused.py::_fft2d_kernel``: the mixed
radix-4/radix-2 Stockham stages of
:func:`repro_torch.core.fft1d.stockham_stages` on every row, a tile
transpose, the same stages on every column, the transpose back, and
1/(H*W) for the inverse, with the packed (s4, 3, n/4) tables of W and H.

The TPU kernel transposes inside VMEM; a 1024^2 fp32 image is 8 MB
against 227 KB of shared memory a block, so ``csrc/fft2d_fused.cu`` runs
two launches, each keeping a 4096-point tile in shared memory for all its
stages: whole rows, then c = 4096/H adjacent columns, the transpose being
the column kernel's indexing.  What bounds it: bytes (16 per complex point
in and out); the design moves the planes twice.  float32 only.
"""
from __future__ import annotations

import torch

from repro_torch.core.complexmath import SplitComplex
from repro_torch.core import twiddle as tw
from repro_torch.core.fft1d import stockham_stages
from . import _build

MAX_DIM = 4096          # the largest H or W the CUDA kernel takes


def _check_dims(h: int, w: int) -> None:
    for d in (h, w):
        if d & (d - 1) or d < 2:
            raise ValueError(f"power-of-two tile dims required, got {(h, w)}")


def fft2d_fused_plain(x: SplitComplex, *, inverse: bool = False
                      ) -> SplitComplex:
    """The kernel's arithmetic in plain PyTorch on (batch, h, w) planes."""
    _, h, w = x.shape
    _check_dims(h, w)
    ww = tw.packed_radix4_twiddles(w, inverse=inverse, dtype=x.dtype,
                                   device=x.device)
    wh = tw.packed_radix4_twiddles(h, inverse=inverse, dtype=x.dtype,
                                   device=x.device)
    re, im = stockham_stages(x.re, x.im, ww.re, ww.im, w,
                             tw.stockham_radices(w), inverse=inverse)
    re, im = re.transpose(-1, -2), im.transpose(-1, -2)   # (batch, w, h)
    re, im = stockham_stages(re, im, wh.re, wh.im, h,
                             tw.stockham_radices(h), inverse=inverse)
    re, im = re.transpose(-1, -2), im.transpose(-1, -2)   # back to (h, w)
    if inverse:
        re, im = re * (1.0 / (h * w)), im * (1.0 / (h * w))
    return SplitComplex(re.contiguous(), im.contiguous())


_ARGS = [_build.P] * 8 + [_build.L] + [_build.I] * 3 + [_build.P]


def fft2d_fused_cuda(x: SplitComplex, *, inverse: bool = False
                     ) -> SplitComplex:
    """Launch the row and column Stockham kernels on (batch, h, w) fp32
    CUDA planes."""
    _build.check_operands(x, 3)
    batch, h, w = x.shape
    _check_dims(h, w)
    if h > MAX_DIM or w > MAX_DIM:
        raise ValueError("the CUDA fused Stockham 2-D kernel takes H, W <= "
                         f"{MAX_DIM}, got {(h, w)}")
    ww = tw.packed_radix4_twiddles(w, inverse=inverse, dtype=torch.float32,
                                   device=x.device)
    wh = tw.packed_radix4_twiddles(h, inverse=inverse, dtype=torch.float32,
                                   device=x.device)
    out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    fn = _build.function("fft2d_fused", "fft2d_fused_f32", _ARGS)
    ptrs = [x.re, x.im, out.re, out.im, ww.re, ww.im, wh.re, wh.im]
    _build.launch(fn, [p.data_ptr() for p in ptrs] + [
        batch, h, w, int(inverse)], "fft2d_fused_f32", x.device)
    return out
