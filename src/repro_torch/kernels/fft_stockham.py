"""Mixed radix-4/radix-2 Stockham FFT and its pure radix-2 twin: the CUDA
kernels and their plain PyTorch versions.

Replaces ``repro/kernels/fft_stockham.py::_stockham_kernel`` (radix=4) and
``::_stockham_kernel_r2`` (radix=2, the oracle and ``algo="stockham2"``).
The TPU kernel runs all stages of a VMEM-resident batch tile; on the card
a row of n > 2^20 points fits no shared memory, so ``csrc/fft_stockham.cu``
launches one kernel per radix-4 stage over global ping-pong buffers (one
thread per butterfly, twiddles from row s of the packed (s4, 3, n/4)
table), then the radix-2 tail.  What bounds it: bytes — every stage
streams the array and its table row through HBM, about 13x the bytes
the transform needs at n = 2^22; a shared-memory all-stages variant for
small n is later work.  The radix-2 kernel is the same design with one
launch per radix-2 stage, stage s reading row s of the packed
(stages, n/2) table: twice the stages, so about twice the traffic.
"""
from __future__ import annotations

import torch

from repro_torch.core.complexmath import SplitComplex
from repro_torch.core import twiddle as tw
from repro_torch.core.fft1d import stockham_stages, stockham_radix2_stages
from . import _build


def _check_n(n: int) -> None:
    if n < 2 or n & (n - 1):
        raise ValueError(f"the Stockham kernel needs a power-of-two n >= 2, "
                         f"got {n}")


def fft_stockham_plain(x: SplitComplex, *, inverse: bool = False
                       ) -> SplitComplex:
    """The kernel's arithmetic in plain PyTorch on (batch, n) planes."""
    n = x.shape[-1]
    _check_n(n)
    w = tw.packed_radix4_twiddles(n, inverse=inverse, dtype=x.dtype,
                                  device=x.device)
    re, im = stockham_stages(x.re, x.im, w.re, w.im, n,
                             tw.stockham_radices(n), inverse=inverse)
    if inverse:
        re, im = re * (1.0 / n), im * (1.0 / n)
    return SplitComplex(re, im)


def fft_stockham_r2_plain(x: SplitComplex, *, inverse: bool = False
                          ) -> SplitComplex:
    """The radix-2 kernel's arithmetic in plain PyTorch on (batch, n)
    planes."""
    n = x.shape[-1]
    _check_n(n)
    w = tw.packed_radix2_twiddles(n, inverse=inverse, dtype=x.dtype,
                                  device=x.device)
    re, im = stockham_radix2_stages(x.re, x.im, w.re, w.im, n)
    if inverse:
        re, im = re * (1.0 / n), im * (1.0 / n)
    return SplitComplex(re, im)


_ARGS = [_build.P] * 8 + [_build.L, _build.I, _build.I, _build.P]


def _launch(symbol: str, table, x: SplitComplex, inverse: bool
            ) -> SplitComplex:
    _build.check_operands(x, 2)
    batch, n = x.shape
    _check_n(n)
    w = table(n, inverse=inverse, dtype=torch.float32, device=x.device)
    out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    scratch = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    fn = _build.function("fft_stockham", symbol, _ARGS)
    ptrs = [x.re, x.im, out.re, out.im, scratch.re, scratch.im, w.re, w.im]
    _build.launch(fn, [p.data_ptr() for p in ptrs] + [batch, n,
                  int(inverse)], symbol, x.device)
    return out


def fft_stockham_cuda(x: SplitComplex, *, inverse: bool = False
                      ) -> SplitComplex:
    """Launch the per-stage mixed-radix Stockham kernels on (batch, n) CUDA
    planes."""
    return _launch("fft_stockham_f32", tw.packed_radix4_twiddles, x, inverse)


def fft_stockham_r2_cuda(x: SplitComplex, *, inverse: bool = False
                         ) -> SplitComplex:
    """Launch the per-stage radix-2 Stockham kernels on (batch, n) CUDA
    planes."""
    return _launch("fft_stockham_r2_f32", tw.packed_radix2_twiddles, x,
                   inverse)
