"""Mixed radix-4/radix-2 Stockham FFT: the CUDA kernel and its plain
PyTorch version.

Replaces ``repro/kernels/fft_stockham.py::_stockham_kernel`` (radix=4).
The TPU kernel runs all stages of a VMEM-resident batch tile; on the card
a row of n > 2^20 points fits no shared memory, so ``csrc/fft_stockham.cu``
launches one kernel per radix-4 stage over global ping-pong buffers (one
thread per butterfly, twiddles from row s of the packed (s4, 3, n/4)
table), then the radix-2 tail.  What bounds it: bytes — every stage
streams the array and its table row through HBM, about 13x the bytes
the transform needs at n = 2^22; a shared-memory all-stages variant for
small n is later work.  The radix-2 oracle kernel
(``_stockham_kernel_r2``) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.complexmath import SplitComplex
from repro_torch.core import twiddle as tw
from repro_torch.core.fft1d import stockham_stages
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


_ARGS = [_build.P] * 8 + [_build.L, _build.I, _build.I, _build.P]


def fft_stockham_cuda(x: SplitComplex, *, inverse: bool = False
                      ) -> SplitComplex:
    """Launch the per-stage Stockham kernels on (batch, n) CUDA planes."""
    _build.check_operands(x, 2)
    batch, n = x.shape
    _check_n(n)
    w = tw.packed_radix4_twiddles(n, inverse=inverse, dtype=torch.float32,
                                  device=x.device)
    out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    scratch = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    fn = _build.function("fft_stockham", "fft_stockham_f32", _ARGS)
    ptrs = [x.re, x.im, out.re, out.im, scratch.re, scratch.im, w.re, w.im]
    _build.launch(fn, [p.data_ptr() for p in ptrs] + [batch, n,
                  int(inverse)], "fft_stockham_f32", x.device)
    return out
