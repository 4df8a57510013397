"""Four-step (Bailey) FFT: the CUDA kernel and its plain PyTorch version.

Replaces ``repro/kernels/fft_fourstep.py::_fourstep_kernel``: n = n1*n2
(``_split_n``), an (n1 x n1) DFT matmul with the batch folded into the
right-hand side's free dimension, the twiddle, an (n2 x n2) DFT matmul and
the output order X[k2*n1 + k1]; the inverse scales by 1/n.  At n = 2^20
each DFT table is 1024x1024 (4 MB a plane), so ``csrc/fft_fourstep.cu``
streams the tables through shared-memory tiles: two launches of one tiled
complex fp32 GEMM (``csrc/cgemm.cuh``), the twiddle in the first one's
epilogue and the reordered, scaled store in the second's.  What bounds it:
the transform itself is bound by bytes (16 per complex point in and out),
but the dense-DFT method does 8*n*(n1+n2) flops per row, about 160x the
FFT's 5*n*log2(n) at n = 2^20, so this design is bound by those fp32
operations on the CUDA cores; the scratch round trip between the two
GEMMs is its known extra traffic.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.complexmath import SplitComplex
from repro_torch.core import twiddle as tw
from repro_torch.core.fft1d import _matmul
from . import _build


def _split_n(n: int) -> tuple:
    """Factor n = n1*n2 with n1 <= n2, n1 the largest divisor <= sqrt(n)."""
    best = None
    for n1 in range(1, int(np.sqrt(n)) + 1):
        if n % n1 == 0:
            best = n1
    n1 = best
    return n1, n // n1


def _factors(n: int, n1) -> tuple:
    if n1 is None:
        n1, n2 = _split_n(n)
    else:
        n2 = n // n1
    if n1 * n2 != n or n1 <= 1:
        raise ValueError(f"four-step needs n = n1*n2 with n1 > 1, got n={n}, "
                         f"n1={n1}")
    return n1, n2


def _tables(n1: int, n2: int, inverse: bool, dtype, device):
    return (tw.dft_matrix(n1, inverse=inverse, dtype=dtype, device=device),
            tw.dft_matrix(n2, inverse=inverse, dtype=dtype, device=device),
            tw.fourstep_twiddle(n1, n2, inverse=inverse, dtype=dtype,
                                device=device))


def fft_fourstep_plain(x: SplitComplex, *, inverse: bool = False,
                       n1: int = None) -> SplitComplex:
    """The kernel's arithmetic in plain PyTorch on (batch, n) planes."""
    b, n = x.shape
    n1, n2 = _factors(n, n1)
    w1, w2, t = _tables(n1, n2, inverse, x.dtype, x.device)
    # (1) column DFTs with the batch folded into the RHS free dim
    ar = x.re.reshape(b, n1, n2).transpose(0, 1).reshape(n1, b * n2)
    ai = x.im.reshape(b, n1, n2).transpose(0, 1).reshape(n1, b * n2)
    br = _matmul(w1.re, ar) - _matmul(w1.im, ai)
    bi = _matmul(w1.re, ai) + _matmul(w1.im, ar)
    br = br.reshape(n1, b, n2).transpose(0, 1)            # (b, n1, n2)
    bi = bi.reshape(n1, b, n2).transpose(0, 1)
    # (2) pointwise twiddle T[k1, n2]
    cr = (br * t.re - bi * t.im).reshape(b * n1, n2)
    ci = (br * t.im + bi * t.re).reshape(b * n1, n2)
    # (3) row DFTs (b*n1, n2) @ (n2, n2), then X[k2*n1 + k1] = D[k1, k2]
    dr = _matmul(cr, w2.re) - _matmul(ci, w2.im)
    di = _matmul(cr, w2.im) + _matmul(ci, w2.re)
    dr = dr.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
    di = di.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
    if inverse:
        dr, di = dr * (1.0 / n), di * (1.0 / n)
    return SplitComplex(dr, di)


_ARGS = [_build.P] * 12 + [_build.L, _build.I, _build.I, _build.I, _build.P]


def fft_fourstep_cuda(x: SplitComplex, *, inverse: bool = False,
                      n1: int = None) -> SplitComplex:
    """Launch the two-GEMM four-step kernel on (batch, n) CUDA planes."""
    _build.check_operands(x, 2)
    batch, n = x.shape
    if n & (n - 1):
        raise ValueError(f"the four-step kernel needs a power-of-two n, "
                         f"got {n}")
    n1, n2 = _factors(n, n1)
    w1, w2, t = _tables(n1, n2, inverse, torch.float32, x.device)
    out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    scratch = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    fn = _build.function("fft_fourstep", "fft_fourstep_f32", _ARGS)
    ptrs = [x.re, x.im, out.re, out.im, scratch.re, scratch.im,
            w1.re, w1.im, w2.re, w2.im, t.re, t.im]
    _build.launch(fn, [p.data_ptr() for p in ptrs] + [batch, n1, n2,
                  int(inverse)], "fft_fourstep_f32", x.device)
    return out
