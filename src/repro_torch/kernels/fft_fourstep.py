"""Four-step (Bailey) FFT: the CUDA kernel and its plain PyTorch version.

Replaces ``repro/kernels/fft_fourstep.py::_fourstep_kernel``: n = n1*n2
(``_split_n``), column DFTs of length n1 with the batch folded into the
right-hand side's free dimension, the twiddle T[k1, j2] = W_n^(k1*j2), row
DFTs of length n2 and the output order X[k2*n1 + k1]; the inverse scales
by 1/n.  The plain version keeps the reference's dense DFT matmuls.  What
bounds the function on the card: bytes (16 per complex point in and out,
~3 flops a byte).  So ``csrc/fft_fourstep.cu`` runs each DFT as a radix-16
Stockham FFT in shared memory and registers, not as a dense matmul (which
did 8*n*(n1+n2) flops a row, 160x the FFT's at n = 2^20), and moves the
planes the fewest times it can: one launch holding whole rows for
n <= 2^14, and for larger n two launches, columns then rows, through one
scratch round trip, every load and store coalesced.  Its twiddles come from
one small table (:func:`kernel_table_np`): the n1- and n2-entry tables of
the sub-FFTs and two tables of about sqrt(n) entries whose products give
T.  The kernel takes power-of-two factors of 2 to :data:`MAX_FACTOR`
(:func:`kernel_factors`), which covers every default split up to 2^20.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.complexmath import SplitComplex
from repro_torch.core import twiddle as tw
from repro_torch.core.fft1d import _matmul
from . import _build
from . import axis_fft as _axis


@functools.lru_cache(maxsize=None)
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
    """The reference kernel's arithmetic in plain PyTorch on (batch, n)
    planes: dense DFT matmuls on either side of the twiddle."""
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


# the fused kernel's limits: each factor a power of two in [2, MAX_FACTOR]
# (a factor's FFT runs in one block); n <= ONE_LAUNCH_MAX runs in one
# launch without scratch, larger n in two.  Other factors up to
# axis_fft.FACTOR_MAX (and bf16 and float16 planes) take the axis route:
# axis_fft.cuh's launches, the "twiddle" one along n1, the "reversed" one
# along n2.
MAX_FACTOR = 1024
ONE_LAUNCH_MAX = 1 << 14


@functools.lru_cache(maxsize=None)
def kernel_factors(n: int, n1=None) -> tuple:
    """(n1, n2) for the CUDA kernel: the plain version's split, each factor
    at most :data:`axis_fft.FACTOR_MAX` (a larger one's dense table is
    beyond the reference's reach too); raises ValueError naming the
    limit."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"the four-step kernel needs a power-of-two n, "
                         f"got {n}")
    n1, n2 = _factors(n, n1)
    if max(n1, n2) > _axis.FACTOR_MAX:
        raise ValueError(f"the four-step kernel takes factors of up to "
                         f"{_axis.FACTOR_MAX}, got n = {n} = {n1} x {n2}")
    return n1, n2


def kernel_route(n: int, n1=None, dtype=torch.float32) -> str:
    """"fused" (``fft_fourstep_f32``: fp32, both factors in [2,
    :data:`MAX_FACTOR`]) or "axis" (:func:`axis_plan`)."""
    n1, n2 = kernel_factors(n, n1)
    if dtype == torch.float32 and max(n1, n2) <= MAX_FACTOR and n2 >= 2:
        return "fused"
    return "axis"


def axis_plan(batch: int, n: int, n1=None) -> tuple:
    """The axis route's launches: the four-step split (n1, n2)
    (:func:`axis_fft.plan_split`), or one rows launch for n2 = 1."""
    n1, n2 = kernel_factors(n, n1)
    if n2 == 1:
        return (_axis.plan_axis(batch, n, 1),)
    return _axis.plan_split(batch, n, 1, factors=(n1, n2))


def level_shift(n: int) -> int:
    """s of T's two-level lookup W_n^m = hi[m >> s] * lo[m mod 2^s]:
    ceil(log2(n) / 2), so both tables hold about sqrt(n) entries."""
    return n.bit_length() // 2


def kernel_table_np(n1: int, n2: int, sign: float) -> tuple:
    """The kernel's one float64 table, (n1 + n2 + 2^s + n/2^s, 2) of
    (cos, sin) pairs: w1[k] = W_n1^k, w2[k] = W_n2^k, lo[k] = W_n^k
    (k < 2^s) and hi[k] = W_n^(k * 2^s), with W_N = exp(sign*2*pi*i/N)."""
    n = n1 * n2
    s = level_shift(n)
    parts = [tw._twiddle_np(n1, sign), tw._twiddle_np(n2, sign)]
    for m in (np.arange(1 << s, dtype=np.float64),
              np.arange(n >> s, dtype=np.float64) * (1 << s)):
        ang = sign * 2.0 * np.pi * m / n
        parts.append((np.cos(ang), np.sin(ang)))
    return (np.stack([np.concatenate([p[0] for p in parts]),
                      np.concatenate([p[1] for p in parts])], axis=1),)


def kernel_table(n1: int, n2: int, *, inverse: bool = False,
                 device="cuda") -> torch.Tensor:
    """:func:`kernel_table_np` as a cached fp32 tensor on ``device``."""
    return tw._cast(kernel_table_np, (n1, n2, tw._sign(inverse)),
                    torch.float32, torch.device(device))[0]


_ARGS = [_build.P] * 7 + [_build.L, _build.I, _build.I, _build.I, _build.P]


def fft_fourstep_cuda(x: SplitComplex, *, inverse: bool = False,
                      n1: int = None) -> SplitComplex:
    """Launch the four-step kernel on (batch, n) CUDA planes (float32,
    bfloat16 or float16): one grid for n <= 2^14, two (columns, then rows
    through scratch) above; the axis route (:func:`kernel_route`) for
    bf16, float16 and factors past :data:`MAX_FACTOR`."""
    n1, n2 = kernel_factors(x.shape[-1], n1)
    _build.check_operands(x, 2, _axis.DTYPES)
    batch, n = x.shape
    if kernel_route(n, n1, x.dtype) == "axis":
        out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
        fn = _build.function("fft_fourstep", "fft_fourstep_axis", _axis.ARGS)
        _axis.run(fn, axis_plan(batch, n, n1), x, out, n, inverse,
                  "fft_fourstep")
        return out
    tab = kernel_table(n1, n2, inverse=inverse, device=x.device)
    out = x.re.new_empty((2, batch, n))
    scratch = x.re.new_empty((2, batch, n)) if n > ONE_LAUNCH_MAX else None
    fn = _build.function("fft_fourstep", "fft_fourstep_f32", _ARGS)
    ptrs = [x.re.data_ptr(), x.im.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr()]
    ptrs += [None, None] if scratch is None else [scratch[0].data_ptr(),
                                                  scratch[1].data_ptr()]
    _build.launch(fn, ptrs + [tab.data_ptr(), batch, n1, n2, int(inverse)],
                  "fft_fourstep_f32", x.device)
    return SplitComplex(out[0], out[1])
