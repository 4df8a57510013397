"""Shared one-level four-step helpers of the 2-D GEMM kernel.

Counterpart of the helpers in ``repro/kernels/rfft2d_fused.py``
(``fourstep_factors``, ``fourstep_tables_np``, ``fft_last_fourstep``,
``fft_col_fourstep``, ``_check_dims``).  The real-input kernels
``_rfft2d_kernel`` / ``_irfft2d_kernel`` are not ported yet (ROADMAP
'Modules to port' item 6).
"""
from __future__ import annotations

from repro_torch.core.fft1d import _best_split, _matmul
from repro_torch.core.twiddle import _dft_matrix_np, _fourstep_twiddle_np

# below this length a single dense DFT matmul replaces the four-step
# (mirrors resolve_algo's naive-leaf region)
FOURSTEP_LEAF = 256


def fourstep_factors(n: int):
    """(n1, n2) with n = n1 * n2: the one-level four-step split; n1 == 1
    means a single dense DFT matmul."""
    n1 = 1 if n <= FOURSTEP_LEAF else _best_split(n)
    return n1, n // n1


def fourstep_tables_np(n: int, inverse: bool, factors=None):
    """Host-built float64 tables for one four-step pass of length n: DFT
    matrices for both factors plus the inter-factor twiddle
    ``T[k1, j2] = exp(sign * 2*pi*i * k1*j2 / n)``.  No 1/n scaling — the
    inverse folds one 1/(H*W) at the end."""
    n1, n2 = fourstep_factors(n) if factors is None else factors
    assert n1 * n2 == n, (n, n1, n2)
    sign = 1.0 if inverse else -1.0
    w1r, w1i = _dft_matrix_np(n1, sign)
    w2r, w2i = _dft_matrix_np(n2, sign)
    twr, twi = _fourstep_twiddle_np(n1, n2, sign)
    return (w1r, w1i, w2r, w2i, twr, twi)


def _left(w, x):
    """sum_a w[k, a] x[..., a, :]: a left contraction along axis -2."""
    return _matmul(w, x)


def fft_last_fourstep(re, im, tabs, n1: int, n2: int):
    """Length-(n1*n2) FFT of the last axis via one four-step level; the
    n1-factor DFT is a left contraction along axis -2 and only the output
    reordering X[k2*n1 + k1] = Z[k1, k2] transposes the factor axes."""
    w1r, w1i, w2r, w2i, twr, twi = tabs
    b = re.shape[:-1]
    re = re.reshape(*b, n1, n2)
    im = im.reshape(*b, n1, n2)
    if n1 > 1:
        yr = _left(w1r, re) - _left(w1i, im)
        yi = _left(w1i, re) + _left(w1r, im)
        re, im = yr * twr - yi * twi, yr * twi + yi * twr
    zr = _matmul(re, w2r) - _matmul(im, w2i)
    zi = _matmul(re, w2i) + _matmul(im, w2r)
    zr = zr.transpose(-1, -2).reshape(*b, n1 * n2)
    zi = zi.transpose(-1, -2).reshape(*b, n1 * n2)
    return zr, zi


def fft_col_fourstep(re, im, tabs, n1: int, n2: int):
    """Length-(n1*n2) FFT along axis -2 of an (..., H, C) tile — the column
    pass — as left-side DFT contractions, absorbing the tile transpose."""
    w1r, w1i, w2r, w2i, twr, twi = tabs
    b = re.shape[:-2]
    c = re.shape[-1]
    re = re.reshape(*b, n1, n2 * c)
    im = im.reshape(*b, n1, n2 * c)
    if n1 > 1:
        yr = (_left(w1r, re) - _left(w1i, im)).reshape(*b, n1, n2, c)
        yi = (_left(w1i, re) + _left(w1r, im)).reshape(*b, n1, n2, c)
        twr = twr[..., None]
        twi = twi[..., None]
        re, im = yr * twr - yi * twi, yr * twi + yi * twr
    re = re.reshape(*b, n1, n2, c)
    im = im.reshape(*b, n1, n2, c)
    zr = _left(w2r, re) - _left(w2i, im)          # (..., n1, k2, c)
    zi = _left(w2i, re) + _left(w2r, im)
    zr = zr.transpose(-3, -2).reshape(*b, n1 * n2, c)
    zi = zi.transpose(-3, -2).reshape(*b, n1 * n2, c)
    return zr, zi


def _check_dims(h: int, w: int):
    for d in (h, w):
        if d & (d - 1) or d < 2:
            raise ValueError("the fused 2-D kernels need power-of-two "
                             f"tile dims >= 2, got {(h, w)}")
