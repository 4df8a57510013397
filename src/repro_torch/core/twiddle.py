"""Twiddle-factor tables.

Counterpart of :mod:`repro.core.twiddle`.  The float64 numpy builders are
a copy of the reference's (the port imports nothing of ``repro``), so the
host tables are bit-identical.  The tensor casts are cached per
``(n, inverse, dtype, device)``: each table is built and copied to the
device once, then later calls reuse it.  The cache holds at most
:data:`TABLE_CACHE_BYTES` of tensors, least recently used first out; the
packed radix-4 Stockham table alone is 277 MB per direction at n = 2^22
in fp32 (the kernel's one-row table 25 MB).  A table cast under
``FakeTensorMode`` (a dry run's) is not cached: a later real call would
get a tensor without data.
:func:`clear_table_cache` frees every cached tensor.
"""
from __future__ import annotations

import functools
import threading
from collections import OrderedDict

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from .complexmath import SplitComplex


@functools.lru_cache(maxsize=128)
def _twiddle_np(n: int, sign: float) -> tuple:
    k = np.arange(n, dtype=np.float64)
    ang = sign * 2.0 * np.pi * k / n
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=64)
def _dft_matrix_np(n: int, sign: float) -> tuple:
    jk = np.outer(np.arange(n, dtype=np.float64), np.arange(n, dtype=np.float64))
    ang = sign * 2.0 * np.pi * jk / n
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=64)
def _fourstep_twiddle_np(n1: int, n2: int, sign: float) -> tuple:
    k1 = np.arange(n1, dtype=np.float64)[:, None]
    n2r = np.arange(n2, dtype=np.float64)[None, :]
    ang = sign * 2.0 * np.pi * (k1 * n2r) / (n1 * n2)
    return np.cos(ang), np.sin(ang)


def bit_reverse_indices(n: int) -> np.ndarray:
    """Bit-reversal permutation for power-of-two n (host-side constant)."""
    bits = int(n).bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def stockham_radices(n: int) -> tuple:
    """Stage plan for a mixed-radix Stockham FFT of power-of-two length n:
    radix-4 stages while 4 | n_cur, then one radix-2 tail (whose twiddle is
    identically 1, so only the radix-4 stages need tables)."""
    assert n > 0 and (n & (n - 1)) == 0, f"power-of-two n required, got {n}"
    radices = []
    n_cur = n
    while n_cur >= 4:
        radices.append(4)
        n_cur //= 4
    if n_cur == 2:
        radices.append(2)
    return tuple(radices)


@functools.lru_cache(maxsize=64)
def packed_radix4_twiddles_np(n: int, inverse: bool) -> tuple:
    """(s4, 3, n//4) twiddle planes for every radix-4 Stockham stage: row s
    holds (w, w^2, w^3) of stage s, pre-broadcast over the stride axis.
    For n < 4 a single zero row of width max(n//4, 1) keeps the operand
    non-empty."""
    s4 = sum(1 for r in stockham_radices(n) if r == 4)
    width = max(n // 4, 1)
    wr = np.zeros((max(s4, 1), 3, width), dtype=np.float64)
    wi = np.zeros((max(s4, 1), 3, width), dtype=np.float64)
    sign = 1.0 if inverse else -1.0
    n_cur, stride = n, 1
    for s in range(s4):
        m = n_cur // 4
        p = np.arange(m, dtype=np.float64)
        ang = sign * 2.0 * np.pi * p / n_cur
        w1 = np.cos(ang) + 1j * np.sin(ang)
        for j, w in enumerate((w1, w1 * w1, w1 * w1 * w1)):
            wr[s, j] = np.repeat(w.real, stride)
            wi[s, j] = np.repeat(w.imag, stride)
        n_cur, stride = m, stride * 4
    return wr, wi


@functools.lru_cache(maxsize=64)
def packed_radix2_twiddles_np(n: int, inverse: bool) -> tuple:
    """(stages, n//2) per-stage, stride-broadcast radix-2 twiddle planes."""
    stages = int(n).bit_length() - 1
    sign = 1.0 if inverse else -1.0
    wr = np.empty((stages, n // 2), dtype=np.float64)
    wi = np.empty((stages, n // 2), dtype=np.float64)
    for s in range(stages):
        n_cur = n >> s
        stride = 1 << s
        m = n_cur // 2
        p = np.arange(m, dtype=np.float64)
        ang = sign * 2.0 * np.pi * p / n_cur
        wr[s] = np.repeat(np.cos(ang), stride)
        wi[s] = np.repeat(np.sin(ang), stride)
    return wr, wi


@functools.lru_cache(maxsize=64)
def radix2_twiddles_np(n: int, inverse: bool) -> tuple:
    """Row 0 of :func:`packed_radix2_twiddles_np` by the same float64
    formula, W_n^p for p < n/2, as one (n/2, 2) array of (cos, sin) pairs:
    the radix-2 kernel's one table.  Row s of the packed table is this row
    re-indexed, entry j = entry (j >> s) << s, bit for bit: the angle
    2*pi*p / (n >> s) equals 2*pi*(p << s) / n exactly in float64."""
    sign = 1.0 if inverse else -1.0
    p = np.arange(n // 2, dtype=np.float64)
    ang = sign * 2.0 * np.pi * p / n
    return (np.stack([np.cos(ang), np.sin(ang)], axis=1),)


@functools.lru_cache(maxsize=64)
def radix4_twiddles_np(n: int, inverse: bool) -> tuple:
    """Row 0 of :func:`packed_radix4_twiddles_np` by the same float64
    formula, (w, w^2, w^3) of W_n^p for p < n/4, as one (3, n/4, 2) array
    of (cos, sin) pairs: the radix-4 kernel's one table (a zero row of
    width 1 for n < 4, as in the packed table).  Row s of the packed table
    is this row re-indexed, entry j = entry (j >> 2s) << 2s, bit for bit:
    the angle 2*pi*p / (n >> 2s) equals 2*pi*(p << 2s) / n exactly in
    float64, and w^2, w^3 are the same float64 products of an equal w."""
    width = max(n // 4, 1)
    out = np.zeros((3, width, 2), dtype=np.float64)
    if n >= 4:
        sign = 1.0 if inverse else -1.0
        p = np.arange(n // 4, dtype=np.float64)
        ang = sign * 2.0 * np.pi * p / n
        w1 = np.cos(ang) + 1j * np.sin(ang)
        for r, w in enumerate((w1, w1 * w1, w1 * w1 * w1)):
            out[r, :, 0] = w.real
            out[r, :, 1] = w.imag
    return (out,)


# ---------------------------------------------------------------------------
# Tensor casts, cached per (table args, dtype, device)
# ---------------------------------------------------------------------------

def _sign(inverse: bool) -> float:
    return 1.0 if inverse else -1.0


TABLE_CACHE_BYTES = 1 << 30     # tensors kept across calls, all devices
_TABLES: OrderedDict = OrderedDict()
_TABLES_LOCK = threading.Lock()


def _nbytes(planes: tuple) -> int:
    return sum(t.numel() * t.element_size() for t in planes)


def _cast(builder, args: tuple, dtype: torch.dtype, dev: torch.device):
    """``builder(*args)``'s planes as ``dtype`` tensors on ``dev``, cached
    least recently used first out within :data:`TABLE_CACHE_BYTES`; the
    newest table stays even when it alone is larger."""
    key = (builder, args, dtype, dev)
    with _TABLES_LOCK:
        if key in _TABLES:
            _TABLES.move_to_end(key)
            return _TABLES[key]
    # normal tensors even when the first caller runs in inference mode: an
    # inference tensor cannot be saved for a later caller's backward
    # (ROADMAP §3 F10)
    with torch.inference_mode(False):
        planes = tuple(torch.from_numpy(np.ascontiguousarray(p))
                       .to(dev, dtype) for p in builder(*args))
    if any(isinstance(p, FakeTensor) for p in planes):
        return planes
    with _TABLES_LOCK:
        _TABLES[key] = planes
        held = sum(_nbytes(v) for v in _TABLES.values())
        while len(_TABLES) > 1 and held > TABLE_CACHE_BYTES:
            _, old = _TABLES.popitem(last=False)
            held -= _nbytes(old)
    return planes


def clear_table_cache() -> None:
    """Drop every cached table tensor (the float64 host tables stay)."""
    with _TABLES_LOCK:
        _TABLES.clear()


def _split(builder, args, dtype, device) -> SplitComplex:
    re, im = _cast(builder, args, dtype, torch.device(device))
    return SplitComplex(re, im)


def twiddles(n: int, *, inverse: bool = False, dtype=torch.float32,
             device="cuda") -> SplitComplex:
    """``exp(sign * 2*pi*i * k / n)`` for k in [0, n): the stage-n table."""
    return _split(_twiddle_np, (n, _sign(inverse)), dtype, device)


def dft_matrix(n: int, *, inverse: bool = False, dtype=torch.float32,
               device="cuda") -> SplitComplex:
    """Dense DFT matrix W[j, k] = exp(sign*2*pi*i*j*k/n) (symmetric)."""
    return _split(_dft_matrix_np, (n, _sign(inverse)), dtype, device)


def fourstep_twiddle(n1: int, n2: int, *, inverse: bool = False,
                     dtype=torch.float32, device="cuda") -> SplitComplex:
    """Inter-factor twiddle T[k1, n2] = exp(sign*2*pi*i*k1*n2/(n1*n2))."""
    return _split(_fourstep_twiddle_np, (n1, n2, _sign(inverse)), dtype,
                  device)


def packed_radix4_twiddles(n: int, *, inverse: bool = False,
                           dtype=torch.float32, device="cuda") -> SplitComplex:
    """The (s4, 3, n//4) packed radix-4 table on ``device``."""
    return _split(packed_radix4_twiddles_np, (n, bool(inverse)), dtype, device)


def packed_radix2_twiddles(n: int, *, inverse: bool = False,
                           dtype=torch.float32, device="cuda") -> SplitComplex:
    """The (stages, n//2) packed radix-2 table on ``device``."""
    return _split(packed_radix2_twiddles_np, (n, bool(inverse)), dtype, device)


def radix2_twiddles(n: int, *, inverse: bool = False, dtype=torch.float32,
                    device="cuda") -> torch.Tensor:
    """:func:`radix2_twiddles_np` as a cached (n/2, 2) tensor on
    ``device``."""
    return _cast(radix2_twiddles_np, (n, bool(inverse)), dtype,
                 torch.device(device))[0]


def radix4_twiddles(n: int, *, inverse: bool = False, dtype=torch.float32,
                    device="cuda") -> torch.Tensor:
    """:func:`radix4_twiddles_np` as a cached (3, n/4, 2) tensor on
    ``device``."""
    return _cast(radix4_twiddles_np, (n, bool(inverse)), dtype,
                 torch.device(device))[0]
