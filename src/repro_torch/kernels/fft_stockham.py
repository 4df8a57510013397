"""Mixed radix-4/radix-2 Stockham FFT and its pure radix-2 twin: the CUDA
kernels and their plain PyTorch versions.

Replaces ``repro/kernels/fft_stockham.py::_stockham_kernel`` (radix=4) and
``::_stockham_kernel_r2`` (radix=2, the oracle and ``algo="stockham2"``).
The TPU kernel runs all stages of a VMEM-resident batch tile.

Both radices run the reference's butterflies in its stage order (radix 4:
radix-4 stages, then a radix-2 tail for odd log2 n), up to four bits of
stages a pass in registers between shared-memory barriers, over tiles that
a persistent grid copies in (``csrc/fft_stockham.cu``, :func:`plan`), each
launch one pass over HBM: one launch for n <= :data:`ONE_MAX`; two up to
:data:`TWO_MAX` (the stages of bits 0..l1-1 on the columns of the
(2^l1, n/2^l1) view, then the rest as length-n/2^l1 Stockhams on the
stride-2^l1 subsets; radix 2 splits at l1 = ceil(log2 n / 2), radix 4 at an
even l1, :func:`split`, so that launch A holds whole radix-4 stages); three
up to :data:`THREE_MAX`, the second split applied again to those subsets
(:func:`split3`).  float32, bfloat16 or float16 planes: sub-fp32 planes
are widened at the load and rounded at each store, the stages run in fp32
off the fp32 tables.

Each radix reads one table: radix 2 W_n^p for p < n/2
(:func:`repro_torch.core.twiddle.radix2_twiddles`) at (j >> s) << s for
stage s's butterfly j, radix 4 (w, w^2, w^3) for p < n/4
(:func:`repro_torch.core.twiddle.radix4_twiddles`) at (j >> 2s) << 2s:
row s of the packed table bit for bit (25 MB a direction at n = 2^22, the
packed table 277 MB).  The plain versions keep the packed tables, as the
reference does.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.complexmath import SplitComplex
from repro_torch.core import twiddle as tw
from repro_torch.core.fft1d import stockham_stages, stockham_radix2_stages
from . import _build
from . import axis_fft as _axis

ONE_MAX = 1 << 14       # the largest n of the one-launch route
TWO_MAX = 1 << 24       # two launches of up to 2^12-point transforms
THREE_MAX = 1 << 36     # three launches of up to 2^14-point transforms


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


_R2_ARGS = ([_build.P] * 5 + [_build.L] + [_build.I] * 7
            + [_build.F, _build.I, _build.P])
_R4_ARGS = _R2_ARGS[:-2] + [_build.I, _build.I, _build.P]
_ROUTES = {"rows": 0, "cols": 1, "transposed": 2, "mid": 4}


def split(n: int, radix: int) -> int:
    """l1, the bits of stages launch A runs: ceil(log2(n) / 2) for radix
    2.  For radix 4 it is even (whole radix-4 stages), 2 * floor((log2(n)
    + 1) / 4): columns of at most 1024 points up to 2^21, whose tiles read
    32-byte row segments (C = 8); from 2^22 it is 12, since l1 = 10 would
    leave launch B rows of 4096 points, two a tile, stored in 8-byte
    column segments."""
    ln = n.bit_length() - 1
    if radix == 2:
        return (ln + 1) // 2
    return 12 if ln >= 22 else 2 * ((ln + 1) // 4)


def split3(n: int, radix: int) -> tuple:
    """(l1, l2, lq), the bits of stages of the three launches past
    :data:`TWO_MAX`, l1 + l2 + lq = log2 n.  Launch 3's rows take lq =
    ceil(log2(n) / 3), at least 7 and at least log2 n - 22 (radix 4: at
    least log2 n - 20, and of log2 n's parity, so that l1 + l2 is even),
    so that the columns of launches 1 and 2 are no longer than 2^11 points
    (radix 4: 2^10): tiles of C >= 8 columns read and write 32-byte
    segments of each fp32 plane.  l1 is half the rest, rounded up (radix
    4: to even, whole radix-4 stages in launches 1 and 2), at least 8.  At
    2^25: (8, 8, 9) for both radices (the other splits timed there are
    within 5 % of it or slower, ``tools/stockham_long.py --sweep``); at
    2^36 radix 2 (11, 11, 14).  Radix 4 at 2^35 and 2^36, whose rows would
    pass 2^14, takes l1 = 12 (4096-point columns, C = 4): (12, 10, 13) and
    (12, 10, 14)."""
    ln = n.bit_length() - 1
    cols = 11 if radix == 2 else 10
    lq = max(7, -(-ln // 3), ln - 2 * cols)
    if radix == 4 and (ln - lq) & 1:
        lq += 1
    top = cols
    if lq > 14:                       # radix 4 past 2^34
        top, lq = 12, ln - 22
    rest = ln - lq
    l1 = max(8, min(top, -(-rest // 2)))
    if radix == 4:
        l1 += l1 & 1
    l2 = rest - l1
    if not 2 <= l2 <= cols:
        raise ValueError(f"no three-launch split of n = {n}")
    return l1, l2, lq


def plan(batch: int, n: int, radix: int) -> tuple:
    """The kernel's launches, as (route, :class:`axis_fft.Launch`) pairs:
    ``("rows", ...)`` alone for n <= :data:`ONE_MAX`; up to
    :data:`TWO_MAX`, with n = M * Q and M = 2^l1 (:func:`split`),
    ``("cols", ...)`` (launch A: the stages of bits 0..l1-1 on the columns
    of the (batch, M, Q) view, x -> scratch, each point back in its place)
    and ``("transposed", ...)`` (launch B: the other stages on the batch*M
    rows of Q of the scratch, row k's point t stored at t*M + k of out);
    up to :data:`THREE_MAX`, with n = M1 * M2 * Q3 (:func:`split3`),
    ``("cols", ...)`` (launch 1: launch A on the (batch, M1, M2*Q3) view,
    x -> out), ``("mid", ...)`` (launch 2: the stages of bits
    l1..l1+l2-1 on the columns of the (batch*M1, M2, Q3) view, point t of
    image k1's column q stored at row t*M1 + k1, out -> scratch) and
    ``("transposed", ...)`` (launch 3: launch B after l1 + l2 bits on the
    batch*M1*M2 rows of Q3, scratch -> out).  Past :data:`THREE_MAX` it
    raises: the planes of 2^37 points take 512 GiB in bfloat16, beyond any
    card's memory."""
    _check_n(n)
    if n <= ONE_MAX:
        return (("rows", _axis.plan_axis(batch, n, 1)),)
    if n <= TWO_MAX:
        l1 = split(n, radix)
        m, q = 1 << l1, n >> l1
        return (("cols", _axis.plan_axis(batch, m, q)),
                ("transposed", _axis.plan_axis(batch * m, q, 1)))
    if n > THREE_MAX:
        raise ValueError(f"the Stockham kernel takes n <= 2^36, got {n}: "
                         "the planes of 2^37 points take 512 GiB in "
                         "bfloat16, beyond any card's memory")
    l1, l2, lq = split3(n, radix)
    m1, m2, q = 1 << l1, 1 << l2, 1 << lq
    return (("cols", _axis.plan_axis(batch, m1, m2 * q)),
            ("mid", _axis.plan_axis(batch * m1, m2, q)),
            ("transposed", _axis.plan_axis(batch * m1 * m2, q, 1)))


def r2_plan(batch: int, n: int) -> tuple:
    """:func:`plan` of the radix-2 kernel."""
    return plan(batch, n, 2)


def r4_plan(batch: int, n: int) -> tuple:
    """:func:`plan` of the radix-4 kernel."""
    return plan(batch, n, 4)


@functools.lru_cache(maxsize=64)
def _launch_args(radix: int, batch: int, n: int, inverse: bool,
                 device: torch.device) -> tuple:
    """Each fused launch's arguments after the five pointers; the l1
    argument is the bits of stages the launches before it ran (three
    launches: l1, l1, l1 + l2 of :func:`split3`), else :func:`split`'s."""
    steps = plan(batch, n, radix)
    if len(steps) == 3:
        l1, l2, _ = split3(n, radix)
        shifts = (l1, l1, l1 + l2)
    else:
        shifts = (split(n, radix),) * len(steps)
    sms = _build.sm_count(device)
    log2 = _axis._log2
    sign = [int(inverse)] if radix == 4 else []
    return tuple([lp.outer, log2(lp.n), log2(lp.inner), log2(lp.c),
                  log2(lp.g), _ROUTES[route], l1, lp.blocks(sms),
                  1.0 / n if inverse and i == len(steps) - 1 else 1.0] + sign
                 for i, ((route, lp), l1) in enumerate(zip(steps, shifts)))


def table(n: int, radix: int, inverse: bool, device) -> torch.Tensor:
    """The radix's one fp32 table on ``device``."""
    if radix == 2:
        return tw.radix2_twiddles(n, inverse=inverse, device=device)
    return tw.radix4_twiddles(n, inverse=inverse, device=device)


def _fused(x: SplitComplex, inverse: bool, radix: int) -> SplitComplex:
    """The launches of :func:`plan` on (batch, n) CUDA planes, the
    inverse's 1/n at the last one's store: x -> out; x -> scratch -> out;
    or x -> out -> scratch -> out (one scratch pair either way)."""
    batch, n = x.shape
    tails = _launch_args(radix, batch, n, bool(inverse), x.re.device)
    x = _axis.aligned(x)
    dev = x.re.device
    tab = table(n, radix, inverse, dev)
    args = _R2_ARGS if radix == 2 else _R4_ARGS
    fn = _build.function("fft_stockham", f"fft_stockham_r{radix}_pass", args)
    out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    if len(tails) == 1:
        bufs = [x, out]
    else:
        scratch = SplitComplex(torch.empty_like(x.re),
                               torch.empty_like(x.im))
        bufs = [x, scratch, out] if len(tails) == 2 else [x, out, scratch,
                                                          out]
    store = [_build.store_code(x.dtype)]
    calls = [[bufs[i].re.data_ptr(), bufs[i].im.data_ptr(),
              bufs[i + 1].re.data_ptr(), bufs[i + 1].im.data_ptr(),
              tab.data_ptr()] + tail + store for i, tail in enumerate(tails)]
    _build.launch_all(fn, calls, f"fft_stockham_r{radix}", dev)
    return out


def _cuda(x: SplitComplex, inverse: bool, radix: int) -> SplitComplex:
    _build.check_operands(x, 2, _axis.DTYPES)
    n = x.shape[1]
    _check_n(n)
    return _fused(x, inverse, radix)


def fft_stockham_cuda(x: SplitComplex, *, inverse: bool = False
                      ) -> SplitComplex:
    """Launch the mixed-radix Stockham kernel on (batch, n) CUDA planes
    (float32, bfloat16 or float16): the fused launches of
    :func:`r4_plan`."""
    return _cuda(x, inverse, 4)


def fft_stockham_r2_cuda(x: SplitComplex, *, inverse: bool = False
                         ) -> SplitComplex:
    """Launch the radix-2 Stockham kernel on (batch, n) CUDA planes
    (float32, bfloat16 or float16): the launches of :func:`r2_plan`."""
    return _cuda(x, inverse, 2)
