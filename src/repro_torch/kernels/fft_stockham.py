"""Mixed radix-4/radix-2 Stockham FFT and its pure radix-2 twin: the CUDA
kernels and their plain PyTorch versions.

Replaces ``repro/kernels/fft_stockham.py::_stockham_kernel`` (radix=4) and
``::_stockham_kernel_r2`` (radix=2, the oracle and ``algo="stockham2"``).
The TPU kernel runs all stages of a VMEM-resident batch tile.

Both radices run the reference's butterflies in its stage order (radix 4:
radix-4 stages, then a radix-2 tail for odd log2 n), up to four bits of
stages a pass in registers between shared-memory barriers, over tiles that
a persistent grid copies in (``csrc/fft_stockham.cu``, :func:`plan`): one
launch for n <= :data:`ONE_MAX`, two above (the stages of bits 0..l1-1 on
the columns of the (2^l1, n/2^l1) view, then the rest as
length-n/2^l1 Stockhams on the stride-2^l1 subsets), each one pass over
HBM, up to :data:`TWO_MAX`.  Radix 2 splits at l1 = ceil(log2 n / 2),
radix 4 at an even l1 (:func:`split`), so that launch A holds whole
radix-4 stages.  Above :data:`TWO_MAX` one kernel launches per stage over
global ping-pong buffers (radix 4: its stages, then the radix-2 tail).
float32, bfloat16 or float16 planes: sub-fp32 planes are widened at the
load and rounded at each store, the stages run in fp32 off the fp32
tables.

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
_STAGES_ARGS = [_build.P] * 7 + [_build.L] + [_build.I] * 4 + [_build.P]
_ROUTES = {"rows": 0, "cols": 1, "transposed": 2}


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


def plan(batch: int, n: int, radix: int) -> tuple:
    """The kernel's launches, as (route, :class:`axis_fft.Launch`) pairs:
    ``("rows", ...)`` alone for n <= :data:`ONE_MAX`; up to
    :data:`TWO_MAX`, with n = M * Q and M = 2^l1 (:func:`split`),
    ``("cols", ...)`` (launch A: the stages of bits 0..l1-1 on the columns
    of the (batch, M, Q) view, x -> scratch, each point back in its place)
    and ``("transposed", ...)`` (launch B: the other stages on the batch*M
    rows of Q of the scratch, row k's point t stored at t*M + k of out);
    above, ``("stages", ...)``: one launch a stage (radix 4: then the
    radix-2 tail) over the (batch, n) planes."""
    _check_n(n)
    if n > TWO_MAX:
        return (("stages", _axis.Launch("stages", batch, n, 1, 1, 1)),)
    if n <= ONE_MAX:
        return (("rows", _axis.plan_axis(batch, n, 1)),)
    l1 = split(n, radix)
    m, q = 1 << l1, n >> l1
    return (("cols", _axis.plan_axis(batch, m, q)),
            ("transposed", _axis.plan_axis(batch * m, q, 1)))


def r2_plan(batch: int, n: int) -> tuple:
    """:func:`plan` of the radix-2 kernel."""
    return plan(batch, n, 2)


def r4_plan(batch: int, n: int) -> tuple:
    """:func:`plan` of the radix-4 kernel."""
    return plan(batch, n, 4)


@functools.lru_cache(maxsize=64)
def _launch_args(radix: int, batch: int, n: int, inverse: bool,
                 device: torch.device) -> tuple:
    """Each fused launch's arguments after the five pointers."""
    steps = plan(batch, n, radix)
    sms = _build.sm_count(device)
    log2 = _axis._log2
    sign = [int(inverse)] if radix == 4 else []
    return tuple([lp.outer, log2(lp.n), log2(lp.inner), log2(lp.c),
                  log2(lp.g), _ROUTES[route], split(n, radix),
                  lp.blocks(sms),
                  1.0 / n if inverse and i == len(steps) - 1 else 1.0] + sign
                 for i, (route, lp) in enumerate(steps))


def table(n: int, radix: int, inverse: bool, device) -> torch.Tensor:
    """The radix's one fp32 table on ``device``."""
    if radix == 2:
        return tw.radix2_twiddles(n, inverse=inverse, device=device)
    return tw.radix4_twiddles(n, inverse=inverse, device=device)


def _fused(x: SplitComplex, inverse: bool, radix: int) -> SplitComplex:
    """The launches of :func:`plan` on (batch, n) CUDA planes, the
    inverse's 1/n at the last one's store."""
    batch, n = x.shape
    tails = _launch_args(radix, batch, n, bool(inverse), x.re.device)
    x = _axis.aligned(x)
    dev = x.re.device
    tab = table(n, radix, inverse, dev)
    args = _R2_ARGS if radix == 2 else _R4_ARGS
    fn = _build.function("fft_stockham", f"fft_stockham_r{radix}_pass", args)
    out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    bufs = [x, out]
    if len(tails) == 2:
        bufs.insert(1, SplitComplex(torch.empty_like(x.re),
                                    torch.empty_like(x.im)))
    store = [_build.store_code(x.dtype)]
    calls = [[bufs[i].re.data_ptr(), bufs[i].im.data_ptr(),
              bufs[i + 1].re.data_ptr(), bufs[i + 1].im.data_ptr(),
              tab.data_ptr()] + tail + store for i, tail in enumerate(tails)]
    _build.launch_all(fn, calls, f"fft_stockham_r{radix}", dev)
    return out


def _per_stage(x: SplitComplex, inverse: bool, radix: int = 4
               ) -> SplitComplex:
    """The kernel above :data:`TWO_MAX`: a launch a stage, off the radix's
    one table."""
    batch, n = x.shape
    dev = x.re.device
    tab = table(n, radix, inverse, dev)
    out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    scratch = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    fn = _build.function("fft_stockham", "fft_stockham_stages", _STAGES_ARGS)
    ptrs = [x.re, x.im, out.re, out.im, scratch.re, scratch.im, tab]
    _build.launch(fn, [p.data_ptr() for p in ptrs] + [
        batch, n.bit_length() - 1, int(inverse), radix,
        _build.store_code(x.dtype)], "fft_stockham_stages", dev)
    return out


def _cuda(x: SplitComplex, inverse: bool, radix: int) -> SplitComplex:
    _build.check_operands(x, 2, _axis.DTYPES)
    n = x.shape[1]
    _check_n(n)
    if n > TWO_MAX:
        return _per_stage(x, inverse, radix)
    return _fused(x, inverse, radix)


def fft_stockham_cuda(x: SplitComplex, *, inverse: bool = False
                      ) -> SplitComplex:
    """Launch the mixed-radix Stockham kernel on (batch, n) CUDA planes
    (float32, bfloat16 or float16): the fused launches of :func:`r4_plan`
    up to :data:`TWO_MAX`, a launch a stage above."""
    return _cuda(x, inverse, 4)


def fft_stockham_r2_cuda(x: SplitComplex, *, inverse: bool = False
                         ) -> SplitComplex:
    """Launch the radix-2 Stockham kernel on (batch, n) CUDA planes
    (float32, bfloat16 or float16): the launches of :func:`r2_plan`."""
    return _cuda(x, inverse, 2)
