"""Mixed radix-4/radix-2 Stockham FFT and its pure radix-2 twin: the CUDA
kernels and their plain PyTorch versions.

Replaces ``repro/kernels/fft_stockham.py::_stockham_kernel`` (radix=4) and
``::_stockham_kernel_r2`` (radix=2, the oracle and ``algo="stockham2"``).
The TPU kernel runs all stages of a VMEM-resident batch tile.

Radix 4 (``csrc/fft_stockham.cu``): a row of n > 2^20 points fits no
shared memory, so one kernel launches per radix-4 stage over global
ping-pong buffers (one thread per butterfly, twiddles from row s of the
packed (s4, 3, n/4) table), then the radix-2 tail.  What bounds it:
bytes -- every stage streams the array and its table row through HBM,
about 13x the bytes the transform needs at n = 2^22.

Radix 2: the same butterflies in the same order, up to four stages a pass
in registers between shared-memory barriers, over tiles that a persistent
grid copies in (:func:`r2_plan`): one launch for n <= :data:`R2_ONE_MAX`,
two above (stages 0..l1-1 on the columns of the (2^l1, n/2^l1) view, then
the rest as length-n/2^l1 Stockhams on the stride-2^l1 subsets), each one
pass over HBM, up to :data:`R2_MAX`.  It reads one table, W_n^p for p < n/2
(:func:`repro_torch.core.twiddle.radix2_twiddles`), at index
(j >> s) << s for stage s's butterfly j: the packed (stages, n/2) table's
row s bit for bit.  The plain version keeps the packed table, as the
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

R2_ONE_MAX = 1 << 14    # the largest n of the one-launch radix-2 route
R2_MAX = 1 << 24        # two launches of up to 2^12-point transforms


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
_R2_ARGS = ([_build.P] * 5 + [_build.L] + [_build.I] * 7
            + [_build.F, _build.P])
_R2_ROUTES = {"rows": 0, "cols": 1, "transposed": 2}


def _r2_split(n: int) -> int:
    """l1 = ceil(log2(n) / 2): the stages of the two-launch route's launch
    A."""
    return n.bit_length() // 2


def r2_plan(batch: int, n: int) -> tuple:
    """The radix-2 kernel's launches, as (route, :class:`axis_fft.Launch`)
    pairs: ``("rows", ...)`` alone for n <= :data:`R2_ONE_MAX`; above,
    with n = M * Q and M = 2^l1, l1 = ceil(log2(n) / 2), ``("cols", ...)``
    (launch A: stages 0..l1-1 on the columns of the (batch, M, Q) view,
    x -> scratch, each point back in its place) and ``("transposed", ...)``
    (launch B: the other stages on the batch*M rows of Q of the scratch,
    row k's point t stored at t*M + k of out)."""
    _check_n(n)
    if n > R2_MAX:
        raise ValueError(f"the radix-2 CUDA kernel takes n <= {R2_MAX} "
                         f"(two launches of up to 2^12 points), got {n}")
    if n <= R2_ONE_MAX:
        return (("rows", _axis.plan_axis(batch, n, 1)),)
    l1 = _r2_split(n)
    m, q = 1 << l1, n >> l1
    return (("cols", _axis.plan_axis(batch, m, q)),
            ("transposed", _axis.plan_axis(batch * m, q, 1)))


def fft_stockham_cuda(x: SplitComplex, *, inverse: bool = False
                      ) -> SplitComplex:
    """Launch the per-stage mixed-radix Stockham kernels on (batch, n) CUDA
    planes."""
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


@functools.lru_cache(maxsize=64)
def _r2_launch_args(batch: int, n: int, inverse: bool,
                    device: torch.device) -> tuple:
    """Each planned launch's arguments after the five pointers."""
    plan = r2_plan(batch, n)
    sms = _build.sm_count(device)
    log2 = _axis._log2
    return tuple([lp.outer, log2(lp.n), log2(lp.inner), log2(lp.c),
                  log2(lp.g), _R2_ROUTES[route], _r2_split(n),
                  lp.blocks(sms),
                  1.0 / n if inverse and i == len(plan) - 1 else 1.0]
                 for i, (route, lp) in enumerate(plan))


def fft_stockham_r2_cuda(x: SplitComplex, *, inverse: bool = False
                         ) -> SplitComplex:
    """Launch the fused radix-2 Stockham kernel on (batch, n) CUDA planes:
    the launches of :func:`r2_plan`, the inverse's 1/n at the last one's
    store."""
    _build.check_operands(x, 2)
    batch, n = x.shape
    tails = _r2_launch_args(batch, n, bool(inverse), x.re.device)
    x = _axis.aligned(x)
    dev = x.re.device
    tab = tw.radix2_twiddles(n, inverse=inverse, device=dev)
    out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    bufs = [x, out]
    if len(tails) == 2:
        bufs.insert(1, SplitComplex(torch.empty_like(x.re),
                                    torch.empty_like(x.im)))
    calls = [[bufs[i].re.data_ptr(), bufs[i].im.data_ptr(),
              bufs[i + 1].re.data_ptr(), bufs[i + 1].im.data_ptr(),
              tab.data_ptr()] + tail for i, tail in enumerate(tails)]
    fn = _build.function("fft_stockham", "fft_stockham_r2_pass", _R2_ARGS)
    _build.launch_all(fn, calls, "fft_stockham_r2", dev)
    return out
