"""Fused Stockham 2-D FFT (the ``algo="fused_stockham"`` oracle): the CUDA
kernel and its plain PyTorch version.

Replaces ``repro/kernels/fft2d_fused.py::_fft2d_kernel``: the mixed
radix-4/radix-2 Stockham stages of
:func:`repro_torch.core.fft1d.stockham_stages` on every row, a tile
transpose, the same stages on every column, the transpose back, and
1/(H*W) for the inverse, with the packed (s4, 3, n/4) tables of W and H.

The TPU kernel transposes inside VMEM; a 1024^2 fp32 image is 8 MB
against 227 KB of shared memory a block, so ``csrc/fft2d_fused.cu`` runs
two launches (:func:`plan`), each one pass over the planes on the fused
radix-4 Stockham machinery of the 1-D kernel (``csrc/stockham.cuh``):
every stage of length w on tiles of G whole rows, then every stage of
length h on tiles of C adjacent whole columns (or G whole images), in
place, the transpose being the column tiles' indexing.  Each launch reads
the one (3, n/4) table of its length (:func:`tables`), whose entry
(j >> 2s) << 2s is row s of the packed table the plain version takes.
What bounds it: bytes (16 per complex point in and out); the design moves
the planes twice.  Longer axes take the 1-D kernel's routes on the same
machinery: rows of up to 2^14 points one a tile, columns of up to 2^14 in
2- and 1-column tiles, either axis up to 2^24 as the 1-D kernel's launches
A and B (the columns' launch B storing whole tiles of columns,
"split_tcols"), and up to :data:`THREE_MAX` as its three launches
(``fft_stockham.split3``; the middle one, "split_mid", with the four-step
column q = column >> log2 w on columns), each one pass over the planes.
float32, bfloat16 or float16 planes (widened at the load, rounded at each
store).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.complexmath import SplitComplex
from repro_torch.core import twiddle as tw
from repro_torch.core.fft1d import stockham_stages
from . import _build
from . import axis_fft as _axis
from .fft_stockham import split, split3

ONE_MAX = 1 << 14       # the longest axis one launch holds
TWO_MAX = 1 << 24       # ... two (the 1-D kernel's launches A and B)
# ... three (its launches 1, 2 and 3): launch 3 on columns (ST_TCOLS) takes
# at most 2^12 points, which split3 gives up to 2^32 (2^33: 2^13).  Its rows
# would take 2^14 (to 2^36), but an image with a row past 2^32 holds 2^34
# points or more, 64 GiB a plane pair in bfloat16, beyond any card.
THREE_MAX = 1 << 32
_ROUTES = {"rows": 0, "split_cols": 1, "split_rows": 2, "split_tcols": 3,
           "split_mid": 4}
_OTHER = ("split_mid", "split_rows", "split_tcols")   # read other planes


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


def rows_smem(w: int, g: int) -> int:
    """The row pass's shared memory a block (``fft2d_fused_pass``): G rows
    of pitch ``pitch(w, min(log2 G, 3))`` a work plane."""
    floats = _axis.pitch(w, min(_axis._log2(g), 3)) * g
    nbuf = 2 if w * g <= _axis.TILE else 1
    return nbuf * 2 * 4 * (-(-floats // 32) * 32)


def _axis_steps(outer: int, n: int, inner: int) -> list:
    """The launches of every stage of length n along the (outer, n, inner)
    view (inner = 1: rows), as (route, Launch) pairs; a "split_*" Launch
    keeps the kernel's l1 argument in ``lr[0]`` (l1 for launches A, B, 1
    and 2, l1 + l2 for launch 3) and log2 of the images' inner extent in
    ``ljr``."""
    if n <= ONE_MAX:
        if inner == 1:
            rows = _axis.plan_axis(outer, n, 1)
            g = rows.g
            while rows_smem(n, g) > _axis.SMEM_MAX:
                g //= 2
            return [("rows", dataclasses.replace(rows, g=g))]
        return [("cols", _axis.plan_axis(outer, n, inner))]
    if n > THREE_MAX:
        raise ValueError(f"the fused Stockham 2-D kernel takes axes of up "
                         f"to 2^{THREE_MAX.bit_length() - 1}, got {n}: its "
                         "third launch on columns takes at most 2^12 points")
    lin = _axis._log2(inner)
    last = "split_rows" if inner == 1 else "split_tcols"
    if n <= TWO_MAX:
        l1 = split(n, 4)
        m, q = 1 << l1, n >> l1
        a = _axis.plan_axis(outer, m, q * inner)
        b = _axis.plan_axis(outer * m, q, inner)
        return [("split_cols", dataclasses.replace(a, ljr=lin, lr=(l1, 0))),
                (last, dataclasses.replace(b, ljr=lin, lr=(l1, 0)))]
    l1, l2, lq = split3(n, 4)
    m1, m2, q = 1 << l1, 1 << l2, 1 << lq
    a = _axis.plan_axis(outer, m1, m2 * q * inner)
    mid = _axis.plan_axis(outer * m1, m2, q * inner)
    b = _axis.plan_axis(outer * m1 * m2, q, inner)
    return [("split_cols", dataclasses.replace(a, ljr=lin, lr=(l1, 0))),
            ("split_mid", dataclasses.replace(mid, ljr=lin, lr=(l1, 0))),
            (last, dataclasses.replace(b, ljr=lin, lr=(l1 + l2, 0)))]


def plan(batch: int, h: int, w: int) -> tuple:
    """The launches, as (route, :class:`axis_fft.Launch`) pairs: every
    stage of length w on the batch*h rows, then every stage of length h on
    the columns of the (batch, h, w) view.  An axis of up to 2^14 is one
    launch: ``("rows", ...)`` on tiles of G whole rows
    (:func:`axis_fft.plan_axis`'s, halved where narrow rows' padded pitch
    would overflow shared memory), ``("cols", ...)`` on tiles of C =
    8192/h adjacent columns (16384/h from h = 2048), or G whole images
    where w < C.  Up to 2^24 it is the 1-D kernel's two launches (l1 =
    :func:`fft_stockham.split`): ``("split_cols", ...)`` on columns of the
    (., 2^l1, n/2^l1 * inner) view, then ``("split_rows", ...)`` or, for
    columns, ``("split_tcols", ...)``, stored transposed.  Up to
    :data:`THREE_MAX` it is the 1-D kernel's three launches, n = M1 * M2 *
    Q (:func:`fft_stockham.split3`): ``("split_cols", ...)`` on columns of
    the (., M1, M2*Q * inner) view, ``("split_mid", ...)`` on the stages
    of the next l2 bits over columns of the (.*M1, M2, Q * inner) view
    (the four-step column q = column >> log2 inner), stored at (o, t*M1 +
    k, c), then ``("split_rows", ...)`` or ``("split_tcols", ...)`` after
    l1 + l2 bits on the (.*M1*M2, Q, inner) view.  Past it, it raises."""
    _check_dims(h, w)
    return tuple(_axis_steps(batch * h, w, 1) + _axis_steps(batch, h, w))


def buffers(steps: tuple) -> list:
    """(src, dst) planes of each launch: 0 x, 1 out, 2 a scratch pair; the
    last writes out, the routes of ``_OTHER`` read other planes than they
    write, the others work in place (:func:`axis_fft.buffers`); a long
    axis' launches 2 and 3 go out -> scratch -> out."""
    return _axis.buffers(tuple(dataclasses.replace(
        lp, mode="reversed" if route in _OTHER else "plain")
        for route, lp in steps))


def tables(h: int, w: int, inverse: bool, device) -> tuple:
    """Each axis' one (3, n/4) radix-4 table: w's, then h's."""
    return tuple(tw.radix4_twiddles(n, inverse=inverse, device=device)
                 for n in (w, h))


@functools.lru_cache(maxsize=64)
def _launch_args(batch: int, h: int, w: int, inverse: bool, store: int,
                 device: torch.device) -> tuple:
    """Each launch's (route, axis, arguments after the pointers)."""
    sms = _build.sm_count(device)
    log2 = _axis._log2
    steps = plan(batch, h, w)
    out = []
    for i, (route, lp) in enumerate(steps):
        axis = 0 if i < len(steps) - len(_axis_steps(batch, h, w)) else 1
        scale = 1.0 / (h * w) if inverse and i == len(steps) - 1 else 1.0
        if route == "cols":
            args = [lp.outer, log2(lp.n), log2(lp.inner), log2(lp.c),
                    log2(lp.g), lp.blocks(sms), scale, int(inverse),
                    store]
        else:
            args = [lp.outer, log2(lp.n), log2(lp.inner), log2(lp.c),
                    log2(lp.g), _ROUTES[route], lp.lr[0], lp.ljr,
                    lp.blocks(sms), scale, int(inverse), store]
        out.append((route, axis, args))
    return tuple(out)


_ARGS = ([_build.P] * 5 + [_build.L] + [_build.I] * 5
         + [_build.F, _build.I, _build.I, _build.P])
_1D_ARGS = ([_build.P] * 5 + [_build.L] + [_build.I] * 8
            + [_build.F, _build.I, _build.I, _build.P])


def fft2d_fused_cuda(x: SplitComplex, *, inverse: bool = False
                     ) -> SplitComplex:
    """Launch the row and column passes of :func:`plan` on (batch, h, w)
    CUDA planes (float32, bfloat16 or float16), the inverse's 1/(h*w) at
    the last store."""
    _build.check_operands(x, 3, _axis.DTYPES)
    batch, h, w = x.shape
    _check_dims(h, w)
    x = _axis.aligned(x)
    dev = x.re.device
    out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    steps = plan(batch, h, w)
    planes = [x, out]
    routes = buffers(steps)
    if any(2 in r for r in routes):
        planes.append(SplitComplex(torch.empty_like(x.re),
                                   torch.empty_like(x.im)))
    tabs = tables(h, w, inverse, dev)
    fns = {}
    for (src, dst), (route, axis, args) in zip(routes, _launch_args(
            batch, h, w, bool(inverse), _build.store_code(x.dtype), dev)):
        ptrs = [*(p.data_ptr() for p in planes[src]),
                *(p.data_ptr() for p in planes[dst])]
        if route == "cols":
            sym, argt = "fft2d_fused_pass", _ARGS
        else:
            sym, argt = "fft2d_fused_1d", _1D_ARGS
        if sym not in fns:
            fns[sym] = _build.function("fft2d_fused", sym, argt)
        _build.launch(fns[sym], ptrs + [tabs[axis].data_ptr()] + args,
                      "fft2d_fused", dev)
    return out
