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
the planes twice.  float32 only.
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

MAX_DIM = 4096          # the largest H or W the CUDA kernel takes
_ROUTES = {"rows": 0, "cols": 1}


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


_ARGS = ([_build.P] * 5 + [_build.L] + [_build.I] * 6
         + [_build.F, _build.I, _build.P])


def rows_smem(w: int, g: int) -> int:
    """The row pass's shared memory a block (``fft2d_fused_pass``): G rows
    of pitch ``pitch(w, min(log2 G, 3))`` a work plane."""
    floats = _axis.pitch(w, min(_axis._log2(g), 3)) * g
    nbuf = 2 if w * g <= _axis.TILE else 1
    return nbuf * 2 * 4 * (-(-floats // 32) * 32)


def plan(batch: int, h: int, w: int) -> tuple:
    """The two launches, as (route, :class:`axis_fft.Launch`) pairs:
    ``("rows", ...)``, every stage of length w on the batch*h rows (tiles
    of G whole rows, :func:`axis_fft.plan_axis`'s, halved where narrow
    rows' padded pitch would overflow shared memory), x -> out;
    ``("cols", ...)``, every stage of length h on the columns of the
    (batch, h, w) view (tiles of C = 8192/h adjacent columns, 16384/h from
    h = 2048, or G whole images where w < C), out in place."""
    _check_dims(h, w)
    rows = _axis.plan_axis(batch * h, w, 1)
    g = rows.g
    while rows_smem(w, g) > _axis.SMEM_MAX:
        g //= 2
    return (("rows", dataclasses.replace(rows, g=g)),
            ("cols", _axis.plan_axis(batch, h, w)))


def tables(h: int, w: int, inverse: bool, device) -> tuple:
    """Each launch's one (3, n/4) radix-4 table: w's, then h's."""
    return tuple(tw.radix4_twiddles(n, inverse=inverse, device=device)
                 for n in (w, h))


@functools.lru_cache(maxsize=64)
def _launch_args(batch: int, h: int, w: int, inverse: bool,
                 device: torch.device) -> tuple:
    """Each launch's arguments after the five pointers."""
    sms = _build.sm_count(device)
    log2 = _axis._log2
    return tuple((lp.outer, log2(lp.n), log2(lp.inner), log2(lp.c),
                  log2(lp.g), _ROUTES[route], lp.blocks(sms),
                  1.0 / (h * w) if inverse and route == "cols" else 1.0,
                  int(inverse))
                 for route, lp in plan(batch, h, w))


def fft2d_fused_cuda(x: SplitComplex, *, inverse: bool = False
                     ) -> SplitComplex:
    """Launch the row and column passes of :func:`plan` on (batch, h, w)
    fp32 CUDA planes, the inverse's 1/(h*w) at the column pass's store."""
    _build.check_operands(x, 3)
    batch, h, w = x.shape
    _check_dims(h, w)
    if h > MAX_DIM or w > MAX_DIM:
        raise ValueError("the CUDA fused Stockham 2-D kernel takes H, W <= "
                         f"{MAX_DIM}, got {(h, w)}")
    x = _axis.aligned(x)
    dev = x.re.device
    out = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
    ptrs = [x.re.data_ptr(), x.im.data_ptr()]
    dst = [out.re.data_ptr(), out.im.data_ptr()]
    calls = [(ptrs if i == 0 else dst) + dst + [tab.data_ptr(), *tail]
             for i, (tab, tail) in enumerate(zip(
                 tables(h, w, inverse, dev),
                 _launch_args(batch, h, w, bool(inverse), dev)))]
    fn = _build.function("fft2d_fused", "fft2d_fused_pass", _ARGS)
    _build.launch_all(fn, calls, "fft2d_fused", dev)
    return out
