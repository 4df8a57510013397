"""The host plan and tables of the plain-variant bfloat16 and float16 route
of the 2-D and 3-D GEMM transforms (``csrc/dft_mma.cuh``): every DFT
product of the four-step method on the tensor cores, one launch and one
pass over device memory an axis.

An axis of n = n1 * n2 points (:func:`~repro_torch.kernels.rfft2d_fused.
fourstep_factors`, or ``fourstep_factors3`` in 3-D; n1 == 1: one dense
DFT) along the (outer, n, inner) view of the planes takes:

- ``"rows"`` (inner == 1): tiles of G whole rows, both steps in shared
  memory, up to ``rows_max`` points (:class:`Limits`);
- ``"cols"``: tiles of C adjacent columns (C >= 8: fewer columns an image
  are zero-padded to 8) of all n rows, up to ``cols_max`` points, in
  place in the output after the first axis;
- past those, two launches through a scratch pair in the storage dtype,
  each a tiled product over device memory that takes a factor of any
  length: ``"long1"``, the n1-point DFT with the twiddle along the
  (outer, n1, n2*inner) view, and ``"long2"``, the n2-point DFT of the
  (outer*n1, n2, inner) view stored at X[k2*n1 + k1].

The plan picks the routes and the tiles' lines from the shape alone,
before any launch; the kernel's source owns the rest (shared memory,
buffers, threads, the grid), which :func:`geometry` reads back from the
built library.

Tables (:func:`tables`): each factor's DFT matrix W (rounded to the
storage dtype, the plain variant's ``hi`` half) as the real 2p x 2p matrix
``[[Wr, -Wi], [Wi, Wr]]`` (p = the factor padded to a multiple of 8, rows
padded to 16) in the order of mma.sync's A fragments (:func:`frag_np`),
and the twiddle T (n1, n2) as two planes, all in the storage dtype and
cached per key by ``core/twiddle.py``.  The DFT matrices are symmetric, so
the row pass's right product U @ W2 is the left product W2 U^T.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.complexmath import SplitComplex
from repro_torch.core.twiddle import _cast
from . import _build
from .axis_fft import aligned
from .rfft2d_fused import fourstep_tables_np

ROUTES = {"rows": 0, "cols": 1, "long1": 2, "long2": 3}
ARGS = ([_build.P] * 8 + [_build.I, _build.L, _build.I, _build.L]
        + [_build.I] * 3 + [_build.F, _build.I, _build.P])
GEOMETRY_ARGS = [_build.I, _build.L, _build.I, _build.L, _build.I, _build.I,
                 _build.I, _build.P]


class Limits(NamedTuple):
    """The plan's thresholds: the longest row and column an axis takes in
    one launch, and the points a tile aims at."""
    rows_max: int = 16384       # one 64 KB row a tile
    cols_max: int = 2048        # 8 columns a tile
    tile: int = 8192


LIMITS = Limits()


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(v, hi))


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch: ``route`` over the (outer, n, inner) view, n = n1 * n2,
    tiles of ``lines`` lines (G rows, or C columns; 0 on the long
    routes); ``axis`` indexes the plan's axes (its tables), ``src`` /
    ``dst`` the planes read and written (0 the input, 1 the output, 2 the
    scratch pair)."""
    route: str
    outer: int
    n: int
    inner: int
    n1: int
    lines: int
    axis: int = 0
    src: int = 1
    dst: int = 1

    @property
    def n2(self) -> int:
        return self.n // self.n1

    @property
    def two(self) -> bool:
        """Both steps in one launch (a four-step axis on one tile)."""
        return self.route in ("rows", "cols") and self.n1 > 1

    @property
    def flops(self) -> int:
        """The products' real flops: 8 f a point for each f-point step."""
        steps = (self.n1, self.n2) if self.two else (
            (self.n1,) if self.route == "long1" else
            (self.n2,) if self.route == "long2" else (self.n,))
        return 8 * sum(steps) * self.outer * self.n * self.inner

    def args(self) -> list:
        """The C entries' arguments that describe this launch."""
        return [ROUTES[self.route], self.outer, self.n, self.inner, self.n1,
                self.lines]


def axis_launches(outer: int, n: int, inner: int, factors, axis: int = 0,
                  src: int = 1, limits: Limits = LIMITS) -> tuple:
    """The launches of one axis of n points along the (outer, n, inner)
    view, factors (n1, n2), reading plane ``src`` and ending in the
    output."""
    n1, n2 = factors
    if n1 * n2 != n:
        raise ValueError(f"factors {factors} of an axis of {n} points")
    if inner == 1 and (n1 == 1 or n <= limits.rows_max):
        # rows of 2 or 4 points take 8 in shared memory
        g = _clamp(limits.tile // max(n, 8), 1, _pow2ceil(outer))
        return (Launch("rows", outer, n, 1, n1, g, axis, src),)
    if inner > 1 and (n1 == 1 or n <= limits.cols_max):
        c = _clamp(limits.tile // n, 8, max(inner, 8))
        return (Launch("cols", outer, n, inner, n1, c, axis, src),)
    return (Launch("long1", outer, n, inner, n1, 0, axis, src, 2),
            Launch("long2", outer, n, inner, n1, 0, axis, 2, 1))


@functools.lru_cache(maxsize=256)
def plan2d(batch: int, h: int, w: int, factors,
           limits: Limits = LIMITS) -> tuple:
    """The launches of a (batch, h, w) transform: the W axis on rows, then
    the H axis on columns, ``factors(n)`` each axis' split."""
    return (axis_launches(batch * h, w, 1, factors(w), 0, 0, limits)
            + axis_launches(batch, h, w, factors(h), 1, 1, limits))


@functools.lru_cache(maxsize=256)
def plan3d(batch: int, d: int, h: int, w: int, factors,
           limits: Limits = LIMITS) -> tuple:
    """The launches of a (batch, d, h, w) transform: W on rows, H on the
    columns of the (batch*d, h, w) view, D on those of (batch, d, h*w)."""
    return (axis_launches(batch * d * h, w, 1, factors(w), 0, 0, limits)
            + axis_launches(batch * d, h, w, factors(h), 1, 1, limits)
            + axis_launches(batch, d, h * w, factors(d), 2, 1, limits))


class Geometry(NamedTuple):
    """What a launch takes on the card, as the kernel's source sizes it:
    dynamic shared memory a block (bytes; the long routes' is static),
    input buffers, threads a block, blocks, and the tiles they walk."""
    smem: int
    nbuf: int
    threads: int
    blocks: int
    tiles: int


def geometry(fn, lp: Launch, sms: int) -> Geometry:
    """``lp``'s :class:`Geometry` on ``sms`` SMs from a library's
    ``*_plain_geometry`` entry ``fn``; raises where the source refuses the
    launch."""
    out = (ctypes.c_longlong * 5)()
    _build.check(fn(*lp.args(), sms, out), f"plain route {lp}")
    return Geometry(*out)


def frag_np(wr: np.ndarray, wi: np.ndarray) -> np.ndarray:
    """The real matrix [[Wr, -Wi], [Wi, Wr]] of an f-point DFT (float64
    planes holding storage-dtype values), zero-padded to 2p columns (p = f
    padded to a multiple of 8) and 16-row blocks, in the order of
    mma.sync m16n8k16's A fragments: [block][re rows, im rows][16-deep
    chunk][lane][8 halves], lane 4g + t holding (g, 2t), (g, 2t+1),
    (g+8, 2t), (g+8, 2t+1), (g, 2t+8), (g, 2t+9), (g+8, 2t+8),
    (g+8, 2t+9)."""
    f = wr.shape[0]
    p = max(8, -(-f // 8) * 8)
    mbs = -(-f // 16)
    big = np.zeros((2, mbs * 16, 2 * p))
    big[0, :f, :f], big[0, :f, p:p + f] = wr, -wi
    big[1, :f, :f], big[1, :f, p:p + f] = wi, wr
    g, t = np.divmod(np.arange(32), 4)
    rows = g[:, None] + np.array([0, 0, 8, 8, 0, 0, 8, 8])
    cols = 2 * t[:, None] + np.array([0, 1, 0, 1, 8, 9, 8, 9])
    mb = np.arange(mbs)[:, None, None, None, None]
    kc = np.arange(2 * p // 16)[None, None, :, None, None]
    part = np.arange(2)[None, :, None, None, None]
    return big[part, mb * 16 + rows, kc * 16 + cols].reshape(-1)


def _round(t: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    return torch.from_numpy(np.asarray(t)).to(dtype).double().numpy()


def _tables_np(n: int, factors: tuple, inverse: bool, dtype_name: str):
    """(A1, Tr, Ti, A2) of one axis as float64 arrays of storage-dtype
    values, or (A2,) for a dense axis."""
    dtype = getattr(torch, dtype_name)
    w1r, w1i, w2r, w2i, twr, twi = (_round(t, dtype) for t in
                                    fourstep_tables_np(n, inverse, factors))
    if factors[0] == 1:
        return (frag_np(w2r, w2i),)
    return frag_np(w1r, w1i), twr, twi, frag_np(w2r, w2i)


def tables(n: int, factors, inverse: bool, dtype: torch.dtype,
           device) -> tuple:
    """:func:`_tables_np` in ``dtype`` on ``device``, cached per key:
    (A1, Tr, Ti, A2), A1 and the twiddle None for a dense axis."""
    name = str(dtype).replace("torch.", "")
    t = _cast(_tables_np, (n, tuple(factors), bool(inverse), name), dtype,
              torch.device(device))
    return t if len(t) == 4 else (None, None, None, t[0])


@functools.lru_cache(maxsize=64)
def prepare(batch: int, dims: tuple, factors,
            limits: Limits = LIMITS) -> tuple:
    """(plan, axes) of a transform of ``batch`` images of ``dims`` ((h, w)
    or (d, h, w)): :func:`plan2d` or :func:`plan3d`, and each axis' (n,
    factors) in the plan's order (W, H, D)."""
    plan = (plan2d(batch, *dims, factors, limits) if len(dims) == 2
            else plan3d(batch, *dims, factors, limits))
    return plan, tuple((n, tuple(factors(n))) for n in reversed(dims))


@functools.lru_cache(maxsize=16)
def _launch_args(plan: tuple, axes: tuple, inverse: bool, dtype, device,
                 sms: int):
    """Each launch's (source, destination, arguments after the four plane
    pointers) on ``sms`` SMs, the inverse's 1/N at the last; the tables
    they point at are held with them."""
    tabs = [tables(n, f, inverse, dtype, device) for n, f in axes]
    total = 1
    for n, _ in axes:
        total *= n
    f16 = int(dtype == torch.float16)
    out = []
    for i, lp in enumerate(plan):
        scale = 1.0 / total if inverse and i == len(plan) - 1 else 1.0
        out.append((lp.src, lp.dst, [
            None if t is None else t.data_ptr() for t in tabs[lp.axis]]
            + lp.args() + [sms, scale, f16]))
    return tuple(out), tabs


def run(fn, dims: tuple, factors, x: SplitComplex, out: SplitComplex,
        inverse: bool, what: str, limits: Limits = LIMITS) -> None:
    """Transform x's images of ``dims`` into out with the C entry ``fn``,
    one launch of :func:`prepare`'s plan at a time."""
    x = aligned(x)
    dev = out.re.device
    plan, axes = prepare(x.shape[0], tuple(dims), factors, limits)
    planes = [x, out]
    if any(lp.dst == 2 for lp in plan):
        planes.append(SplitComplex(torch.empty_like(x.re),
                                   torch.empty_like(x.im)))
    args, _ = _launch_args(plan, axes, bool(inverse), x.dtype, dev,
                           _build.sm_count(dev))
    calls = [[p.data_ptr() for p in (*planes[src], *planes[dst])] + tail
             for src, dst, tail in args]
    _build.launch_all(fn, calls, what, dev)
