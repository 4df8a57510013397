"""The launches of the 2-D and 3-D FFT kernels (``csrc/axis_fft.cuh``) and
their twiddle tables.

A launch is one length-n complex FFT along the middle axis of the planes
viewed as (outer, n, inner), over tiles that a persistent grid walks, or a
*plane* launch: both FFTs of whole (h, w) images.  The plan takes the
fewest launches, since the transform is bound by bytes:

- 2-D (:func:`plan2d`): one plane launch for h*w <= :data:`PLANE_MAX`; else
  the W FFT on rows, then the H FFT on columns;
- 3-D (:func:`plan3d`): a plane launch and the D FFT on columns for
  h*w <= :data:`PLANE_MAX`; else W on rows, H and D on columns;
- the real-input 2-D forward's column pass (:func:`plan_half_cols`): the
  length-h FFT of c = w/2+1 columns, which is no power of two.

An axis longer than :data:`AXIS_MAX` (:func:`plan_split`) runs as one
launch a factor of a four-step split n = n1 * n2 (* n3,
:func:`split_factors`): the FFT along n1 of the (outer, n1, n2*inner) view
with the twiddle W_n^(k1*j2) at its store ("twiddle"), in place, then along
n2 of the (outer*n1, n2, inner) view, each point stored at its
digit-reversed place ("reversed"), into other planes.

Tiling (:func:`plan_axis`, :func:`plan_plane`): a rows tile holds G whole
rows, a columns tile C = 8192/n adjacent inner columns of all n rows
(16384/n from n = 2048, so C >= 8 but at n = 4096, where C = 4) or, where
inner is narrower, G whole images; a plane tile G whole images.  Tiles of up
to :data:`TILE` points take two buffers a block and overlap the next tile's
copy with their passes; larger ones (:data:`TILE_BIG`) take one.  Every
tile has at least :data:`MIN_POINTS` points (G pads past the last image:
those images are zero-filled and never stored), so a block has a warp.
The kernel checks each launch against the same rules
(``axis_fft_launch``) and takes its tiling from here.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import twiddle as tw
from repro_torch.core.complexmath import SplitComplex
from . import _build

TILE = 8192            # points of a tile with two buffers a block
TILE_BIG = 16384       # points of a tile with one buffer (n >= 2048 columns)
MIN_POINTS = 512       # points of the smallest tile: 32 threads
PLANE_MAX = 16384      # largest h*w of a plane launch (one 128 KB tile)
AXIS_MAX = 4096        # longest axis of one launch of the 2-D/3-D kernels
FACTOR_MAX = 1 << 14   # longest factor a launch takes (the four-step's)
DTYPES = _build.FFT_DTYPES                   # what the kernels store
SMEM_MAX = 232448      # dynamic shared memory a block may have (227 KB)
SM_SHARED = 233472     # shared memory of an SM, 1 KB of it reserved a block
POINTS_A_THREAD = 16


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def pitch(width: int, lt: int) -> int:
    """The kernels' padded row pitch (``pitch`` in ``axis_fft.cuh``): 32
    lanes over 2^lt rows hit 32 banks."""
    return width + (1 if lt >= 5 else 32 >> lt)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch: ``kind`` "rows" (inner = 1), "cols" or "plane" (n = h,
    inner = w); a tile holds ``c`` adjacent inner columns of ``g``
    consecutive images (c < inner: of one image).  In a plan of
    :func:`plan_half_cols`, ``inner`` is the row pitch of ragged columns,
    and the last tile of an image may reach past them."""
    kind: str
    outer: int
    n: int
    inner: int
    c: int
    g: int
    mode: str = "plain"    # or "twiddle", "reversed" (:func:`plan_split`)
    m: int = 0             # twiddle: the length M of W_M^(k1*j2)
    ljr: int = 0           # twiddle: log2 of the inner extent (j2's unit)
    lr: tuple = (0, 0)     # reversed: log2 of n1 (and n2) of the split
    img_in: int = 0        # elements between images read (0: dense)
    img_out: int = 0       # ... and written

    @property
    def points(self) -> int:
        return self.n * self.c * self.g

    @property
    def threads(self) -> int:
        return self.points // POINTS_A_THREAD

    @property
    def nbuf(self) -> int:
        """Buffers a block: with two, it copies its next tile in while it
        transforms one."""
        return 2 if self.points <= TILE else 1

    @property
    def tiles(self) -> int:
        return -(-self.outer // self.g) * -(-self.inner // self.c)

    @property
    def work_floats(self) -> int:
        """Floats a work plane of a tile (``work_floats`` in the kernel)."""
        if self.kind == "plane":
            f = pitch(self.inner, _log2(self.g * self.n)) * self.g * self.n
        elif self.kind == "rows":
            f = pitch(self.n, _log2(self.g)) * self.g
        else:
            f = self.points
        return -(-f // 32) * 32

    @property
    def smem(self) -> int:
        """Dynamic shared memory a block: nbuf buffers of two work planes."""
        return self.nbuf * 2 * 4 * self.work_floats

    def blocks(self, sms: int) -> int:
        """The persistent grid: the blocks that fit on the card at once."""
        per_sm = min(2048 // self.threads, SM_SHARED // (self.smem + 1024))
        return min(self.tiles, sms * max(1, per_sm))


def _images(cap: int, img: int, outer: int) -> int:
    """Images a tile holds: up to ``cap`` points, no more than there are,
    and at least :data:`MIN_POINTS` points."""
    g = min(max(1, cap // img), _pow2ceil(outer))
    return max(g, MIN_POINTS // img, 1)


def plan_axis(outer: int, n: int, inner: int) -> Launch:
    """The launch of a length-n FFT along the (outer, n, inner) view."""
    if inner == 1:
        return Launch("rows", outer, n, 1, 1, _images(TILE, n, outer))
    cap = TILE if n <= 1024 else TILE_BIG
    c = min(inner, cap // n)
    g = _images(cap, n * inner, outer) if c == inner else 1
    return Launch("cols", outer, n, inner, c, g)


def plan_plane(images: int, h: int, w: int) -> Launch:
    """The plane launch of both FFTs of ``images`` (h, w) images."""
    if h * w > PLANE_MAX or max(h, w) > AXIS_MAX:
        raise ValueError(f"a plane launch takes h*w <= {PLANE_MAX} and h, "
                         f"w <= {AXIS_MAX}, got {(h, w)}")
    cap = TILE if h * w <= TILE else TILE_BIG
    return Launch("plane", images, h, w, w, _images(cap, h * w, images))


def plan_half_cols(batch: int, h: int, width: int) -> Launch:
    """The length-h FFT of the first ``width`` columns (any number) of
    (batch, h, pitch) planes, the pitch chosen here: whole images a tile
    where h * 2^ceil(log2 width) points fit a tile (pitch = C = that power
    of two); else tiles of C = 8192/h (16384/h from h = 2048) adjacent
    columns and a pitch of ``width`` rounded up to min(C, 8), so that no
    C-column row segment straddles a 32-byte sector, the last tile of an
    image ragged: its chunks past the pitch read nothing."""
    cap = TILE if h <= 1024 else TILE_BIG
    whole = _pow2ceil(width)
    if h * whole <= cap:
        return Launch("cols", batch, h, whole, whole,
                      _images(cap, h * whole, batch))
    c = cap // h
    align = min(c, 8)
    return Launch("cols", batch, h, -(-width // align) * align, c, 1)


def split_factors(n: int) -> tuple:
    """The factors of an axis of n points, one launch each: n itself up to
    :data:`AXIS_MAX`, else the fewest near-equal powers of two of at most
    :data:`AXIS_MAX` points (two up to 2^24, three up to 2^36), then of at
    most :data:`FACTOR_MAX` (three up to 2^42)."""
    ln = _log2(n)
    for most in (_log2(AXIS_MAX), _log2(FACTOR_MAX)):
        parts = -(-ln // most)
        if parts <= 3:
            return tuple(1 << (ln // parts + (i < ln % parts))
                         for i in range(parts))
    raise ValueError(f"an axis of {n} points exceeds any card's memory")


def plan_split(outer: int, n: int, inner: int, img_in: int = 0,
               img_out: int = 0, factors=None) -> tuple:
    """The launches of a length-n FFT along the (outer, n, inner) view: one
    (:func:`plan_axis`) for n <= :data:`AXIS_MAX`, else one a factor of
    ``factors`` (:func:`split_factors`): the FFT along n_i of the
    (outer*n_1..n_(i-1), n_i, n_(i+1)..*inner) view, "twiddle" launches
    multiplying point (k_i, j) by W_M^(k_i*j) (M = n_i*n_(i+1)..., j the
    column over ``inner``), in place, and a last "reversed" launch storing
    point k of image (o, k_1, k_2) at (o, k*n_1*n_2 + k_2*n_1 + k_1).
    ``img_in`` / ``img_out``: strides of the images read by the first
    launch and written by the last (0: dense)."""
    fs = split_factors(n) if factors is None else tuple(factors)
    if len(fs) == 1:
        return (plan_axis(outer, n, inner),)
    launches, before = [], 1
    for i, f in enumerate(fs):
        after = n // (before * f)
        lp = plan_axis(outer * before, f, after * inner)
        if i == 0 and img_in and lp.c == lp.inner:
            lp = dataclasses.replace(lp, g=1)    # images apart: one a tile
        if i < len(fs) - 1:
            lp = dataclasses.replace(lp, mode="twiddle", m=f * after,
                                     ljr=_log2(inner))
        else:
            lr = [_log2(x) for x in fs[:-1]] + [0]
            lp = dataclasses.replace(lp, mode="reversed", lr=(lr[0], lr[1]))
        launches.append(dataclasses.replace(
            lp, img_in=img_in if i == 0 else 0,
            img_out=img_out if i == len(fs) - 1 else 0))
        before *= f
    return tuple(launches)


def plan2d(batch: int, h: int, w: int) -> tuple:
    """The launches of a (batch, h, w) 2-D FFT."""
    if h * w <= PLANE_MAX and max(h, w) <= AXIS_MAX:
        return (plan_plane(batch, h, w),)
    return plan_split(batch * h, w, 1) + plan_split(batch, h, w)


def plan3d(batch: int, d: int, h: int, w: int, planes=None) -> tuple:
    """The launches of a (batch, d, h, w) 3-D FFT: with ``planes`` (the
    default where h*w <= :data:`PLANE_MAX` and h, w <= :data:`AXIS_MAX`) a
    plane launch and D, else W, H and D."""
    if planes is None:
        planes = h * w <= PLANE_MAX and max(h, w) <= AXIS_MAX
    if planes:
        return (plan_plane(batch * d, h, w),) + plan_split(batch, d, h * w)
    return (plan_split(batch * d * h, w, 1) + plan_split(batch * d, h, w)
            + plan_split(batch, d, h * w))


def twiddle_table_np(n: int, sign: float) -> tuple:
    """W_n^k = exp(sign*2*pi*i*k/n), k < n, as one float64 (n, 2) array of
    (cos, sin) pairs: the kernel's table for every pass of a length-n
    FFT."""
    c, s = tw._twiddle_np(n, sign)
    return (np.stack([c, s], axis=1),)


def twiddle_table(n: int, *, inverse: bool = False,
               device="cuda") -> torch.Tensor:
    """:func:`twiddle_table_np` as a cached fp32 tensor on ``device``."""
    return tw._cast(twiddle_table_np, (n, tw._sign(inverse)), torch.float32,
                    torch.device(device))[0]


def split_table_np(m: int, sign: float) -> tuple:
    """The "twiddle" launch's float64 (2^s + m/2^s, 2) table [lo | hi] of
    (cos, sin) pairs, lo[k] = W_m^k (k < 2^s), hi[k] = W_m^(k*2^s), s =
    :func:`level_shift`: W_m^j = hi[j >> s] * lo[j mod 2^s]."""
    s = level_shift(m)
    parts = []
    for j in (np.arange(1 << s, dtype=np.float64),
              np.arange(m >> s, dtype=np.float64) * (1 << s)):
        ang = sign * 2.0 * np.pi * j / m
        parts.append(np.stack([np.cos(ang), np.sin(ang)], axis=1))
    return (np.concatenate(parts),)


def level_shift(m: int) -> int:
    """ceil(log2(m) / 2): both halves of :func:`split_table_np` hold about
    sqrt(m) entries."""
    return m.bit_length() // 2


def split_table(m: int, *, inverse: bool = False,
                device="cuda") -> torch.Tensor:
    """:func:`split_table_np` as a cached fp32 tensor on ``device``."""
    return tw._cast(split_table_np, (m, tw._sign(inverse)), torch.float32,
                    torch.device(device))[0]


MODES = {"plain": 0, "twiddle": 1, "reversed": 2}
ARGS = ([_build.P] * 6 + [_build.L] + [_build.I] * 7
        + [_build.F, _build.I, _build.I, _build.P] + [_build.I] * 4
        + [_build.L, _build.L, _build.P])


def aligned(x: SplitComplex) -> SplitComplex:
    """x with both planes at 16-byte boundaries (the copies move 16-byte
    chunks): a view at an odd offset is copied."""
    if all(p.data_ptr() % 16 == 0 for p in x):
        return x
    return SplitComplex(x.re.clone(), x.im.clone())


def buffers(plan: tuple) -> list:
    """Which planes each launch of ``plan`` reads and writes: 0 the input,
    1 the output, 2 a scratch pair.  The last launch writes the output; a
    "reversed" launch reads other planes than it writes, the others work
    in place, and the first reads the input."""
    dst = [1] * len(plan)
    src = [1] * len(plan)
    for i in range(len(plan) - 1, -1, -1):
        if i < len(plan) - 1:
            dst[i] = src[i + 1]
        src[i] = 0 if i == 0 else (3 - dst[i] if plan[i].mode == "reversed"
                                   else dst[i])
    return list(zip(src, dst))


@functools.lru_cache(maxsize=64)
def _launch_args(plan: tuple, inverse: bool, total: int, store: int,
                 device: torch.device) -> tuple:
    """Each launch's table lengths, twiddle length (0: none) and its
    arguments after the pointers, in two parts around the twiddle's."""
    sms = _build.sm_count(device)
    out = []
    for i, lp in enumerate(plan):
        tables = (lp.inner, lp.n) if lp.kind == "plane" else (lp.n,)
        scale = 1.0 / total if inverse and i == len(plan) - 1 else 1.0
        out.append((tables, lp.m, [lp.outer, _log2(lp.n), _log2(lp.inner),
                                   _log2(lp.c), _log2(lp.g),
                                   int(lp.kind == "plane"), lp.blocks(sms),
                                   int(inverse), scale, store,
                                   MODES[lp.mode]],
                    [level_shift(lp.m) if lp.m else 0, lp.ljr, *lp.lr,
                     lp.img_in, lp.img_out]))
    return tuple(out)


def call_args(plan: tuple, ptrs: list, inverse: bool, scale: float,
              store: int, device) -> tuple:
    """The argument lists of ``plan``'s launches, ``ptrs`` each launch's
    four plane pointers (src re, im, dst re, im), ``scale`` at the last
    launch's store; returns (argument lists, the tables they point at)."""
    held, calls = [], []
    for p4, (lengths, m, head, tail) in zip(ptrs, _launch_args(
            plan, bool(inverse), 1, int(store), device)):
        tabs = [twiddle_table(n, inverse=inverse, device=device)
                for n in lengths]
        twt = split_table(m, inverse=inverse, device=device) if m else None
        held += tabs + [twt]
        tp = [t.data_ptr() for t in tabs] + [None] * (2 - len(tabs))
        head = list(head)
        head[8] = scale if len(calls) == len(plan) - 1 else 1.0
        calls.append(list(p4) + tp + head
                     + [None if twt is None else twt.data_ptr()] + tail)
    return calls, held


def run(fn, plan: tuple, x: SplitComplex, out: SplitComplex, total: int,
        inverse: bool, what: str) -> None:
    """Launch ``plan`` with the C entry point ``fn``: the first launch from
    x, the last into out, the others in place but for "reversed" launches,
    which go through a scratch pair (:func:`buffers`); the inverse's
    1/total at the last one's store."""
    x = aligned(x)
    dev = out.re.device
    routes = buffers(plan)
    planes = [x, out]
    if any(2 in r for r in routes):
        planes.append(SplitComplex(torch.empty_like(x.re),
                                   torch.empty_like(x.im)))
    ptrs = [[p.data_ptr() for p in (*planes[s], *planes[d])]
            for s, d in routes]
    calls, held = call_args(plan, ptrs, inverse,
                            1.0 / total if inverse else 1.0,
                            _build.store_code(x.dtype), dev)
    _build.launch_all(fn, calls, what, dev)
