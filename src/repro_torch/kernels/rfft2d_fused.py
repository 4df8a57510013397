"""Real-input 2-D FFT (rfft2 / irfft2): the CUDA kernels and their plain
PyTorch versions, and the one-level four-step helpers they share with the
complex 2-D GEMM kernel.

Replaces ``repro/kernels/rfft2d_fused.py::_rfft2d_kernel`` and
``::_irfft2d_kernel``: rows 2j and 2j+1 of a real (H, W) image are the re
and im planes of one complex row, so the row pass runs H/2 complex FFTs of
length W; the Hermitian untangle splits each packed spectrum into the two
rows' half spectra (W/2+1 bins); the column pass runs along axis -2 of the
half-width tile.  The inverse twin runs the inverse column pass, repacks
each row pair by Hermitian extension and runs the inverse row pass,
writing the real plane scaled by 1/(H*W).  The plain versions keep the
reference's four-step DFT contractions.

The TPU kernel holds one image in VMEM; a 1024^2 real plane is 4 MB
against 227 KB of shared memory per block, and the function is bound by
bytes.  So ``csrc/rfft2d_fused.cu`` makes two launches a direction, each
one pass over HBM, on the shared-memory FFT passes of
``csrc/axis_fft.cuh``.  The forward (:func:`plan`): the row pass on tiles
of whole packed rows (base x and x + W, row pitch 2W), untangling at its
store into a scratch pair whose rows are padded so that no tile's row
segment straddles a 32-byte sector, then the column pass on tiles of C
adjacent columns of that scratch, the last tile of an image ragged
(:func:`repro_torch.kernels.axis_fft.plan_half_cols`).  The inverse
(:func:`inverse_plan`) mirrors it: the column pass on the same tiles, read
at the input's own pitch W/2+1, into the padded scratch, then the row pass,
which builds each packed row Z = A_ext + i B_ext from scratch rows 2j and
2j+1 at its first pass's load and stores re and im to the real rows 2j and
2j+1, scaled by 1/(H*W).  An axis longer than
:data:`axis_fft.AXIS_MAX` takes :func:`steps` instead: that axis as
``axis_fft.cuh``'s split launches (the packed rows read or stored at a
row pitch of 2W), with the untangle, the Hermitian repack and a change of
row pitch as launches of their own between it and the other axis.  x and
the half spectra are float32 or bfloat16 (the scratch stays fp32).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.complexmath import SplitComplex
from repro_torch.core.fft1d import _best_split, _matmul
from repro_torch.core.twiddle import (_cast, _dft_matrix_np,
                                      _fourstep_twiddle_np)
from . import _build
from . import axis_fft as _axis

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


def _tables_np(h: int, w: int, inverse: bool) -> tuple:
    return fourstep_tables_np(w, inverse) + fourstep_tables_np(h, inverse)


def tables(h: int, w: int, inverse: bool, dtype=torch.float32,
           device="cuda") -> tuple:
    """The 12 table operands of one (h, w) 2-D four-step transform (6 per
    axis, W then H) on ``device``, cast once per (h, w, inverse, dtype,
    device)."""
    return _cast(_tables_np, (h, w, bool(inverse)), dtype,
                 torch.device(device))


def _left(w, x):
    """sum_a w[k, a] x[..., a, :]: a left contraction along axis -2."""
    return _matmul(w, x)


def fft_last_fourstep(re, im, tabs, n1: int, n2: int, mid=None):
    """Length-(n1*n2) FFT of the last axis via one four-step level; the
    n1-factor DFT is a left contraction along axis -2 and only the output
    reordering X[k2*n1 + k1] = Z[k1, k2] transposes the factor axes.
    ``mid``, when given, rounds the twiddled first contraction (the bf16
    GEMM kernels' plain variant rounds every GEMM's output)."""
    w1r, w1i, w2r, w2i, twr, twi = tabs
    b = re.shape[:-1]
    re = re.reshape(*b, n1, n2)
    im = im.reshape(*b, n1, n2)
    if n1 > 1:
        yr = _left(w1r, re) - _left(w1i, im)
        yi = _left(w1i, re) + _left(w1r, im)
        re, im = yr * twr - yi * twi, yr * twi + yi * twr
        if mid is not None:
            re, im = mid(re), mid(im)
    zr = _matmul(re, w2r) - _matmul(im, w2i)
    zi = _matmul(re, w2i) + _matmul(im, w2r)
    zr = zr.transpose(-1, -2).reshape(*b, n1 * n2)
    zi = zi.transpose(-1, -2).reshape(*b, n1 * n2)
    return zr, zi


def fft_col_fourstep(re, im, tabs, n1: int, n2: int, mid=None):
    """Length-(n1*n2) FFT along axis -2 of an (..., H, C) tile — the column
    pass — as left-side DFT contractions, absorbing the tile transpose.
    ``mid`` as in :func:`fft_last_fourstep`."""
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
        if mid is not None:
            re, im = mid(re), mid(im)
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


def _conj_rev(x):
    """x[(W-k) % W] for k = 0..W/2 on a length-W last axis (the conj(Z[-k])
    gather of the Hermitian untangle, built from a flip)."""
    h = x.shape[-1] // 2
    return torch.cat([x[..., :1], x[..., h:].flip(-1)], -1)


def rfft2d_fused_plain(x: torch.Tensor) -> SplitComplex:
    """The forward kernel's arithmetic in plain PyTorch: real (batch, h, w)
    -> (batch, h, w/2+1) half spectra."""
    bb, h, w = x.shape
    _check_dims(h, w)
    tabs = tables(h, w, False, x.dtype, x.device)
    re = x[:, 0::2, :]                           # row pairs -> one complex
    im = x[:, 1::2, :]                           # row: (bb, h/2, w)
    re, im = fft_last_fourstep(re, im, tabs[:6], *fourstep_factors(w))
    # untangle Z -> A (even rows), B (odd rows), bins k = 0..w/2
    hw = w // 2
    cr, ci = _conj_rev(re), _conj_rev(im)
    rk, ik = re[..., :hw + 1], im[..., :hw + 1]
    ar, ai = (rk + cr) * 0.5, (ik - ci) * 0.5
    br, bi = (ik + ci) * 0.5, (cr - rk) * 0.5
    re2 = torch.stack([ar, br], 2).reshape(bb, h, hw + 1)
    im2 = torch.stack([ai, bi], 2).reshape(bb, h, hw + 1)
    re2, im2 = fft_col_fourstep(re2, im2, tabs[6:], *fourstep_factors(h))
    return SplitComplex(re2, im2)


def irfft2d_fused_plain(xf: SplitComplex) -> torch.Tensor:
    """The inverse kernel's arithmetic in plain PyTorch: (batch, h, w/2+1)
    half spectra -> real (batch, h, w), scaled by 1/(h*w)."""
    bb, h, bins = xf.shape
    w = 2 * (bins - 1)
    _check_dims(h, w)
    tabs = tables(h, w, True, xf.dtype, xf.device)
    re, im = fft_col_fourstep(xf.re, xf.im, tabs[6:], *fourstep_factors(h))
    # repack: rows 2j/2j+1's half spectra A/B -> Z = A_ext + i * B_ext,
    # with the imaginary parts of the DC and Nyquist bins dropped (the C2R
    # convention); kept, a complex Nyquist (after an s= width truncation)
    # would leak row 2j+1's residue into row 2j
    hw = w // 2
    ar, ai = re[:, 0::2, :], im[:, 0::2, :]      # (bb, h/2, w/2+1)
    br, bi = re[:, 1::2, :], im[:, 1::2, :]
    z0 = torch.zeros_like(ai[..., :1])

    def drop_ends(q):
        return torch.cat([z0, q[..., 1:hw], z0], -1)

    def ext(q, sign):                            # Hermitian-extend to w
        return torch.cat([q, sign * q[..., 1:hw].flip(-1)], -1)

    ai, bi = drop_ends(ai), drop_ends(bi)
    zr = ext(ar, 1.0) - ext(bi, -1.0)
    zi = ext(ai, -1.0) + ext(br, 1.0)
    zr, zi = fft_last_fourstep(zr, zi, tabs[:6], *fourstep_factors(w))
    out = torch.stack([zr, zi], 2).reshape(bb, h, w)   # re -> 2j, im -> 2j+1
    return out * (1.0 / (h * w))


_ARGS = [_build.P] * 7 + [_build.L] + [_build.I] * 9 + [_build.P]
_ROWS_ARGS = [_build.P] * 4 + [_build.L] + [_build.I] * 6 + [_build.P]
_IROWS_ARGS = ([_build.P] * 4 + [_build.L] + [_build.I] * 5
               + [_build.F, _build.I, _build.P])
_COLS_ARGS = [_build.P] * 5 + [_build.L] + [_build.I] * 9 + [_build.P]
_EW_ARGS = [_build.P] * 4 + [_build.L] + [_build.I] * 3 + [_build.P]
_REPITCH_ARGS = [_build.P] * 4 + [_build.L] + [_build.I] * 5 + [_build.P]


def plan(batch: int, h: int, w: int) -> tuple:
    """The forward kernel's two launches: the rows route on the batch*h/2
    packed rows of w, then the ragged column pass on the w/2+1 columns of
    the scratch (whose row pitch is the second launch's ``inner``)."""
    return (_axis.plan_axis(batch * h // 2, w, 1),
            _axis.plan_half_cols(batch, h, w // 2 + 1))


def _inverse_rows(batch: int, h: int, w: int, pitch: int) -> _axis.Launch:
    """The inverse's rows route on the batch*h/2 packed rows of w, G halved
    until the 2G scratch rows of ``pitch`` a tile copies in fit its shared
    memory."""
    rows = _axis.plan_axis(batch * h // 2, w, 1)
    g = rows.g
    while 2 * g * pitch > _axis.SMEM_MAX // 16 and g * w > _axis.MIN_POINTS:
        g //= 2
    return dataclasses.replace(rows, g=g)


def inverse_plan(batch: int, h: int, w: int) -> tuple:
    """The inverse kernel's two launches, in launch order: the column pass
    on the forward's column tiles (its ``inner`` the scratch's row pitch:
    the forward's, or w/2+1 rounded up to 4 where whole images fill a
    tile), then the rows route on the batch*h/2 packed rows of w, G halved
    until the 2G scratch rows a tile copies in fit its shared memory."""
    c = w // 2 + 1
    cols = _axis.plan_half_cols(batch, h, c)
    if cols.c >= c:
        cols = dataclasses.replace(cols, inner=-(-c // 4) * 4)
    return cols, _inverse_rows(batch, h, w, cols.inner)


def split_pitch(w: int) -> int:
    """The scratch's row pitch where h takes the split launches: w/2+1
    rounded up to a power of two (their inner extent), at least 4."""
    return max(4, _axis._pow2ceil(w // 2 + 1))


def scratch_pitch(batch: int, h: int, w: int, inverse: bool) -> int:
    """The row pitch of the fp32 half-spectrum scratch: :func:`split_pitch`
    where h splits, else the column pass's (:func:`plan`,
    :func:`inverse_plan`)."""
    if h > _axis.AXIS_MAX:
        return split_pitch(w)
    return (inverse_plan if inverse else plan)(batch, h, w)[
        0 if inverse else 1].inner


def _chain(src: str, mid: str, dst: str, launches: tuple) -> list:
    """A split's launches as steps: the first from ``src`` into ``mid``,
    the others in place on ``mid`` but the "reversed" last, into ``dst``."""
    out = [("axis", src, mid, launches[0])]
    out += [("axis", mid, mid, lp) for lp in launches[1:-1]]
    return out + [("axis", mid, dst, launches[-1])]


def steps(batch: int, h: int, w: int, inverse: bool = False) -> tuple:
    """The launches of a direction, as (kind, src, dst, what) with buffer
    names x (the input), out, Z and Z2 (packed complex rows, the input's
    dtype), S and S2 (fp32 half spectra at the scratch's pitch).  Up to
    :data:`axis_fft.AXIS_MAX` on both axes: ("fused", x, out, None), the
    two launches of :func:`plan` or :func:`inverse_plan` in one call.
    Longer axes split (:func:`axis_fft.plan_split`, kind "axis", what the
    Launch): the packed rows read (forward) or stored (inverse) at a row
    pitch of 2w; kinds "rows", "irows" and "cols" (what the Launch, its
    scratch pitch in ``inner`` for "cols") are the short axis' pass alone;
    "untangle" and "repack" (what the pitch) turn packed spectra into
    half spectra and back; "repitch" (what (width, src pitch, dst
    pitch)) moves rows between the input's or output's pitch w/2+1 and
    the split's pitch (:func:`split_pitch`)."""
    _check_dims(h, w)
    big_h, big_w = h > _axis.AXIS_MAX, w > _axis.AXIS_MAX
    if not (big_h or big_w):
        return (("fused", "x", "out", None),)
    c, pairs = w // 2 + 1, batch * h // 2
    p = scratch_pitch(batch, h, w, inverse)
    out = []
    if not inverse:
        if big_w:
            out += _chain("x", "Z", "Z2", _axis.plan_split(pairs, w, 1,
                                                           img_in=2 * w))
            out.append(("untangle", "Z2", "S", p))
        else:
            out.append(("rows", "x", "S", _axis.plan_axis(pairs, w, 1)))
        if big_h:
            out += _chain("S", "S", "S2", _axis.plan_split(batch, h, p))
            out.append(("repitch", "S2", "out", (c, p, c)))
        else:
            out.append(("cols", "S", "out", plan(batch, h, w)[1]))
        return tuple(out)
    if big_h:
        out.append(("repitch", "x", "S", (c, c, p)))
        out += _chain("S", "S", "S2", _axis.plan_split(batch, h, p))
    else:
        out.append(("cols", "x", "S2", inverse_plan(batch, h, w)[0]))
    if big_w:
        out.append(("repack", "S2", "Z", p))
        out += _chain("Z", "Z", "out", _axis.plan_split(pairs, w, 1,
                                                        img_out=2 * w))
    else:
        out.append(("irows", "S2", "out", _inverse_rows(batch, h, w, p)))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _launch_args(batch: int, h: int, w: int, inverse: bool,
                 device: torch.device) -> tuple:
    """(scratch pitch, the kernel's arguments after the seven pointers)."""
    if inverse:
        cols, rows = inverse_plan(batch, h, w)
    else:
        rows, cols = plan(batch, h, w)
    sms = _build.sm_count(device)
    log2 = _axis._log2
    return cols.inner, [batch, log2(h), log2(w), cols.inner, log2(rows.g),
                        rows.blocks(sms), log2(cols.c), log2(cols.g),
                        cols.blocks(sms)]


def _run(symbol: str, ins: list, out: list, batch: int, h: int, w: int,
         inverse: bool, store: int) -> None:
    """Launch ``symbol`` on the operands ``ins`` -> ``out`` with its scratch
    pair and the two axes' tables of the transform's sign."""
    dev = out[0].device
    pitch, tail = _launch_args(batch, h, w, inverse, dev)
    scratch = [torch.empty(batch * h * pitch, dtype=torch.float32,
                           device=dev) for _ in range(2)]
    tabs = [_axis.twiddle_table(n, inverse=inverse, device=dev)
            for n in (w, h)]
    fn = _build.function("rfft2d_fused", symbol, _ARGS)
    ptrs = [*ins, *out, *scratch, *tabs]
    _build.launch(fn, [p.data_ptr() for p in ptrs] + tail + [store],
                  symbol, dev)


def _run_steps(x, out, batch: int, h: int, w: int, inverse: bool) -> None:
    """Launch :func:`steps` (a long axis): ``x`` and ``out`` the real plane
    and the half spectra's SplitComplex, in the direction's order."""
    real = out if inverse else x              # the real plane
    dev, dtype = real.device, real.dtype
    store = _build.store_code(dtype)
    sms = _build.sm_count(dev)
    log2 = _axis._log2
    todo = steps(batch, h, w, inverse)
    pairs = batch * h // 2
    pitch = scratch_pitch(batch, h, w, inverse)
    names = {k for _, s_, d_, _ in todo for k in (s_, d_)}
    buf = {}
    for name in ("S", "S2"):
        if name in names:
            buf[name] = [torch.empty(batch * h * pitch, dtype=torch.float32,
                                     device=dev) for _ in range(2)]
    for name in ("Z", "Z2"):
        if name in names:
            buf[name] = [torch.empty(pairs * w, dtype=dtype, device=dev)
                         for _ in range(2)]
    elt = real.element_size()
    if not inverse:
        buf["x"] = [real.data_ptr(), real.data_ptr() + w * elt]
        buf["out"] = list(out)
    else:
        buf["x"] = list(x)
        buf["out"] = [real.data_ptr(), real.data_ptr() + w * elt]
    ptr = {k: [p if isinstance(p, int) else p.data_ptr() for p in v]
           for k, v in buf.items()}
    tw_w = _axis.twiddle_table(w, inverse=inverse, device=dev)
    tw_h = _axis.twiddle_table(h, inverse=inverse, device=dev)
    scale = 1.0 / (h * w) if inverse else 1.0
    held = [buf, tw_w, tw_h]
    for i, (kind, src, dst, what) in enumerate(todo):
        last = i == len(todo) - 1
        if kind == "axis":
            fn = _build.function("rfft2d_fused", "rfft2d_axis_pass",
                                 _axis.ARGS)
            calls, tabs = _axis.call_args(
                (what,), [ptr[src] + ptr[dst]], inverse,
                scale if last else 1.0,
                0 if src in ("S", "S2") else store, dev)
            held.append(tabs)
            _build.launch_all(fn, calls, "rfft2d_fused", dev)
        elif kind == "rows":
            fn = _build.function("rfft2d_fused", "rfft2d_rows_pass",
                                 _ROWS_ARGS)
            _build.launch(fn, [ptr[src][0], *ptr[dst], tw_w.data_ptr(),
                               batch, log2(h), log2(w), pitch,
                               log2(what.g), what.blocks(sms), store],
                          "rfft2d_fused", dev)
        elif kind == "irows":
            fn = _build.function("rfft2d_fused", "irfft2d_rows_pass",
                                 _IROWS_ARGS)
            _build.launch(fn, [*ptr[src], ptr[dst][0], tw_w.data_ptr(),
                               batch, log2(h), log2(w), pitch,
                               log2(what.g), what.blocks(sms), scale,
                               store], "rfft2d_fused", dev)
        elif kind == "cols":
            fn = _build.function("rfft2d_fused", "rfft2d_cols_pass",
                                 _COLS_ARGS)
            _build.launch(fn, [*ptr[src], *ptr[dst], tw_h.data_ptr(),
                               batch, log2(h), log2(w), what.inner,
                               log2(what.c), log2(what.g), what.blocks(sms),
                               int(inverse), store if inverse else 0,
                               0 if inverse else store],
                          "rfft2d_fused", dev)
        elif kind in ("untangle", "repack"):
            fn = _build.function("rfft2d_fused", f"rfft2d_{kind}", _EW_ARGS)
            _build.launch(fn, [*ptr[src], *ptr[dst], pairs, log2(w), what,
                               store], "rfft2d_fused", dev)
        else:                                     # repitch
            width, sp, dp = what
            fn = _build.function("rfft2d_fused", "rfft2d_repitch",
                                 _REPITCH_ARGS)
            _build.launch(fn, [*ptr[src], *ptr[dst], batch * h, width, sp,
                               dp, store if src == "x" else 0,
                               store if dst == "out" else 0],
                          "rfft2d_fused", dev)


def rfft2d_fused_cuda(x: torch.Tensor) -> SplitComplex:
    """Launch the real-input 2-D FFT kernel on a (batch, h, w) CUDA tensor,
    float32, bfloat16 or float16; returns the (batch, h, w/2+1) half
    spectra of the
    same dtype."""
    _build.check_operands(x, 3, _axis.DTYPES)
    batch, h, w = x.shape
    _check_dims(h, w)
    if x.data_ptr() % 16:            # the copies move 16-byte chunks
        x = x.clone()
    shape = (batch, h, w // 2 + 1)
    out = SplitComplex(torch.empty(shape, dtype=x.dtype, device=x.device),
                       torch.empty(shape, dtype=x.dtype, device=x.device))
    if steps(batch, h, w)[0][0] == "fused":
        _run("rfft2d_fused_pass", [x], list(out), batch, h, w, False,
             _build.store_code(x.dtype))
    else:
        _run_steps(x, out, batch, h, w, False)
    return out


def irfft2d_fused_cuda(xf: SplitComplex) -> torch.Tensor:
    """Launch the inverse real-input 2-D FFT kernel on (batch, h, w/2+1)
    CUDA half spectra, float32, bfloat16 or float16; returns the real
    (batch, h, w)
    images of the same dtype."""
    _build.check_operands(xf, 3, _axis.DTYPES)
    batch, h, bins = xf.shape
    w = 2 * (bins - 1)
    _check_dims(h, w)
    xf = _axis.aligned(xf)           # whole-image runs move 16-byte chunks
    out = torch.empty((batch, h, w), dtype=xf.dtype, device=xf.device)
    if steps(batch, h, w, True)[0][0] == "fused":
        _run("irfft2d_fused_pass", list(xf), [out], batch, h, w, True,
             _build.store_code(xf.dtype))
    else:
        _run_steps(xf, out, batch, h, w, True)
    return out
