"""Fused spectral convolution (rfft -> pointwise multiply -> irfft in one
pass): the CUDA kernel, its plain PyTorch version and the packed-domain
filter operands.

Replaces ``repro/kernels/fftconv_fused.py::_fftconv_kernel``.  Each real
row of m samples (m a power of two >= 4) is packed into m/2 complex points
(even samples the re plane, odd the im plane), transformed forward at
length m/2, multiplied in the packed domain

    ``Z'[k] = E[k] Z[k] + F[k] conj(Z[(m/2-k) % (m/2)])``

and transformed back at length m/2; the re/im planes interleave into the
real row, scaled by 2/m.  E and F fold the Hermitian untangle, the filter
multiply and the packed-irfft pre-tangle together; they depend only on the
filter, so :func:`pack_filter` builds them outside the kernel (float64
numpy for a filter that autograd does not record through, cached per
filter; torch ops in the graph for one it does).

The TPU kernel runs both transforms as four-step DFT matmuls.  The
function is bound by bytes on the H100 (a real sample in and out, an E/F
bin pair in: 340 MB, 0.101 ms at 3.35 TB/s at the SSM conv shape, against
0.034 ms of FFT flops), so ``csrc/fftconv_fused.cu`` keeps each row on
chip instead: for m <= 16384 a persistent grid walks tiles of G rows
(:func:`rows_a_tile`), copied in asynchronously as interleaved complex
while the last tile is transformed, and runs fft_stockham's fused radix-4
passes, the packed-domain multiply and the inverse passes in shared memory
and registers, reading x and E/F once and writing y once.  A
longer row fits no shared memory; it runs a multi-launch schedule: the
port's 1-D kernels at length m/2 (four-step up to 2^20, Stockham beyond),
the spectral-section kernel between them, and the even/odd split and the
interleave as strided torch copies.

Layout: x is (batch, R, m) real; E and F are (R, m/2) (one filter per
row, shared across the batch: the SSM channel bank) or (batch, R, m/2).
The kernel takes float32, bfloat16 or float16 x with E/F of the same dtype
(widened at the load and rounded at the store, the FFTs in fp32).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import twiddle as tw
from repro_torch.core.complexmath import SplitComplex
from . import _build
from . import axis_fft as _axis
from .rfft2d_fused import (fft_last_fourstep, fourstep_factors,
                           fourstep_tables_np)

# the longest row the one-pass kernel holds in shared memory: m/2 complex
# points ping-pong in 16 * (m/2) bytes, 128 KB at m = 16384
MAX_ONE_PASS = 16384


def _conv_tables_np(m: int) -> tuple:
    """The 12 four-step tables of one plain conv call: forward and inverse
    at the packed length m/2."""
    hm = m // 2
    return fourstep_tables_np(hm, False) + fourstep_tables_np(hm, True)


def conv_tables(m: int, dtype=torch.float32, device="cuda") -> tuple:
    return tw._cast(_conv_tables_np, (m,), dtype, torch.device(device))


# -- packed-domain filter operands ------------------------------------------

# (lead shape, m, dtype) -> (kf.re, kf.im, their versions, packed pair)
_PACK_CACHE = {}


def clear_pack_cache() -> None:
    """Drop every cached packed filter pair (called alongside the plan
    registry's spectrum cache: packed operands derive from spectra)."""
    _PACK_CACHE.clear()


def _pack_coeffs(m: int):
    """The four twiddle coefficient vectors of the packed-domain collapse
    (float64): untangle A/B at k = 0..m/2, pre-tangle C/D at
    k = 0..m/2-1."""
    hm = m // 2
    w = np.exp(-2j * np.pi * np.arange(hm + 1) / m)
    a = (1.0 - 1j * w) / 2.0
    b = (1.0 + 1j * w) / 2.0
    c = (1.0 + 1j * np.conj(w[:hm])) / 2.0
    d = (1.0 - 1j * np.conj(w[:hm])) / 2.0
    return a, b, c, d


def _pack_filter_np(kre, kri, m: int, dtype):
    """Filters autograd does not record through: build E/F in float64 on
    the host and cast once, onto the filter's device."""
    hm = m // 2
    dev = kre.device
    kc = kre.detach().double().cpu().numpy() \
        + 1j * kri.detach().double().cpu().numpy()
    # the C2R convention ignores the DC/Nyquist imaginary parts; zero them
    # here so residue in the fp32 spectrum cannot alias across the edges
    kc[..., 0] = kc[..., 0].real
    kc[..., hm] = kc[..., hm].real
    a, b, c, d = _pack_coeffs(m)
    p, q = kc * a, kc * b
    e = c * p[..., :hm] + d * np.conj(q[..., :0:-1])
    f = c * q[..., :hm] + d * np.conj(p[..., :0:-1])

    def put(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev, dtype)
    return (SplitComplex(put(e.real), put(e.imag)),
            SplitComplex(put(f.real), put(f.imag)))


def _pack_filter_torch(kf: SplitComplex, m: int, dtype):
    """Filters autograd records through (training parameters): the same
    E/F build as torch ops on the filter's device, part of the graph."""
    hm = m // 2
    dev = kf.re.device
    a, b, c, d = _pack_coeffs(m)
    ar, ai, br, bi, cr, ci, dr, di = [
        torch.from_numpy(np.ascontiguousarray(v)).to(dev, dtype)
        for co in (a, b, c, d) for v in (co.real, co.imag)]
    # zero the DC/Nyquist imaginary parts (C2R convention)
    mask = np.ones(hm + 1, np.float64)
    mask[0] = mask[hm] = 0.0
    kr = kf.re.to(dtype)
    ki = kf.im.to(dtype) * torch.from_numpy(mask).to(dev, dtype)
    pr, pi = kr * ar - ki * ai, kr * ai + ki * ar
    qr, qi = kr * br - ki * bi, kr * bi + ki * br

    def rev(t):                                   # indices m/2 .. 1
        return t[..., 1:].flip(-1)
    prr, pri, qrr, qri = rev(pr), rev(pi), rev(qr), rev(qi)
    er = cr * pr[..., :hm] - ci * pi[..., :hm] + dr * qrr + di * qri
    ei = cr * pi[..., :hm] + ci * pr[..., :hm] + di * qrr - dr * qri
    fr = cr * qr[..., :hm] - ci * qi[..., :hm] + dr * prr + di * pri
    fi = cr * qi[..., :hm] + ci * qr[..., :hm] + di * prr - dr * pri
    return SplitComplex(er, ei), SplitComplex(fr, fi)


def uncacheable(*ts) -> bool:
    """Whether a value derived from ``ts`` must be recomputed every call:
    autograd records through one of them (the port's counterpart of the
    reference's test for a traced, jit-time value), or one is an
    inference-mode tensor, which has no ``_version`` to test a hit by."""
    return (torch.is_grad_enabled() and any(t.requires_grad for t in ts)) \
        or any(t.is_inference() for t in ts)


def pack_filter(kf: SplitComplex, m: int, dtype):
    """Fold the Hermitian untangle, the pointwise filter multiply and the
    packed-irfft pre-tangle into the packed-domain filter pair (E, F)
    with ``Z'[k] = E[k] Z[k] + F[k] conj(Z[(m/2-k) % (m/2)])``.

    kf is the filter half spectrum (..., m/2+1); returns two SplitComplex
    of (..., m/2).  Other filters build in float64 and are cached (one
    entry per lead-shape/length key); the hit test is the identity of
    both planes and their ``_version``, so a filter updated in place
    repacks.  Filters that autograd records through build in the graph,
    and inference-mode spectra (no version to test; a served model's conv
    makes one a call) build the same way on their device, uncached: the
    host build's round trip took about 240 ms a layer of ssm_demo's
    prefill at 8 x 4096 on an H100 (PERF.md)."""
    if uncacheable(kf.re, kf.im):
        return _pack_filter_torch(kf, m, dtype)
    key = (tuple(kf.re.shape[:-1]), m, str(dtype))
    vers = (kf.re._version, kf.im._version)
    ent = _PACK_CACHE.get(key)
    if ent is not None and ent[0] is kf.re and ent[1] is kf.im \
            and ent[2] == vers:
        return ent[3]
    ef = _pack_filter_np(kf.re, kf.im, m, dtype)
    _PACK_CACHE[key] = (kf.re, kf.im, vers, ef)
    return ef


# -- the kernel --------------------------------------------------------------

def _check_len(m: int):
    if m & (m - 1) or m < 4:
        raise ValueError("the fused conv kernel needs a power-of-two FFT "
                         f"length >= 4, got {m}")


def _check_bank(x: torch.Tensor, ef) -> bool:
    """Shapes of x (batch, r, m) and the packed pair; returns whether the
    bank is shared ((r, m/2)) rather than per batch ((batch, r, m/2))."""
    if x.dim() != 3:
        raise ValueError(f"x must be (batch, rows, m), got {tuple(x.shape)}")
    batch, r, m = x.shape
    _check_len(m)
    e, f = ef
    shared = e.re.dim() == 2
    want = (r, m // 2) if shared else (batch, r, m // 2)
    for plane in (*e, *f):
        if tuple(plane.shape) != want:
            raise ValueError(f"packed filter planes must be {want}, got "
                             f"{tuple(plane.shape)}")
    return shared


def fftconv_fused_plain(x: torch.Tensor, ef) -> torch.Tensor:
    """The TPU kernel's arithmetic in plain PyTorch: x (batch, r, m) real
    circularly convolved with the packed pair ef = (E, F) from
    :func:`pack_filter` -> (batch, r, m) real."""
    _check_bank(x, ef)
    batch, r, m = x.shape
    hm = m // 2
    e, f = ef
    tabs = conv_tables(m, x.dtype, x.device)
    n1, n2 = fourstep_factors(hm)
    re = x[..., 0::2]                            # even/odd samples -> one
    im = x[..., 1::2]                            # complex row: (b, r, m/2)
    zr, zi = fft_last_fourstep(re, im, tabs[:6], n1, n2)
    # Z' = E Z + F conj(Z[(m/2-k) % (m/2)]): a flip with DC fixed
    zcr = torch.cat([zr[..., :1], zr[..., 1:].flip(-1)], -1)
    zci = torch.cat([zi[..., :1], zi[..., 1:].flip(-1)], -1)
    er, ei, fr, fi = e.re, e.im, f.re, f.im      # (r, m/2) broadcasts
    z2r = er * zr - ei * zi + fr * zcr + fi * zci
    z2i = er * zi + ei * zr + fi * zcr - fr * zci
    z2r, z2i = fft_last_fourstep(z2r, z2i, tabs[6:], n1, n2)
    out = torch.stack([z2r, z2i], 3).reshape(batch, r, m)  # interleave
    return out * (2.0 / m)


_ONE_PASS_ARGS = ([_build.P] * 8 + [_build.L] + [_build.I] * 6
                  + [_build.P])
_SECTION_ARGS = [_build.P] * 8 + [_build.L] + [_build.I] * 4 + [_build.P]
TILE_POINTS = 4096      # complex points a tile holds where rows allow


def rows_a_tile(rows: int, m: int, sms: int) -> int:
    """G, the rows of a one-pass tile: :data:`TILE_POINTS` / (m/2) (at
    least one row, at least 512 points: a warp), halved while the tiles
    would leave fewer than two a streaming multiprocessor (table 11's
    64-row banks get a row a tile)."""
    hm = m // 2
    g = max(1, TILE_POINTS // hm, _axis.MIN_POINTS // hm)
    while g > 1 and g // 2 * hm >= _axis.MIN_POINTS \
            and -(-rows // g) < 2 * sms:
        g //= 2
    return g


REGISTERS = 128         # a thread of the one-pass kernel (its launch bound)


def one_pass_blocks(rows: int, m: int, sms: int) -> tuple:
    """(G, the persistent grid's blocks) of the one-pass launch: as many
    blocks as are resident on the card at once, by threads, shared memory
    and registers (a block more an SM than fit would wait for a whole
    tile walk, and the grid's last tiles with it)."""
    g = rows_a_tile(rows, m, sms)
    hm = m // 2
    lp = (g * hm).bit_length() - 1
    threads = 1 << (lp - 4)
    wf = -(-(_axis.pitch(hm, min(g.bit_length() - 1, 3)) * g) // 32) * 32
    smem = 2 * 2 * 4 * wf
    per_sm = min(2048 // threads, _axis.SM_SHARED // (smem + 1024),
                 65536 // (threads * REGISTERS))
    tiles = -(-rows // g)
    return g, min(tiles, sms * max(1, per_sm))


def fftconv_fused_cuda(x: torch.Tensor, ef) -> torch.Tensor:
    """Launch the fused conv on a (batch, r, m) CUDA tensor (float32,
    bfloat16 or float16) with the packed pair ef (CUDA planes of x's
    dtype): the one-pass kernel for m <= :data:`MAX_ONE_PASS`, else the multi-launch
    schedule."""
    _build.check_operands(x, 3, _axis.DTYPES)
    shared = _check_bank(x, ef)
    e, f = ef
    for sc in ef:
        _build.check_operands(sc, 2 if shared else 3, (x.dtype,))
        if sc.device != x.device:
            raise ValueError("x and the packed filter are on different "
                             "devices")
    batch, r, m = x.shape
    hm = m // 2
    store = _build.store_code(x.dtype)
    if m <= MAX_ONE_PASS:
        if x.data_ptr() % 16:            # the copies move 16-byte chunks
            x = x.clone()
        g, blocks = one_pass_blocks(batch * r, m, _build.sm_count(x.device))
        tabf = tw.radix4_twiddles(hm, device=x.device)
        tabb = tw.radix4_twiddles(hm, inverse=True, device=x.device)
        out = torch.empty_like(x)
        fn = _build.function("fftconv_fused", "fftconv_fused_pass",
                             _ONE_PASS_ARGS)
        ptrs = [x, e.re, e.im, f.re, f.im, tabf, tabb, out]
        _build.launch(fn, [p.data_ptr() for p in ptrs] + [
            batch, r, m, g.bit_length() - 1, blocks, int(shared), store],
            "fftconv_fused_pass", x.device)
        return out
    # multi-launch: the 1-D kernels at length m/2 around the section
    # kernel; the even/odd split and the interleave are strided copies
    from repro_torch.core.fft1d import _fft_inner, resolve_algo
    algo = resolve_algo(hm)
    z = _fft_inner(SplitComplex(x[..., 0::2], x[..., 1::2]), algo=algo,
                   backend="cuda")
    y = SplitComplex(torch.empty_like(z.re), torch.empty_like(z.im))
    fn = _build.function("fftconv_fused", "spectral_section_pass",
                         _SECTION_ARGS)
    ptrs = [z.re, z.im, e.re, e.im, f.re, f.im, y.re, y.im]
    _build.launch(fn, [p.data_ptr() for p in ptrs] + [
        batch, r, hm, int(shared), store], "spectral_section_pass",
        x.device)
    # the inverse's 1/(m/2) is the kernel's 2/m
    y = _fft_inner(y, inverse=True, algo=algo, backend="cuda")
    return torch.stack([y.re, y.im], -1).reshape(batch, r, m)
