"""The long-axis routes of the CUDA kernels on the CPU: the plans that
replace the old size refusals, checked on every power-of-two size without
a launch, and the split arithmetic of each route as a plain-torch model of
its launches, held against float64 numpy with the thresholds lowered so
that the split runs at small sizes.

- 2-D and 3-D kernels (``axis_fft.plan_split``): an axis past
  ``AXIS_MAX`` runs as one launch a factor, "twiddle" launches then a
  "reversed" one;
- the fused Stockham 2-D kernel (``fft2d_fused.plan``): the 1-D kernel's
  launches A and B along either axis, its three launches past 2^24;
- the real-input kernels (``rfft2d_fused.steps``): the split launches with
  the untangle, repack and repitch steps between them;
- the four-step kernel's factors up to 2^14 (``fft_fourstep.axis_plan``);
- the radix-2 Stockham kernel past 2^24 (``fft_stockham.r2_plan``).

The kernels themselves run under ``tools/cuda_emu/emulate.py`` and in
``chip_smoke.py`` (on a card)."""
import numpy as np
import pytest
import torch

from repro_torch.core import SplitComplex, from_numpy
from repro_torch.core import twiddle as tw
from repro_torch.kernels import _build, axis_fft as A
from repro_torch.kernels import (fft2d_fused as S2, fft2d_gemm, fft3d_fused,
                                 fft_fourstep as F, fft_stockham as S,
                                 rfft2d_fused as R)

TOL_2D = 1e-5           # of max|X| against float64 numpy (2-D, 1-D)
TOL_3D = 1e-6           # relative norm against float64 numpy (3-D)


def _lg(n):
    return n.bit_length() - 1


# -- what the kernels take (the checks of axis_fft_launch, stockham_pass,
# fft2d_fused_pass), mirrored ---------------------------------------------

def axis_kernel_takes(lp) -> bool:
    """Whether ``axis_fft_launch`` takes the Launch and has its kernel."""
    ln, linner, lc, lg = map(_lg, (lp.n, lp.inner, lp.c, lp.g))
    lp_ = ln + lc + lg
    mode = A.MODES[lp.mode]
    plane = lp.kind == "plane"
    ok = (1 <= ln <= 14 and 0 <= lc <= linner <= 30 and lp.outer > 0
          and lp_ <= 14 and (1 << lp_) >= A.MIN_POINTS
          and not (lc < linner and lg != 0) and lp.smem <= A.SMEM_MAX)
    if plane:
        return ok and lc == linner and ln + lc <= 14 and mode == 0
    if mode == 1:
        ok = ok and 0 <= lp.ljr <= linner and lp.m >= lp.n
    if mode == 2:
        ok = ok and lp.lr[0] >= 0 and lp.lr[1] >= 0 and sum(lp.lr) <= 30
    ok = ok and (not lp.img_in or lg == 0) and (not lp.img_out or mode != 0)
    threads = 1 << (lp_ - 4)
    if linner == 0:              # rows
        return ok and mode != 1 and (ln <= 13 if threads <= 512
                                     else ln == 14)
    if threads > 512:
        return ok and (ln in (11, 12) or (mode == 1 and ln in (13, 14)))
    return ok and ln <= 12


def check_split(launches, outer, n, inner):
    """A split's launches: each taken by the kernel, "twiddle" ones then a
    "reversed" last one, factors multiplying to n, each launch's view the
    split's (outer * n_1..n_(i-1), n_i, n_(i+1)..*inner)."""
    fs = [lp.n for lp in launches]
    assert np.prod(fs) == n
    before = 1
    for i, lp in enumerate(launches):
        assert axis_kernel_takes(lp), lp
        after = n // (before * lp.n)
        assert (lp.outer, lp.inner) == (outer * before, after * inner)
        if len(launches) == 1:
            assert lp.mode == "plain"
        elif i < len(launches) - 1:
            assert lp.mode == "twiddle" and lp.m == lp.n * after
            assert lp.ljr == _lg(inner)
        else:
            assert lp.mode == "reversed"
            assert lp.lr == ((_lg(fs[0]), _lg(fs[1]) if len(fs) == 3 else 0))
        # every point of the view lies in exactly one tile
        assert lp.tiles * lp.points >= lp.outer * lp.n * lp.inner
        assert 1 <= lp.blocks(132) <= lp.tiles
        before *= lp.n


@pytest.mark.parametrize("k", range(1, 31))
def test_split_factors_every_pow2_axis(k):
    """One factor up to 4096; two of at most 4096 up to 2^24, three from
    2^25 (at most 4096 each up to 2^36), near-equal powers of two."""
    n = 1 << k
    fs = A.split_factors(n)
    assert np.prod(fs) == n and all(f >= 2 and f & (f - 1) == 0 for f in fs)
    assert len(fs) == (1 if k <= 12 else 2 if k <= 24 else 3)
    assert max(fs) <= A.AXIS_MAX and max(fs) <= 2 * min(fs)


@pytest.mark.parametrize("k", range(1, 27))
@pytest.mark.parametrize("outer,inner", [(1, 1), (3, 1), (2, 4), (1, 64),
                                         (5, 1024)])
def test_plan_split_every_pow2_axis(k, outer, inner):
    """The launches of a length-2^k FFT along (outer, 2^k, inner), k up to
    26: no ValueError, every launch one the kernel takes."""
    n = 1 << k
    launches = A.plan_split(outer, n, inner)
    assert len(launches) == len(A.split_factors(n))
    check_split(launches, outer, n, inner)


@pytest.mark.parametrize("k", range(13, 27))
def test_plan2d_and_plan3d_with_a_long_axis(k):
    """Images (2, 2^k), (2^k, 4) and volumes (2, 2, 2^k), (2^k, 2, 4): each
    axis its split, no plane launch, no refusal."""
    n = 1 << k
    for h, w in ((2, n), (n, 4)):
        plan = A.plan2d(2, h, w)
        assert all(lp.kind != "plane" for lp in plan)
        rows = A.plan_split(2 * h, w, 1)
        assert plan == rows + A.plan_split(2, h, w)
        check_split(rows, 2 * h, w, 1)
    for d, h, w in ((2, 2, n), (n, 2, 4)):
        plan = A.plan3d(1, d, h, w)
        assert all(axis_kernel_takes(lp) for lp in plan)
        assert sum(lp.mode == "reversed" for lp in plan) == 1


def test_buffers_never_read_what_a_reversed_launch_writes():
    """The first launch reads the input, the last writes the output; a
    "reversed" launch reads other planes than it writes; the others work
    in place; the scratch pair (2) only where a split needs it."""
    for shape in [(2, 2, 8192), (1, 8192, 8192), (3, 1 << 25, 2),
                  (1, 64, 64)]:
        plan = A.plan2d(*shape)
        routes = A.buffers(plan)
        assert routes[0][0] == 0 and routes[-1][1] == 1
        for (src, dst), lp in zip(routes, plan):
            assert (src != dst) == (lp.mode == "reversed") or src == 0
            assert dst != 0
        for (_, d0), (s1, _) in zip(routes, routes[1:]):
            assert d0 == s1


# -- the split arithmetic as plain torch -----------------------------------

def dft(v, n, inverse):
    """The length-n DFT along axis 1 of (outer, n, inner) complex64, off the
    kernel's fp32 table W_n^k (``axis_fft.twiddle_table``)."""
    tab = A.twiddle_table(n, inverse=inverse, device="cpu")
    w = torch.complex(tab[:, 0], tab[:, 1])
    k = torch.arange(n)
    mat = w[(k[:, None] * k[None, :]) % n]               # (k, j)
    return torch.einsum("kj,ojc->okc", mat, v)


def split_twiddle(m, idx, inverse):
    """W_m^idx the kernel's way: hi[idx >> s] * lo[idx mod 2^s] of the fp32
    [lo | hi] table (``axis_fft.split_table``)."""
    tab = A.split_table(m, inverse=inverse, device="cpu")
    s = A.level_shift(m)
    t = torch.complex(tab[:, 0], tab[:, 1])
    lo, hi = t[:1 << s], t[1 << s:]
    return hi[idx >> s] * lo[idx & ((1 << s) - 1)]


def launch_model(lp, src, inverse):
    """One launch of ``lp`` on the flat complex64 planes ``src``: its FFT
    (both of a plane launch's), then the store: in place, twiddled, or at
    the digit-reversed place; returns the flat planes it writes."""
    if lp.kind == "plane":
        v = src.reshape(lp.outer * lp.n, lp.inner, 1)
        v = dft(v, lp.inner, inverse).reshape(lp.outer, lp.n, lp.inner)
        return dft(v, lp.n, inverse).reshape(-1)
    v = dft(src.reshape(lp.outer, lp.n, lp.inner), lp.n, inverse)
    if lp.mode == "twiddle":
        k = torch.arange(lp.n)[:, None]
        j2 = torch.arange(lp.inner)[None, :] >> lp.ljr
        v = v * split_twiddle(lp.m, k * j2, inverse)[None]
    if lp.mode != "reversed":
        return v.reshape(-1)
    l1, l2 = lp.lr
    lr = l1 + l2
    o = torch.arange(lp.outer)[:, None, None]
    k = torch.arange(lp.n)[None, :, None]
    c = torch.arange(lp.inner)[None, None, :]
    lo = o & ((1 << lr) - 1)
    rev = ((lo & ((1 << l2) - 1)) << l1) | (lo >> l2)
    at = ((o >> lr) * (lp.n << lr) + (k << lr) + rev) * lp.inner + c
    out = torch.empty_like(src)
    out[at.reshape(-1)] = v.reshape(-1)
    return out


def run_model(plan, z, inverse, total):
    """The launches of ``plan`` on the planes of z through the buffers the
    wrapper assigns (``axis_fft.buffers``), 1/total at the last store."""
    bufs = {0: torch.from_numpy(z.astype(np.complex64)).reshape(-1)}
    for (src, dst), lp in zip(A.buffers(plan), plan):
        bufs[dst] = launch_model(lp, bufs[src], inverse)
    out = bufs[1].reshape(z.shape)
    return (out / total if inverse else out).numpy()


def _err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("shape", [(2, 2, 64), (1, 64, 4), (2, 32, 32),
                                   (1, 4, 128), (1, 2, 2048), (1, 1024, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_split_2d_model_matches_numpy(monkeypatch, shape, inverse):
    """With AXIS_MAX at 16, every axis longer than 16 splits (three factors
    from 2^13: 2048 = 16 x 16 x 8 with FACTOR_MAX at 16 too); the model of
    the launches is within 1e-5 of max|X| of numpy."""
    monkeypatch.setattr(A, "AXIS_MAX", 16)
    monkeypatch.setattr(A, "FACTOR_MAX", 16)
    rng = np.random.default_rng(sum(shape))
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    plan = A.plan2d(*shape)
    assert any(lp.mode == "reversed" for lp in plan)
    got = run_model(plan, z, inverse, shape[1] * shape[2])
    want = np.fft.ifft2(z) if inverse else np.fft.fft2(z)
    assert _err(got, want) <= TOL_2D


@pytest.mark.parametrize("shape", [(1, 2, 2, 64), (1, 64, 2, 4),
                                   (2, 2, 64, 4), (1, 32, 32, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_split_3d_model_matches_numpy(monkeypatch, shape, inverse):
    """The 3-D kernel's launches with AXIS_MAX at 16: within 1e-6 relative
    norm of numpy."""
    monkeypatch.setattr(A, "AXIS_MAX", 16)
    rng = np.random.default_rng(sum(shape))
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    plan = A.plan3d(*shape)
    got = run_model(plan, z, inverse, int(np.prod(shape[1:])))
    axes = (-3, -2, -1)
    want = np.fft.ifftn(z, axes=axes) if inverse else np.fft.fftn(z,
                                                                   axes=axes)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= TOL_3D


def _recorder(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "function", lambda *a: a)
    monkeypatch.setattr(_build, "launch_all",
                        lambda fn, arg_lists, what, dev: calls.extend(
                            (fn, args, what) for args in arg_lists))
    monkeypatch.setattr(_build, "launch",
                        lambda fn, args, what, dev: calls.append(
                            (fn, args, what)))
    A._launch_args.cache_clear()
    R._launch_args.cache_clear()
    S2._launch_args.cache_clear()
    return calls


@pytest.mark.parametrize("shape", [(2, 2, 8192), (2, 8192, 4),
                                   (1, 2, 16384), (1, 8192, 8192)])
def test_2d_and_3d_wrappers_launch_the_split(monkeypatch, shape):
    """On meta planes past 4096: one call a planned launch, the "twiddle"
    ones with their [lo | hi] table and level shift, the "reversed" ones
    into other planes, 1/(h*w) only at the last on the inverse."""
    for inverse in (False, True):
        calls = _recorder(monkeypatch)
        x = SplitComplex(torch.empty(shape, device="meta"),
                         torch.empty(shape, device="meta"))
        fft2d_gemm.fft2d_gemm_cuda(x, inverse=inverse)
        plan = A.plan2d(*shape)
        assert len(calls) == len(plan)
        for i, ((fn, args, _), lp) in enumerate(zip(calls, plan)):
            assert fn == ("fft2d_gemm", "fft2d_gemm_pass", A.ARGS)
            assert len(args) == len(A.ARGS) - 1
            assert args[16] == A.MODES[lp.mode]
            if lp.mode == "twiddle":
                assert args[17] == A.split_table(
                    lp.m, inverse=inverse, device="meta").data_ptr()
                assert args[18] == A.level_shift(lp.m)
            assert args[19:23] == [lp.ljr, *lp.lr, lp.img_in]
            last = i == len(plan) - 1
            assert args[14] == (1.0 / (shape[1] * shape[2])
                                if inverse and last else 1.0)
    calls = _recorder(monkeypatch)
    x = SplitComplex(torch.empty((1, 2, 2, 8192), device="meta"),
                     torch.empty((1, 2, 2, 8192), device="meta"))
    fft3d_fused.fft3d_fused_cuda(x)
    assert [a[16] for _, a, _ in calls] == [
        A.MODES[lp.mode] for lp in A.plan3d(1, 2, 2, 8192)]


def test_split_table_within_two_ulp():
    """hi[j >> s] * lo[j mod 2^s] of the fp32 table against float64 W_m^j:
    within 2e-7 (three fp32 roundings of unit-magnitude values)."""
    for m in (1 << 13, 1 << 20, 1 << 24):
        j = torch.from_numpy(np.random.default_rng(m).integers(0, m, 4096))
        got = split_twiddle(m, j, False).numpy()
        want = np.exp(-2j * np.pi * j.numpy() / m)
        assert np.abs(got - want).max() <= 2e-7


# -- the fused Stockham 2-D kernel ------------------------------------------

def stockham_takes(route, lp) -> bool:
    """Whether ``fft2d_fused_pass`` / ``fft2d_fused_1d`` take it (the
    latter ``stockham_pass<4>``: whole transforms of up to 2^36)."""
    ln, linner, lc, lg = map(_lg, (lp.n, lp.inner, lp.c, lp.g))
    lp_ = ln + lc + lg
    threads = 1 << (lp_ - 4)
    ok = (lp.outer > 0 and ln >= 1 and lc <= linner and lp_ <= 14
          and (1 << lp_) >= A.MIN_POINTS and not (lc < linner and lg != 0))
    rows_ok = (linner == 0 and not (lp_ == 14 and lg != 0)
               and S2.rows_smem(lp.n, lp.g) <= A.SMEM_MAX)
    if route == "rows":
        return (ok and rows_ok and (ln <= 13 and threads <= 512
                                    or ln == 14 and threads == 1024))
    if route == "cols":
        return (ok and ln <= 14 and 1 <= linner <= 32
                and (threads <= 512 and ln <= 13
                     or threads == 1024 and ln >= 11))
    l1 = lp.lr[0]
    after = l1 >= 2 and l1 % 2 == 0         # radix 4: whole stages before
    if route == "split_cols":
        return (ok and lg == 0 and lc < linner and ln in (8, 10, 12)
                and (threads <= 512) == (ln <= 10) and lp.ljr <= linner
                and ln + linner - lp.ljr <= 36)
    if route == "split_mid":
        return (ok and after and ln in (2, 4, 6, 8, 10) and threads <= 512
                and 1 <= linner and lp.ljr <= linner
                and l1 + ln + linner - lp.ljr <= 36)
    if route == "split_rows":
        return (ok and rows_ok and after and l1 + ln <= 36
                and (7 <= ln <= 13 and threads <= 512
                     or ln == 14 and threads == 1024))
    return (ok and route == "split_tcols" and 7 <= ln <= 12
            and lp.ljr == linner >= 1 and after and l1 + ln <= 36
            and (threads <= 512 and ln <= 10 or threads == 1024))


@pytest.mark.parametrize("k", range(1, 34))
def test_stockham2d_plan_every_pow2_axis(k):
    """Images (3, 2, 2^k) and (3, 2^k, 4), k up to THREE_MAX's 32: every
    launch one the kernel takes; up to 2^14 one a pass, to 2^24 the 1-D
    kernel's two (columns: "split_tcols" last), past 2^24 its three, whose
    l1 arguments are l1, l1, l1 + l2 of ``split3`` and whose views hold
    the whole axis; past 2^32 a refusal that names the limit."""
    n = 1 << k
    for h, w, axis in ((2, n, "rows"), (n, 4, "cols")):
        if n > S2.THREE_MAX:
            with pytest.raises(ValueError, match=r"axes of up to 2\^32"):
                S2.plan(3, h, w)
            continue
        plan = S2.plan(3, h, w)
        for route, lp in plan:
            assert stockham_takes(route, lp), (route, lp)
        routes = [r for r, _ in plan]
        long = routes[:-1] if axis == "rows" else routes[1:]
        last = "split_rows" if axis == "rows" else "split_tcols"
        if n <= S2.ONE_MAX:
            assert long == [axis]
        elif n <= S2.TWO_MAX:
            assert long == ["split_cols", last]
        else:
            assert long == ["split_cols", "split_mid", last]
            steps = plan[:-1] if axis == "rows" else plan[1:]
            l1, l2, lq = S.split3(n, 4)
            inner, outer = (1, 3 * 2) if axis == "rows" else (4, 3)
            assert [lp.lr[0] for _, lp in steps] == [l1, l1, l1 + l2]
            assert [(lp.outer, lp.n, lp.inner) for _, lp in steps] == [
                (outer, 1 << l1, (n >> l1) * inner),
                (outer << l1, 1 << l2, inner << lq),
                (outer << (l1 + l2), 1 << lq, inner)]
            assert {lp.ljr for _, lp in steps} == {_lg(inner)}


def stockham_model(steps, z, inverse, h, w):
    """The fused Stockham 2-D kernel's launches in plain torch: "rows" and
    "cols" every stage of their axis (``stockham_stages``), the split's
    launch A (and launch 1) the radix-4 stages of bits 0..l1-1 on each
    column c of the (outer, M, Q*inner) view (twiddle entry (q + ((j >>
    2s) << log2 Q)) << 2s, q = c >> lin), the middle launch the next l2
    bits on each column c of the (outer*M1, M2, Q*inner) view (entry (q +
    ((j >> 2s) << log2 Q)) << (2s + l1)), launch B (and launch 3) the rest
    on each (image, column) of the (outer*M, Q, inner) view (entry (t >>
    2s) << (2s + l1), l1 the bits before it); the last three store point t
    of (o, k, c) at (o, t*M + k, c)."""
    from repro_torch.core.fft1d import stockham_stages
    x = torch.from_numpy(z.astype(np.complex64))
    b = x.shape[0]
    for route, lp in steps:
        n, inner = lp.n, lp.inner
        if route in ("rows", "cols"):
            v = x.reshape(-1, n, inner).transpose(1, 2)
            pk = tw.packed_radix4_twiddles(n, inverse=inverse, device="cpu")
            re, im = stockham_stages(v.real.contiguous(),
                                     v.imag.contiguous(), pk.re, pk.im, n,
                                     tw.stockham_radices(n), inverse=inverse)
            x = torch.complex(re, im).transpose(1, 2).reshape(b, h, w)
            continue
        l1 = lp.lr[0]
        if route == "split_cols":
            m, q = n, inner >> lp.ljr
            full = m * q
            tab = tw.radix4_twiddles(full, inverse=inverse, device="cpu")
            v = x.reshape(lp.outer, m, inner).transpose(1, 2)  # (o, c, m)
            cols = (torch.arange(inner) >> lp.ljr)[None, :, None]
            re, im = v.real, v.imag
            for s in range(_lg(m) // 2):
                j = torch.arange(m // 4)[None, None, :]
                idx = (cols + ((j >> (2 * s)) << _lg(q))) << (2 * s)
                re, im = _stage4(re, im, tab[:, idx], inverse, s)
            x = torch.complex(re, im).transpose(1, 2).reshape(b, h, w)
        else:       # split_mid, split_rows, split_tcols: stored transposed
            q, m = n, 1 << l1
            full = m * q
            lq = _lg(inner) - lp.ljr          # the middle launch's columns
            tab = tw.radix4_twiddles(full << lq, inverse=inverse,
                                     device="cpu")
            v = x.reshape(lp.outer, q, inner).transpose(1, 2)  # (o', i, q)
            cols = (torch.arange(inner) >> lp.ljr)[None, :, None]
            re, im = v.real, v.imag
            for s in range(_lg(q) // 2):
                j = torch.arange(q // 4)[None, None, :]
                idx = (cols + ((j >> (2 * s)) << lq)) << (2 * s + l1)
                re, im = _stage4(re, im, tab[:, idx], inverse, s)
            if _lg(q) & 1:
                re, im = _tail(re, im)
            y = torch.complex(re, im)                       # (o', i, t)
            o = torch.arange(lp.outer)[:, None, None]
            i = torch.arange(inner)[None, :, None]
            t = torch.arange(q)[None, None, :]
            at = ((o >> l1) * full + (t << l1) + (o & (m - 1))) * inner + i
            out = torch.empty(b * h * w, dtype=y.dtype)
            out[at.reshape(-1)] = y.reshape(-1)
            x = out.reshape(b, h, w)
    if inverse:
        x = x / (h * w)
    return x


def _stage4(re, im, w, inverse, s):
    """Radix-4 stage s of a Stockham along the last axis (the arithmetic of
    ``stockham_stages``); w (3, ..., n/4, 2) broadcast over the quarters."""
    n = re.shape[-1]
    q, lead = n // 4, re.shape[:-1]
    a = [(re[..., r * q:(r + 1) * q], im[..., r * q:(r + 1) * q])
         for r in range(4)]
    (a0r, a0i), (a1r, a1i), (a2r, a2i), (a3r, a3i) = a
    e0r, e0i, d0r, d0i = a0r + a2r, a0i + a2i, a0r - a2r, a0i - a2i
    e1r, e1i, d1r, d1i = a1r + a3r, a1i + a3i, a1r - a3r, a1i - a3i
    if inverse:
        y1, y3 = (d0r - d1i, d0i + d1r), (d0r + d1i, d0i - d1r)
    else:
        y1, y3 = (d0r + d1i, d0i - d1r), (d0r - d1i, d0i + d1r)
    outs = [(e0r + e1r, e0i + e1i)]
    for r, (yr, yi) in enumerate((y1, (e0r - e1r, e0i - e1i), y3)):
        wr, wi = w[r][..., 0], w[r][..., 1]
        outs.append((yr * wr - yi * wi, yr * wi + yi * wr))
    stride = 4 ** s
    m = q // stride
    return tuple(torch.stack([o[p].reshape(*lead, m, stride) for o in outs],
                             -2).reshape(*lead, n) for p in (0, 1))


def _tail(re, im):
    n = re.shape[-1]
    h, lead = n // 2, re.shape[:-1]
    ar, ai, br, bi = re[..., :h], im[..., :h], re[..., h:], im[..., h:]
    return (torch.stack([ar + br, ar - br], -2).reshape(*lead, n),
            torch.stack([ai + bi, ai - bi], -2).reshape(*lead, n))


@pytest.mark.parametrize("shape", [(2, 4, 256), (1, 256, 4), (1, 512, 512),
                                   (2, 2, 2048), (1, 1024, 2),
                                   (2, 4, 1 << 17), (1, 1 << 17, 8)])
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham2d_split_model_equals_the_plain_version(monkeypatch, shape,
                                                          inverse):
    """With ONE_MAX at 64 every axis past 64 takes the 1-D kernel's two
    launches, and with TWO_MAX at 2^16 an axis of 2^17 its three (split
    (8, 2, 7): the middle launch on tiles of whole images, over the
    columns of images with q = column >> 3 on (1, 2^17, 8)): the model of
    them equals ``fft2d_fused_plain`` under torch.equal, and is within
    1e-5 of max|X| of numpy."""
    monkeypatch.setattr(S2, "ONE_MAX", 64)
    monkeypatch.setattr(S2, "TWO_MAX", 1 << 16)
    rng = np.random.default_rng(sum(shape))
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    steps = S2.plan(*shape)
    assert any(r.startswith("split") for r, _ in steps)
    assert (("split_mid" in [r for r, _ in steps])
            == (max(shape) > S2.TWO_MAX))
    got = stockham_model(steps, z, inverse, *shape[1:])
    want = S2.fft2d_fused_plain(from_numpy(z, device="cpu"), inverse=inverse)
    assert torch.equal(got.real, want.re) and torch.equal(got.imag, want.im)
    ref = np.fft.ifft2(z) if inverse else np.fft.fft2(z)
    assert _err(got.numpy(), ref) <= TOL_2D


@pytest.mark.parametrize("inverse", [False, True])
def test_stockham2d_three_launch_model_against_the_reference(monkeypatch,
                                                              inverse):
    """The three launches' model at the smallest image that takes them
    (TWO_MAX at 2^16: rows of 2^17, split (8, 2, 7)) against the JAX
    package's ``fft2`` on its jnp backend with the default algo (that
    backend refuses "fused_stockham"): within 1e-5 of max|X|."""
    import jax.numpy as jnp
    import repro.core as ref_core
    from repro.core.complexmath import SplitComplex as RefSplit
    monkeypatch.setattr(S2, "TWO_MAX", 1 << 16)
    shape = (1, 2, 1 << 17)
    steps = S2.plan(*shape)
    assert [r for r, _ in steps] == ["split_cols", "split_mid",
                                     "split_rows", "cols"]
    z = np.random.default_rng(17).standard_normal((2,) + shape)
    z = (z[0] + 1j * z[1]).astype(np.complex64)
    got = stockham_model(steps, z, inverse, *shape[1:]).numpy()
    ref = ref_core.fft2(RefSplit(jnp.asarray(z.real), jnp.asarray(z.imag)),
                        inverse=inverse, backend="jnp")
    ref = np.asarray(ref.re) + 1j * np.asarray(ref.im)
    assert _err(got, ref) <= TOL_2D


@pytest.mark.parametrize("shape", [(1, 2, 1 << 15), (1, 1 << 15, 4),
                                   (2, 2, 1 << 25), (1, 1 << 25, 4)])
def test_stockham2d_wrapper_launches_long_axes(monkeypatch, shape):
    """On meta planes: one call a planned launch, each with its entry (the
    split's at its route, l1 and lin: past 2^24 the three launches
    "split_cols", "split_mid", then "split_rows" or "split_tcols", at
    l1, l1, l1 + l2), through one scratch pair (out -> scratch -> out for
    the last two), 1/(h*w) at the last only."""
    calls = _recorder(monkeypatch)
    x = SplitComplex(torch.empty(shape, device="meta"),
                     torch.empty(shape, device="meta"))
    S2.fft2d_fused_cuda(x, inverse=True)
    steps = S2.plan(*shape)
    assert len(calls) == len(steps)
    n = max(shape[1:])
    routes = [r for r, _ in steps]
    if n > S2.TWO_MAX:
        l1, l2, _ = S.split3(n, 4)
        long = [a for (_, a, _), r in zip(calls, routes)
                if r.startswith("split")]
        assert [a[10] for a in long] == [1, 4, 2 if shape[2] == n else 3]
        assert [a[11] for a in long] == [l1, l1, l1 + l2]
        assert [a[12] for a in long] == [0 if shape[2] == n
                                         else _lg(shape[2])] * 3
        bufs = [b for b, r in zip(S2.buffers(steps), routes)
                if r.startswith("split")]
        assert bufs[0][1] == 1 and bufs[1:] == [(1, 2), (2, 1)]
    for i, ((fn, args, _), (route, lp)) in enumerate(zip(calls, steps)):
        assert fn[1] == ("fft2d_fused_pass" if route == "cols"
                         else "fft2d_fused_1d")
        last = i == len(steps) - 1
        scale = 1.0 / (shape[1] * shape[2]) if last else 1.0
        if route.startswith("split"):
            assert args[10:13] == [S2._ROUTES[route], lp.lr[0], lp.ljr]
            assert args[14] == scale


# -- the real-input kernels ------------------------------------------------

@pytest.mark.parametrize("k", range(1, 27))
@pytest.mark.parametrize("inverse", [False, True])
def test_rfft2_steps_every_pow2_axis(k, inverse):
    """Images (2, 2^k) and (2^k, 4), k up to 26 (and (2^k, 2^k) up to
    2^13): the fused two launches up to 4096 a side, else split steps whose
    axis launches the kernel takes and whose buffers chain."""
    n = 1 << k
    shapes = [(2, 2, n), (1, n, 4)] + ([(1, n, n)] if k <= 13 else [])
    for shape in shapes:
        b, h, w = shape
        steps = R.steps(*shape, inverse=inverse)
        if max(h, w) <= A.AXIS_MAX:
            assert steps == (("fused", "x", "out", None),)
            continue
        assert steps[0][1] == "x" and steps[-1][2] == "out"
        for (_, _, d0, _), (_, s1, _, _) in zip(steps, steps[1:]):
            assert d0 == s1
        kinds = [kd for kd, *_ in steps]
        axis = [wt for kd, _, _, wt in steps if kd == "axis"]
        assert len(axis) == sum(len(A.split_factors(n_)) for n_ in (h, w)
                                if n_ > A.AXIS_MAX)
        for lp in axis:
            assert axis_kernel_takes(lp), lp
        if w > A.AXIS_MAX:
            assert ("untangle" if not inverse else "repack") in kinds
        if h > A.AXIS_MAX:
            assert "repitch" in kinds
            assert R.scratch_pitch(b, h, w, inverse) == R.split_pitch(w)


def rfft_steps_model(steps, x, b, h, w, inverse):
    """The real-input steps in plain torch: "axis" launches through
    ``launch_model`` (the packed rows: re = row 2j, im = row 2j+1), the
    fused passes' FFTs as DFTs off the kernels' tables, the untangle,
    repack and repitch index maps of their kernels."""
    c, pairs = w // 2 + 1, b * h // 2
    p = R.scratch_pitch(b, h, w, inverse)
    buf = {}
    if inverse:
        buf["x"] = torch.from_numpy(x.astype(np.complex64))       # (b, h, c)
    else:
        xr = torch.from_numpy(x.astype(np.float32))
        buf["x"] = torch.complex(xr[:, 0::2], xr[:, 1::2]).reshape(-1)
    out = None
    for kind, src, dst, what in steps:
        if kind == "axis":
            y = launch_model(what, buf[src].reshape(-1), inverse)
            if dst == "out":                         # inverse: real rows
                y = y.reshape(b, h // 2, w)
                out = torch.stack([y.real, y.imag], 2).reshape(b, h, w)
                out = out / (h * w)
            buf[dst] = y
        elif kind == "rows":                         # forward, untangled
            z = dft(buf[src].reshape(pairs, w, 1), w, False).reshape(pairs,
                                                                     w)
            buf[dst] = _untangle(z, p)
        elif kind == "untangle":
            buf[dst] = _untangle(buf[src].reshape(pairs, w), what)
        elif kind == "repack":
            buf[dst] = _repack(buf[src].reshape(b * h, -1), w)
        elif kind == "repitch":
            width, sp, dp = what
            v = buf[src].reshape(b * h, sp)[:, :width]
            buf[dst] = torch.cat([v, v.new_zeros(b * h, dp - width)], 1)
        elif kind == "cols":
            v = buf[src].reshape(b, h, -1)
            v = dft(v, h, inverse)
            buf[dst] = v
        else:                                        # irows
            z = _repack(buf[src].reshape(b * h, -1), w)
            y = dft(z.reshape(pairs, w, 1), w, True).reshape(b, h // 2, w)
            out = torch.stack([y.real, y.imag], 2).reshape(b, h, w)
            out = out / (h * w)
    if inverse:
        return out.numpy()
    return buf["out"].reshape(b, h, -1)[..., :c].numpy()


def _untangle(z, p):
    """Packed spectra (pairs, w) -> half spectra rows 2j (A), 2j+1 (B) at
    pitch p, bins 0..w/2 (``untangle``)."""
    pairs, w = z.shape
    kk = torch.arange(w // 2 + 1)
    zk, zc = z[:, kk], z[:, (w - kk) % w].conj()
    a, bb = (zk + zc) / 2, (zk - zc) / 2j
    out = torch.zeros(pairs, 2, p, dtype=z.dtype)
    out[:, 0, :w // 2 + 1], out[:, 1, :w // 2 + 1] = a, bb
    return out.reshape(-1)


def _repack(s, w):
    """Half spectra rows (pitch >= w/2+1) -> packed rows Z = A_ext + i
    B_ext, the DC and Nyquist imaginary parts dropped (``repack``)."""
    hw = w // 2
    a, bb = s[0::2, :hw + 1].clone(), s[1::2, :hw + 1].clone()
    for t in (a, bb):
        t[:, 0] = t[:, 0].real
        t[:, hw] = t[:, hw].real

    def ext(t):
        return torch.cat([t, t[:, 1:hw].flip(-1).conj()], -1)
    return (ext(a) + 1j * ext(bb)).reshape(-1)


@pytest.mark.parametrize("shape", [(2, 2, 64), (1, 64, 4), (1, 32, 64),
                                   (3, 4, 32), (1, 64, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_rfft2_steps_model_matches_numpy(monkeypatch, shape, inverse):
    """With AXIS_MAX at 16 the real-input steps' model is within 1e-5 of
    max|X| of numpy's rfft2 / irfft2."""
    monkeypatch.setattr(A, "AXIS_MAX", 16)
    b, h, w = shape
    rng = np.random.default_rng(sum(shape))
    steps = R.steps(*shape, inverse=inverse)
    assert any(kd == "axis" for kd, *_ in steps)
    if inverse:
        x = rng.standard_normal((b, h, w // 2 + 1)) \
            + 1j * rng.standard_normal((b, h, w // 2 + 1))
        want = np.fft.irfft2(x, s=(h, w))
    else:
        x = rng.standard_normal(shape)
        want = np.fft.rfft2(x)
    got = rfft_steps_model(steps, x, b, h, w, inverse)
    assert _err(got, want) <= TOL_2D


@pytest.mark.parametrize("shape,inverse,kinds", [
    ((1, 2, 8192), False, ["rfft2d_axis_pass", "rfft2d_axis_pass",
                           "rfft2d_untangle", "rfft2d_cols_pass"]),
    ((1, 8192, 4), False, ["rfft2d_rows_pass", "rfft2d_axis_pass",
                           "rfft2d_axis_pass", "rfft2d_repitch"]),
    ((1, 8192, 4), True, ["rfft2d_repitch", "rfft2d_axis_pass",
                          "rfft2d_axis_pass", "irfft2d_rows_pass"]),
    ((1, 2, 8192), True, ["rfft2d_cols_pass", "rfft2d_repack",
                          "rfft2d_axis_pass", "rfft2d_axis_pass"])])
def test_rfft2_wrappers_launch_the_steps(monkeypatch, shape, inverse, kinds):
    """On meta tensors: one call a step; the packed rows at a 2w row pitch
    (img_in forward, img_out inverse); 1/(h*w) at the inverse's last."""
    calls = _recorder(monkeypatch)
    b, h, w = shape
    if inverse:
        xf = SplitComplex(torch.empty((b, h, w // 2 + 1), device="meta"),
                          torch.empty((b, h, w // 2 + 1), device="meta"))
        out = R.irfft2d_fused_cuda(xf)
        assert out.shape == shape
    else:
        out = R.rfft2d_fused_cuda(torch.empty(shape, device="meta"))
        assert out.re.shape == (b, h, w // 2 + 1)
    assert [fn[1] for fn, _, _ in calls] == kinds
    axis = [a for fn, a, _ in calls if fn[1] == "rfft2d_axis_pass"]
    if w > A.AXIS_MAX:
        pos = 22 if not inverse else 23            # img_in / img_out
        assert (axis[0] if not inverse else axis[-1])[pos] == 2 * w
    if inverse:
        last = calls[-1][1]
        scale = last[14] if calls[-1][0][1] == "rfft2d_axis_pass" \
            else last[10]
        assert scale == 1.0 / (h * w)


# -- the four-step kernel's factors, the radix-2 kernel past 2^24 ----------

def test_fourstep_every_factor_pair():
    """Every (n, n1) with n1, n/n1 <= 2^14 and n <= 2^22: a route, and the
    axis route's launches ones the kernel takes (one rows launch for
    n1 = n, else the split (n1, n2))."""
    for k in range(1, 23):
        n = 1 << k
        for j in range(1, k + 1):
            n1 = 1 << j
            if n // n1 > A.FACTOR_MAX or n1 > A.FACTOR_MAX:
                with pytest.raises(ValueError, match="factors of up to"):
                    F.kernel_factors(n, n1)
                continue
            route = F.kernel_route(n, n1)
            assert route == ("fused" if max(n1, n // n1) <= F.MAX_FACTOR
                             and n // n1 >= 2 else "axis")
            launches = F.axis_plan(3, n, n1)
            if n1 == n:
                (lp,) = launches
                assert (lp.kind, lp.n, lp.mode) == ("rows", n, "plain")
                assert axis_kernel_takes(lp)
            else:
                check_split(launches, 3, n, 1)
                assert [lp.n for lp in launches] == [n1, n // n1]


@pytest.mark.parametrize("n,n1", [(64, 2), (64, 32), (256, 256), (512, 8),
                                  (1024, 4)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_axis_route_model_matches_numpy(n, n1, inverse):
    """The axis route's launches (column FFTs twiddled by W_n^(k1*j2), then
    row FFTs stored at k2*n1 + k1) as plain torch: within 5e-5 of max|X|
    of numpy."""
    rng = np.random.default_rng(n + n1)
    z = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    got = run_model(F.axis_plan(3, n, n1), z, inverse, n)
    want = np.fft.ifft(z) if inverse else np.fft.fft(z)
    assert _err(got, want) <= 5e-5


@pytest.mark.parametrize("k", range(1, 28))
def test_r2_plan_every_n_to_2_27(k):
    """The radix-2 kernel's plan at every power of two up to 2^27: one
    launch up to 2^14, two to 2^24, then three; no refusal."""
    n = 1 << k
    routes = [r for r, _ in S.r2_plan(2, n)]
    assert routes == (["rows"] if n <= S.ONE_MAX else
                      ["cols", "transposed"] if n <= S.TWO_MAX
                      else ["cols", "mid", "transposed"])
