"""The fused radix-4 Stockham kernel's one twiddle table, its two- and
three-launch routes as plain-torch models, its launch plan and what its
wrapper refuses, on the CPU.  The kernel itself runs in
``tests/test_torch_cuda.py`` (on a card), under
``tools/cuda_emu/emulate.py`` and in ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from repro.core import twiddle as ref_tw
from repro_torch.core import from_numpy
from repro_torch.core import twiddle as tw
from repro_torch.core.fft1d import stockham_stages
from repro_torch.kernels import _build, axis_fft as A, fft_stockham as S

NS = [1 << k for k in range(2, 17)]


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("inverse", [False, True])
def test_one_table_is_row0_of_the_packed_table(n, inverse):
    """The kernel's (3, n/4) table is row 0 of the reference's packed
    (s4, 3, n/4) table, bit for bit, in float64 and after the fp32 cast."""
    (one,) = tw.radix4_twiddles_np(n, inverse)
    wr, wi = ref_tw.packed_radix4_twiddles_np(n, inverse)
    assert one.shape == (3, n // 4, 2) and one.dtype == np.float64
    assert np.array_equal(one[..., 0], wr[0])
    assert np.array_equal(one[..., 1], wi[0])
    card = tw.radix4_twiddles(n, inverse=inverse, device="cpu")
    packed = tw.packed_radix4_twiddles(n, inverse=inverse, device="cpu")
    assert card.dtype == torch.float32 and card.shape == (3, n // 4, 2)
    assert torch.equal(card[..., 0], packed.re[0])
    assert torch.equal(card[..., 1], packed.im[0])


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("inverse", [False, True])
def test_one_table_gives_every_stage_row(n, inverse):
    """Row s of the packed table is entry (r, (j >> 2s) << 2s) of the one
    table at each (r, j), bit for bit (the kernel's index), in float64 and
    in fp32."""
    (one,) = tw.radix4_twiddles_np(n, inverse)
    wr, wi = tw.packed_radix4_twiddles_np(n, inverse)
    card = tw.radix4_twiddles(n, inverse=inverse, device="cpu")
    packed = tw.packed_radix4_twiddles(n, inverse=inverse, device="cpu")
    j = np.arange(n // 4)
    assert wr.shape[0] == (n.bit_length() - 1) // 2
    for s in range(wr.shape[0]):
        idx = (j >> (2 * s)) << (2 * s)
        assert np.array_equal(wr[s], one[:, idx, 0])
        assert np.array_equal(wi[s], one[:, idx, 1])
        assert torch.equal(packed.re[s], card[:, torch.from_numpy(idx), 0])
        assert torch.equal(packed.im[s], card[:, torch.from_numpy(idx), 1])


def test_one_table_of_n2_is_the_packed_zero_row():
    (one,) = tw.radix4_twiddles_np(2, False)
    wr, wi = tw.packed_radix4_twiddles_np(2, False)
    assert one.shape == (3, 1, 2) and not one.any()
    assert np.array_equal(one[..., 0], wr[0])


def test_one_table_is_cached():
    a = tw.radix4_twiddles(512, inverse=True, device="cpu")
    assert tw.radix4_twiddles(512, inverse=True, device="cpu") is a
    assert tw.radix4_twiddles(512, inverse=False, device="cpu") is not a


def _stage4(re, im, w, inverse, s):
    """Radix-4 stage s of a Stockham along the last axis, the arithmetic of
    ``stockham_stages``; w (3, ..., n/4, 2) broadcast over the quarters."""
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


def two_pass_model(re, im, n, l1, inverse):
    """The kernel's two-launch route in plain torch, off the one table:
    launch A runs the radix-4 stages of bits 0..l1-1 on each column q of
    the (M, Q) view (the twiddles of its butterfly j at stage s: entry
    (q + ((j >> 2s) << log2 Q)) << 2s of each row) and leaves each point
    where its column lies; launch B runs the length-Q Stockham on each row
    k of that (entry (t >> 2s) << (2s + l1)), the radix-2 tail last for
    odd log2 Q, storing row k's point t at t*M + k."""
    tab = tw.radix4_twiddles(n, inverse=inverse, device="cpu")
    b = re.shape[0]
    m, q = 1 << l1, n >> l1
    qb = q.bit_length() - 1
    cols = torch.arange(q)[:, None]
    re = re.reshape(b, m, q).transpose(1, 2)       # column q's m points last
    im = im.reshape(b, m, q).transpose(1, 2)
    for s in range(l1 // 2):
        j = torch.arange(m // 4)[None, :]
        idx = (cols + ((j >> (2 * s)) << qb)) << (2 * s)
        re, im = _stage4(re, im, tab[:, idx], inverse, s)
    re, im = re.transpose(1, 2), im.transpose(1, 2)  # (b, M, Q): row k
    for s in range(qb // 2):
        idx = (torch.arange(q // 4) >> (2 * s)) << (2 * s + l1)
        re, im = _stage4(re, im, tab[:, idx], inverse, s)
    if qb & 1:
        re, im = _tail(re, im)
    return (re.transpose(1, 2).reshape(b, n),
            im.transpose(1, 2).reshape(b, n))


@pytest.mark.parametrize("n,l1", [(1 << 12, 6), (1 << 12, 4), (1 << 11, 6),
                                  (1 << 11, 4), (1 << 9, 2), (1 << 9, 8),
                                  (1 << 15, 8), (1 << 13, 6), (1 << 17, 10),
                                  (1 << 16, 8)])
@pytest.mark.parametrize("inverse", [False, True])
def test_two_pass_route_equals_the_stage_by_stage_oracle(n, l1, inverse):
    """Splitting the stages at an even l1 (odd log2 n included: the tail
    in launch B) changes no bit: the model of the two launches equals
    ``stockham_stages`` on the packed table under torch.equal."""
    rng = np.random.default_rng(n + l1)
    z = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    x = from_numpy(z, device="cpu")
    packed = tw.packed_radix4_twiddles(n, inverse=inverse, device="cpu")
    want = stockham_stages(x.re, x.im, packed.re, packed.im, n,
                           tw.stockham_radices(n), inverse=inverse)
    got = two_pass_model(x.re, x.im, n, l1, inverse)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_launch_a_twiddle_index_stays_in_the_table():
    """Launch A's folded index (q + ((j >> 2s) << log2 Q)) << 2s and launch
    B's (t >> 2s) << (2s + l1) stay below n/4 at every n of the route."""
    for k in range(15, 25):
        n = 1 << k
        l1 = S.split(n, 4)
        m, q = 1 << l1, n >> l1
        qb = q.bit_length() - 1
        for s in range(l1 // 2):
            j = m // 4 - 1
            assert ((q - 1) + ((j >> (2 * s)) << qb)) << (2 * s) < n // 4
        for s in range(qb // 2):
            t = q // 4 - 1
            assert (t >> (2 * s)) << (2 * s + l1) < n // 4


def _smem(route, lp):
    """The kernel's shared memory a block (stockham_pass): rows of
    pitch(n, min(lg, 3)) for the rows routes, the tile itself for
    columns, nbuf buffers of two planes."""
    lg = lp.g.bit_length() - 1
    if route == "cols":
        wf = lp.points
    else:
        wf = A.pitch(lp.n, min(lg, 3)) * lp.g
    return lp.nbuf * 2 * 4 * (-(-wf // 32) * 32)


@pytest.mark.parametrize("batch", [1, 3, 16])
def test_r4_plan_every_n(batch):
    """One rows launch up to 2^14; above, launch A on the columns of the
    (2^l1, n/2^l1) view, l1 = 2 * floor((log2 n + 1) / 4) (even: whole
    radix-4 stages; columns of at most 1024 points up to 2^21) and 12 from
    2^22, and launch B on the batch*2^l1 rows of n/2^l1: transforms of
    2^7..2^12 points, tiles the kernel takes."""
    for k in range(1, 25):
        n = 1 << k
        plan = S.r4_plan(batch, n)
        if n <= S.ONE_MAX:
            assert [r for r, _ in plan] == ["rows"]
            lp = plan[0][1]
            assert (lp.kind, lp.outer, lp.n, lp.inner) == ("rows", batch, n,
                                                           1)
        else:
            l1 = 12 if k >= 22 else 2 * ((k + 1) // 4)
            assert S.split(n, 4) == l1 and l1 % 2 == 0
            assert [r for r, _ in plan] == ["cols", "transposed"]
            a, b = plan[0][1], plan[1][1]
            assert (a.kind, a.outer, a.n, a.inner) == ("cols", batch,
                                                       1 << l1, n >> l1)
            assert (b.kind, b.outer, b.n, b.inner) == ("rows", batch << l1,
                                                       n >> l1, 1)
            assert 4 <= a.c < a.inner and a.g == 1
            assert a.n.bit_length() - 1 in ((8, 10) if k <= 21 else (12,))
            assert 7 <= b.n.bit_length() - 1 <= 12 and b.points <= A.TILE
        for route, lp in plan:
            assert A.MIN_POINTS <= lp.points <= A.TILE_BIG
            assert lp.threads == lp.points // 16 <= 1024
            if lp.points > A.TILE:
                assert lp.g == 1 and lp.nbuf == 1
            assert _smem(route, lp) <= A.SMEM_MAX
            assert lp.tiles * lp.points >= lp.outer * lp.n * lp.inner
            assert 1 <= lp.blocks(132) <= lp.tiles
    assert [S.split(1 << k, 4) for k in range(15, 25)] == [8] * 4 + [10] * 3 \
        + [12] * 3


def test_r4_launches_at_the_main_shapes():
    """2 x 2^22: launch A on 4096-point columns (C = 4, one buffer), B on
    1024-point rows (G = 8); 2 x 2^23: B on 2048-point rows (G = 4, the
    tail); irfft's 4 x 2^21: A on 1024-point columns (C = 8, two buffers),
    B on 2048-point rows (G = 4); the row_col rows of 256 and 1024 points:
    one launch."""
    (ra, a), (rb, b) = S.r4_plan(2, 1 << 22)
    assert (a.n, a.inner, a.c, a.nbuf, b.n, b.g) == (4096, 1024, 4, 1, 1024,
                                                     8)
    (_, a), (_, b) = S.r4_plan(2, 1 << 23)
    assert (a.n, a.inner, b.n, b.g) == (4096, 2048, 2048, 4)
    (_, a), (_, b) = S.r4_plan(4, 1 << 21)
    assert (a.n, a.inner, a.c, a.nbuf, b.n, b.g) == (1024, 2048, 8, 2, 2048,
                                                     4)
    for shape in [(131072, 256), (2048, 1024), (16384, 1024)]:
        assert len(S.r4_plan(*shape)) == 1


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
    S._launch_args.cache_clear()
    return calls


@pytest.mark.parametrize("n", [2, 8, 1 << 14, 1 << 15, 1 << 17, 1 << 20])
@pytest.mark.parametrize("inverse", [False, True])
def test_r4_wrapper_launches_the_plan(monkeypatch, n, inverse):
    """One call a planned launch: x -> out, or x -> scratch -> out; the one
    (3, n/4) table; the route, l1 and grid; 1/n at the last store only;
    the transform's sign last."""
    calls = _recorder(monkeypatch)
    x = from_numpy(np.ones((2, n), np.complex64), device="cpu")
    out = S.fft_stockham_cuda(x, inverse=inverse)
    plan = S.r4_plan(2, n)
    assert len(calls) == len(plan)
    tab = tw.radix4_twiddles(n, inverse=inverse, device="cpu")
    for i, ((fn, args, what), (route, lp)) in enumerate(zip(calls, plan)):
        assert fn == ("fft_stockham", "fft_stockham_r4_pass", S._R4_ARGS)
        assert what == "fft_stockham_r4"
        assert len(args) == len(S._R4_ARGS) - 1
        if i == 0:
            assert args[:2] == [x.re.data_ptr(), x.im.data_ptr()]
        else:
            assert args[:2] == calls[0][1][2:4]      # launch A's output
        if i == len(plan) - 1:
            assert args[2:4] == [out.re.data_ptr(), out.im.data_ptr()]
        assert args[4] == tab.data_ptr()
        assert args[5:10] == [lp.outer, lp.n.bit_length() - 1,
                              lp.inner.bit_length() - 1,
                              lp.c.bit_length() - 1, lp.g.bit_length() - 1]
        assert args[10] == {"rows": 0, "cols": 1, "transposed": 2}[route]
        assert args[11] == S.split(n, 4) and args[12] == lp.blocks(132)
        last = i == len(plan) - 1
        assert args[13] == (1.0 / n if inverse and last else 1.0)
        assert args[14] == int(inverse)


@pytest.mark.parametrize("inverse", [False, True])
def test_r4_wrapper_runs_a_launch_a_stage_above_its_fused_limit(
        monkeypatch, inverse):
    """Past TWO_MAX the wrapper runs three fused launches, no longer a
    launch a stage (shown with the limit lowered to 2^16, so that 2^17
    takes that route): x -> out (launch A's route), out -> scratch (the
    middle launch), scratch -> out (launch B's route), off the one
    (3, n/4) table; l1 and l1 + l2 bits done before launches 2 and 3; 1/n
    at the last store only; the transform's sign last."""
    calls = _recorder(monkeypatch)
    monkeypatch.setattr(S, "TWO_MAX", 1 << 16)
    n = 1 << 17
    x = from_numpy(np.ones((3, n), np.complex64), device="cpu")
    out = S.fft_stockham_cuda(x, inverse=inverse)
    assert len(calls) == 3
    l1, l2, _ = S.split3(n, 4)
    tab = tw.radix4_twiddles(n, inverse=inverse, device="cpu")
    xp = [x.re.data_ptr(), x.im.data_ptr()]
    op = [out.re.data_ptr(), out.im.data_ptr()]
    (_, a1, _), (_, a2, _), (_, a3, _) = calls
    assert a1[:4] == xp + op and a2[:2] == op and a3[2:4] == op
    assert a2[2:4] == a3[:2] and not set(a2[2:4]) & set(xp + op)
    for i, ((fn, args, what), (route, lp)) in enumerate(
            zip(calls, S.r4_plan(3, n))):
        assert fn == ("fft_stockham", "fft_stockham_r4_pass", S._R4_ARGS)
        assert what == "fft_stockham_r4"
        assert args[4] == tab.data_ptr()
        assert args[10] == S._ROUTES[route] == (1, 4, 2)[i]
        assert args[11] == (l1, l1, l1 + l2)[i]
        assert args[13] == (1.0 / n if inverse and i == 2 else 1.0)
        assert args[14] == int(inverse)
    S._launch_args.cache_clear()


def test_r4_plan_refuses_n_past_the_fused_limit():
    """Past TWO_MAX the plan is three fused launches for radix 4 as for
    radix 2 (launch A's route, the middle launch, launch B's route), up
    to THREE_MAX = 2^36; past that it refuses."""
    for radix in (4, 2):
        plan = S.plan(1, S.TWO_MAX * 2, radix)
        assert [r for r, _ in plan] == ["cols", "mid", "transposed"]
        assert plan[0][1].n * plan[0][1].inner == S.TWO_MAX * 2
        with pytest.raises(ValueError, match="2\\^36"):
            S.plan(1, S.THREE_MAX * 2, radix)
    assert len(S.r4_plan(2, S.THREE_MAX)) == 3


def three_pass_model(re, im, n, l1, l2, inverse):
    """The kernel's three-launch route in plain torch, off the one table
    (``test_torch_stockham_r2.three_pass_model`` with radix-4 stages, l1
    and l2 even): launch 1 is :func:`two_pass_model`'s launch A on the
    (M1, M2*Q) view; launch 2 runs the radix-4 stages of bits
    l1..l1+l2-1 on each column q of image k1's (M2, Q) view (entry
    (q + ((j >> 2s) << log2 Q)) << (2s + l1)), storing point t of (k1, q)
    at row t*M1 + k1; launch 3 the length-Q Stockham on each row o (entry
    (t >> 2s) << (2s + l1 + l2), the tail last for odd log2 Q), row o's
    point t at t*M1*M2 + o; the inverse's 1/n last."""
    tab = tw.radix4_twiddles(n, inverse=inverse, device="cpu")
    b = re.shape[0]
    m1, m2 = 1 << l1, 1 << l2
    q = n >> (l1 + l2)
    qb = q.bit_length() - 1

    def stages(re, im, count, index):
        for s in range(count):
            re, im = _stage4(re, im, tab[:, index(s)], inverse, s)
        return re, im
    cols = torch.arange(m2 * q)[:, None]
    j = torch.arange(m1 // 4)[None, :]
    re, im = (t.reshape(b, m1, m2 * q).transpose(1, 2) for t in (re, im))
    re, im = stages(re, im, l1 // 2, lambda s: (
        cols + ((j >> (2 * s)) << (l2 + qb))) << (2 * s))
    re, im = (t.transpose(1, 2).reshape(b, m1, m2, q).transpose(2, 3)
              for t in (re, im))
    cols, j = torch.arange(q)[:, None], torch.arange(m2 // 4)[None, :]
    re, im = stages(re, im, l2 // 2, lambda s: (
        cols + ((j >> (2 * s)) << qb)) << (2 * s + l1))
    re, im = (t.permute(0, 3, 1, 2).reshape(b, m2 * m1, q) for t in (re, im))
    re, im = stages(re, im, qb // 2, lambda s: (
        torch.arange(q // 4) >> (2 * s)) << (2 * s + l1 + l2))
    if qb & 1:
        re, im = _tail(re, im)
    re, im = (t.transpose(1, 2).reshape(b, n) for t in (re, im))
    if inverse:
        re, im = re * (1.0 / n), im * (1.0 / n)
    return re, im


@pytest.mark.parametrize("n,l1,l2", [(1 << 7, 2, 2), (1 << 9, 2, 2),
                                     (1 << 10, 4, 2), (1 << 11, 4, 4),
                                     (1 << 12, 2, 4), (1 << 13, 6, 4),
                                     (1 << 17, None, None),
                                     (1 << 18, None, None)])
@pytest.mark.parametrize("inverse", [False, True])
def test_three_pass_route_equals_the_plain_version(monkeypatch, n, l1, l2,
                                                   inverse):
    """The three launches at even l1 and l2 (odd log2 n included: the tail
    in launch 3) change no bit: their model equals the plain version
    (``stockham_stages`` on the packed table, then 1/n) under torch.equal;
    at 2^17 and 2^18 with TWO_MAX lowered to 2^16, at :func:`split3`'s
    split of the plan."""
    if l1 is None:
        monkeypatch.setattr(S, "TWO_MAX", 1 << 16)
        assert [r for r, _ in S.r4_plan(3, n)] == ["cols", "mid",
                                                   "transposed"]
        l1, l2, _ = S.split3(n, 4)
    rng = np.random.default_rng(n + l1 + l2)
    z = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    x = from_numpy(z, device="cpu")
    want = S.fft_stockham_plain(x, inverse=inverse)
    got = three_pass_model(x.re, x.im, n, l1, l2, inverse)
    assert torch.equal(got[0], want.re) and torch.equal(got[1], want.im)


def test_r4_wrapper_refuses_cpu_tensors():
    x = from_numpy(np.ones((2, 16), np.complex64), device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        S.fft_stockham_cuda(x)


@pytest.mark.parametrize("n", [12, 1000, 1, 3 << 20])
def test_r4_wrapper_refuses_non_pow2(monkeypatch, n):
    calls = _recorder(monkeypatch)
    x = from_numpy(np.ones((1, n), np.complex64), device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        S.fft_stockham_cuda(x)
    assert calls == []
