"""The fused radix-2 Stockham kernel's one twiddle table, its two- and
three-launch routes as plain-torch models, its launch plan and what its
wrapper refuses, on the CPU.  The kernel itself runs in
``tests/test_torch_cuda.py`` (on a card) and under
``tools/cuda_emu/emulate.py``."""
import numpy as np
import pytest
import torch

from repro.core import twiddle as ref_tw
from repro_torch.core import SplitComplex, from_numpy
from repro_torch.core import twiddle as tw
from repro_torch.core.fft1d import stockham_radix2_stages
from repro_torch.kernels import _build, axis_fft as A, fft_stockham as S

NS = [2, 8, 1024, 1 << 16]


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("inverse", [False, True])
def test_one_row_table_is_row0_of_the_packed_table(n, inverse):
    """The kernel's table is row 0 of the reference's packed (stages, n/2)
    table, bit for bit, in float64 and after the fp32 cast."""
    (one,) = tw.radix2_twiddles_np(n, inverse)
    wr, wi = ref_tw.packed_radix2_twiddles_np(n, inverse)
    assert one.shape == (n // 2, 2) and one.dtype == np.float64
    assert np.array_equal(one[:, 0], wr[0])
    assert np.array_equal(one[:, 1], wi[0])
    card = tw.radix2_twiddles(n, inverse=inverse, device="cpu")
    packed = tw.packed_radix2_twiddles(n, inverse=inverse, device="cpu")
    assert card.dtype == torch.float32 and card.shape == (n // 2, 2)
    assert torch.equal(card[:, 0], packed.re[0])
    assert torch.equal(card[:, 1], packed.im[0])


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("inverse", [False, True])
def test_one_row_gives_every_stage_row(n, inverse):
    """Row s of the packed table is entry (j >> s) << s of row 0 at each
    j, bit for bit (the kernel's index), in float64 and in fp32."""
    (one,) = tw.radix2_twiddles_np(n, inverse)
    wr, wi = tw.packed_radix2_twiddles_np(n, inverse)
    card = tw.radix2_twiddles(n, inverse=inverse, device="cpu")
    packed = tw.packed_radix2_twiddles(n, inverse=inverse, device="cpu")
    j = np.arange(n // 2)
    assert wr.shape[0] == n.bit_length() - 1
    for s in range(wr.shape[0]):
        idx = (j >> s) << s
        assert np.array_equal(wr[s], one[idx, 0])
        assert np.array_equal(wi[s], one[idx, 1])
        assert torch.equal(packed.re[s], card[torch.from_numpy(idx), 0])
        assert torch.equal(packed.im[s], card[torch.from_numpy(idx), 1])


def test_one_row_table_is_cached():
    a = tw.radix2_twiddles(512, inverse=True, device="cpu")
    assert tw.radix2_twiddles(512, inverse=True, device="cpu") is a
    assert tw.radix2_twiddles(512, inverse=False, device="cpu") is not a


def _stage(re, im, wr, wi, s):
    """Stage s of a radix-2 Stockham along the last axis, the arithmetic
    of ``stockham_radix2_stages``; (wr, wi) broadcast over the lower half."""
    n = re.shape[-1]
    h, stride, m = n // 2, 1 << s, n >> (s + 1)
    lead = re.shape[:-1]
    ar, ai, br, bi = re[..., :h], im[..., :h], re[..., h:], im[..., h:]
    sr, si = ar - br, ai - bi
    tr = sr * wr - si * wi
    ti = sr * wi + si * wr
    re = torch.stack([(ar + br).reshape(*lead, m, stride),
                      tr.reshape(*lead, m, stride)], -2).reshape(*lead, n)
    im = torch.stack([(ai + bi).reshape(*lead, m, stride),
                      ti.reshape(*lead, m, stride)], -2).reshape(*lead, n)
    return re, im


def two_pass_model(re, im, n, l1, inverse):
    """The kernel's two-launch route in plain torch, off the one table:
    launch A runs stages 0..l1-1 on each column q of the (M, Q) view (the
    twiddle of its butterfly j at stage s: entry (q + ((j >> s) << log2 Q))
    << s) and leaves each point where its column lies; launch B runs the
    length-Q Stockham on each row k of that (entry (t >> s) << (s + l1)),
    storing row k's point t at t*M + k."""
    tab = tw.radix2_twiddles(n, inverse=inverse, device="cpu")
    b = re.shape[0]
    m, q = 1 << l1, n >> l1
    qb = q.bit_length() - 1
    cols = torch.arange(q)[:, None]
    re = re.reshape(b, m, q).transpose(1, 2)       # column q's m points last
    im = im.reshape(b, m, q).transpose(1, 2)
    for s in range(l1):
        j = torch.arange(m // 2)[None, :]
        idx = (cols + ((j >> s) << qb)) << s
        re, im = _stage(re, im, tab[idx, 0], tab[idx, 1], s)
    re, im = re.transpose(1, 2), im.transpose(1, 2)  # (b, M, Q): row k
    for s in range(qb):
        idx = (torch.arange(q // 2) >> s) << (s + l1)
        re, im = _stage(re, im, tab[idx, 0], tab[idx, 1], s)
    return (re.transpose(1, 2).reshape(b, n),
            im.transpose(1, 2).reshape(b, n))


@pytest.mark.parametrize("n,l1", [(1 << 12, 5), (1 << 12, 6), (1 << 11, 5),
                                  (1 << 11, 6), (1 << 9, 1), (1 << 9, 8),
                                  (1 << 15, 8), (1 << 13, 7)])
@pytest.mark.parametrize("inverse", [False, True])
def test_two_pass_route_equals_the_stage_by_stage_oracle(n, l1, inverse):
    """Splitting the stages at l1 (odd log2 n included) changes no bit:
    the model of the two launches equals ``stockham_radix2_stages`` on the
    packed table under torch.equal."""
    rng = np.random.default_rng(n + l1)
    z = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    x = from_numpy(z, device="cpu")
    packed = tw.packed_radix2_twiddles(n, inverse=inverse, device="cpu")
    want = stockham_radix2_stages(x.re, x.im, packed.re, packed.im, n)
    got = two_pass_model(x.re, x.im, n, l1, inverse)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _r2_smem(route, lp):
    """The kernel's shared memory a block (fft_stockham_r2_pass): rows of
    pitch(n, min(lg, 3)) for the rows routes, the tile itself for
    columns, nbuf buffers of two planes."""
    lg = lp.g.bit_length() - 1
    if route == "cols":
        wf = lp.points
    else:
        wf = A.pitch(lp.n, min(lg, 3)) * lp.g
    return lp.nbuf * 2 * 4 * (-(-wf // 32) * 32)


@pytest.mark.parametrize("batch", [1, 3, 16])
def test_r2_plan_every_n(batch):
    """One rows launch up to 2^14; above, launch A on the columns of the
    (2^l1, n/2^l1) view (l1 = ceil(log2 n / 2)) and launch B on the
    batch*2^l1 rows of n/2^l1: transforms of 2^7..2^12 points, tiles the
    kernel takes."""
    for k in range(1, 25):
        n = 1 << k
        plan = S.r2_plan(batch, n)
        if n <= S.ONE_MAX:
            assert [r for r, _ in plan] == ["rows"]
            lp = plan[0][1]
            assert (lp.kind, lp.outer, lp.n, lp.inner) == ("rows", batch, n,
                                                           1)
        else:
            l1 = (k + 1) // 2
            assert [r for r, _ in plan] == ["cols", "transposed"]
            a, b = plan[0][1], plan[1][1]
            assert (a.kind, a.outer, a.n, a.inner) == ("cols", batch,
                                                       1 << l1, n >> l1)
            assert (b.kind, b.outer, b.n, b.inner) == ("rows", batch << l1,
                                                       n >> l1, 1)
            assert 4 <= a.c < a.inner and a.g == 1
            assert 8 <= a.n.bit_length() - 1 <= 12
            assert 7 <= b.n.bit_length() - 1 <= 12 and b.points <= A.TILE
        for route, lp in plan:
            assert A.MIN_POINTS <= lp.points <= A.TILE_BIG
            assert lp.threads == lp.points // 16 <= 1024
            if lp.points > A.TILE:
                assert lp.g == 1 and lp.nbuf == 1
            assert _r2_smem(route, lp) <= A.SMEM_MAX
            assert lp.tiles * lp.points >= lp.outer * lp.n * lp.inner
            assert 1 <= lp.blocks(132) <= lp.tiles


def test_r2_launches_at_the_main_shapes():
    """One grid launch up to 2^14 (2^13 the largest with two buffers a
    block), two at 2 x 2^20 (10 + 10 stages, C = 8 columns, G = 8 rows)."""
    assert len(S.r2_plan(3, 1 << 13)) == 1
    assert S.r2_plan(3, 1 << 13)[0][1].nbuf == 2
    assert S.r2_plan(3, 1 << 14)[0][1].nbuf == 1
    (ra, a), (rb, b) = S.r2_plan(2, 1 << 20)
    assert (a.n, a.inner, a.c, b.n, b.g) == (1024, 1024, 8, 1024, 8)
    for shape in [(1024, 512), (513, 1024), (1024, 1024)]:   # stockham2
        assert len(S.r2_plan(*shape)) == 1


def _recorder(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "function", lambda *a: a)
    monkeypatch.setattr(_build, "launch_all",
                        lambda fn, arg_lists, what, dev: calls.extend(
                            (fn, args, what) for args in arg_lists))
    S._launch_args.cache_clear()
    return calls


@pytest.mark.parametrize("n", [8, 1 << 14, 1 << 15, 1 << 17])
@pytest.mark.parametrize("inverse", [False, True])
def test_r2_wrapper_launches_the_plan(monkeypatch, n, inverse):
    """One call a planned launch: x -> out, or x -> scratch -> out; the one
    table; the route, l1 and grid; 1/n at the last store only."""
    calls = _recorder(monkeypatch)
    x = from_numpy(np.ones((2, n), np.complex64), device="cpu")
    out = S.fft_stockham_r2_cuda(x, inverse=inverse)
    plan = S.r2_plan(2, n)
    assert len(calls) == len(plan)
    tab = tw.radix2_twiddles(n, inverse=inverse, device="cpu")
    l1 = (n.bit_length() - 1 + 1) // 2
    for i, ((fn, args, what), (route, lp)) in enumerate(zip(calls, plan)):
        assert fn == ("fft_stockham", "fft_stockham_r2_pass", S._R2_ARGS)
        assert what == "fft_stockham_r2"
        assert len(args) == len(S._R2_ARGS) - 1
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
        assert args[11] == l1 and args[12] == lp.blocks(132)
        last = i == len(plan) - 1
        assert args[13] == (1.0 / n if inverse and last else 1.0)


def test_r2_wrapper_refuses_cpu_tensors():
    x = from_numpy(np.ones((2, 16), np.complex64), device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        S.fft_stockham_r2_cuda(x)


@pytest.mark.parametrize("n", [12, 1000, 1])
def test_r2_wrapper_refuses_non_pow2(monkeypatch, n):
    calls = _recorder(monkeypatch)
    x = from_numpy(np.ones((2, n), np.complex64), device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        S.fft_stockham_r2_cuda(x)
    assert calls == []


def test_r2_wrapper_refuses_n_past_its_limit(monkeypatch):
    """The limit is 2^36 now.  Past 2^24 the wrapper makes the three
    launches of :func:`split3` (shown on meta tensors at 2^25 and 2^27):
    launch A's route on the (M1, M2*Q) view, the middle launch on the
    (M1 images, M2, Q) view after l1 bits, launch B's route on the rows of
    Q after l1 + l2 bits, 1/n at the last store only; past 2^36 the plan
    refuses (no card holds such planes)."""
    for n in (S.TWO_MAX * 2, S.TWO_MAX * 8):
        calls = _recorder(monkeypatch)
        x = SplitComplex(torch.empty((1, n), device="meta"),
                         torch.empty((1, n), device="meta"))
        out = S.fft_stockham_r2_cuda(x, inverse=True)
        l1, l2, lq = S.split3(n, 2)
        plan = S.r2_plan(1, n)
        assert [r for r, _ in plan] == ["cols", "mid", "transposed"]
        assert [(lp.outer, lp.n, lp.inner) for _, lp in plan] == [
            (1, 1 << l1, n >> l1), (1 << l1, 1 << l2, 1 << lq),
            (1 << (l1 + l2), 1 << lq, 1)]
        assert len(calls) == 3 and out.re.shape == (1, n)
        for i, ((fn, args, what), (route, lp)) in enumerate(zip(calls,
                                                                plan)):
            assert fn == ("fft_stockham", "fft_stockham_r2_pass",
                          S._R2_ARGS)
            assert what == "fft_stockham_r2"
            assert args[10] == S._ROUTES[route]
            assert args[11] == (l1, l1, l1 + l2)[i]
            assert args[13] == (1.0 / n if i == 2 else 1.0)
    with pytest.raises(ValueError, match="2\\^36"):
        S.r2_plan(1, S.THREE_MAX * 2)


def three_pass_model(re, im, n, l1, l2, inverse):
    """The kernel's three-launch route in plain torch, off the one table:
    launch 1 is ``two_pass_model``'s launch A on the (M1, M2*Q) view;
    launch 2 runs stages l1..l1+l2-1 on each column q of image k1's
    (M2, Q) view (the twiddle of its butterfly j at stage s: entry
    (q + ((j >> s) << log2 Q)) << (s + l1)) and stores point t of (k1, q)
    at row t*M1 + k1; launch 3 runs the length-Q Stockham on each row o of
    that (entry (t >> s) << (s + l1 + l2)), storing row o's point t at
    t*M1*M2 + o; the inverse's 1/n last."""
    tab = tw.radix2_twiddles(n, inverse=inverse, device="cpu")
    b = re.shape[0]
    m1, m2 = 1 << l1, 1 << l2
    q = n >> (l1 + l2)
    qb = q.bit_length() - 1

    def stages(re, im, count, index):
        for s in range(count):
            idx = index(s)
            re, im = _stage(re, im, tab[idx, 0], tab[idx, 1], s)
        return re, im
    # launch 1: the column k of the (M1, M2*Q) view, its m1 points last
    cols = torch.arange(m2 * q)[:, None]
    j = torch.arange(m1 // 2)[None, :]
    re, im = (t.reshape(b, m1, m2 * q).transpose(1, 2) for t in (re, im))
    re, im = stages(re, im, l1, lambda s: (cols + ((j >> s) << (l2 + qb)))
                    << s)
    # launch 2: column q of image k1, its m2 points last
    re, im = (t.transpose(1, 2).reshape(b, m1, m2, q).transpose(2, 3)
              for t in (re, im))
    cols, j = torch.arange(q)[:, None], torch.arange(m2 // 2)[None, :]
    re, im = stages(re, im, l2, lambda s: (cols + ((j >> s) << qb))
                    << (s + l1))
    re, im = (t.permute(0, 3, 1, 2).reshape(b, m2 * m1, q) for t in (re, im))
    # launch 3: the rows t*M1 + k1, stored transposed
    re, im = stages(re, im, qb, lambda s: (torch.arange(q // 2) >> s)
                    << (s + l1 + l2))
    re, im = (t.transpose(1, 2).reshape(b, n) for t in (re, im))
    if inverse:
        re, im = re * (1.0 / n), im * (1.0 / n)
    return re, im


@pytest.mark.parametrize("n,l1,l2", [(8, 1, 1), (1 << 9, 3, 3),
                                     (1 << 10, 3, 4), (1 << 11, 4, 3),
                                     (1 << 12, 2, 2), (1 << 13, 5, 4),
                                     (1 << 17, None, None)])
@pytest.mark.parametrize("inverse", [False, True])
def test_per_stage_route_equals_the_plain_version(monkeypatch, n, l1, l2,
                                                  inverse):
    """The route past 2^24 (three launches, no longer a launch a stage):
    its plain-torch model equals the plain version (the stage-by-stage
    oracle on the packed table, then 1/n) under torch.equal at any split,
    odd and even log2 n; at 2^17 with TWO_MAX lowered to 2^16 the plan is
    the three launches at :func:`split3`'s split."""
    if l1 is None:
        monkeypatch.setattr(S, "TWO_MAX", 1 << 16)
        assert [r for r, _ in S.r2_plan(3, n)] == ["cols", "mid",
                                                   "transposed"]
        l1, l2, _ = S.split3(n, 2)
    rng = np.random.default_rng(n + l1)
    z = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    x = from_numpy(z, device="cpu")
    want = S.fft_stockham_r2_plain(x, inverse=inverse)
    got = three_pass_model(x.re, x.im, n, l1, l2, inverse)
    assert torch.equal(got[0], want.re) and torch.equal(got[1], want.im)
    ref = np.fft.ifft(z) if inverse else np.fft.fft(z)
    err = np.abs(got[0].numpy() + 1j * got[1].numpy() - ref).max()
    assert err <= 5e-5 * np.abs(ref).max()
