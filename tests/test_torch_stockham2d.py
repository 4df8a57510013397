"""The fused Stockham 2-D kernel's host side (the ``algo="fused_stockham"``
oracle, ``csrc/fft2d_fused.cu``) on the CPU: its two launches and their
tiles for every power-of-two shape it takes, its one (3, n/4) table per
axis against the packed table the plain version reads, a plain-torch model
of the two passes against the plain version, the wrapper's calls and its
refusals.  The kernel itself runs in ``tests/test_torch_cuda.py`` (on a
card), under ``tools/cuda_emu/emulate.py`` and in ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from repro.core import twiddle as ref_tw
from repro_torch.core import from_numpy
from repro_torch.core import twiddle as tw
from repro_torch.core.complexmath import SplitComplex
from repro_torch.core.fft1d import stockham_stages
from repro_torch.kernels import _build, axis_fft as A, fft2d_fused as S2

DIMS = [1 << k for k in range(1, 13)]
# chip_smoke.py's CHECKS shapes of the kernel
CHECKS = [(16, 1024, 1024), (2, 8, 16), (1, 64, 32), (1, 256, 256),
          (3, 2, 4096), (1, 4096, 2048)]


def _lg(n):
    return n.bit_length() - 1


def _smem(route, lp):
    """``fft2d_fused_pass``'s shared memory a block: rows of pitch
    pitch(w, min(lg, 3)), or the columns tile itself, nbuf buffers of two
    planes."""
    if route == "rows":
        return S2.rows_smem(lp.n, lp.g)
    return lp.nbuf * 2 * 4 * (-(-lp.points // 32) * 32)


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("h", DIMS)
def test_plan_every_shape(batch, h):
    """Rows then columns for every (h, w) in [2, 4096]^2: tiles the kernel
    takes (512..16384 points, 16 a thread, at most 8192 for rows), within
    shared memory, covering every point; columns whole (n = h), C adjacent
    columns of one image or G whole images where w < C, C >= 8 up to
    h = 2048 and 4 at 4096; 16384-point tiles (one buffer) only for
    columns of 2048 and 4096."""
    for w in DIMS:
        (rr, rows), (rc, cols) = S2.plan(batch, h, w)
        assert (rr, rc) == ("rows", "cols")
        assert (rows.kind, rows.outer, rows.n, rows.inner, rows.c) == (
            "rows", batch * h, w, 1, 1)
        assert (cols.kind, cols.outer, cols.n, cols.inner) == (
            "cols", batch, h, w)
        assert A.MIN_POINTS <= rows.points <= A.TILE
        assert A.MIN_POINTS <= cols.points <= A.TILE_BIG
        for route, lp in ((rr, rows), (rc, cols)):
            assert lp.threads == lp.points // 16 <= 1024
            assert _smem(route, lp) <= A.SMEM_MAX
            assert lp.tiles * lp.points >= lp.outer * lp.n * lp.inner
            assert 1 <= lp.blocks(132) <= lp.tiles
        if cols.c < w:
            assert cols.g == 1 and cols.c * h == (
                A.TILE if h <= 1024 else A.TILE_BIG)
            assert cols.c >= (8 if h <= 2048 else 4)
        else:
            assert cols.c == w
        if cols.points > A.TILE:     # one 16384-point buffer
            assert cols.nbuf == 1 and h >= 2048


@pytest.mark.parametrize("shape,rows_g,cols_c,cols_g", [
    ((16, 1024, 1024), 8, 8, 1), ((2, 8, 16), 32, 16, 4),
    ((1, 64, 32), 64, 32, 1), ((1, 256, 256), 32, 32, 1),
    ((3, 2, 4096), 2, 4096, 1), ((1, 4096, 2048), 4, 4, 1)])
def test_plan_at_the_checked_shapes(shape, rows_g, cols_c, cols_g):
    """The tiles (G rows; C columns of G images) of every CHECKS shape:
    the main shape's 8 rows and 8 columns (32-byte segments, two buffers),
    whole images at (2, 8, 16) and h = 2, 4-column tiles at h = 4096."""
    (_, rows), (_, cols) = S2.plan(*shape)
    assert (rows.g, cols.c, cols.g) == (rows_g, cols_c, cols_g)
    assert rows.nbuf == 2
    assert cols.nbuf == (1 if shape[1] == 4096 else 2)


def test_narrow_rows_halve_their_tile():
    """At w = 2 and 4 the padded row pitch would take 393 and 262 KB for
    plan_axis's 8192-point tile: the plan halves G until it fits."""
    for w, g in ((2, 2048), (4, 1024)):
        (_, rows), _ = S2.plan(4096, 2, w)
        assert rows.g == g and S2.rows_smem(w, g) <= A.SMEM_MAX
        assert S2.rows_smem(w, 2 * g) > A.SMEM_MAX


@pytest.mark.parametrize("n", [2, 8, 1024, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_one_table_equals_the_packed_table(n, inverse):
    """Each launch's one (3, n/4) table, read at (j >> 2s) << 2s, is row s
    of the reference's packed (s4, 3, n/4) table bit for bit, in float64
    and after the fp32 cast; the wrapper's tables are w's then h's."""
    (one,) = tw.radix4_twiddles_np(n, inverse)
    wr, wi = ref_tw.packed_radix4_twiddles_np(n, inverse)
    card = tw.radix4_twiddles(n, inverse=inverse, device="cpu")
    packed = tw.packed_radix4_twiddles(n, inverse=inverse, device="cpu")
    assert card.shape == (3, max(n // 4, 1), 2)
    j = np.arange(max(n // 4, 1))
    for s in range(wr.shape[0]):
        idx = (j >> (2 * s)) << (2 * s)
        assert np.array_equal(wr[s], one[:, idx, 0])
        assert np.array_equal(wi[s], one[:, idx, 1])
        assert torch.equal(packed.re[s], card[:, torch.from_numpy(idx), 0])
        assert torch.equal(packed.im[s], card[:, torch.from_numpy(idx), 1])
    th, tw_ = S2.tables(n, 2 * n, inverse, "cpu")
    assert th is tw.radix4_twiddles(2 * n, inverse=inverse, device="cpu")
    assert tw_ is card


@pytest.mark.parametrize("shape", [(2, 8, 16), (1, 32, 4), (2, 2, 64),
                                   (1, 128, 32)])
@pytest.mark.parametrize("inverse", [False, True])
def test_two_passes_equal_the_plain_version(shape, inverse):
    """The kernel's two launches in plain torch: the stages of length w on
    every row, then the stages of length h on every column, each off the
    one table re-indexed as the kernel reads it, 1/(h*w) at the second
    store; equal (torch.equal) to the plain version, which transposes."""
    b, h, w = shape
    rng = np.random.default_rng(3)
    x = from_numpy(rng.standard_normal(shape)
                   + 1j * rng.standard_normal(shape), device="cpu")

    def packed_from_one(n):
        card = tw.radix4_twiddles(n, inverse=inverse, device="cpu")
        j = torch.arange(max(n // 4, 1))
        rows = [card[:, (j >> (2 * s)) << (2 * s)]
                for s in range(max(1, _lg(n) // 2))]
        t = torch.stack(rows)
        return t[..., 0], t[..., 1]

    wr, wi = packed_from_one(w)
    re, im = stockham_stages(x.re, x.im, wr, wi, w, tw.stockham_radices(w),
                             inverse=inverse)
    hr, hi = packed_from_one(h)
    re, im = stockham_stages(re.transpose(-1, -2), im.transpose(-1, -2), hr,
                             hi, h, tw.stockham_radices(h), inverse=inverse)
    re, im = re.transpose(-1, -2), im.transpose(-1, -2)
    if inverse:
        re, im = re * (1.0 / (h * w)), im * (1.0 / (h * w))
    want = S2.fft2d_fused_plain(x, inverse=inverse)
    assert torch.equal(re.contiguous(), want.re)
    assert torch.equal(im.contiguous(), want.im)


def _recorder(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "function", lambda *a: a)
    monkeypatch.setattr(_build, "launch_all",
                        lambda fn, arg_lists, what, dev: calls.extend(
                            (fn, args, what) for args in arg_lists))
    S2._launch_args.cache_clear()
    return calls


@pytest.mark.parametrize("shape", CHECKS)
@pytest.mark.parametrize("inverse", [False, True])
def test_wrapper_launches_the_plan(monkeypatch, shape, inverse):
    """Two calls: rows x -> out off w's table (the 1-D kernel's rows route,
    ``fft2d_fused_1d``), columns out -> out off h's (``fft2d_fused_pass``);
    each launch's view, tiling, route and grid; 1/(h*w) at the column
    store only; the transform's sign, then the bf16 flag, last."""
    calls = _recorder(monkeypatch)
    x = SplitComplex(torch.zeros(shape), torch.zeros(shape))
    out = S2.fft2d_fused_cuda(x, inverse=inverse)
    b, h, w = shape
    assert len(calls) == 2
    tabs = S2.tables(h, w, inverse, "cpu")
    outp = [out.re.data_ptr(), out.im.data_ptr()]
    for i, ((fn, args, what), (route, lp)) in enumerate(
            zip(calls, S2.plan(*shape))):
        if route == "rows":       # the 1-D kernel's rows route
            assert fn == ("fft2d_fused", "fft2d_fused_1d", S2._1D_ARGS)
        else:
            assert fn == ("fft2d_fused", "fft2d_fused_pass", S2._ARGS)
        assert what == "fft2d_fused" and len(args) == len(fn[2]) - 1
        src = [x.re.data_ptr(), x.im.data_ptr()] if i == 0 else outp
        assert args[:5] == src + outp + [tabs[i].data_ptr()]
        assert tabs[i].shape == (3, max(lp.n // 4, 1), 2)
        assert args[5:10] == [lp.outer, _lg(lp.n), _lg(lp.inner), _lg(lp.c),
                              _lg(lp.g)]
        if route == "rows":
            assert args[10:13] == [0, 0, 0]        # ST_ROWS, l1, lin
            args = args[:10] + args[13:]
        assert args[10] == lp.blocks(132)
        assert args[11] == (1.0 / (h * w) if inverse and i == 1 else 1.0)
        assert args[12] == int(inverse) and args[13] == 0


def test_wrapper_refuses_cpu_tensors():
    x = from_numpy(np.ones((1, 8, 8), np.complex64), device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        S2.fft2d_fused_cuda(x)


@pytest.mark.parametrize("shape", [(1, 12, 8), (1, 8, 1), (1, 6, 8),
                                   (1, 8, 24)])
def test_wrapper_refuses_shapes_it_does_not_take(monkeypatch, shape):
    """Dims that are no power of two >= 2, before any launch (an axis past
    4096 takes the long-axis routes: the tests below)."""
    calls = _recorder(monkeypatch)
    x = SplitComplex(torch.zeros(shape), torch.zeros(shape))
    with pytest.raises(ValueError, match="power-of-two"):
        S2.fft2d_fused_cuda(x)
    assert calls == []
