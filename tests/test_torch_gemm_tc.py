"""The plain-variant bfloat16 and float16 route of the 2-D and 3-D GEMM
transforms on the tensor cores (``kernels/dft_mma.py``,
``csrc/dft_mma.cuh``): its host plan for every power-of-two axis, its
tables against the plain versions' rounded tables, and its kernels run on
the CPU under ``tools/cuda_emu/emulate.py`` (ldmatrix and mma.sync with
the PTX fragment layouts) against the plain versions within 2^-7 (bf16)
and 2^-10 (float16) of max|plain|, both directions.  The long-axis
route's tiled products are held in the same way by the
``test_torch_gemm_tc_long*.py`` files, a file a shape group so that
``--dist loadfile`` spreads them over workers.  The kernels' arithmetic on
the card is checked by ``chip_smoke.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _emulated import TOL, emulated_fixture, planes, rel
from repro_torch.kernels import _build, dft_mma as D
from repro_torch.kernels import fft2d_gemm as G
from repro_torch.kernels import fft3d_fused as V
from repro_torch.kernels.rfft2d_fused import fourstep_factors

POW2 = [1 << i for i in range(1, 27)]
SMEM_MAX = 232448                  # the dynamic shared memory of a block

emulated = emulated_fixture("fft2d_gemm", "fft3d_fused")


@pytest.fixture(scope="module")
def geometry(emulated):
    """A launch's :class:`~repro_torch.kernels.dft_mma.Geometry` on 132
    SMs, as the kernel's source sizes it (the emulated library's query)."""
    fn = _build.function("fft2d_gemm", "fft2d_gemm_plain_geometry",
                         D.GEOMETRY_ARGS)
    return lambda lp: D.geometry(fn, lp, 132)


def _check(geo, lp: D.Launch) -> None:
    g = geo(lp)
    assert g.smem <= SMEM_MAX and g.tiles >= 1 and 1 <= g.blocks <= g.tiles
    assert g.threads in (256, 512)
    if lp.route in ("rows", "cols"):
        assert lp.lines & (lp.lines - 1) == 0
        assert lp.lines >= (8 if lp.route == "cols" else 1)
    else:
        assert lp.lines == 0 and g.smem == 0 and g.threads == 256


@pytest.mark.parametrize("factors", [fourstep_factors,
                                     V.fourstep_factors3],
                         ids=["2d", "3d"])
def test_plan_takes_every_axis(geometry, factors):
    """Every power-of-two axis from 2 to 2^26, as rows and as columns (of
    2 and of 4096 columns): one launch up to rows_max (rows) or cols_max
    (columns) points and for every dense axis, else the two long-axis
    products through the scratch pair; every launch the source takes, in
    a block's shared memory."""
    lim = D.LIMITS
    for n in POW2:
        n1, n2 = factors(n)
        rows = D.axis_launches(16, n, 1, (n1, n2), src=0)
        one = n1 == 1 or n <= lim.rows_max
        assert [lp.route for lp in rows] == (["rows"] if one
                                             else ["long1", "long2"])
        assert [(lp.src, lp.dst) for lp in rows] == (
            [(0, 1)] if one else [(0, 2), (2, 1)])
        for inner in (2, 4096):
            cols = D.axis_launches(2, n, inner, (n1, n2))
            one = n1 == 1 or n <= lim.cols_max
            assert [lp.route for lp in cols] == (["cols"] if one
                                                 else ["long1", "long2"])
            for lp in cols:
                _check(geometry, lp)
        for lp in rows:
            _check(geometry, lp)
            if lp.route == "rows":
                assert lp.lines == min(max(1, lim.tile // max(n, 8)), 16)


def test_plan_launches_at_the_main_cells(geometry):
    """2 launches at 16 x 1024^2 (rows, then columns in place) and 3 at
    2 x 256^3, each a four-step axis in tiles of 8192 points, two
    persistent blocks an SM."""
    p2 = D.plan2d(16, 1024, 1024, fourstep_factors)
    assert [(lp.route, lp.lines, lp.src, lp.dst, lp.two) for lp in p2] == [
        ("rows", 8, 0, 1, True), ("cols", 8, 1, 1, True)]
    p3 = D.plan3d(2, 256, 256, 256, V.fourstep_factors3)
    assert [(lp.route, lp.outer, lp.inner, lp.lines, lp.src) for lp in p3] \
        == [("rows", 2 * 256 * 256, 1, 32, 0), ("cols", 512, 256, 32, 1),
            ("cols", 2, 65536, 32, 1)]
    for lp in p2 + p3:   # two 8192-point input buffers, U, the twiddle
        g = geometry(lp)
        assert (g.nbuf, g.threads, g.blocks) == (2, 256, 2 * 132)
        assert g.smem == 4 * (3 * 8192 + lp.n) + 16
    assert sum(lp.flops for lp in p2) == 16 * 1024 ** 2 * 2 * 8 * 64


@pytest.mark.parametrize("dims", [2, 3])
def test_no_shape_the_chain_took_raises(geometry, dims):
    """The GEMM chain took every power-of-two shape its int sizes hold;
    the plan and the kernel's source take an axis of every power of two
    up to 2^30 beside axes of 2."""
    for n in [1 << i for i in range(1, 31)]:
        for pos in range(dims):
            shape = [2] * dims
            shape[pos] = n
            plan = (D.plan2d(1, *shape, fourstep_factors) if dims == 2
                    else D.plan3d(1, *shape, V.fourstep_factors3))
            assert plan
            for lp in plan:
                _check(geometry, lp)


def _unpack(flat: np.ndarray, f: int) -> np.ndarray:
    """The (2, 16*blocks, 2p) real table from its fragment order, element
    by element from the PTX layout of mma.m16n8k16's A fragment."""
    p = max(8, f)
    mbs, kcs = -(-f // 16), 2 * p // 16
    big = np.full((2, mbs * 16, 2 * p), np.nan)
    i = 0
    for mb in range(mbs):
        for part in range(2):
            for kc in range(kcs):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for reg in range(4):        # a0 .. a3
                        row = g + 8 * (reg & 1)
                        for half in range(2):
                            col = 2 * t + half + 8 * (reg >> 1)
                            big[part, mb * 16 + row, kc * 16 + col] = flat[i]
                            i += 1
    assert i == flat.size
    return big


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n,factors", [(4, (1, 4)), (16, (1, 16)),
                                       (512, (16, 32)), (256, (16, 16))])
def test_tables_are_the_plain_tables(n, factors, dtype):
    """The storage-dtype tables hold exactly the plain version's rounded
    tables (``axis_tables(..., "plain")``): [[Wr, -Wi], [Wi, Wr]] with the
    imaginary block negated bit for bit, zero padding, and the twiddle."""
    for inverse in (False, True):
        a1, tr, ti, a2 = D.tables(n, factors, inverse, dtype, "cpu")
        w1r, w1i, w2r, w2i, twr, twi = G.axis_tables(n, factors, inverse,
                                                     dtype, "plain", "cpu")
        pairs = [(a2, w2r, w2i)]
        if factors[0] > 1:
            pairs.append((a1, w1r, w1i))
            assert torch.equal(tr, twr.to(dtype)) and torch.equal(
                ti, twi.to(dtype))
        else:
            assert a1 is None and tr is None
        for flat, wr, wi in pairs:
            assert flat.dtype == dtype
            f = wr.shape[0]
            p = max(8, f)
            big = torch.from_numpy(_unpack(flat.double().numpy(), f))
            want = torch.zeros(big.shape, dtype=torch.float64)
            want[0, :f, :f], want[0, :f, p:p + f] = wr.double(), -wi.double()
            want[1, :f, :f], want[1, :f, p:p + f] = wi.double(), wr.double()
            assert torch.equal(big, want)
            neg = big[0, :f, p:p + f].to(dtype).view(torch.int16)
            assert torch.equal(neg, (-wi.to(dtype)).view(torch.int16))


def _against_plain(shape, dtype):
    kern, plain = ((G.fft2d_gemm_cuda, G.fft2d_gemm_plain) if len(shape) == 3
                   else (V.fft3d_fused_cuda, V.fft3d_fused_plain))
    x = planes(shape, dtype, sum(shape))
    for inverse in (False, True):
        got = kern(x, inverse=inverse, variant="plain")
        want = plain(x, inverse=inverse, variant="plain")
        assert got.re.dtype == dtype and got.re.shape == x.re.shape
        assert rel(got, want) <= TOL[dtype], (shape, dtype, inverse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(2, 8, 16), (1, 32, 64), (1, 512, 16),
                                   (1, 4, 8, 16), (1, 2, 2, 256)])
def test_kernels_match_the_plain_version(emulated, shape, dtype):
    """Dense axes (2 .. 64 points: rows of 8 and 16, columns of 2 .. 8
    padded to 8), four-step axes with n1 < n2 (512 = 16 x 32 columns) and
    equal factors (256 = 16 x 16 rows), in one launch an axis."""
    _against_plain(shape, dtype)


@pytest.mark.parametrize("shape,entry,grids", [
    ((2, 8, 16), "fft2d_gemm_plain_pass", 2),
    ((1, 4, 8, 16), "fft3d_fused_plain_pass", 3)])
def test_grid_launches_are_counted_where_they_happen(emulated, shape, entry,
                                                     grids):
    """A wrapper call counts one call of the C entry an axis (one grid
    launch each) in ``_build.CALLS``, which ``ops.reset_launches`` sets to
    0 with the wrappers' counts."""
    from repro_torch.kernels import ops
    x = planes(shape, torch.bfloat16, 3)
    ops.reset_launches()
    assert not _build.CALLS
    (G.fft2d_gemm_cuda if len(shape) == 3 else V.fft3d_fused_cuda)(
        x, variant="plain")
    assert dict(_build.CALLS) == {entry: grids}
    ops.reset_launches()
    assert not _build.CALLS
