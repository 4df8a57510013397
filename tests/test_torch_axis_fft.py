"""The 2-D and 3-D FFT kernels' launch plan and twiddle tables
(``repro_torch.kernels.axis_fft``), the real-input forward's two launches,
and what their CUDA wrappers refuse, on the CPU.  The kernels themselves
run in ``tests/test_torch_cuda.py`` (on a card) and under
``tools/cuda_emu/emulate.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import SplitComplex, from_numpy
from repro_torch.kernels import _build, axis_fft as A
from repro_torch.kernels import fft2d_gemm, fft3d_fused, rfft2d_fused

POW2 = [1 << k for k in range(1, 13)]          # 2 .. 4096


@pytest.mark.parametrize("n", POW2)
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_table_within_two_ulp(n, inverse):
    """W_n^k = exp(sign*2*pi*i*k/n), k < n, in fp32 against float64: each
    entry within 2 ulp of 1 (the twiddles' magnitude)."""
    tab = A.twiddle_table(n, inverse=inverse, device="cpu").numpy()
    want = np.exp((1.0 if inverse else -1.0) * 2j * np.pi * np.arange(n) / n)
    assert tab.dtype == np.float32 and tab.shape == (n, 2)
    err = np.maximum(np.abs(tab[:, 0] - want.real),
                     np.abs(tab[:, 1] - want.imag))
    assert err.max() <= 2 * np.spacing(np.float32(1.0))


def test_twiddle_table_is_cached():
    a = A.twiddle_table(256, inverse=True, device="cpu")
    assert A.twiddle_table(256, inverse=True, device="cpu") is a
    assert A.twiddle_table(256, inverse=False, device="cpu") is not a


def _check_launch(lp):
    """The tiling rules every launch keeps (the kernel refuses others)."""
    assert lp.kind in ("rows", "cols", "plane")
    for v in (lp.n, lp.inner, lp.c, lp.g):
        assert v >= 1 and v & (v - 1) == 0
    assert A.MIN_POINTS <= lp.points <= A.TILE_BIG
    assert lp.threads == lp.points // 16 <= 1024
    assert lp.nbuf == (2 if lp.points <= A.TILE else 1)
    assert lp.smem <= A.SMEM_MAX
    assert lp.c <= lp.inner
    if lp.c < lp.inner:
        assert lp.g == 1          # columns of one image at a time
    if lp.kind == "rows":
        assert lp.inner == 1 and lp.c == 1 and lp.points <= A.TILE
    if lp.kind == "cols":
        assert lp.inner > 1
        want_c = min(lp.inner, (A.TILE if lp.n <= 1024 else A.TILE_BIG)
                     // lp.n)
        assert lp.c == want_c
        if lp.c < lp.inner:       # every row segment a whole sector but
            assert lp.c >= (8 if lp.n < 4096 else 4)     # at n = 4096
    if lp.kind == "plane":
        assert lp.c == lp.inner and lp.n * lp.inner <= A.PLANE_MAX
    # the tiles cover the view, and at most one tile's images are padding
    assert lp.tiles * lp.points >= lp.outer * lp.n * lp.inner
    assert lp.tiles >= 1 and 1 <= lp.blocks(132) <= lp.tiles


@pytest.mark.parametrize("batch", [1, 3, 16])
def test_plan2d_every_pow2_shape(batch):
    """One plane launch for h*w <= 16384, else rows along w then columns
    along h, for every power-of-two (h, w) up to 4096."""
    for h in POW2:
        for w in POW2:
            plan = A.plan2d(batch, h, w)
            if h * w <= A.PLANE_MAX:
                assert [lp.kind for lp in plan] == ["plane"]
                assert (plan[0].outer, plan[0].n, plan[0].inner) == \
                    (batch, h, w)
            else:
                assert [lp.kind for lp in plan] == ["rows", "cols"]
                assert (plan[0].outer, plan[0].n) == (batch * h, w)
                assert (plan[1].outer, plan[1].n, plan[1].inner) == \
                    (batch, h, w)
            for lp in plan:
                _check_launch(lp)


@pytest.mark.parametrize("batch", [1, 2])
def test_plan3d_every_pow2_shape(batch):
    """A plane launch and D for h*w <= 16384, else W, H and D, for every
    power-of-two (d, h, w) up to 4096 a side and 2^27 points; the
    three-launch route on request."""
    for d in POW2:
        for h in POW2:
            for w in POW2:
                if d * h * w > 1 << 27:
                    continue
                plan = A.plan3d(batch, d, h, w)
                views = [(lp.outer, lp.n, lp.inner) for lp in plan]
                if h * w <= A.PLANE_MAX:
                    assert [lp.kind for lp in plan] == ["plane", "cols"]
                    assert views == [(batch * d, h, w), (batch, d, h * w)]
                    three = A.plan3d(batch, d, h, w, planes=False)
                    assert len(three) == 3
                    plan = plan + three
                else:
                    assert [lp.kind for lp in plan] == ["rows", "cols",
                                                        "cols"]
                    assert views == [(batch * d * h, w, 1),
                                     (batch * d, h, w), (batch, d, h * w)]
                for lp in plan:
                    _check_launch(lp)


@pytest.mark.parametrize("shape,tiles", [
    # the main shapes: 8192-point tiles that overlap their copies, but the
    # 128^2 planes and columns at n >= 2048 (one 128 KB buffer)
    ((16, 1024, 1024), [("rows", 8, 1, True), ("cols", 1, 8, True)]),
    ((1, 4096, 2048), [("rows", 4, 1, True), ("cols", 1, 4, False)]),
    ((2, 8, 4), [("plane", 16, 4, True)]),
    ((1, 128, 128), [("plane", 1, 128, False)]),
    ((2, 256, 256, 256), [("rows", 32, 1, True), ("cols", 1, 32, True),
                          ("cols", 1, 32, True)]),
    ((8, 128, 128, 128), [("plane", 1, 128, False), ("cols", 1, 64, True)]),
])
def test_plan_of_main_shapes(shape, tiles):
    plan = A.plan2d(*shape) if len(shape) == 3 else A.plan3d(*shape)
    assert [(lp.kind, lp.g, lp.c, lp.nbuf == 2) for lp in plan] == tiles
    assert all(lp.blocks(132) <= 132 for lp in plan if lp.points >= 8192)


def test_plane_refuses_large_images():
    with pytest.raises(ValueError, match="h\\*w <= 16384"):
        A.plan_plane(1, 256, 128)
    with pytest.raises(ValueError, match="h\\*w <= 16384"):
        A.plan3d(1, 4, 256, 128, planes=True)


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
    rfft2d_fused._launch_args.cache_clear()
    return calls


@pytest.mark.parametrize("shape,inverse", [((2, 64, 512), False),
                                           ((2, 64, 512), True),
                                           ((3, 8, 16), True)])
def test_fft2d_wrapper_launches_the_plan(monkeypatch, shape, inverse):
    """fft2d_gemm_cuda hands the planned launches to the kernel: x -> out,
    then out -> out; the inverse's 1/(h*w) at the last; the W table for
    rows, the H table for columns, both for a plane."""
    calls = _recorder(monkeypatch)
    x = from_numpy(np.ones(shape, np.complex64), device="cpu")
    out = fft2d_gemm.fft2d_gemm_cuda(x, inverse=inverse)
    plan = A.plan2d(*shape)
    assert len(calls) == len(plan)
    b, h, w = shape
    for i, ((fn, args, what), lp) in enumerate(zip(calls, plan)):
        assert fn == ("fft2d_gemm", "fft2d_gemm_pass", A.ARGS)
        assert what == "fft2d_gemm" and len(args) == len(A.ARGS) - 1
        src = x if i == 0 else out
        assert args[:4] == [src.re.data_ptr(), src.im.data_ptr(),
                            out.re.data_ptr(), out.im.data_ptr()]
        tab = A.twiddle_table(w if lp.kind != "cols" else h, inverse=inverse,
                           device="cpu")
        assert args[4] == tab.data_ptr()
        if lp.kind == "plane":
            assert args[5] == A.twiddle_table(h, inverse=inverse,
                                           device="cpu").data_ptr()
        else:
            assert args[5] is None
        assert args[6:12] == [lp.outer, lp.n.bit_length() - 1,
                              lp.inner.bit_length() - 1,
                              lp.c.bit_length() - 1, lp.g.bit_length() - 1,
                              int(lp.kind == "plane")]
        assert args[12] == lp.blocks(132) and args[13] == int(inverse)
        last = i == len(plan) - 1
        assert args[14] == (1.0 / (h * w) if inverse and last else 1.0)
        assert args[15] == 0


@pytest.mark.parametrize("variant,mma", [("compensated", False),
                                         ("plain", True)])
def test_bf16_variants_pick_their_route(monkeypatch, variant, mma):
    """bf16 compensated runs the FFT passes (bf16 flag set); bf16 plain the
    tensor-core DFT products, one launch an axis; float32 the FFT passes
    whatever the variant."""
    calls = _recorder(monkeypatch)
    z = np.ones((2, 4, 128, 256), np.complex64)
    x = from_numpy(z, device="cpu")
    xb = SplitComplex(x.re.bfloat16(), x.im.bfloat16())
    fft3d_fused.fft3d_fused_cuda(xb, variant=variant)
    fft3d_fused.fft3d_fused_cuda(x, variant=variant)
    if mma:
        assert [c[0][1] for c in calls[:3]] == ["fft3d_fused_plain_pass"] * 3
        assert all(c[0][1] == "fft3d_fused_pass" for c in calls[3:])
        assert len(calls) == 3 + 3
    else:
        assert [c[0][1] for c in calls] == ["fft3d_fused_pass"] * 6
        assert [c[1][15] for c in calls] == [1, 1, 1, 0, 0, 0]


def test_unaligned_planes_are_copied():
    base = torch.zeros(2 * 64 + 1)
    x = SplitComplex(base[1:65].view(1, 8, 8), base[65:].view(1, 8, 8))
    y = A.aligned(x)
    assert all(p.data_ptr() % 16 == 0 for p in y)
    assert torch.equal(y.re, x.re) and torch.equal(y.im, x.im)
    z = SplitComplex(torch.zeros(1, 8, 8), torch.zeros(1, 8, 8))
    assert A.aligned(z) is z


_WRAPPERS = [(fft2d_gemm.fft2d_gemm_cuda, (1, 8, 8), (1, 8, 12)),
             (fft3d_fused.fft3d_fused_cuda, (1, 4, 8, 8), (1, 4, 6, 8))]


@pytest.mark.parametrize("launch,shape,bad", _WRAPPERS)
def test_wrappers_refuse_cpu_tensors(launch, shape, bad):
    x = from_numpy(np.ones(shape, np.complex64), device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        launch(x)


@pytest.mark.parametrize("launch,shape,bad", _WRAPPERS)
def test_wrappers_refuse_float16(launch, shape, bad):
    """float16 in both variants passes the dtype checks (the plain one on
    the tensor cores since ROADMAP §2e, the compensated one, the plans'
    variant, since F11) and is refused here only for lying on the CPU."""
    x = SplitComplex(torch.zeros(shape, dtype=torch.float16),
                     torch.zeros(shape, dtype=torch.float16))
    for variant in ("plain", "compensated"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            launch(x, variant=variant)


@pytest.mark.parametrize("launch,shape,bad", _WRAPPERS)
def test_wrappers_refuse_non_pow2_dims(monkeypatch, launch, shape, bad):
    """Past the operand checks, a dim that is no power of two raises before
    any launch."""
    calls = _recorder(monkeypatch)
    x = from_numpy(np.ones(bad, np.complex64), device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        launch(x)
    assert calls == []


@pytest.mark.parametrize("launch,shape,bad", _WRAPPERS)
def test_wrappers_refuse_unknown_variant(launch, shape, bad):
    x = from_numpy(np.ones(shape, np.complex64), device="cpu")
    with pytest.raises(ValueError, match="variant must be one of"):
        launch(x, variant="fast")


# -- the real-input forward's launches ---------------------------------------

def _check_half_cols(lp, batch, h, width):
    """The ragged column plan: every one of the ``width`` columns of each
    image in exactly one tile, rows of 16 bytes (or whole images of a
    power-of-two pitch), tiles the kernel takes."""
    assert (lp.kind, lp.outer, lp.n) == ("cols", batch, h)
    assert lp.c & (lp.c - 1) == 0 and lp.g & (lp.g - 1) == 0
    assert A.MIN_POINTS <= lp.points <= A.TILE_BIG
    assert lp.threads == lp.points // 16 <= 1024
    if lp.points > A.TILE:
        assert h >= 2048 and lp.nbuf == 1
    assert lp.smem <= A.SMEM_MAX
    tpi = -(-lp.inner // lp.c)
    if lp.c == lp.inner:          # whole images, pitch a power of two
        assert lp.inner == 1 << (width - 1).bit_length()
        assert h * lp.inner <= (A.TILE if h <= 1024 else A.TILE_BIG)
    else:                         # C columns, the last tile ragged
        assert lp.g == 1 and lp.c >= 4 and lp.c < width
        align = min(lp.c, 8)            # no segment straddles a sector
        assert lp.inner % align == 0 and width <= lp.inner < width + align
        assert lp.c == (A.TILE if h <= 1024 else A.TILE_BIG) // h
    covered = np.zeros(width, int)
    for t in range(tpi):
        cols = np.arange(t * lp.c, (t + 1) * lp.c)
        assert cols[0] < width            # every tile stores a column
        covered[cols[cols < width]] += 1
    assert (covered == 1).all()
    assert lp.tiles == -(-batch // lp.g) * tpi
    assert 1 <= lp.blocks(132) <= lp.tiles


@pytest.mark.parametrize("batch", [1, 3, 16])
def test_rfft2_plan_every_pow2_shape(batch):
    """Two launches at every power-of-two (h, w) up to 4096: the rows route
    on the batch*h/2 packed rows of w, then the column pass on the w/2+1
    columns of the scratch."""
    for h in POW2:
        for w in POW2:
            rows, cols = rfft2d_fused.plan(batch, h, w)
            assert (rows.kind, rows.outer, rows.n, rows.inner) == (
                "rows", batch * h // 2, w, 1)
            _check_launch(rows)
            _check_half_cols(cols, batch, h, w // 2 + 1)


@pytest.mark.parametrize("shape,want", [
    # (rows G, cols C, G, pitch, tiles): 16x1024^2 in 65 column tiles an
    # image, 1.4 % of the bins read padding; a ragged last tile at h != w;
    # h = 4096 in 4-column tiles; small images whole
    ((16, 1024, 1024), (8, 8, 1, 520, 16 * 65)),
    ((1, 1024, 1024), (8, 8, 1, 520, 65)),
    ((3, 256, 512), (16, 32, 1, 264, 3 * 9)),
    ((2, 512, 64), (128, 16, 1, 40, 2 * 3)),
    ((1, 4096, 2048), (4, 4, 1, 1028, 257)),
    ((3, 8, 4), (128, 4, 16, 4, 1)),
    ((2, 2, 2), (256, 2, 128, 2, 1)),
])
def test_rfft2_plan_of_checked_shapes(shape, want):
    rows, cols = rfft2d_fused.plan(*shape)
    assert (rows.g, cols.c, cols.g, cols.inner, cols.tiles) == want


def test_half_cols_plan_any_width():
    """Widths that are no half spectrum's too (the inverse's column pass
    will take the user's pitch-c spectra)."""
    for h in POW2:
        for width in (1, 2, 3, 7, 100, 513, 1025, 2049):
            _check_half_cols(A.plan_half_cols(2, h, width), 2, h, width)


@pytest.mark.parametrize("shape", [(2, 64, 512), (3, 8, 4), (1, 2048, 16)])
def test_rfft2d_wrapper_launches_the_plan(monkeypatch, shape):
    """rfft2d_fused_cuda hands the kernel x, the output planes, a scratch
    pair of batch*h*pitch floats, the W and H tables and the plan."""
    calls = _recorder(monkeypatch)
    scratch = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: scratch.append(
        empty(*a, **k)) or scratch[-1])
    b, h, w = shape
    x = torch.zeros(shape)
    out = rfft2d_fused.rfft2d_fused_cuda(x)
    rows, cols = rfft2d_fused.plan(*shape)
    assert out.shape == (b, h, w // 2 + 1)
    (fn, args, what), = calls
    assert fn == ("rfft2d_fused", "rfft2d_fused_pass",
                  rfft2d_fused._ARGS)
    assert len(args) == len(rfft2d_fused._ARGS) - 1
    s0, s1 = scratch[-2:]
    assert s0.numel() == s1.numel() == b * h * cols.inner
    assert args[:7] == [x.data_ptr(), out.re.data_ptr(), out.im.data_ptr(),
                        s0.data_ptr(), s1.data_ptr(),
                        A.twiddle_table(w, device="cpu").data_ptr(),
                        A.twiddle_table(h, device="cpu").data_ptr()]
    lg = lambda v: v.bit_length() - 1              # noqa: E731
    assert args[7:] == [b, lg(h), lg(w), cols.inner, lg(rows.g),
                        rows.blocks(132), lg(cols.c), lg(cols.g),
                        cols.blocks(132), 0]


def test_rfft2d_wrapper_refuses(monkeypatch):
    """CPU tensors; then, past the operand checks, dims that are no power
    of two, before any launch.  An axis past 4096 is no refusal: the
    wrapper launches the split steps (:func:`rfft2d_fused.steps`)."""
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rfft2d_fused.rfft2d_fused_cuda(torch.zeros(1, 8, 8))
    calls = _recorder(monkeypatch)
    for shape in [(1, 8, 12), (1, 6, 8)]:
        with pytest.raises(ValueError, match="power-of-two"):
            rfft2d_fused.rfft2d_fused_cuda(torch.zeros(shape))
    assert calls == []
    rfft2d_fused.rfft2d_fused_cuda(torch.empty((1, 2, 8192), device="meta"))
    symbols = [fn[1] for fn, _, _ in calls]
    assert symbols == ["rfft2d_axis_pass", "rfft2d_axis_pass",
                       "rfft2d_untangle", "rfft2d_cols_pass"]
