"""The 2-D real-input slice on the CPU: the fused real-input kernels' plain
versions against the reference Pallas kernels in interpret mode, rfft2 /
irfft2 end to end on both backends, and 2-D rfft plan parity, on the same
seeded inputs.  On CPU tensors the cuda backend runs each kernel's plain
version.

Tolerances, as max error / max |reference|: 1e-5 for the 2-D transforms
against the reference kernels and float64 numpy (the 2-D kernels' bound in
test_torch_kernels.py: the same fp32 arithmetic, summed in another order),
5e-5 where the row-column schedule runs 1-D passes, and 1e-4 for round
trips against the input; plan resolution must agree field by field."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import plan as RP
from repro.core.complexmath import SplitComplex as RefSplit
from repro.kernels import ops as ref_ops
from repro.kernels import rfft2d_fused as ref_rfused
import repro_torch.core as core
from repro_torch.core import fft2d, from_numpy, to_complex
from repro_torch.core import plan as P
from repro_torch.kernels import ops, rfft2d_fused

TOL_2D = 1e-5
TOL_1D = 5e-5
TOL_ROUNDTRIP = 1e-4
BACKENDS = [("pallas", "cuda"), ("jnp", "torch")]


@pytest.fixture(autouse=True)
def _fresh_registries():
    RP.clear_plan_cache()
    P.clear_plan_cache()
    yield
    RP.clear_plan_cache()
    P.clear_plan_cache()


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _ref(y):
    return np.asarray(y.re) + 1j * np.asarray(y.im)


def _ref_in(z):
    return RefSplit(jnp.asarray(z.real), jnp.asarray(z.imag))


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("hw", [(2, 2), (8, 4), (4, 8), (64, 128),
                                (256, 256)])
def test_rfft2d_plain_matches_reference_kernel(hw):
    x = _real((2, *hw), seed=hw[1])
    got = to_complex(rfft2d_fused.rfft2d_fused_plain(_t(x))).numpy()
    ref = _ref(ref_rfused.rfft2d_fused_pallas(jnp.asarray(x),
                                              interpret=True))
    assert got.shape == (2, hw[0], hw[1] // 2 + 1)
    assert _rel(got, ref) <= TOL_2D
    assert _rel(got, np.fft.rfft2(x)) <= TOL_2D


@pytest.mark.parametrize("hw", [(2, 2), (8, 4), (4, 8), (64, 128),
                                (256, 256)])
def test_irfft2d_plain_matches_reference_kernel(hw):
    """An arbitrary half spectrum: its DC and Nyquist bins carry imaginary
    parts that both kernels must drop."""
    zf = _rand((2, hw[0], hw[1] // 2 + 1), seed=hw[0])
    got = rfft2d_fused.irfft2d_fused_plain(
        from_numpy(zf, device="cpu")).numpy()
    ref = np.asarray(ref_rfused.irfft2d_fused_pallas(_ref_in(zf),
                                                     interpret=True))
    assert got.shape == (2, *hw)
    assert _rel(got, ref) <= TOL_2D
    assert _rel(got, np.fft.irfft2(zf, s=hw)) <= TOL_2D


@pytest.mark.parametrize("lead", [(0,), (2, 0), (2, 3)])
def test_ops_wrappers_flatten_and_empty_batch_like_reference(lead):
    x = _real((*lead, 4, 8), seed=1)
    got = ops.rfft2d_fused(_t(x))
    ref = ref_ops.rfft2d_fused(jnp.asarray(x))
    assert got.shape == tuple(ref.re.shape)
    scale = np.abs(_ref(ref)).max(initial=1.0)
    assert np.abs(to_complex(got).numpy() - _ref(ref)).max(initial=0.0) \
        <= TOL_2D * scale
    back = ops.irfft2d_fused(got)
    ref_back = np.asarray(ref_ops.irfft2d_fused(ref))
    assert back.shape == ref_back.shape
    assert np.abs(back.numpy() - ref_back).max(initial=0.0) <= TOL_ROUNDTRIP


@pytest.mark.parametrize("fn,arg", [
    (rfft2d_fused.rfft2d_fused_cuda, lambda: _t(_real((1, 8, 8), 0))),
    (rfft2d_fused.irfft2d_fused_cuda,
     lambda: from_numpy(_rand((1, 8, 5), 0), device="cpu"))])
def test_rfft2d_cuda_wrappers_refuse_cpu_tensors(fn, arg):
    """The CUDA launchers never fall back: a CPU tensor is refused."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(arg())


@pytest.mark.parametrize("shape", [(1, 6, 8), (1, 8, 12), (1, 1, 8)])
def test_rfft2d_wrappers_refuse_non_pow2_dims(shape):
    with pytest.raises(ValueError, match="power-of-two"):
        ops.rfft2d_fused(_t(_real(shape, 0)))


@pytest.mark.parametrize("shape", [(3, 8, 16), (2, 64, 128), (2, 12, 20),
                                   (1, 256, 256)])
@pytest.mark.parametrize("backends", BACKENDS)
def test_rfft2_irfft2_match_reference(shape, backends):
    """rfft2/irfft2 through the registry: (12, 20) demotes on the kernel
    backend with the reference's reason."""
    x = _real(shape, seed=shape[-1])
    got = to_complex(core.rfft2(_t(x), backend=backends[1])).numpy()
    ref = _ref(ref_core.rfft2(jnp.asarray(x), backend=backends[0]))
    assert _rel(got, ref) <= TOL_2D
    assert _rel(got, np.fft.rfft2(x)) <= TOL_2D
    back = core.irfft2(from_numpy(got, device="cpu"),
                       backend=backends[1]).numpy()
    ref_back = np.asarray(ref_core.irfft2(_ref_in(got),
                                          backend=backends[0]))
    assert _rel(back, ref_back) <= TOL_2D
    assert _rel(back, x) <= TOL_ROUNDTRIP
    plan = P.get_plan(shape[-2:], kind="rfft", backend=backends[1])
    ref_plan = RP.get_plan(shape[-2:], kind="rfft", backend=backends[0])
    assert plan.demote_reason == ref_plan.demote_reason


@pytest.mark.parametrize("s", [(8, 8), (16, 32), (8, 15), (5, 9), (16, 16),
                               (6, 4)])
@pytest.mark.parametrize("backends", BACKENDS)
def test_irfft2_s_fits_and_odd_widths(s, backends):
    """s= truncates or pads both axes first; (16, 16) truncates the width
    so the new Nyquist bin is complex, and odd widths take the direct
    path (numpy semantics)."""
    zf = _rand((2, 16, 17), seed=sum(s))
    got = core.irfft2(from_numpy(zf, device="cpu"), s=s,
                      backend=backends[1]).numpy()
    assert got.shape == (2, *s)
    want = np.fft.irfft2(zf, s=s)
    assert _rel(got, want) <= TOL_2D
    ref = np.asarray(ref_core.irfft2(_ref_in(zf), s=s, backend=backends[0]))
    assert _rel(got, ref) <= TOL_2D


def test_nonzero_imaginary_nyquist_does_not_leak_between_rows():
    """After the inverse column pass the DC and Nyquist bins of ``zf`` have
    imaginary parts; ``clean`` differs from it only there (its DC and
    Nyquist columns are the transforms of the real parts).  The C2R
    convention drops those parts, so the outputs must agree: a kept
    imaginary Nyquist would leak row 2j+1's residue into row 2j."""
    zf = _rand((1, 8, 5), seed=3)
    clean = zf.copy()
    for col in (0, -1):
        column = np.fft.ifft(zf[..., col], axis=-1)
        clean[..., col] = np.fft.fft(column.real, axis=-1)
    for backend in ("cuda", "torch"):
        a = core.irfft2(from_numpy(zf, device="cpu"), backend=backend)
        b = core.irfft2(from_numpy(clean, device="cpu"), backend=backend)
        assert _rel(a.numpy(), b.numpy()) <= TOL_2D
        assert _rel(a.numpy(), np.fft.irfft2(zf)) <= TOL_2D


@pytest.mark.parametrize("algo", ["stockham2", "stockham", "four_step"])
def test_rfft2_explicit_algo_runs_row_column_on_kernels(algo):
    """An explicit 1-D algo on backend="cuda" runs the row-column schedule
    with kernel 1-D passes, as the reference's pallas path does."""
    x = _real((2, 64, 512), seed=11)
    got = to_complex(core.rfft2(_t(x), algo=algo, backend="cuda")).numpy()
    ref = _ref(ref_core.rfft2(jnp.asarray(x), algo=algo, backend="pallas"))
    assert _rel(got, ref) <= TOL_1D
    back = core.irfft2(from_numpy(got, device="cpu"), algo=algo,
                       backend="cuda").numpy()
    assert _rel(back, x) <= TOL_ROUNDTRIP
    plan = P.get_plan((64, 512), kind="rfft", algo=algo, backend="cuda")
    via_plan = to_complex(plan(_t(x))).numpy()
    assert _rel(via_plan, got) <= TOL_1D


def test_fused_algo_needs_the_kernel_backend():
    x = _t(_real((1, 8, 8), 0))
    with pytest.raises(ValueError, match="requires backend"):
        core.rfft2(x, algo="fused", backend="torch")
    with pytest.raises(ValueError, match="even output width"):
        core.irfft2(core.rfft2(x), s=(8, 7), algo="fused", backend="cuda")
    with pytest.raises(ValueError, match="must be positive"):
        core.irfft2(core.rfft2(x), s=(0, 8))
    got = core.rfft2(x, algo="fused", backend="cuda")
    assert _rel(to_complex(got).numpy(), np.fft.rfft2(x.numpy())) <= TOL_2D


RFFT_SHAPES_2D = [(2, 2), (8, 4), (4, 8), (64, 128), (256, 256),
                  (1024, 1024), (4096, 2048), (1000, 1000), (12, 20),
                  (97, 128), (128, 96), (1, 64), (64, 2), (2, 1024)]


def _agree(mine, ref):
    assert mine == P.plan_from_reference(dataclasses.asdict(ref)), \
        (mine, ref)


@pytest.mark.parametrize("shape", RFFT_SHAPES_2D)
@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("inverse", [False, True])
def test_rfft_plan_parity_2d(shape, backends, inverse):
    ref = RP.get_plan(shape, inverse=inverse, backend=backends[0],
                      kind="rfft")
    mine = P.get_plan(shape, inverse=inverse, backend=backends[1],
                      kind="rfft")
    _agree(mine, ref)
    if shape == (1024, 1024) and backends[1] == "cuda":
        assert (mine.algo, mine.backend, mine.demote_reason) == \
            ("fused", "cuda", None)


@pytest.mark.parametrize("shape,algo", [
    ((64, 128), "fused"), ((64, 128), "stockham2"), ((64, 128), "naive"),
    ((64, 128), "cooley_tukey"), ((64, 128), "four_step"),
    ((96, 128), "fused"), ((1000, 1000), "stockham"), ((64, 2), "stockham")])
@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("inverse", [False, True])
def test_rfft_plan_explicit_algo_parity_2d(shape, algo, backends, inverse):
    try:
        ref = RP.get_plan(shape, inverse=inverse, algo=algo,
                          backend=backends[0], kind="rfft")
    except ValueError:
        with pytest.raises(ValueError):
            P.get_plan(shape, inverse=inverse, algo=algo,
                       backend=backends[1], kind="rfft")
        return
    _agree(P.get_plan(shape, inverse=inverse, algo=algo,
                      backend=backends[1], kind="rfft"), ref)


def test_fft2d_fit_spectrum2_matches_reference():
    from repro.core import fft2d as ref_fft2d
    zf = _rand((2, 8, 5), seed=2)
    for h, w in [(8, 8), (4, 8), (12, 8), (8, 4), (12, 16), (3, 5)]:
        got = to_complex(fft2d._fit_spectrum2(from_numpy(zf, device="cpu"),
                                              h, w)).numpy()
        ref = _ref(ref_fft2d._fit_spectrum2(_ref_in(zf), h, w))
        assert np.array_equal(got, ref), (h, w)


def test_rfft2_counts_no_launch_on_cpu():
    before = dict(ops.LAUNCHES)
    x = _t(_real((1, 16, 16), seed=0))
    core.irfft2(core.rfft2(x, backend="cuda"), backend="cuda")
    assert ops.LAUNCHES == before


def two_pass_inverse_model(xf):
    """The CUDA inverse's two launches in plain torch (complex128 FFTs),
    index for index: launch 1 reads each tile of C columns of the user's
    half spectra at their own pitch w/2+1 (columns past it zero), runs the
    unscaled inverse length-h FFT down them and stores the first w/2+1
    into a scratch pair of pitch P (the padding left NaN: nothing may read
    it); launch 2 copies scratch rows 2j and 2j+1 of each tile of G packed
    rows in as one run, builds Z = A_ext + i B_ext at the load (the DC and
    Nyquist imaginary parts dropped), runs the unscaled inverse length-w
    FFT and stores re to row 2j and im to row 2j+1, scaled by 1/(h*w)."""
    b, h, c = xf.shape
    w = 2 * (c - 1)
    cols, rows = rfft2d_fused.inverse_plan(b, h, w)
    pitch, cw, g = cols.inner, cols.c, rows.g
    src = (xf.re.double() + 1j * xf.im.double()).reshape(-1)
    scratch = torch.full((b * h * pitch,), complex("nan+nanj"),
                         dtype=torch.complex128)
    for o in range(b):
        for c0 in range(0, c, cw):
            col = torch.arange(c0, c0 + cw)
            row = torch.arange(h)[:, None]
            tile = torch.where(col < c, src[(o * h + row) * c
                                            + col.clamp(max=c - 1)], 0)
            tile = torch.fft.ifft(tile, dim=0) * h
            keep = col < c
            scratch[((o * h + row) * pitch + col)[:, keep]] = tile[:, keep]
    packed = b * h // 2
    out = torch.empty(b * h * w, dtype=torch.float64)
    i = torch.arange(w)
    mirror = i > w // 2
    kk = torch.where(mirror, w - i, i)
    ends = (kk == 0) | (kk == w // 2)
    for k in range(-(-packed // g)):
        run = scratch[k * g * 2 * pitch:(k + 1) * g * 2 * pitch]
        run = torch.cat([run, torch.zeros(2 * g * pitch - run.numel(),
                                          dtype=run.dtype)])
        t = torch.arange(g)[:, None]
        a, bb = run[2 * t * pitch + kk], run[(2 * t + 1) * pitch + kk]
        ai = torch.where(ends, 0.0, a.imag)
        bi = torch.where(ends, 0.0, bb.imag)
        ai, bi = torch.where(mirror, -ai, ai), torch.where(mirror, -bi, bi)
        z = torch.fft.ifft((a.real - bi) + 1j * (ai + bb.real), dim=-1) * w
        z = torch.stack([z.real, z.imag], 1).reshape(-1) / (h * w)
        start = k * g * 2 * w
        out[start:start + z.numel()] = z[:out.numel() - start]
    return out.reshape(b, h, w)


@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 8, 4), (2, 4, 8),
                                   (3, 16, 2), (2, 64, 128), (1, 128, 128),
                                   (2, 256, 64)])
def test_inverse_two_pass_model_matches_plain_and_reference(shape):
    """Whole images a column tile (pitch w/2+1 rounded up to 4) and C
    columns with a ragged last tile (128^2: 2 tiles of 64 columns; h = 256,
    w = 64: 2 tiles of 32, pitch 40), a row tile ragged at the last packed
    row, on a random half spectrum whose DC and Nyquist bins are complex:
    the model equals irfft2d_fused_plain and the reference kernel in
    interpret mode within 1e-6 of max."""
    b, h, w = shape
    zf = _rand((b, h, w // 2 + 1), seed=w + h)
    assert np.abs(zf[..., -1].imag).max() > 0.1
    got = two_pass_inverse_model(from_numpy(zf, device="cpu")).numpy()
    plain = rfft2d_fused.irfft2d_fused_plain(
        from_numpy(zf, device="cpu")).numpy()
    ref = np.asarray(ref_rfused.irfft2d_fused_pallas(_ref_in(zf),
                                                     interpret=True))
    assert np.isfinite(got).all()
    assert _rel(got, plain) <= 1e-6
    assert _rel(got, ref) <= 1e-6
    assert _rel(got, np.fft.irfft2(zf.astype(np.complex128), s=(h, w))) \
        <= 1e-6
