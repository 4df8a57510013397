"""float16 planes through the FFT kernels (ROADMAP §3 F11).

- Every float16 route's plan resolves as the reference's does (``algo``,
  ``variant``, ``demote_reason``).
- Each kernel's plain version in float16 (what the wrappers run on CPU
  tensors) matches the reference's kernel in interpret mode on the same
  seeded numpy input, within :data:`TOL_F16` of max|X|.  The kernels whose
  reference rounds to float16 at every stage (both Stockham radices, the
  staged FFT, the fused Stockham 2-D oracle) are held to
  :func:`_check_staged` instead: XLA keeps another set of intermediates in
  fp32 than torch's float16 ops do, and the reference alone is 0.9e-3 to
  1.4e-3 of max|X| from float64 numpy there (4096 points, staged at
  16384), so the two agree to TOL_F16 plus the reference's own error, and
  the port is no further from float64 numpy than the reference plus half a
  float16 ulp.
- ``csrc/f16.cuh``'s conversions, compiled with g++ as
  ``tools/cuda_emu/emulate.py`` compiles the kernels, equal torch's casts
  bit for bit.

The CUDA kernels are held to float64 numpy and to their plain versions in
``chip_smoke.py`` (``f16_path``) and under ``tools/cuda_emu/emulate.py``.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as ref_plan
from repro.core.complexmath import SplitComplex as RefSplit
from repro.kernels import ops as ref_ops
from repro_torch.core import SplitComplex
from repro_torch.core import plan as port_plan
from repro_torch.kernels import fft2d_gemm, ops

TOL_F16 = 1e-3          # of max|X|, the kernels' float16 bound
HALF_ULP = 2.0 ** -11   # float16's unit roundoff
ROOT = Path(__file__).resolve().parents[1]


def _planes(z):
    """The float16 rounding of z's planes: (port, reference) SplitComplex
    of the same values."""
    re = torch.from_numpy(np.ascontiguousarray(z.real)).half()
    im = torch.from_numpy(np.ascontiguousarray(z.imag)).half()
    ref = RefSplit(jnp.asarray(re.numpy()), jnp.asarray(im.numpy()))
    return SplitComplex(re, im), ref


def _real(x):
    t = torch.from_numpy(np.ascontiguousarray(x)).half()
    return t, jnp.asarray(t.numpy())


def _np(y):
    if isinstance(y, (SplitComplex, RefSplit)):
        return _np(y.re) + 1j * _np(y.im)
    if isinstance(y, torch.Tensor):
        return y.double().numpy()
    return np.asarray(y, np.float64)


def _check(got, want):
    dtype = (got.re if isinstance(got, SplitComplex) else got).dtype
    assert dtype == torch.float16
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= TOL_F16 * np.abs(w).max()


def _exact(z, fn):
    """float64 numpy of ``fn`` on the float16 rounding of z."""
    return fn(z.real.astype(np.float16).astype(np.float64)
              + 1j * z.imag.astype(np.float16).astype(np.float64))


def _check_staged(got, want, exact):
    g, w = _np(got), _np(want)
    assert (got.re if isinstance(got, SplitComplex) else got).dtype \
        == torch.float16
    scale = np.abs(exact).max()
    err_ref = np.abs(w - exact).max() / scale
    err_port = np.abs(g - exact).max() / scale
    assert np.abs(g - w).max() / scale <= TOL_F16 + err_ref
    assert err_port <= err_ref + HALF_ULP


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# -- the plans ---------------------------------------------------------------

@pytest.mark.parametrize("shape,kind", [
    ((2, 64, 64), "c2c"), ((16, 1024, 1024), "c2c"), ((4, 1 << 20), "c2c"),
    ((2, 1 << 22), "c2c"), ((4, 256), "c2c"), ((128, 128, 128), "c2c"),
    ((1024, 1024), "rfft"), ((1 << 21,), "rfft"), ((1024, 1024), "c2c"),
    ((2, 96, 64), "c2c")])
def test_float16_plans_resolve_as_the_reference(shape, kind):
    ref = ref_plan.get_plan(shape, dtype=jnp.float16, backend="pallas",
                            kind=kind)
    got = port_plan.get_plan(shape, dtype=torch.float16, backend="cuda",
                             kind=kind)
    assert (got.algo, got.variant, got.demote_reason) == \
        (ref.algo, ref.variant, ref.demote_reason)


def test_float16_default_2d_plan_is_compensated_on_the_kernel():
    got = port_plan.get_plan((2, 64, 64), dtype=torch.float16,
                             backend="cuda")
    assert (got.algo, got.variant, got.demote_reason) == \
        ("fused", "compensated", None)


# -- the plain versions against the reference's kernels ----------------------

@pytest.mark.parametrize("shape", [(4, 256), (3, 2), (2, 1 << 12)])
@pytest.mark.parametrize("radix", [4, 2])
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_f16_matches_the_reference(shape, radix, inverse):
    z = _rand(shape, sum(shape) + radix)
    x, xr = _planes(z)
    _check_staged(ops.fft_stockham(x, inverse=inverse, radix=radix),
                  ref_ops.fft_stockham(xr, inverse=inverse, radix=radix),
                  _exact(z, np.fft.ifft if inverse else np.fft.fft))


@pytest.mark.parametrize("shape", [(4, 256), (2, 4096), (3, 64)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_f16_matches_the_reference(shape, inverse):
    x, xr = _planes(_rand(shape, sum(shape)))
    _check(ops.fft_fourstep(x, inverse=inverse),
           ref_ops.fft_fourstep(xr, inverse=inverse))


@pytest.mark.parametrize("shape", [(4, 256), (4, 16), (2, 2048)])
@pytest.mark.parametrize("inverse", [False, True])
def test_staged_f16_matches_the_reference(shape, inverse):
    z = _rand(shape, sum(shape))
    x, xr = _planes(z)
    _check_staged(ops.fft_staged(x, inverse=inverse),
                  ref_ops.fft_staged(xr, inverse=inverse),
                  _exact(z, np.fft.ifft if inverse else np.fft.fft))


@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 16, 16), (1, 64, 32),
                                   (2, 2, 8)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fused_stockham_2d_f16_matches_the_reference(shape, inverse):
    z = _rand(shape, sum(shape))
    x, xr = _planes(z)
    _check_staged(ops.fft2d_fused(x, inverse=inverse),
                  ref_ops.fft2d_fused(xr, inverse=inverse),
                  _exact(z, np.fft.ifft2 if inverse else np.fft.fft2))


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 64, 32), (2, 8, 4)])
@pytest.mark.parametrize("variant", ["compensated", "plain"])
@pytest.mark.parametrize("inverse", [False, True])
def test_gemm_2d_f16_matches_the_reference(shape, variant, inverse):
    x, xr = _planes(_rand(shape, sum(shape)))
    _check(ops.fft2d_gemm(x, inverse=inverse, variant=variant),
           ref_ops.fft2d_gemm(xr, inverse=inverse, variant=variant))


def test_f11_input_through_fft2_matches_the_reference():
    """F11's input: (2, 64, 64) from default_rng(0), a zero imaginary
    plane, through the entry points on the kernel backends."""
    import repro.core as ref_core
    import repro_torch.core as port_core
    z = np.random.default_rng(0).standard_normal((2, 64, 64)) + 0j
    x, xr = _planes(z)
    _check(port_core.fft2(x, backend="cuda"),
           ref_core.fft2(xr, backend="pallas"))


@pytest.mark.parametrize("shape", [(1, 4, 8, 16), (2, 8, 8, 8)])
@pytest.mark.parametrize("variant", ["compensated", "plain"])
def test_fft3d_f16_matches_the_reference(shape, variant):
    x, xr = _planes(_rand(shape, sum(shape)))
    _check(ops.fft3d_fused(x, variant=variant),
           ref_ops.fft3d_fused(xr, variant=variant))


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 64, 32), (2, 8, 4)])
def test_rfft2d_f16_matches_the_reference(shape):
    x, xr = _real(np.random.default_rng(sum(shape)).standard_normal(shape))
    _check(ops.rfft2d_fused(x), ref_ops.rfft2d_fused(xr))


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 64, 32), (2, 8, 4)])
def test_irfft2d_f16_matches_the_reference(shape):
    b, h, w = shape
    x, xr = _planes(_rand((b, h, w // 2 + 1), sum(shape)))
    _check(ops.irfft2d_fused(x), ref_ops.irfft2d_fused(xr))


@pytest.mark.parametrize("lead,m", [((2, 3), 64), ((1, 4), 256), ((3, 2), 8)])
def test_fftconv_f16_matches_the_reference(lead, m):
    rng = np.random.default_rng(m)
    x, xr = _real(rng.standard_normal(lead + (m,)))
    kf, kfr = _planes(_rand((lead[-1], m // 2 + 1), m + 1))
    _check(ops.fftconv_fused(x, kf), ref_ops.fftconv_fused(xr, kfr))


def test_plain_float16_on_the_gemm_chain_names_roadmap_2e():
    """The CUDA kernel refuses plain float16 (no plan resolves to it)
    before it looks at the operands, naming the roadmap item."""
    with pytest.raises(TypeError, match="2e"):
        fft2d_gemm.check_chain(torch.float16, "plain")
    fft2d_gemm.check_chain(torch.float16, "compensated")
    fft2d_gemm.check_chain(torch.bfloat16, "plain")


# -- the conversions, compiled with g++ --------------------------------------

def _emulate():
    spec = importlib.util.spec_from_file_location(
        "cuda_emu_emulate", ROOT / "tools" / "cuda_emu" / "emulate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sample_bits() -> np.ndarray:
    """About 2^20 float32 bit patterns: 2^12 random mantissas at every
    exponent and sign, each float16 rounding boundary's neighbours (the
    ties between adjacent float16 values, subnormal, normal and the
    overflow edge at 65520, each +-3 ulps), +-0, +-inf and NaNs with
    several payloads."""
    rng = np.random.default_rng(16)
    exps = np.arange(256, dtype=np.uint32) << 23
    mants = rng.integers(0, 1 << 23, (256, 1 << 11), dtype=np.uint32)
    rand = (exps[:, None] | mants).ravel()
    halves = np.arange(0x7C00, dtype=np.uint16).view(np.float16)
    mids = ((halves[:-1].astype(np.float64) + halves[1:].astype(np.float64))
            / 2).astype(np.float32).view(np.uint32)
    top = np.array([65504.0, 65520.0, 65536.0], np.float32).view(np.uint32)
    edges = np.concatenate([mids, top])
    near = (edges[:, None].astype(np.int64) + np.arange(-3, 4)).ravel()
    special = np.array([0, 0x7F800000, 0x7F800001, 0x7FC00000, 0x7FA00000,
                        0x7FFFFFFF, 0x7F802000], np.uint32)
    pos = np.concatenate([rand, near.astype(np.uint32), special])
    return np.concatenate([pos, pos | np.uint32(0x80000000)])


def test_f16_conversions_match_torch_bit_for_bit(tmp_path):
    lib = _emulate().f16_conversions(tmp_path)
    bits = _sample_bits()
    assert bits.size > 1 << 20
    x = bits.view(np.float32)
    got = np.empty(x.size, np.uint16)
    lib.f32_to_f16(x.ctypes.data, got.ctypes.data, x.size)
    want = torch.from_numpy(x.copy()).half().view(torch.int16).numpy() \
        .view(np.uint16)
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, [(hex(bits[i]), hex(got[i]), hex(want[i]))
                           for i in bad[:8]]
    # widening: every float16 pattern; NaN widens to a NaN
    h = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    wide = np.empty(h.size, np.float32)
    lib.f16_to_f32(h.ctypes.data, wide.ctypes.data, h.size)
    ref = torch.from_numpy(h.view(np.int16).copy()).view(torch.float16) \
        .float().numpy()
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(wide), nan)
    assert np.array_equal(wide[~nan].view(np.uint32),
                          ref[~nan].view(np.uint32))
