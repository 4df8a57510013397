"""float16 planes through the FFT kernels (ROADMAP §3 F11), the plain
variant's tensor-core route and decode attention (ROADMAP §2e).

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
- Decode attention's plain version in float16, whole and as the
  sequence-parallel partials of two slot halves merged, matches the
  reference's kernel in interpret mode on the same float16 q and caches
  within :data:`TOL_F16` of max|out|; plain float16 on the 2-D and 3-D
  GEMM transforms takes the tensor-core route's launches.
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


def test_plain_float16_on_the_gemm_chain_names_roadmap_2e(monkeypatch):
    """Plain float16 (ROADMAP §2e, no plan resolves to it) runs the
    tensor-core DFT products' launches (the route that replaced the GEMM
    chain) with their float16 flag set, as plain bf16 does with it clear:
    one launch an axis; compensated float16 runs the FFT passes."""
    from repro_torch.kernels import _build, fft3d_fused
    calls = []
    monkeypatch.setattr(_build, "check_operands", lambda *a: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "function", lambda *a: a[1])
    monkeypatch.setattr(_build, "launch", lambda fn, args, what, dev:
                        calls.append((fn, args[-1])))
    monkeypatch.setattr(_build, "launch_all", lambda fn, lists, what, dev:
                        calls.extend((fn, args[-1]) for args in lists))
    for dt, flag in ((torch.float16, 1), (torch.bfloat16, 0)):
        x = SplitComplex(torch.zeros(1, 8, 8, dtype=dt),
                         torch.zeros(1, 8, 8, dtype=dt))
        x3 = SplitComplex(torch.zeros(1, 2, 8, 8, dtype=dt),
                          torch.zeros(1, 2, 8, 8, dtype=dt))
        assert fft2d_gemm.on_dft_mma(dt, "plain")
        calls.clear()
        fft2d_gemm.fft2d_gemm_cuda(x, variant="plain")
        fft3d_fused.fft3d_fused_cuda(x3, variant="plain")
        assert calls == [("fft2d_gemm_plain_pass", flag)] * 2 + [
            ("fft3d_fused_plain_pass", flag)] * 3
    assert not fft2d_gemm.on_dft_mma(torch.float16, "compensated")


def _decode_case(b, s, h, kv, d, seed):
    """float16 q (B, H, D) and caches (B, S, KV, D), a ring's positions,
    a row that sees no slot; as torch tensors and the reference's arrays."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).half()
               for shape in ((b, h, d), (b, s, kv, d), (b, s, kv, d)))
    q_pos = torch.from_numpy(rng.integers(s // 2, 3 * s, b)).int()
    slot = torch.arange(s)
    kv_pos = (q_pos[:, None] - (q_pos[:, None] - slot) % s).int()
    kv_pos[-1] = -1
    port = (q, k, v, kv_pos, q_pos)
    return port, [jnp.asarray(t.numpy()) for t in port]


@pytest.mark.parametrize("cell,window", [((2, 64, 4, 2, 16), None),
                                         ((3, 128, 8, 2, 32), 48),
                                         ((2, 96, 12, 4, 80), 40)])
def test_decode_attention_f16_matches_the_reference(cell, window):
    """The plain version in float16 (what the wrapper runs on CPU tensors)
    against the reference's kernel in interpret mode, and the two slot
    halves' partials merged as the sequence-parallel route does."""
    port, ref = _decode_case(*cell, seed=sum(cell))
    want = ref_ops.decode_attention(*ref, window=window, chunk=16)
    got = ops.decode_attention(*port, window=window, chunk=16)
    _check(got, want)
    q, k, v, kv_pos, q_pos = port
    half = k.shape[1] // 2
    parts = [ops.decode_attention_partial(
        q, k[:, i * half:(i + 1) * half], v[:, i * half:(i + 1) * half],
        kv_pos[:, i * half:(i + 1) * half], q_pos, window=window)
        for i in range(2)]
    merged = ops.decode_attention_merge(
        *(torch.stack([p[j] for p in parts]) for j in range(4)),
        k.shape[1], torch.float16)
    _check(merged, want)


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
