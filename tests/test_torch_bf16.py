"""bf16 planes on the kernels that took float32 only until now (the 1-D
Stockham kernels of both radices, the four-step, stage, real-input 2-D,
fused Stockham 2-D and fused conv kernels): the port's plain versions in
bf16 (what the wrappers run on CPU tensors) against the reference's
kernels in interpret mode in bf16, on the same seeded numpy input, within
the reference's bf16 bound, 6e-2 of max|X| (``tests/test_kernels.py``).
The CUDA kernels are held to float64 numpy in ``chip_smoke.py`` (bf16
lines) and to their plain versions under ``tools/cuda_emu/emulate.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.complexmath import SplitComplex as RefSplit
from repro.kernels import ops as ref_ops
from repro_torch.core import SplitComplex
from repro_torch.kernels import ops

TOL_BF16 = 6e-2         # the reference's bf16 bound, of max|X|


def _planes(z):
    """The bf16 rounding of z's planes: (port SplitComplex, reference
    SplitComplex) of the same values."""
    re = torch.from_numpy(np.ascontiguousarray(z.real)).float().bfloat16()
    im = torch.from_numpy(np.ascontiguousarray(z.imag)).float().bfloat16()
    ref = RefSplit(jnp.asarray(re.float().numpy(), jnp.bfloat16),
                   jnp.asarray(im.float().numpy(), jnp.bfloat16))
    return SplitComplex(re, im), ref


def _real(x):
    t = torch.from_numpy(np.ascontiguousarray(x)).float().bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(y):
    """A port or reference result (complex or real) as complex128/float64."""
    if isinstance(y, (SplitComplex, RefSplit)):
        return _np(y.re) + 1j * _np(y.im)
    if isinstance(y, torch.Tensor):
        return y.float().numpy().astype(np.float64)
    return np.asarray(y.astype(jnp.float32), np.float64)


def _check(got, want):
    dtype = (got.re if isinstance(got, SplitComplex) else got).dtype
    assert dtype == torch.bfloat16
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= TOL_BF16 * np.abs(w).max()


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("shape", [(4, 256), (3, 2), (2, 1 << 12)])
@pytest.mark.parametrize("radix", [4, 2])
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_bf16_matches_the_reference(shape, radix, inverse):
    x, xr = _planes(_rand(shape, sum(shape) + radix))
    _check(ops.fft_stockham(x, inverse=inverse, radix=radix),
           ref_ops.fft_stockham(xr, inverse=inverse, radix=radix))


@pytest.mark.parametrize("shape", [(4, 256), (2, 4096), (3, 64)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_bf16_matches_the_reference(shape, inverse):
    x, xr = _planes(_rand(shape, sum(shape)))
    _check(ops.fft_fourstep(x, inverse=inverse),
           ref_ops.fft_fourstep(xr, inverse=inverse))


@pytest.mark.parametrize("shape", [(4, 256), (4, 16), (2, 2048)])
@pytest.mark.parametrize("inverse", [False, True])
def test_staged_bf16_matches_the_reference(shape, inverse):
    x, xr = _planes(_rand(shape, sum(shape)))
    _check(ops.fft_staged(x, inverse=inverse),
           ref_ops.fft_staged(xr, inverse=inverse))


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 64, 32), (2, 2, 8)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fused_stockham_2d_bf16_matches_the_reference(shape, inverse):
    x, xr = _planes(_rand(shape, sum(shape)))
    _check(ops.fft2d_fused(x, inverse=inverse),
           ref_ops.fft2d_fused(xr, inverse=inverse))


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 64, 32), (2, 8, 4)])
def test_rfft2d_bf16_matches_the_reference(shape):
    x, xr = _real(np.random.default_rng(sum(shape)).standard_normal(shape))
    _check(ops.rfft2d_fused(x), ref_ops.rfft2d_fused(xr))


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 64, 32), (2, 8, 4)])
def test_irfft2d_bf16_matches_the_reference(shape):
    b, h, w = shape
    x, xr = _planes(_rand((b, h, w // 2 + 1), sum(shape)))
    _check(ops.irfft2d_fused(x), ref_ops.irfft2d_fused(xr))


@pytest.mark.parametrize("lead,m", [((2, 3), 64), ((1, 4), 256), ((3, 2), 8)])
def test_fftconv_bf16_matches_the_reference(lead, m):
    rng = np.random.default_rng(m)
    x, xr = _real(rng.standard_normal(lead + (m,)))
    kf, kfr = _planes(_rand((lead[-1], m // 2 + 1), m + 1))
    _check(ops.fftconv_fused(x, kf), ref_ops.fftconv_fused(xr, kfr))
