"""Each kernel's plain PyTorch version (what a kernel wrapper runs on a CPU
tensor) against the reference Pallas kernel in interpret mode and against
float64 numpy, on the same seeded inputs.

Tolerances, as max error / max |reference|: 1e-5 for the 2-D kernel and
5e-5 for the 1-D kernels against the reference kernel (the same fp32
arithmetic, summed in another order); against numpy the reference's own
bounds (test_fft2d_gemm.py: 1e-5; test_kernels.py: 5e-4 of max)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.complexmath import SplitComplex as RefSplit
from repro.kernels import ops as ref_ops
from repro_torch.core import from_numpy, to_complex
from repro_torch.kernels import ops
from repro_torch.kernels import fft2d_gemm, fft_fourstep, fft_stockham


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _ref_in(z):
    return RefSplit(jnp.asarray(z.real), jnp.asarray(z.imag))


def _ref_out(y):
    return np.asarray(y.re) + 1j * np.asarray(y.im)


def _port(y):
    return to_complex(y).numpy()


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("hw", [(8, 4), (64, 128), (256, 256)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft2d_gemm_plain_vs_reference(hw, inverse):
    z = _rand((2,) + hw, seed=sum(hw))
    got = _port(ops.fft2d_gemm(from_numpy(z, device="cpu"), inverse=inverse))
    ref = _ref_out(ref_ops.fft2d_gemm(_ref_in(z), inverse=inverse))
    assert _rel(got, ref) <= 1e-5
    want = np.fft.ifft2(z) if inverse else np.fft.fft2(z)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("n", [512, 1024, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_fourstep_plain_vs_reference(n, inverse):
    z = _rand((3, n), seed=n)        # ragged against the reference's tile 4
    got = _port(ops.fft_fourstep(from_numpy(z, device="cpu"),
                                 inverse=inverse))
    ref = _ref_out(ref_ops.fft_fourstep(_ref_in(z), inverse=inverse))
    assert _rel(got, ref) <= 5e-5
    want = np.fft.ifft(z) if inverse else np.fft.fft(z)
    np.testing.assert_allclose(got, want, atol=5e-4 * np.abs(want).max())


@pytest.mark.parametrize("n", [2, 4, 8, 32, 2048])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_stockham_plain_vs_reference(n, inverse):
    z = _rand((3, n), seed=n + 1)
    got = _port(ops.fft_stockham(from_numpy(z, device="cpu"),
                                 inverse=inverse))
    ref = _ref_out(ref_ops.fft_stockham(_ref_in(z), inverse=inverse))
    assert _rel(got, ref) <= 5e-5
    want = np.fft.ifft(z) if inverse else np.fft.fft(z)
    np.testing.assert_allclose(got, want, atol=5e-4 * np.abs(want).max())


def test_leading_batch_dims_flatten():
    z = _rand((2, 3, 16, 32), seed=7)
    got = _port(ops.fft2d_gemm(from_numpy(z, device="cpu")))
    assert got.shape == z.shape
    assert _rel(got, np.fft.fft2(z)) <= 1e-5
    z = _rand((2, 3, 1024), seed=8)
    for fn in (ops.fft_fourstep, ops.fft_stockham):
        got = _port(fn(from_numpy(z, device="cpu")))
        assert got.shape == z.shape
        assert _rel(got, np.fft.fft(z)) <= 5e-5


@pytest.mark.parametrize("fn,shape", [(ops.fft2d_gemm, (0, 16, 16)),
                                      (ops.fft_fourstep, (0, 512)),
                                      (ops.fft_stockham, (0, 64))])
def test_empty_batch(fn, shape):
    x = from_numpy(np.zeros(shape, np.complex64), device="cpu")
    out = fn(x)
    assert out.shape == shape


def test_cpu_path_counts_no_launch():
    before = dict(ops.LAUNCHES)
    ops.fft2d_gemm(from_numpy(_rand((1, 8, 8), 0), device="cpu"))
    ops.fft_stockham(from_numpy(_rand((1, 8), 0), device="cpu"))
    assert ops.LAUNCHES == before


def test_unported_options_raise():
    """float16, the sub-fp32 dtype the GEMM kernels do not take, raises
    naming its ROADMAP item; an unknown variant is refused."""
    x = from_numpy(_rand((1, 8, 8), 0), device="cpu")
    half = type(x)(x.re.half(), x.im.half())
    with pytest.raises(TypeError, match="item 2e"):
        ops.fft2d_gemm(half, variant="compensated")
    with pytest.raises(ValueError, match="variant"):
        ops.fft2d_gemm(x, variant="split")


@pytest.mark.parametrize("fn,shape", [(ops.fft2d_gemm, (1, 12, 8)),
                                      (ops.fft2d_gemm, (1, 1, 8)),
                                      (ops.fft_stockham, (1, 12)),
                                      (ops.fft_stockham, (1, 1))])
def test_unsupported_shapes_raise(fn, shape):
    with pytest.raises(ValueError):
        fn(from_numpy(_rand(shape, 0), device="cpu"))


@pytest.mark.parametrize("launch,shape", [
    (fft2d_gemm.fft2d_gemm_cuda, (1, 8, 8)),
    (fft_fourstep.fft_fourstep_cuda, (1, 512)),
    (fft_stockham.fft_stockham_cuda, (1, 512))])
def test_cuda_wrappers_refuse_cpu_tensors(launch, shape):
    """The CUDA launchers never fall back: a CPU tensor is refused."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch(from_numpy(_rand(shape, 0), device="cpu"))


def test_from_numpy_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_numpy(np.zeros(4, np.complex64))
