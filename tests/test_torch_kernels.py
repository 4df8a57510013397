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
from repro_torch.core import SplitComplex, from_numpy, to_complex
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
    """Plain float16 on the tensor cores (ROADMAP §2e; no plan resolves to
    it) passes the dtype checks and is refused only for lying on the CPU;
    an unknown variant is refused."""
    x = from_numpy(_rand((1, 8, 8), 0), device="cpu")
    half = type(x)(x.re.half(), x.im.half())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fft2d_gemm.fft2d_gemm_cuda(half, variant="plain")
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


# -- the four-step CUDA kernel's pure-Python parts ---------------------------

@pytest.mark.parametrize("k", range(2, 21))
def test_fourstep_kernel_takes_every_default_split(k):
    """Every default split up to 2^20 is within the fused kernel's limits
    (the "fused" route, fp32); bf16 takes the axis route."""
    n = 1 << k
    n1, n2 = fft_fourstep.kernel_factors(n)
    assert (n1, n2) == fft_fourstep._split_n(n)
    assert 2 <= n1 <= fft_fourstep.MAX_FACTOR
    assert 2 <= n2 <= fft_fourstep.MAX_FACTOR
    assert fft_fourstep.kernel_route(n) == "fused"
    assert fft_fourstep.kernel_route(n, dtype=torch.bfloat16) == "axis"


@pytest.mark.parametrize("n,n1", [(1 << 15, 1 << 15), (1 << 16, 2),
                                  (1 << 29, None), (1 << 28, 1 << 13)])
def test_fourstep_kernel_refuses_factors_past_its_limit(n, n1):
    """A factor above 2^14 (whose dense DFT table is past the reference's
    reach too) raises, naming the limit; the check runs before the device
    check, so it shows on CPU tensors."""
    with pytest.raises(ValueError, match="factors of up to 16384"):
        fft_fourstep.kernel_factors(n, n1)
    x = SplitComplex(torch.empty((1, n), device="meta"),
                     torch.empty((1, n), device="meta"))
    with pytest.raises(ValueError, match="factors of up to 16384"):
        fft_fourstep.fft_fourstep_cuda(x, n1=n1)


def test_fourstep_kernel_refuses_non_pow2():
    with pytest.raises(ValueError, match="power-of-two"):
        fft_fourstep.kernel_factors(768)


def _table_parts(n1, n2, inverse):
    """(fp32 table, float64 table, s) of the kernel's twiddle table."""
    sign = 1.0 if inverse else -1.0
    exact = fft_fourstep.kernel_table_np(n1, n2, sign)[0]
    got = fft_fourstep.kernel_table(n1, n2, inverse=inverse,
                                    device="cpu").numpy()
    return got, exact, fft_fourstep.level_shift(n1 * n2)


@pytest.mark.parametrize("n1,n2", [(2, 2), (16, 32), (64, 64), (512, 1024),
                                   (1024, 1024), (1024, 32)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_kernel_table_within_one_ulp(n1, n2, inverse):
    """[w1 | w2 | lo | hi] against exp(sign*2*pi*i*k/N) in float64 numpy:
    each fp32 entry within 1 ulp of its own value."""
    got, _, s = _table_parts(n1, n2, inverse)
    n = n1 * n2
    sign = 1.0 if inverse else -1.0
    ks = [np.arange(n1) / n1, np.arange(n2) / n2, np.arange(1 << s) / n,
          np.arange(n >> s) * (1 << s) / n]
    want = np.exp(sign * 2j * np.pi * np.concatenate(ks))
    assert got.dtype == np.float32 and got.shape == (len(want), 2)
    for col, ref in ((0, want.real), (1, want.imag)):
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert (np.abs(got[:, col] - ref) <= ulp).all()


@pytest.mark.parametrize("n1,n2", [(16, 32), (64, 64), (512, 1024),
                                   (1024, 1024), (1024, 32)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_twiddle_two_level_within_two_ulp(n1, n2, inverse):
    """T's two-level product hi[m >> s] * lo[m mod 2^s], in fp32 as the
    kernel forms it, for every m = k1*j2 of the split: within 2 ulp of 1
    (the twiddles' magnitude) of W_n^m in float64."""
    got, _, s = _table_parts(n1, n2, inverse)
    n = n1 * n2
    lo = got[n1 + n2:n1 + n2 + (1 << s)]
    hi = got[n1 + n2 + (1 << s):]
    m = np.unique(np.outer(np.arange(n1), np.arange(n2)))
    a, b = hi[m >> s], lo[m & ((1 << s) - 1)]
    re = a[:, 0] * b[:, 0] - a[:, 1] * b[:, 1]
    im = a[:, 0] * b[:, 1] + a[:, 1] * b[:, 0]
    assert re.dtype == np.float32
    want = np.exp((1.0 if inverse else -1.0) * 2j * np.pi * m / n)
    err = np.maximum(np.abs(re - want.real), np.abs(im - want.imag))
    assert err.max() <= 2 * np.spacing(np.float32(1.0))
