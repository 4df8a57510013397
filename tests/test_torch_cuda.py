"""The CUDA kernels against their plain versions on the card.  Marked
``cuda``: these skip (with the reason) where CUDA is absent.  Run them on
a GPU machine with ``PYTHONPATH=src python -m pytest -m cuda tests/``."""
import numpy as np
import pytest
import torch

from repro_torch.core import fft2, from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import fft2d_gemm, fft_fourstep, fft_stockham

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return "cuda"


def _rand(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(got, ref):
    d = max((got.re - ref.re).abs().max().item(),
            (got.im - ref.im).abs().max().item())
    return d / max(ref.re.abs().max().item(), ref.im.abs().max().item())


@pytest.mark.parametrize("launch,plain,shape,tol", [
    (fft2d_gemm.fft2d_gemm_cuda, fft2d_gemm.fft2d_gemm_plain, (2, 8, 4), 1e-5),
    (fft2d_gemm.fft2d_gemm_cuda, fft2d_gemm.fft2d_gemm_plain, (3, 512, 256),
     1e-5),
    (fft_fourstep.fft_fourstep_cuda, fft_fourstep.fft_fourstep_plain,
     (3, 8192), 5e-5),
    (fft_stockham.fft_stockham_cuda, fft_stockham.fft_stockham_plain,
     (3, 2048), 5e-5),
    (fft_stockham.fft_stockham_cuda, fft_stockham.fft_stockham_plain,
     (3, 2), 5e-5)])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_plain_on_card(card, launch, plain, shape, tol,
                                      inverse):
    x = from_numpy(_rand(shape), device=card)
    got = launch(x, inverse=inverse)
    torch.cuda.synchronize()
    assert _rel(got, plain(x, inverse=inverse)) <= tol


def test_wrappers_count_launches_on_card(card):
    ops.reset_launches()
    ops.fft2d_gemm(from_numpy(_rand((1, 64, 64)), device=card))
    ops.fft_fourstep(from_numpy(_rand((1, 1024)), device=card))
    ops.fft_stockham(from_numpy(_rand((1, 1024)), device=card))
    assert ops.LAUNCHES == {"fft_stockham": 1, "fft_fourstep": 1,
                            "fft2d_gemm": 1}


@pytest.mark.parametrize("inverse", [False, True])
def test_fft2_row_col_on_card(card, inverse):
    """algo="row_col": two Stockham kernel passes with the swap between,
    against float64 numpy and the GEMM kernel at the paper's size."""
    z = _rand((2, 1024, 1024), seed=3)
    x = from_numpy(z, device=card)
    got = fft2(x, inverse=inverse, algo="row_col", backend="cuda")
    ref = np.fft.ifft2(z) if inverse else np.fft.fft2(z)
    zz = got.re.double().cpu().numpy() + 1j * got.im.double().cpu().numpy()
    assert np.abs(zz - ref).max() <= 1e-5 * np.abs(ref).max()
    assert _rel(got, fft2d_gemm.fft2d_gemm_cuda(x, inverse=inverse)) <= 1e-5
