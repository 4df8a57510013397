"""The port's host tables and factorisations against the reference's:
the float64 builders must be bit-identical, and the split/radix choices
must agree over a sweep of lengths."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import twiddle as ref_tw
from repro.core import fft1d as ref_fft1d
from repro.kernels import fft_fourstep as ref_fourstep
from repro.kernels import fft2d_gemm as ref_gemm
from repro.kernels import rfft2d_fused as ref_rfused
from repro_torch.core import twiddle as tw
from repro_torch.core import fft1d
from repro_torch.kernels import fft_fourstep, fft2d_gemm, rfft2d_fused

POW2 = [1 << k for k in range(1, 13)]
SWEEP = POW2 + [3, 5, 6, 12, 97, 100, 257, 1000, 1024 * 3, 4097]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float64
        assert np.array_equal(x, y)


@pytest.mark.parametrize("n", POW2 + [12, 100])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_dense_and_twiddle_tables_bit_identical(n, sign):
    _same(tw._twiddle_np(n, sign), ref_tw._twiddle_np(n, sign))
    _same(tw._dft_matrix_np(n, sign), ref_tw._dft_matrix_np(n, sign))
    n1 = fft1d._best_split(n)
    _same(tw._fourstep_twiddle_np(n1, n // n1, sign),
          ref_tw._fourstep_twiddle_np(n1, n // n1, sign))


@pytest.mark.parametrize("n", POW2)
@pytest.mark.parametrize("inverse", [False, True])
def test_packed_stockham_tables_bit_identical(n, inverse):
    _same(tw.packed_radix4_twiddles_np(n, inverse),
          ref_tw.packed_radix4_twiddles_np(n, inverse))
    _same(tw.packed_radix2_twiddles_np(n, inverse),
          ref_tw.packed_radix2_twiddles_np(n, inverse))


@pytest.mark.parametrize("inverse", [False, True])
def test_gemm_tables_match_reference(inverse):
    """The 12 operands of the 2-D kernel: float64 builders identical, and
    the float32 casts identical to the reference's operand arrays."""
    for h, w in [(8, 4), (64, 128), (512, 1024), (4096, 256)]:
        mine = rfft2d_fused.fourstep_tables_np(w, inverse) \
            + rfft2d_fused.fourstep_tables_np(h, inverse)
        ref = ref_rfused.fourstep_tables_np(w, inverse) \
            + ref_rfused.fourstep_tables_np(h, inverse)
        _same(mine, ref)
    ops = ref_gemm.gemm_tables(64, 512, inverse, jnp.float32, "plain")
    cast = fft2d_gemm.gemm_tables(64, 512, inverse, torch.float32, "plain")
    for a, b in zip(cast, ops):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_packed_table_small_n_edge_case():
    """n < 4 has no radix-4 stage: one zero row of width max(n//4, 1)."""
    for n in (2,):
        wr, wi = tw.packed_radix4_twiddles_np(n, False)
        assert wr.shape == wi.shape == (1, 3, 1)
        assert not wr.any() and not wi.any()


def test_tensor_casts_cached_per_device_and_dtype():
    a = tw.dft_matrix(16, dtype=torch.float32, device="cpu")
    b = tw.dft_matrix(16, dtype=torch.float32, device="cpu")
    c = tw.dft_matrix(16, dtype=torch.float64, device="cpu")
    assert a.re is b.re and a.im is b.im
    assert c.re.dtype == torch.float64
    ref = ref_tw.dft_matrix(16, dtype=jnp.float32)
    assert np.array_equal(a.re.numpy(), np.asarray(ref.re))


def test_tensor_cast_cache_holds_its_byte_budget(monkeypatch):
    """Least recently used tables leave once the cache passes its budget;
    the newest stays even when it alone is larger."""
    tw.clear_table_cache()
    monkeypatch.setattr(tw, "TABLE_CACHE_BYTES", 2 * 4 * 64 * 64)
    a = tw.dft_matrix(64, dtype=torch.float32, device="cpu")
    assert tw.dft_matrix(64, dtype=torch.float32, device="cpu").re is a.re
    b = tw.dft_matrix(128, dtype=torch.float32, device="cpu")
    assert tw.dft_matrix(128, dtype=torch.float32, device="cpu").re is b.re
    a2 = tw.dft_matrix(64, dtype=torch.float32, device="cpu")
    assert a2.re is not a.re and torch.equal(a2.re, a.re)
    tw.clear_table_cache()
    assert tw.dft_matrix(64, dtype=torch.float32, device="cpu").re \
        is not a2.re


def test_tables_cast_under_fake_tensor_mode_are_not_cached():
    """A dry run's table (fake, no data) never reaches a later real call."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    tw.clear_table_cache()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = tw.dft_matrix(32, dtype=torch.float32, device="cpu")
    assert isinstance(fake.re, FakeTensor)
    real = tw.dft_matrix(32, dtype=torch.float32, device="cpu")
    assert not isinstance(real.re, FakeTensor)
    np.testing.assert_array_equal(
        real.re.numpy(), ref_tw._dft_matrix_np(32, -1.0)[0].astype(np.float32))
    tw.clear_table_cache()


@pytest.mark.parametrize("n", POW2)
def test_stockham_radices_agree(n):
    assert tw.stockham_radices(n) == ref_tw.stockham_radices(n)


@pytest.mark.parametrize("n", SWEEP + [1 << 20, 1 << 22])
def test_splits_agree(n):
    assert fft1d._best_split(n) == ref_fft1d._best_split(n)
    assert fft_fourstep._split_n(n) == ref_fourstep._split_n(n)
    assert rfft2d_fused.fourstep_factors(n) == ref_rfused.fourstep_factors(n)
    assert fft1d.resolve_algo(n) == ref_fft1d.resolve_algo(n)
