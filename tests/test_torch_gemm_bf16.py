"""The bfloat16 path of the GEMM kernels: the split tables bit-identical to
the reference's, the plain versions of both GEMM kernels in bf16 (both
variants) against the reference kernels in interpret mode and against
float64 numpy, and the registry's variant resolution.

Tolerances: port vs reference <= 2^-7 of max|ref| (one bf16 ulp at the top
of the range: the two round the same fp32 sums to bf16 at different
places, see repro_torch/kernels/fft2d_gemm.py); compensated vs float64
numpy <= 5e-3 relative norm, the reference's bound
(tests/test_fft2d_gemm.py, tests/test_fft3.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as RP
from repro.core.complexmath import SplitComplex as RefSplit
from repro.kernels import fft2d_gemm as ref_gemm
from repro.kernels import fft3d_fused as ref_fused3d
from repro.kernels import ops as ref_ops
from repro.kernels import rfft2d_fused as ref_rfused
from repro_torch.core import SplitComplex, fft2, fft3
from repro_torch.core import plan as P
from repro_torch.kernels import fft2d_gemm, fft3d_fused, ops

ULP_TOP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _fresh_registries():
    RP.clear_plan_cache()
    P.clear_plan_cache()
    yield
    RP.clear_plan_cache()
    P.clear_plan_cache()


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _port_in(zr, zi):
    return SplitComplex(torch.from_numpy(zr).to(torch.bfloat16),
                        torch.from_numpy(zi).to(torch.bfloat16))


def _ref_in(zr, zi):
    return RefSplit(jnp.asarray(zr, jnp.bfloat16),
                    jnp.asarray(zi, jnp.bfloat16))


def _port_out(y):
    return y.re.double().numpy() + 1j * y.im.double().numpy()


def _ref_out(y):
    return np.asarray(y.re, np.float64) + 1j * np.asarray(y.im, np.float64)


def _rel_max(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _rel_norm(got, ref):
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_split_tables_bit_identical(n, inverse):
    """torch's float64 -> bf16 rounding gives the reference's (ml_dtypes')
    hi and lo bits on every four-step table, and fp32(hi) + fp32(lo) is
    exact."""
    for t in ref_rfused.fourstep_tables_np(n, inverse):
        mine = fft2d_gemm.split_table_np(t, torch.bfloat16)
        ref = np.asarray(ref_gemm.split_table_np(t, jnp.bfloat16))
        assert mine.dtype == torch.bfloat16 and mine.shape == (2,) + t.shape
        assert np.array_equal(mine.view(torch.int16).numpy(),
                              ref.view(np.int16))
        hi, lo = mine.double()
        assert torch.equal((mine[0].float() + mine[1].float()).double(),
                           hi + lo)


def test_split_tables_random_values_bit_identical():
    t = np.random.default_rng(4).standard_normal(100_000) * 10.0 ** \
        np.random.default_rng(5).integers(-20, 20, 100_000)
    mine = fft2d_gemm.split_table_np(t, torch.bfloat16)
    ref = np.asarray(ref_gemm.split_table_np(t, jnp.bfloat16))
    assert np.array_equal(mine.view(torch.int16).numpy(), ref.view(np.int16))


@pytest.mark.parametrize("variant", ["plain", "compensated"])
def test_gemm_tables_operands(variant):
    """Operand count, shape and dtype of both kernels' tables, as the
    reference's; the unsplit work tables are what the kernels load."""
    for mine, ref in [
            (fft2d_gemm.gemm_tables(64, 512, False, torch.bfloat16, variant),
             ref_gemm.gemm_tables(64, 512, False, jnp.bfloat16, variant)),
            (fft3d_fused.gemm_tables3(4, 256, 512, True, torch.bfloat16,
                                      variant),
             ref_fused3d.gemm_tables3(4, 256, 512, True, jnp.bfloat16,
                                      variant))]:
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            assert tuple(a.shape) == b.shape and a.dtype == torch.bfloat16
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  np.asarray(b).view(np.int16))
    ops2 = fft2d_gemm.gemm_tables(64, 512, False, torch.bfloat16, variant)
    work = fft2d_gemm._unsplit(ops2, variant == "compensated")
    cached = (fft2d_gemm.axis_tables(512, (16, 32), False, torch.bfloat16,
                                     variant, "cpu")
              + fft2d_gemm.axis_tables(64, (1, 64), False, torch.bfloat16,
                                       variant, "cpu"))
    for a, b in zip(work, cached):
        assert b.dtype == torch.float32 and torch.equal(a.float(), b)


@pytest.mark.parametrize("hw", [(64, 64), (256, 256)])
@pytest.mark.parametrize("variant", ["plain", "compensated"])
def test_fft2d_gemm_bf16_plain_vs_reference(hw, variant):
    zr, zi = _planes((1,) + hw, seed=sum(hw))
    got = _port_out(fft2d_gemm.fft2d_gemm_plain(_port_in(zr, zi),
                                                variant=variant))
    ref = _ref_out(ref_ops.fft2d_gemm(_ref_in(zr, zi), variant=variant))
    assert _rel_max(got, ref) <= ULP_TOP
    if variant == "compensated":
        assert _rel_norm(got, np.fft.fft2(zr + 1j * zi)) <= 5e-3


@pytest.mark.parametrize("variant", ["plain", "compensated"])
def test_fft3d_fused_bf16_plain_vs_reference(variant):
    zr, zi = _planes((1, 32, 32, 32), seed=7)
    got = _port_out(fft3d_fused.fft3d_fused_plain(_port_in(zr, zi),
                                                  variant=variant))
    ref = _ref_out(ref_ops.fft3d_fused(_ref_in(zr, zi), variant=variant))
    assert _rel_max(got, ref) <= ULP_TOP
    if variant == "compensated":
        want = np.fft.fftn(zr + 1j * zi, axes=(-3, -2, -1))
        assert _rel_norm(got, want) <= 5e-3


@pytest.mark.parametrize("hw", [(256, 256), (512, 512)])
def test_bf16_compensated_beats_plain(hw):
    """Compensated within 5e-3 of float64 numpy and tighter than plain,
    as tests/test_fft2d_gemm.py asserts of the reference."""
    zr, zi = _planes(hw, seed=sum(hw))
    ref = np.fft.fft2(zr + 1j * zi)
    x = _port_in(zr[None], zi[None])
    errs = {v: _rel_norm(_port_out(ops.fft2d_gemm(x, variant=v))[0], ref)
            for v in ("plain", "compensated")}
    assert errs["compensated"] <= 5e-3, errs
    assert errs["compensated"] < errs["plain"], errs


def test_fft3d_bf16_compensated_beats_plain():
    zr, zi = _planes((32, 32, 32), seed=7)
    ref = np.fft.fftn(zr + 1j * zi)
    x = _port_in(zr[None], zi[None])
    errs = {v: _rel_norm(_port_out(ops.fft3d_fused(x, variant=v))[0], ref)
            for v in ("plain", "compensated")}
    assert errs["compensated"] <= 5e-3, errs
    assert errs["compensated"] < errs["plain"], errs


@pytest.mark.parametrize("ndim", [2, 3])
def test_bf16_round_trip_keeps_dtype(ndim):
    shape = (2, 64, 64) if ndim == 2 else (2, 16, 16, 16)
    zr, zi = _planes(shape, seed=6)
    x = _port_in(zr, zi)
    fwd = fft2 if ndim == 2 else fft3
    back = fwd(fwd(x, backend="cuda"), inverse=True, backend="cuda")
    assert back.re.dtype == back.im.dtype == torch.bfloat16
    assert _rel_norm(_port_out(back), zr + 1j * zi) < 1e-2


@pytest.mark.parametrize("shape", [(128, 128), (16, 32, 64)])
def test_registry_variant_resolution(shape):
    """bf16 GEMM keys on cuda resolve to (fused, compensated), on torch to
    plain; explicit variants intern apart and never displace the auto
    plan; the reference resolves the same."""
    cuda = P.get_plan(shape, dtype=torch.bfloat16, backend="cuda")
    assert (cuda.algo, cuda.variant) == ("fused", "compensated")
    ref = RP.get_plan(shape, dtype=jnp.bfloat16, backend="pallas")
    assert (ref.algo, ref.variant, ref.block_batch) == \
        (cuda.algo, cuda.variant, cuda.block_batch)
    plain = P.get_plan(shape, dtype=torch.bfloat16, backend="torch")
    assert (plain.algo, plain.variant) == ("row_col", "plain")
    explicit = P.get_plan(shape, dtype=torch.bfloat16, backend="cuda",
                          variant="plain")
    assert explicit.variant == "plain" and explicit is not cuda
    assert P.get_plan(shape, dtype=torch.bfloat16, backend="cuda") is cuda
    f32 = P.get_plan(shape, backend="cuda")
    assert (f32.algo, f32.variant) == ("fused", "plain")


def test_registry_bf16_plan_executes_to_bound():
    zr, zi = _planes((128, 128), seed=1)
    plan = P.get_plan((128, 128), dtype=torch.bfloat16, backend="cuda")
    got = _port_out(plan(_port_in(zr, zi)))
    assert _rel_norm(got, np.fft.fft2(zr + 1j * zi)) <= 5e-3


def test_float16_raises_naming_the_roadmap():
    """Plain float16 runs on the tensor cores (ROADMAP §2e): both CUDA
    wrappers pass it through the dtype checks and refuse it only for lying
    on the CPU.  The plain versions compute float16 in both variants on
    the CPU, float16 in, float16 out."""
    x = SplitComplex(torch.zeros(1, 8, 8, dtype=torch.float16),
                     torch.zeros(1, 8, 8, dtype=torch.float16))
    x3 = SplitComplex(torch.zeros(1, 2, 8, 8, dtype=torch.float16),
                      torch.zeros(1, 2, 8, 8, dtype=torch.float16))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fft2d_gemm.fft2d_gemm_cuda(x, variant="plain")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fft3d_fused.fft3d_fused_cuda(x3, variant="plain")
    for variant in ("plain", "compensated"):
        assert ops.fft2d_gemm(x, variant=variant).re.dtype == torch.float16
        assert ops.fft3d_fused(x3, variant=variant).re.dtype == \
            torch.float16
