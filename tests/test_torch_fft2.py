"""The slice end to end on the CPU: repro_torch.core.fft2 / fft through the
plan registry against repro.core.fft2 / fft on the same seeded inputs.
On CPU tensors the cuda backend runs each kernel's plain version."""
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as ref_core
from repro.core import plan as RP
from repro.core.complexmath import SplitComplex as RefSplit
import repro_torch.core as core
from repro_torch.core import from_numpy, to_complex
from repro_torch.core import plan as P
from repro_torch.kernels import ops


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


def _ref(y):
    return np.asarray(y.re) + 1j * np.asarray(y.im)


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("shape", [(3, 64, 128), (2, 256, 256)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft2_cuda_backend_matches_reference(shape, inverse):
    z = _rand(shape, seed=shape[-1])
    got = to_complex(core.fft2(from_numpy(z, device="cpu"), inverse=inverse,
                               backend="cuda")).numpy()
    ref = _ref(ref_core.fft2(RefSplit(jnp.asarray(z.real),
                                      jnp.asarray(z.imag)),
                             inverse=inverse, backend="pallas"))
    assert _rel(got, ref) <= 1e-5
    assert P.get_plan(shape[-2:], inverse=inverse, backend="cuda").algo \
        == "fused"


def test_fft2_round_trip():
    z = _rand((2, 128, 64), seed=3)
    x = from_numpy(z, device="cpu")
    y = core.fft2(core.fft2(x, backend="cuda"), inverse=True, backend="cuda")
    assert _rel(to_complex(y).numpy(), z) <= 1e-5


@pytest.mark.parametrize("backends", [("cuda", "pallas"), ("torch", "jnp")])
def test_fft2_row_col_matches_reference(backends):
    z = _rand((2, 32, 64), seed=5)
    got = to_complex(core.fft2(from_numpy(z, device="cpu"), algo="row_col",
                               backend=backends[0])).numpy()
    ref = _ref(ref_core.fft2(RefSplit(jnp.asarray(z.real),
                                      jnp.asarray(z.imag)),
                             algo="row_col", backend=backends[1]))
    assert _rel(got, ref) <= 1e-5
    assert _rel(got, np.fft.fft2(z)) <= 1e-5


def test_fft2_demoted_shape_runs_torch_path():
    z = _rand((2, 24, 40), seed=9)
    before = dict(ops.LAUNCHES)
    got = to_complex(core.fft2(from_numpy(z, device="cpu"),
                               backend="cuda")).numpy()
    plan = P.get_plan((24, 40), backend="cuda")
    assert plan.backend == "torch" and plan.demote_reason
    assert _rel(got, np.fft.fft2(z)) <= 1e-5
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("n", [8, 300, 512, 1000, 4096])
@pytest.mark.parametrize("backends", [("cuda", "pallas"), ("torch", "jnp")])
def test_fft_1d_plans_match_reference(n, backends):
    z = _rand((3, n), seed=n)
    plan = P.plan_fft(n, backend=backends[0])
    got = to_complex(plan(from_numpy(z, device="cpu"))).numpy()
    ref_plan = RP.plan_fft(n, backend=backends[1])
    ref = _ref(ref_plan(RefSplit(jnp.asarray(z.real), jnp.asarray(z.imag))))
    assert _rel(got, ref) <= 5e-5
    assert plan.algo == ref_plan.algo


@pytest.mark.parametrize("algo", ["naive", "stockham", "stockham2",
                                  "four_step", "bluestein"])
def test_fft_explicit_algos_match_reference(algo):
    z = _rand((2, 512), seed=11)
    got = to_complex(core.fft(from_numpy(z, device="cpu"), algo=algo)).numpy()
    ref = _ref(ref_core.fft(RefSplit(jnp.asarray(z.real),
                                     jnp.asarray(z.imag)), algo=algo))
    assert _rel(got, ref) <= 5e-5
    back = core.ifft(core.fft(from_numpy(z, device="cpu"), algo=algo),
                     algo=algo)
    assert _rel(to_complex(back).numpy(), z) <= 5e-5


def test_fft_axis_and_unported_algo():
    """fft_axis, and algo="fused_stockham" on a CPU tensor: the Stockham
    fused kernel's plain version, which refuses the non-power-of-two
    (3, 8) tile as the reference kernel does."""
    z = _rand((16, 3, 8), seed=2)
    got = to_complex(core.fft_axis(from_numpy(z, device="cpu"), 0)).numpy()
    assert _rel(got, np.fft.fft(z, axis=0)) <= 1e-5
    with pytest.raises(ValueError, match="power-of-two tile dims"):
        core.fft2(from_numpy(z, device="cpu"), algo="fused_stockham",
                  backend="cuda")
    z = _rand((16, 4, 8), seed=2)
    got = to_complex(core.fft2(from_numpy(z, device="cpu"),
                               algo="fused_stockham", backend="cuda")).numpy()
    assert _rel(got, np.fft.fft2(z)) <= 1e-5


# (2, 8, 16): radix-4 + radix-2 rows, radix-2 tail on columns of 8;
# (1, 64, 32): all-radix-4 columns; (1, 256, 256): the square tile
@pytest.mark.parametrize("shape", [(2, 8, 16), (1, 64, 32), (1, 256, 256)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft2d_fused_plain_vs_reference(shape, inverse):
    """The Stockham fused kernel's plain version against the reference
    kernel in interpret mode, <= 1e-5 of max (same stages, same fp32
    arithmetic)."""
    from repro.kernels import ops as ref_ops
    from repro_torch.kernels import fft2d_fused
    z = _rand(shape, seed=shape[-1] + shape[-2])
    got = to_complex(fft2d_fused.fft2d_fused_plain(
        from_numpy(z, device="cpu"), inverse=inverse)).numpy()
    ref = _ref(ref_ops.fft2d_fused(RefSplit(jnp.asarray(z.real),
                                            jnp.asarray(z.imag)),
                                   inverse=inverse))
    assert _rel(got, ref) <= 1e-5
    want = np.fft.ifft2(z) if inverse else np.fft.fft2(z)
    assert _rel(got, want) <= 1e-5


def test_fft2_fused_stockham_on_torch_raises_the_reference_error():
    z = _rand((1, 8, 8), seed=4)
    with pytest.raises(ValueError) as ref:
        ref_core.fft2(RefSplit(jnp.asarray(z.real), jnp.asarray(z.imag)),
                      algo="fused_stockham", backend="jnp")
    with pytest.raises(ValueError) as mine:
        core.fft2(from_numpy(z, device="cpu"), algo="fused_stockham",
                  backend="torch")
    assert str(mine.value) == str(ref.value).replace(
        '"pallas"', '"cuda"').replace("jnp", "torch")


def test_fft2_fused_stockham_plan_counts_launch_only_on_card():
    z = _rand((2, 16, 32), seed=8)
    before = dict(ops.LAUNCHES)
    plan = P.get_plan((16, 32), algo="fused_stockham", backend="cuda")
    got = to_complex(plan(from_numpy(z, device="cpu"))).numpy()
    assert (plan.algo, plan.block_batch) == ("fused_stockham", 1)
    assert _rel(got, np.fft.fft2(z)) <= 1e-5
    assert ops.LAUNCHES == before
