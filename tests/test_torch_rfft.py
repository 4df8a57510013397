"""The 1-D real-input slice on the CPU: Cooley-Tukey, the radix-2 Stockham
kernel's plain version, rfft/irfft and 1-D rfft plans against the
reference on the same seeded inputs.  On CPU tensors the cuda backend runs
each kernel's plain version.

Tolerances, as max error / max |reference|: 5e-5 for the 1-D transforms
against the reference (the same fp32 arithmetic, summed in another order;
the 1-D kernels' bound in test_torch_kernels.py) and 1e-4 for round trips
against the input; plan resolution must agree field by field."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import fft1d as ref_fft1d
from repro.core import plan as RP
from repro.core.complexmath import SplitComplex as RefSplit
from repro.kernels import fft_stockham as ref_stockham
import repro_torch.core as core
from repro_torch.core import fft1d, from_numpy, to_complex
from repro_torch.core import plan as P
from repro_torch.kernels import fft_stockham, ops

TOL_1D = 5e-5
TOL_ROUNDTRIP = 1e-4


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


@pytest.mark.parametrize("n", [2, 8, 512])
@pytest.mark.parametrize("variant", ["two_reorder", "one_reorder"])
@pytest.mark.parametrize("inverse", [False, True])
def test_cooley_tukey_matches_reference(n, variant, inverse):
    z = _rand((3, n), seed=n)
    got = to_complex(fft1d.fft_cooley_tukey(
        from_numpy(z, device="cpu"), inverse=inverse,
        variant=variant)).numpy()
    ref = _ref(ref_fft1d.fft_cooley_tukey(_ref_in(z), inverse=inverse,
                                          variant=variant))
    assert _rel(got, ref) <= TOL_1D
    want = np.fft.ifft(z) if inverse else np.fft.fft(z)
    assert _rel(got, want) <= TOL_1D


@pytest.mark.parametrize("algo", ["cooley_tukey", "cooley_tukey_fused"])
def test_cooley_tukey_through_fft_dispatch(algo):
    z = _rand((2, 64), seed=4)
    x = from_numpy(z, device="cpu")
    assert _rel(to_complex(core.fft(x, algo=algo)).numpy(),
                np.fft.fft(z)) <= TOL_1D
    back = core.ifft(core.fft(x, algo=algo), algo=algo)
    assert _rel(to_complex(back).numpy(), z) <= TOL_ROUNDTRIP
    with pytest.raises(ValueError, match="unknown variant"):
        fft1d.fft_cooley_tukey(x, variant="three_reorder")


@pytest.mark.parametrize("n", [2, 8, 2048])
@pytest.mark.parametrize("inverse", [False, True])
def test_radix2_stockham_plain_matches_reference_kernel(n, inverse):
    """The radix-2 kernel's plain version against the reference Pallas
    kernel (_stockham_kernel_r2) in interpret mode, and through ops."""
    z = _rand((4, n), seed=n + 1)
    x = from_numpy(z, device="cpu")
    got = to_complex(fft_stockham.fft_stockham_r2_plain(
        x, inverse=inverse)).numpy()
    ref = _ref(ref_stockham.fft_stockham_pallas(
        _ref_in(z), inverse=inverse, radix=2, block_batch=4,
        interpret=True))
    assert _rel(got, ref) <= TOL_1D
    via_ops = to_complex(ops.fft_stockham(x, inverse=inverse,
                                          radix=2)).numpy()
    assert np.array_equal(via_ops, got)


def test_stockham2_c2c_plan_runs_the_radix2_path():
    z = _rand((2, 1024), seed=9)
    plan = P.plan_fft(1024, algo="stockham2", backend="cuda")
    assert (plan.algo, plan.radix, plan.backend) == ("stockham", 2, "cuda")
    got = to_complex(plan(from_numpy(z, device="cpu"))).numpy()
    assert _rel(got, np.fft.fft(z)) <= TOL_1D


@pytest.mark.parametrize("n", [8, 64, 600, 2048])
@pytest.mark.parametrize("backends", [("pallas", "cuda"), ("jnp", "torch")])
def test_rfft_irfft_match_reference(n, backends):
    """rfft/irfft through the registry on both backends (600 demotes on
    the kernel backend: its inner length 300 has no kernel path)."""
    x = _real((3, n), seed=n)
    got = to_complex(core.rfft(_t(x), backend=backends[1])).numpy()
    ref = _ref(ref_core.rfft(jnp.asarray(x), backend=backends[0]))
    assert got.shape == (3, n // 2 + 1)
    assert _rel(got, ref) <= TOL_1D
    assert _rel(got, np.fft.rfft(x)) <= TOL_1D
    xf = from_numpy(got, device="cpu")
    back = core.irfft(xf, backend=backends[1]).numpy()
    ref_back = np.asarray(ref_core.irfft(_ref_in(got), backend=backends[0]))
    assert _rel(back, ref_back) <= TOL_1D
    assert _rel(back, x) <= TOL_ROUNDTRIP


@pytest.mark.parametrize("n", [6, 15, 16, 40])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_irfft_fits_and_odd_lengths_match_numpy(n, backend):
    """irfft(xf, n) truncates or zero-pads the 17-bin spectrum first; odd
    n runs the direct Hermitian extension (numpy semantics)."""
    zf = _rand((2, 17), seed=n)
    got = core.irfft(from_numpy(zf, device="cpu"), n,
                     backend=backend).numpy()
    assert got.shape == (2, n)
    assert _rel(got, np.fft.irfft(zf, n)) <= TOL_1D
    ref = np.asarray(ref_core.irfft(_ref_in(zf), n, backend="jnp"))
    assert _rel(got, ref) <= TOL_1D


@pytest.mark.parametrize("bins,n", [(9, 16), (9, 8), (9, 40), (5, 7)])
def test_fit_half_spectrum_matches_reference(bins, n):
    zf = _rand((2, bins), seed=bins)
    got = to_complex(fft1d._fit_half_spectrum(from_numpy(zf, device="cpu"),
                                              n)).numpy()
    ref = _ref(ref_fft1d._fit_half_spectrum(_ref_in(zf), n))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("algo", ["stockham", "stockham2", "four_step",
                                  "naive", "cooley_tukey", "bluestein"])
def test_rfft_explicit_inner_algos_match_reference(algo):
    x = _real((2, 1024), seed=7)
    got = to_complex(core.rfft(_t(x), algo=algo, backend="cuda")).numpy()
    ref = _ref(ref_core.rfft(jnp.asarray(x), algo=algo, backend="pallas"))
    assert _rel(got, ref) <= TOL_1D
    back = core.irfft(from_numpy(got, device="cpu"), algo=algo,
                      backend="cuda").numpy()
    assert _rel(back, x) <= TOL_ROUNDTRIP


RFFT_SHAPES_1D = [(2,), (4,), (8,), (512,), (600,), (1000,), (1024,),
                  (4096,), (1 << 21,), (1 << 22,), (1 << 23,)]


def _agree(mine, ref):
    crossed = P.plan_from_reference(dataclasses.asdict(ref))
    assert mine == crossed, (mine, ref)


@pytest.mark.parametrize("shape", RFFT_SHAPES_1D)
@pytest.mark.parametrize("backends", [("pallas", "cuda"), ("jnp", "torch")])
@pytest.mark.parametrize("inverse", [False, True])
def test_rfft_plan_parity_1d(shape, backends, inverse):
    ref = RP.get_plan(shape, inverse=inverse, backend=backends[0],
                      kind="rfft")
    mine = P.get_plan(shape, inverse=inverse, backend=backends[1],
                      kind="rfft")
    _agree(mine, ref)
    assert mine is P.get_plan(shape, inverse=inverse, backend=backends[1],
                              kind="rfft")


@pytest.mark.parametrize("shape,algo", [
    ((1024,), "stockham2"), ((1024,), "naive"), ((1024,), "cooley_tukey"),
    ((1024,), "four_step"), ((600,), "stockham"), ((4,), "stockham2"),
    ((2,), "four_step")])
@pytest.mark.parametrize("backends", [("pallas", "cuda"), ("jnp", "torch")])
@pytest.mark.parametrize("inverse", [False, True])
def test_rfft_plan_explicit_algo_parity_1d(shape, algo, backends, inverse):
    ref = RP.get_plan(shape, inverse=inverse, algo=algo, backend=backends[0],
                      kind="rfft")
    _agree(P.get_plan(shape, inverse=inverse, algo=algo,
                      backend=backends[1], kind="rfft"), ref)


def test_rfft_plan_requests_refused_like_reference():
    for kw in (dict(shape=(7,)), dict(shape=(8, 8, 8))):
        with pytest.raises(ValueError):
            RP.get_plan(kind="rfft", **kw)
        with pytest.raises(ValueError):
            P.get_plan(kind="rfft", **kw)
    with pytest.raises(ValueError):
        core.rfft(_t(_real((2, 7), seed=0)), algo="stockham")
    plan = P.get_plan((16,), kind="rfft", backend="torch")
    with pytest.raises(ValueError, match="got input"):
        plan(_t(_real((2, 8), seed=0)))


def test_rfft_counts_no_launch_on_cpu():
    before = dict(ops.LAUNCHES)
    core.rfft(_t(_real((2, 4096), seed=1)), backend="cuda")
    core.rfft(_t(_real((2, 64), seed=1)), algo="stockham2", backend="cuda")
    assert ops.LAUNCHES == before
