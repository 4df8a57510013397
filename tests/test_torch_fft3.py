"""The 3-D path on the CPU: the fused 3-D kernel's plain version against
the reference kernel in interpret mode, repro_torch.core.fft3 on both
backends against float64 numpy and repro.core.fft3, and 3-D plan
resolution against the reference's registry.  On CPU tensors the cuda
backend runs each kernel's plain version.

Tolerances: kernel vs reference kernel <= 1e-5 of max|ref| (the same fp32
arithmetic summed in another order, as for the 2-D kernel); fft3 vs
float64 numpy 1e-5 of max, round trips 1e-4 (the reference's bounds,
tests/test_fft3.py)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import plan as RP
from repro.core.complexmath import SplitComplex as RefSplit
from repro.kernels import ops as ref_ops
from repro_torch.core import fft3, from_numpy, to_complex
from repro_torch.core import plan as P
from repro_torch.kernels import fft3d_fused, ops

AXES = (-3, -2, -1)
BACKENDS = [("pallas", "cuda"), ("jnp", "torch")]
# every 3-D key tests/test_fft3.py resolves (tests/test_plan.py has none)
KEYS_3D = [(8, 16, 32), (6, 16, 32), (8, 16, 16), (4, 8, 16), (8, 8, 8),
           (2, 4, 4), (6, 8, 8), (4, 12, 10), (4, 8, 8), (2, 4, 8),
           (4, 16, 32), (32, 16, 4), (16, 16, 16), (32, 32, 32)]


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


def _ref_in(z):
    return RefSplit(jnp.asarray(z.real), jnp.asarray(z.imag))


def _ref_out(y):
    return np.asarray(y.re) + 1j * np.asarray(y.im)


def _port(y):
    return to_complex(y).numpy()


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _ported_message(text: str) -> str:
    """A reference error message in the port's backend names."""
    return text.replace('"pallas"', '"cuda"').replace("jnp", "torch")


# (1, 4, 8, 16): dense on every axis; (2, 2, 4, 256) and (1, 256, 4, 4):
# the four-step branch on W and on D; (2, 8, 8, 8): a batch of cubes
@pytest.mark.parametrize("shape", [(1, 4, 8, 16), (2, 2, 4, 256),
                                   (1, 256, 4, 4), (2, 8, 8, 8)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft3d_fused_plain_vs_reference(shape, inverse):
    z = _rand(shape, seed=sum(shape))
    got = _port(fft3d_fused.fft3d_fused_plain(from_numpy(z, device="cpu"),
                                              inverse=inverse))
    ref = _ref_out(ref_ops.fft3d_fused(_ref_in(z), inverse=inverse))
    assert _rel(got, ref) <= 1e-5
    want = np.fft.ifftn(z, axes=AXES) if inverse else np.fft.fftn(z,
                                                                 axes=AXES)
    assert _rel(got, want) <= 1e-5


def test_fourstep_factors3_match_reference():
    from repro.kernels import fft3d_fused as ref_fused3d
    assert fft3d_fused.FOURSTEP_LEAF3 == ref_fused3d.FOURSTEP_LEAF3
    for n in [1 << k for k in range(1, 13)]:
        assert fft3d_fused.fourstep_factors3(n) == \
            ref_fused3d.fourstep_factors3(n)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("shape", [(2, 8, 16, 32), (4, 8, 4), (1, 2, 256, 8)])
def test_fft3_matches_numpy_and_round_trips(backend, shape):
    z = _rand(shape, seed=len(shape) + shape[-1])
    x = from_numpy(z, device="cpu")
    y = fft3(x, backend=backend)
    assert _rel(_port(y), np.fft.fftn(z, axes=AXES)) <= 1e-5
    back = fft3(y, inverse=True, backend=backend)
    assert _rel(_port(back), z) <= 1e-4


@pytest.mark.parametrize("backends", BACKENDS)
def test_fft3_row_col_matches_reference(backends):
    z = _rand((2, 8, 16, 32), seed=5)
    got = _port(fft3(from_numpy(z, device="cpu"), algo="row_col",
                     backend=backends[1]))
    ref = _ref_out(ref_core.fft2d.fft3(_ref_in(z), algo="row_col",
                                       backend=backends[0]))
    assert _rel(got, ref) <= 1e-5


def test_fft3_demoted_shape_matches_reference():
    """(8, 12, 16) has no kernel path: both registries demote to the
    row-column schedule with the same reason, and the numbers agree."""
    z = _rand((8, 12, 16), seed=12)
    before = dict(ops.LAUNCHES)
    got = _port(fft3(from_numpy(z, device="cpu"), backend="cuda"))
    ref = _ref_out(ref_core.fft2d.fft3(_ref_in(z), backend="pallas"))
    assert _rel(got, ref) <= 1e-5
    assert _rel(got, np.fft.fftn(z)) <= 1e-5
    mine = P.get_plan((8, 12, 16), backend="cuda")
    theirs = RP.get_plan((8, 12, 16), backend="pallas")
    assert mine.backend == "torch" and mine.algo == "row_col"
    assert mine.demote_reason == theirs.demote_reason
    assert ops.LAUNCHES == before


def test_fft3d_fused_empty_and_leading_batch():
    x = from_numpy(np.zeros((0, 4, 4, 4), np.complex64), device="cpu")
    assert ops.fft3d_fused(x).shape == (0, 4, 4, 4)
    z = _rand((2, 3, 4, 8, 16), seed=5)          # a leading batch of rank 2
    got = _port(ops.fft3d_fused(from_numpy(z, device="cpu")))
    assert got.shape == z.shape
    assert _rel(got, np.fft.fftn(z, axes=AXES)) <= 1e-5
    ref = _ref_out(ref_ops.fft3d_fused(_ref_in(z)))
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("shape", KEYS_3D)
@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("inverse", [False, True])
def test_3d_plan_resolution_parity(shape, backends, inverse):
    ref = RP.get_plan(shape, inverse=inverse, backend=backends[0])
    mine = P.get_plan(shape, inverse=inverse, backend=backends[1])
    for f in ("shape", "algo", "radix", "block_batch", "variant",
              "demote_reason", "kind", "dtype"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.backend == dict(BACKENDS)[ref.backend]
    assert P.plan_from_reference(dataclasses.asdict(ref)) == mine


@pytest.mark.parametrize("kw", [
    dict(algo="row_col"), dict(algo="fused"), dict(algo="fused_stockham"),
    dict(algo="stockham"), dict(variant="compensated"),
    dict(variant="compensated", algo="row_col"), dict(variant="plain"),
    dict(kind="rfft")])
@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("shape", [(8, 16, 16), (6, 16, 32)])
def test_3d_explicit_requests_match_reference(kw, backends, shape):
    """Explicit algos and variants on 3-D keys: the same plan, or the same
    ValueError word for word (backend names mapped)."""
    try:
        ref = RP.get_plan(shape, backend=backends[0], **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            P.get_plan(shape, backend=backends[1], **kw)
        assert str(mine.value) == _ported_message(str(e))
        return
    crossed = P.plan_from_reference(dataclasses.asdict(ref))
    assert P.get_plan(shape, backend=backends[1], **kw) == crossed


@pytest.mark.parametrize("dtype", [(jnp.bfloat16, torch.bfloat16),
                                   (jnp.float32, torch.float32)])
@pytest.mark.parametrize("variant", ["auto", "plain", "compensated"])
@pytest.mark.parametrize("backends", BACKENDS)
def test_3d_variant_parity(dtype, variant, backends):
    try:
        ref = RP.get_plan((16, 32, 64), dtype=dtype[0], backend=backends[0],
                          variant=variant)
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            P.get_plan((16, 32, 64), dtype=dtype[1], backend=backends[1],
                       variant=variant)
        assert str(mine.value) == _ported_message(str(e))
        return
    assert P.plan_from_reference(dataclasses.asdict(ref)) == \
        P.get_plan((16, 32, 64), dtype=dtype[1], backend=backends[1],
                   variant=variant)


def test_fft3_entry_errors():
    x = from_numpy(_rand((8, 8, 8), seed=1), device="cpu")
    with pytest.raises(ValueError, match="at least 3 axes"):
        fft3(from_numpy(_rand((8, 8), seed=1), device="cpu"))
    with pytest.raises(ValueError, match='requires backend="cuda"'):
        fft3(x, algo="fused", backend="torch")
    with pytest.raises(ValueError, match="no cuda 3-D path"):
        fft3(x, algo="stockham", backend="cuda")
    with pytest.raises(ValueError, match="power-of-two dims >= 2"):
        ops.fft3d_fused(from_numpy(_rand((1, 6, 8, 8), seed=1), device="cpu"))
    # prune="model" (ROADMAP item 13, once refused here) now tunes the
    # key, measuring the candidates the reference's model keeps
    ref = RP.get_plan((8, 8, 8), backend="pallas")
    _, pruned = RP._model_prune(RP._candidates(ref, batch=2), batch=2,
                                prune_k=None, model_arch="tpu_v5e")
    pl = P.get_plan((8, 8, 8), backend="cuda", tune=True, tune_batch=2,
                    prune="model", device="cpu")
    assert pl.tuned and pruned
    assert pl.tune_report["model_pruned"] == "|".join(
        P._port_label(lbl) for lbl in pruned)


@pytest.mark.parametrize("backends", BACKENDS)
def test_fft3_tuned_plan(backends):
    """A tuned 3-D plan measures the reference's candidates and its winner
    computes fft3 within the 3-D bound (1e-5 of max against numpy)."""
    ref = RP.get_plan((4, 8, 16), backend=backends[0], tune=True,
                      tune_batch=2)
    plan = P.get_plan((4, 8, 16), backend=backends[1], tune=True,
                      tune_batch=2, device="cpu")
    crossed = P.plan_from_reference(dataclasses.asdict(ref))
    assert plan.tuned and list(plan.tune_report) == list(crossed.tune_report)
    z = _rand((2, 4, 8, 16), seed=3)
    got = to_complex(plan(from_numpy(z, device="cpu"))).numpy()
    want = np.fft.fftn(z, axes=AXES)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
