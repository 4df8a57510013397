"""Plan resolution parity: the port's registry resolves every c2c 1-D and
2-D key exactly as the reference's does (backend names mapped
pallas -> cuda, jnp -> torch), interns plans the same way, and carries a
reference plan across with plan_from_reference."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.core import plan as RP
from repro_torch.core import plan as P

BACKENDS = [("pallas", "cuda"), ("jnp", "torch")]
FIELDS = ("shape", "dtype", "inverse", "algo", "radix", "block_batch",
          "kind", "variant", "demote_reason", "tuned")
SHAPES_1D = [(1,), (2,), (4,), (13,), (256,), (257,), (512,), (997,), (1000,),
             (1024,), (4096,), (1 << 20,), (1 << 21,), (1 << 22,), (3 * 1024,)]
SHAPES_2D = [(2, 2), (8, 4), (64, 128), (1024, 1024), (4096, 4096),
             (1000, 1000), (97, 128), (256, 13), (64, 1), (1, 64)]


@pytest.fixture(autouse=True)
def _fresh_registries():
    RP.clear_plan_cache()
    P.clear_plan_cache()
    yield
    RP.clear_plan_cache()
    P.clear_plan_cache()


def _agree(mine, ref):
    for f in FIELDS:
        assert getattr(mine, f) == getattr(ref, f), (f, mine, ref)
    assert mine.backend == dict(BACKENDS)[ref.backend]


@pytest.mark.parametrize("shape", SHAPES_1D + SHAPES_2D)
@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("inverse", [False, True])
def test_auto_resolution_parity(shape, backends, inverse):
    ref = RP.get_plan(shape, inverse=inverse, backend=backends[0])
    mine = P.get_plan(shape, inverse=inverse, backend=backends[1])
    _agree(mine, ref)


@pytest.mark.parametrize("shape,algo", [
    ((1024,), "stockham"), ((1024,), "stockham2"), ((1024,), "naive"),
    ((4096,), "four_step"), ((1000,), "four_step"), ((64, 64), "row_col"),
    ((64, 64), "fused"), ((64, 64), "fused_stockham"), ((96, 64), "fused")])
@pytest.mark.parametrize("backends", BACKENDS)
def test_explicit_algo_parity(shape, algo, backends):
    try:
        ref = RP.get_plan(shape, algo=algo, backend=backends[0])
    except ValueError:
        with pytest.raises(ValueError):
            P.get_plan(shape, algo=algo, backend=backends[1])
        return
    _agree(P.get_plan(shape, algo=algo, backend=backends[1]), ref)


@pytest.mark.parametrize("dtype", [(jnp.bfloat16, torch.bfloat16),
                                   (jnp.float16, torch.float16),
                                   (jnp.float32, torch.float32)])
@pytest.mark.parametrize("variant", ["auto", "plain"])
@pytest.mark.parametrize("shape", [(64, 64), (96, 64), (1024,)])
def test_variant_parity(dtype, variant, shape):
    ref = RP.get_plan(shape, dtype=dtype[0], backend="pallas",
                      variant=variant)
    _agree(P.get_plan(shape, dtype=dtype[1], backend="cuda",
                      variant=variant), ref)


def test_demote_reasons_are_the_references():
    p = P.get_plan((1000, 1000), backend="cuda")
    assert p.backend == "torch"
    assert p.demote_reason == ("kernels need power-of-two tile dims >= 2, "
                               "got (1000, 1000)")
    q = P.get_plan((1000,), inverse=True, backend="cuda")
    assert q.demote_reason == "algo 'bluestein' at (1000,) has no kernel path"


def test_interning():
    a = P.plan_fft2(64, 64, backend="cuda")
    assert P.get_plan((64, 64), backend="cuda") is a
    assert P.plan_ifft2(64, 64, backend="cuda") is not a
    e = P.get_plan((64, 64), algo="row_col", backend="cuda")
    assert e is P.get_plan((64, 64), algo="row_col", backend="cuda")
    assert e is not a and P.get_plan((64, 64), backend="cuda") is a
    assert P.plan_fft(512, backend="cuda") is P.FFTPlan.create(
        512, backend="cuda")
    assert P.plan_ifft(512).inverse
    assert P.plan_cache_size() == 4
    P.clear_plan_cache()
    assert P.plan_cache_size() == 0
    assert P.get_plan((64, 64), backend="cuda") is not a


@pytest.mark.parametrize("shape", [(1024, 1024), (1000, 1000), (1 << 20,),
                                   (1 << 22,), (300,)])
@pytest.mark.parametrize("backends", BACKENDS)
def test_plan_from_reference_round_trip(shape, backends):
    ref = RP.get_plan(shape, backend=backends[0])
    crossed = P.plan_from_reference(dataclasses.asdict(ref))
    assert crossed == P.get_plan(shape, backend=backends[1])


@pytest.mark.parametrize("kw,item", [
    (dict(shape=(8, 8, 8), tune=True), "item 10"),
    (dict(shape=(64,), kind="rfft", tune=True), "item 10"),
    (dict(shape=(64,), kind="conv_causal", tune=True), "item 10"),
    (dict(shape=(64,), tune=True), "item 10")])
def test_unported_plan_requests_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        P.get_plan(**kw)
