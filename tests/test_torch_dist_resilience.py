"""Exchange integrity of the port's pencil FFTs over 4 gloo ranks against
the JAX reference's matrix (tests/test_dist_resilience.py) on the same
seeded inputs: energy-checksummed exchanges detect each injected wire
fault, recover on the one retry bit-identical to the clean run, raise
``ExchangeIntegrityError`` when the fault persists, and every rank takes
the same branch — also when only one rank has the fault installed, which
would hang the group if a rank retried alone.  Then the group's own
failure handling: a rank that raises fails the run, and ``make_mesh``'s
refusals.

Tolerances: results against the clean run bit for bit; the clean run's
energy delta below 1e-6 (fp32 rounding of the all-reduced energies; the
reference's is computed in one XLA program); outputs against the
reference within 1e-6 of max|ref|."""
import concurrent.futures
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _subproc import run_with_devices
from repro_torch.core.complexmath import SplitComplex
from repro_torch.dist import assemble, local_block, make_mesh, pencil
from repro_torch.dist.local import LocalGroup, RankFailed
from repro_torch.resilience import faults

FLAT = {"data": 4}
KINDS = ("drop", "corrupt", "nan")

REF_CODE = r"""
import json
import numpy as np, jax, jax.numpy as jnp
from repro.core.complexmath import SplitComplex
from repro.dist import _compat, pencil
from repro.dist._compat import make_mesh
from repro.resilience import faults

# one compile a transform instead of one an op: the body is still traced
# on every call, so the fault site's visits are those of the eager runs
_unchecked = _compat.shard_map_unchecked
pencil.shard_map_unchecked = lambda f, **kw: jax.jit(_unchecked(f, **kw))

d = dict(np.load(r"IN_PATH"))
mesh = make_mesh((4,), ("data",))
x = SplitComplex(jnp.asarray(d["x"].real, jnp.float32),
                 jnp.asarray(d["x"].imag, jnp.float32))
host = lambda y: np.asarray(y.re) + 1j * np.asarray(y.im)
out, res = {}, {}
out["clean"] = host(pencil.pfft2(x, mesh))
pencil.reset_exchange_log()
out["verified"] = host(pencil.pfft2(x, mesh, verify=True))
res["clean_log"] = [e["ok"] for e in pencil.exchange_log()]
for kind in ("drop", "corrupt", "nan"):
    pencil.reset_exchange_log()
    with faults.inject("dist.exchange", kind) as fp:
        out[kind] = host(pencil.pfft2(x, mesh, verify=True))
    res[kind] = [[e["ok"] for e in pencil.exchange_log()], fp.fired()]
with faults.inject("dist.exchange", "drop"):
    out["unverified"] = host(pencil.pfft2(x, mesh))
try:
    with faults.inject("dist.exchange", "drop", times=None):
        pencil.pfft2(x, mesh, verify=True)
    res["persistent"] = None
except pencil.ExchangeIntegrityError as e:
    res["persistent"] = e.tag
xr = jnp.asarray(d["xr"], jnp.float32)
with faults.inject("dist.exchange", "corrupt"):
    rout = pencil.prfft2(xr, mesh, verify=True)
out["rfft"] = host(rout)
with faults.inject("dist.exchange", "nan"):
    out["rback"] = np.asarray(pencil.pirfft2(rout, mesh, verify=True))
pencil.reset_exchange_log()
pencil.pfft2(x, mesh, compress="bf16", verify=True)
res["bf16"] = [e["ok"] for e in pencil.exchange_log()]
np.savez(r"OUT_PATH", **out)
print("RES " + json.dumps(res))
"""


def _inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((64, 64))
            + 1j * rng.standard_normal((64, 64)),
            "xr": rng.standard_normal((64, 64))}


# -- the rank side ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mesh():
    return make_mesh((4,), ("data",), device="cpu")


def _block(z):
    b = local_block(z, _mesh(), ("data", None))
    return SplitComplex(torch.from_numpy(np.ascontiguousarray(b.real)).float(),
                        torch.from_numpy(np.ascontiguousarray(b.imag)).float())


def _host(y):
    return np.stack([y.re.numpy(), y.im.numpy()])


def _log():
    return [(e["ok"], e["delta"], e["attempt"])
            for e in pencil.exchange_log()]


def _rank_clean(x):
    m = _mesh()
    plain = pencil.pfft2(_block(x), m)
    pencil.reset_exchange_log()
    verified = pencil.pfft2(_block(x), m, verify=True)
    return _host(plain), _host(verified), _log()


def _rank_fault(x, kind, times=1, install_rank=None, verify=True):
    """pfft2 under a ``dist.exchange`` fault installed on every rank, or
    on ``install_rank`` alone; (output or the error's tag, log, fired)."""
    m = _mesh()
    pencil.reset_exchange_log()
    plan = faults.FaultPlan().add("dist.exchange", kind, times=times)
    mine = install_rank is None or dist.get_rank() == install_rank
    try:
        if mine:
            with plan:
                y = pencil.pfft2(_block(x), m, verify=verify)
        else:
            y = pencil.pfft2(_block(x), m, verify=verify)
    except pencil.ExchangeIntegrityError as e:
        return e.tag, _log(), plan.fired()
    return _host(y), _log(), plan.fired()


def _rank_guarded_columns(x, kind):
    """pfft2 with backend="cuda" at (512, 8): the 512-point column pass is
    a cuda plan whose guard scans its output (here its plain version)."""
    m = _mesh()
    xb = _block(x)
    clean = pencil.pfft2(xb, m, backend="cuda")
    pencil.reset_exchange_log()
    with faults.inject("dist.exchange", kind):
        y = pencil.pfft2(xb, m, backend="cuda", verify=True)
    return (torch.equal(y.re, clean.re) and torch.equal(y.im, clean.im),
            [e["ok"] for e in pencil.exchange_log()])


def _rank_rfft_pair(xr):
    m = _mesh()
    xl = torch.from_numpy(np.ascontiguousarray(
        local_block(xr, m, ("data", None)))).float()
    clean = pencil.prfft2(xl, m)
    with faults.inject("dist.exchange", "corrupt"):
        out = pencil.prfft2(xl, m, verify=True)
    with faults.inject("dist.exchange", "nan"):
        back = pencil.pirfft2(out, m, verify=True)
    same = torch.equal(out.re, clean.re) and torch.equal(out.im, clean.im)
    return _host(out), back.numpy(), same


def _rank_bf16(x):
    pencil.reset_exchange_log()
    pencil.pfft2(_block(x), _mesh(), compress="bf16", verify=True)
    return [e["ok"] for e in pencil.exchange_log()]


def _rank_raises_on(rank):
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return dist.get_rank()


def _rank_mesh_refusals():
    msgs = []
    for kw in (dict(shape=(4,), names=("data",), backend="nccl"),
               dict(shape=(8,), names=("data",)),
               dict(shape=(2, 2), names=("data",))):
        try:
            make_mesh(kw.pop("shape"), kw.pop("names"), device="cpu", **kw)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu",
                     backend="gloo")
    return msgs, [mesh.get_local_rank(a) for a in ("pod", "data")]


# -- fixtures -----------------------------------------------------------------

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    import json
    d = tmp_path_factory.mktemp("dist_res")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    code = (REF_CODE.replace("IN_PATH", str(d / "in.npz"))
            .replace("OUT_PATH", str(d / "ref.npz")))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ref_run = pool.submit(run_with_devices, code, 4)

    @functools.lru_cache(maxsize=None)
    def ref():
        line = [ln for ln in ref_run.result().splitlines()
                if ln.startswith("RES ")][0]
        return json.loads(line[4:]), dict(np.load(d / "ref.npz"))

    group = LocalGroup(4)
    try:
        yield inputs, group, ref
    finally:
        group.close()
        pool.shutdown(wait=True)


def _full(outs):
    """The assembled complex result from each rank's stacked planes."""
    g = assemble(outs, FLAT, (None, "data", None))
    return g[0].astype(np.float64) + 1j * g[1]


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_clean_verified_run_is_one_attempt(env):
    inputs, group, ref = env
    outs = group.run(_rank_clean, inputs["x"])
    res, rout = ref()
    for plain, verified, log in outs:
        np.testing.assert_array_equal(plain, verified)
        assert [ok for ok, _, _ in log] == res["clean_log"] == [True]
        assert log[0][1] < 1e-6
    # every rank read the same (all-reduced) delta
    assert len({log[0][1] for _, _, log in outs}) == 1
    assert _rel(_full([o[0] for o in outs]).T, rout["clean"].T) <= 1e-6


@pytest.mark.parametrize("kind", KINDS)
def test_fault_detected_and_recovered_bit_identical(env, kind):
    inputs, group, ref = env
    clean = group.run(_rank_clean, inputs["x"])
    outs = group.run(_rank_fault, inputs["x"], kind)
    res, rout = ref()
    oks, fired = res[kind]
    assert oks == [False, True] and fired == 1
    for (y, log, n), (c, _, _) in zip(outs, clean):
        assert [ok for ok, _, _ in log] == oks and n == fired
        np.testing.assert_array_equal(y, c)
    # the same branch on every rank, on the same deltas
    assert len({tuple(map(str, o[1])) for o in outs}) == 1
    assert _rel(_full([o[0] for o in outs]), rout[kind]) <= 1e-6


def test_unverified_fault_passes_through(env):
    inputs, group, ref = env
    clean = group.run(_rank_clean, inputs["x"])
    outs = group.run(_rank_fault, inputs["x"], "drop", 1, None, False)
    got = _full([o[0] for o in outs])
    assert not np.array_equal(got, _full([c[0] for c in clean]))
    assert _rel(got, ref()[1]["unverified"]) <= 1e-6


@pytest.mark.parametrize("kind", KINDS)
def test_persistent_fault_raises_on_every_rank(env, kind):
    inputs, group, ref = env
    outs = group.run(_rank_fault, inputs["x"], kind, None)
    assert ref()[0]["persistent"] == "pfft2"
    for tag, log, fired in outs:
        assert tag == "pfft2"
        assert [ok for ok, _, _ in log] == [False, False] and fired == 2


@pytest.mark.parametrize("install_rank,oks", [(0, [False, True]),
                                              (2, [True])])
def test_every_rank_takes_the_same_branch(env, install_rank, oks):
    """The fault plan on one rank only: installed on the rank at index 0
    (the one that corrupts) every rank still retries with it, since the
    delta is all-reduced; installed elsewhere nothing is corrupted and no
    rank retries.  A rank retrying alone would leave the others blocked
    in their next collective (the group's timeout would fail the run)."""
    inputs, group, _ = env
    clean = group.run(_rank_clean, inputs["x"])
    outs = group.run(_rank_fault, inputs["x"], "corrupt", 1, install_rank)
    for r, ((y, log, fired), (c, _, _)) in enumerate(zip(outs, clean)):
        assert [ok for ok, _, _ in log] == oks
        assert fired == (1 if r == install_rank else 0)
        np.testing.assert_array_equal(y, c)


@pytest.mark.parametrize("kind", KINDS)
def test_wire_fault_never_reaches_a_guarded_pass(env, kind):
    """A NaN payload fed to the guarded cuda column pass would fail its
    guard, and the torch fallback's too (GuardViolation, as pfft2 at
    8192² with backend="cuda" does on the card): verify checks each
    exchange as it lands, so the retry comes first."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((512, 8)) + 1j * rng.standard_normal((512, 8))
    outs = env[1].run(_rank_guarded_columns, x, kind)
    assert outs == [(True, [False, True])] * 4


def test_rfft_pair_recovers_under_verify(env):
    inputs, group, ref = env
    xr = inputs["xr"]
    outs = group.run(_rank_rfft_pair, xr)
    assert all(o[2] for o in outs)
    back = assemble([o[1] for o in outs], FLAT, ("data", None))
    assert np.abs(back - xr).max() < 1e-5
    rout = ref()[1]
    assert _rel(_full([o[0] for o in outs]), rout["rfft"]) <= 1e-6
    assert _rel(back, rout["rback"]) <= 1e-6


def test_bf16_wire_passes_verify(env):
    inputs, group, ref = env
    assert group.run(_rank_bf16, inputs["x"]) == [ref()[0]["bf16"]] * 4 \
        == [[True]] * 4


def test_make_mesh_refusals_and_coordinates(env):
    _, group, _ = env
    outs = group.run(_rank_mesh_refusals)
    for r, (msgs, coord) in enumerate(outs):
        assert "make_mesh(backend='nccl') on a 'gloo'" in msgs[0]
        assert "needs 8 ranks" in msgs[1]
        assert "differ in length" in msgs[2]
        assert coord == [r // 2, r % 2]       # row-major rank layout


def test_a_failing_rank_fails_the_run():
    group = LocalGroup(2, timeout_s=30)
    try:
        assert group.run(_rank_raises_on, 5) == [0, 1]
        with pytest.raises(RankFailed, match="rank 1 fails on purpose"):
            group.run(_rank_raises_on, 1)
        procs = group._procs
        assert procs == []                    # closed by the failure
        with pytest.raises(RankFailed, match="closed"):
            group.run(_rank_raises_on, 5)
    finally:
        group.close()
