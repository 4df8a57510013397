"""The port's pencil FFTs over 4 gloo ranks against the JAX reference on 4
emulated devices, on the same seeded numpy inputs: pfft2 (chunks, both
output layouts, the three wire formats), the forward/inverse roundtrip,
the two-hop hierarchy, pfft3 (both backends, the registry route of its
local passes) and pfft1d (forward and inverse in the four-step layout).

The reference's calls run under ``jax.jit`` (one compile a call, where
its eager ``shard_map`` compiles every op).  Tolerances: fp32 with the plain wire, 1e-6 of max|ref| against the
reference and against float64 numpy; the compressed wires at the
reference tests' own bounds against numpy (bf16 5e-2, int8 0.35 of
max|ref|, tests/test_dist_rfft.py) and against the reference; roundtrips
1e-5 of max|x|.  The ranks run in one module-scoped group
(:class:`repro_torch.dist.local.LocalGroup`, FileStore rendezvous) while
the reference runs in its own subprocess."""
import concurrent.futures
import functools

import numpy as np
import pytest
import torch

from _subproc import run_with_devices
from repro_torch.core import plan as plan_lib
from repro_torch.core.complexmath import SplitComplex
from repro_torch.dist import assemble, local_block, make_mesh, pencil
from repro_torch.dist.local import LocalGroup

TOL = 1e-6
WIRE_TOL = {"none": TOL, "bf16": 5e-2, "int8": 0.35}
FLAT = {"data": 4}
PODS = {"pod": 2, "data": 2}
GRID = {"data": 2, "model": 2}
N1D = 1 << 12

PFFT2 = [(chunks, t, c) for chunks in (1, 2, 4) for t in (True, False)
         for c in ("none", "bf16", "int8")]

REF_CODE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.complexmath import SplitComplex
from repro.core import plan as plan_lib
from repro.dist import pencil
from repro.launch.mesh import make_mesh

d = dict(np.load(r"IN_PATH"))
out = {}

def put(z, mesh, spec):
    sh = NamedSharding(mesh, spec)
    return SplitComplex(jax.device_put(jnp.asarray(z.real, jnp.float32), sh),
                        jax.device_put(jnp.asarray(z.imag, jnp.float32), sh))

def host(y):
    return np.asarray(y.re) + 1j * np.asarray(y.im)

def jit(f, *args):        # one compile a call instead of one an op
    return jax.jit(f)(*args)

m = make_mesh((4,), ("data",))
x = put(d["x2"], m, P("data", None))
for chunks, t, c in PFFT2:
    out[f"pfft2/{chunks}/{int(t)}/{c}"] = host(jit(
        lambda x: pencil.pfft2(x, m, "data", chunks=chunks,
                               transposed_output=t, compress=c), x))
fwd = jit(lambda x: pencil.pfft2(x, m, "data", transposed_output=False), x)
out["roundtrip"] = host(jit(lambda y: pencil.pfft2(
    y, m, "data", inverse=True, transposed_output=False), fwd))
m2 = make_mesh((2, 2), ("pod", "data"))
x2 = put(d["x2"], m2, P(("pod", "data"), None))
out["hier"] = host(jit(lambda x: pencil.pfft2_hierarchical(x, m2), x2))
out["hier_inv"] = host(jit(lambda x: pencil.pfft2_hierarchical(
    x, m2, inverse=True), x2))
m3 = make_mesh((2, 2), ("data", "model"))
x3 = put(d["x3"], m3, P("data", "model", None))
out["pfft3/x3"] = host(jit(lambda x: pencil.pfft3(x, m3), x3))
out["pfft3_inv"] = host(jit(lambda x: pencil.pfft3(x, m3, inverse=True), x3))
out["pfft3/x3k"] = host(jit(lambda x: pencil.pfft3(x, m3, backend="pallas"),
                            put(d["x3k"], m3, P("data", "model", None))))
v = put(d["v"], m, P("data"))
f = jit(lambda v: pencil.pfft1d(v, m, "data"), v)
out["pfft1d"] = host(f)
out["pfft1d_inv"] = host(jit(lambda f: pencil.pfft1d(f, m, "data",
                                                     inverse=True), f))
np.savez(r"OUT_PATH", **out)
print("REF_OK")
"""


def _inputs():
    rng = np.random.default_rng(23)

    def c(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return {"x2": c(64, 64), "x3": c(8, 8, 16), "x3k": c(4, 8, 512),
            "v": c(N1D)}


# -- the rank side: top-level functions, pickled by reference -----------------

@functools.lru_cache(maxsize=None)
def _mesh(shape, names):
    return make_mesh(shape, names, device="cpu")


def _block(z, mesh, spec) -> SplitComplex:
    b = local_block(z, mesh, spec)
    return SplitComplex(torch.from_numpy(np.ascontiguousarray(b.real)).float(),
                        torch.from_numpy(np.ascontiguousarray(b.imag)).float())


def _host(y: SplitComplex):
    return y.re.numpy().astype(np.float64) + 1j * y.im.numpy()


def _rank_pfft2(x, chunks, transposed, compress):
    m = _mesh((4,), ("data",))
    pencil.reset_wire_log()
    y = pencil.pfft2(_block(x, m, ("data", None)), m, chunks=chunks,
                     transposed_output=transposed, compress=compress)
    return _host(y), pencil.logged_exchange_bytes(), len(pencil.wire_log())


def _rank_roundtrip(x):
    m = _mesh((4,), ("data",))
    y = pencil.pfft2(_block(x, m, ("data", None)), m,
                     transposed_output=False)
    return _host(pencil.pfft2(y, m, inverse=True, transposed_output=False))


def _rank_hier(x, inverse):
    m = _mesh((2, 2), ("pod", "data"))
    return _host(pencil.pfft2_hierarchical(
        _block(x, m, (("pod", "data"), None)), m, inverse=inverse))


def _rank_pfft3(x, backend, inverse=False):
    m = _mesh((2, 2), ("data", "model"))
    plan_lib.clear_plan_cache()
    y = pencil.pfft3(_block(x, m, ("data", "model", None)), m,
                     backend=backend, inverse=inverse)
    z = x.shape[-1]
    keys = {k[3] for k in plan_lib._PLAN_CACHE if k[0] == (z,)}
    plan = plan_lib.get_plan((z,), backend=backend)
    return _host(y), sorted(keys), plan.backend, plan.demote_reason


def _rank_pfft1d(v, inverse, backend="torch"):
    m = _mesh((4,), ("data",))
    return _host(pencil.pfft1d(_block(v, m, ("data",)), m, inverse=inverse,
                               backend=backend))


# -- fixtures -----------------------------------------------------------------

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """(inputs, group, reference outputs): the reference's subprocess runs
    while the ranks start and the first tests run."""
    d = tmp_path_factory.mktemp("dist_fft")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    code = (REF_CODE.replace("IN_PATH", str(d / "in.npz"))
            .replace("OUT_PATH", str(d / "ref.npz"))
            .replace("PFFT2", repr(PFFT2)))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ref_run = pool.submit(run_with_devices, code, 4)

    @functools.lru_cache(maxsize=None)
    def ref():
        assert "REF_OK" in ref_run.result()
        return dict(np.load(d / "ref.npz"))

    group = LocalGroup(4)
    try:
        yield inputs, group, ref
    finally:
        group.close()
        pool.shutdown(wait=True)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


# -- pfft2 --------------------------------------------------------------------

@pytest.mark.parametrize("chunks,transposed,compress", PFFT2)
def test_pfft2_matches_reference_and_numpy(env, chunks, transposed,
                                           compress):
    inputs, group, ref = env
    x = inputs["x2"]
    outs = group.run(_rank_pfft2, x, chunks, transposed, compress)
    got = assemble([o[0] for o in outs], FLAT, ("data", None))
    want = np.fft.fft2(x)
    if transposed:
        got = got.T
    tol = WIRE_TOL[compress]
    assert _rel(got, want) <= tol
    r = ref()[f"pfft2/{chunks}/{int(transposed)}/{compress}"]
    assert _rel(got, r.T if transposed else r) <= tol
    # the wire log: one entry an exchange, the payload exchange_bytes prices
    assert all(o[2] == chunks + (0 if transposed else 1) for o in outs)
    assert all(o[1] == pencil.exchange_bytes(
        64, 64, 4, method=compress, transposed_output=transposed)
        for o in outs)


def test_pfft2_roundtrip_matches_reference(env):
    inputs, group, ref = env
    x = inputs["x2"]
    got = assemble(group.run(_rank_roundtrip, x), FLAT, ("data", None))
    assert np.abs(got - x).max() <= 1e-5 * np.abs(x).max()
    assert _rel(got, ref()["roundtrip"]) <= TOL


@pytest.mark.parametrize("inverse", [False, True])
def test_hierarchical_matches_reference(env, inverse):
    inputs, group, ref = env
    x = inputs["x2"]
    outs = group.run(_rank_hier, x, inverse)
    # the output tiling is data-major: P((data, pod), None)
    got = assemble(outs, PODS, (("data", "pod"), None)).T
    want = np.fft.ifft2(x) if inverse else np.fft.fft2(x)
    assert _rel(got, want) <= TOL
    assert _rel(got, ref()["hier_inv" if inverse else "hier"].T) <= TOL


# -- pfft3 --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["x3", "x3k"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_pfft3_matches_reference(env, name, backend):
    inputs, group, ref = env
    x = inputs[name]
    outs = group.run(_rank_pfft3, x, backend)
    got = assemble([o[0] for o in outs], GRID, ("model", "data", None))
    got = got.transpose(2, 1, 0)                 # (Z, Y, X) -> (X, Y, Z)
    want = np.fft.fftn(x)
    assert _rel(got, want) <= TOL
    assert _rel(got, ref()[f"pfft3/{name}"].transpose(2, 1, 0)) <= TOL
    # the local Z pass resolved through the registry: Z = 16 demotes to
    # torch (interned under the torch key), Z = 512 keeps a cuda plan
    _, keys, plan_backend, reason = outs[0]
    if backend == "torch" or name == "x3":
        assert keys == ["torch"] and plan_backend == "torch"
        assert (reason is None) == (backend == "torch")
    else:
        assert keys == ["cuda"] and plan_backend == "cuda" and reason is None


def test_pfft3_inverse_matches_reference(env):
    inputs, group, ref = env
    x = inputs["x3"]
    outs = group.run(_rank_pfft3, x, "torch", True)
    got = assemble([o[0] for o in outs], GRID, ("model", "data", None))
    assert _rel(got.transpose(2, 1, 0), np.fft.ifftn(x)) <= TOL
    assert _rel(got, ref()["pfft3_inv"]) <= TOL


# -- pfft1d -------------------------------------------------------------------

def test_fourstep_split_matches_reference_rule():
    for n in (1 << 10, 1 << 12, 1 << 26, 3 * (1 << 12)):
        for p in (1, 2, 4, 8):
            h, w = p, n // p
            while (w > 2 * h) and (w % 2 == 0) and ((w // 2) % p == 0):
                h, w = h * 2, w // 2
            assert pencil.fourstep_split(n, p) == (h, w)
    assert pencil.fourstep_split(1 << 26, 4) == (8192, 8192)


def test_pfft1d_forward_and_inverse_match_reference(env):
    inputs, group, ref = env
    v = inputs["v"]
    h, w = pencil.fourstep_split(N1D, 4)
    fwd = assemble(group.run(_rank_pfft1d, v, False), FLAT, ("data",))
    assert _rel(fwd.reshape(h, w).T.reshape(-1), np.fft.fft(v)) <= TOL
    assert _rel(fwd, ref()["pfft1d"]) <= TOL
    for backend in ("torch", "cuda"):
        back = assemble(group.run(_rank_pfft1d, fwd, True, backend), FLAT,
                        ("data",))
        assert np.abs(back - v).max() <= 1e-5 * np.abs(v).max()
        assert _rel(back, ref()["pfft1d_inv"]) <= TOL


# -- layouts ------------------------------------------------------------------

@pytest.mark.parametrize("layout,spec", [
    (FLAT, ("data", None)), (FLAT, (None, "data")), (FLAT, ("data",)),
    (PODS, (("pod", "data"), None)), (PODS, (("data", "pod"), None)),
    (GRID, ("data", "model", None)), (GRID, ("model", "data", None)),
    (PODS, ("pod", None))])
def test_local_block_and_assemble_invert(layout, spec):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 8, 4)[:len(spec)])
    world = int(np.prod(list(layout.values())))
    blocks = [local_block(x, layout, spec, rank=r) for r in range(world)]
    np.testing.assert_array_equal(assemble(blocks, layout, spec), x)
    tb = [torch.from_numpy(b) for b in blocks]
    assert torch.equal(assemble(tb, layout, spec), torch.from_numpy(x))
