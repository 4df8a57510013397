"""The port's compressed collectives over 4 gloo ranks against the JAX
reference on 4 emulated devices (tests/test_compression.py), on the same
seeded inputs: ``psum_compressed`` and ``all_to_all_compressed`` in each
wire format, and ``wire_bytes`` on the same trees in-process.

Tolerances: psum against the exact sum at the reference test's bounds
(none 1e-6, bf16 0.1, int8 0.3 of max|sum|) and against the reference's
result within 1e-6 of max|sum| (the same wire values, summed in another
order); all_to_all against the reference's result exactly for the plain
and bf16 wires (a permutation of the same values) and within 1e-6 of
max|ref| for int8 (XLA's dequantisation rounds an ulp apart); byte counts
exact."""
import concurrent.futures
import functools

import numpy as np
import pytest
import torch

from _subproc import run_with_devices
from repro_torch.dist import assemble, local_block, make_mesh
from repro_torch.dist.compression import (METHODS, all_to_all_compressed,
                                          psum_compressed, wire_bytes)
from repro_torch.dist.local import LocalGroup

FLAT = {"data": 4}
PSUM_TOL = {"none": 1e-6, "bf16": 0.1, "int8": 0.3}
# (global shape, split_axis, concat_axis, spec)
A2A = [((16, 16), 1, 0, ("data", None)), ((16, 16), 0, 1, ("data", None)),
       ((8, 16, 4), 2, 0, ("data", None, None)),
       ((8, 16, 4), 1, 2, (None, "data", None))]

REF_CODE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.dist._compat import shard_map
from repro.dist.compression import all_to_all_compressed, psum_compressed
from repro.launch.mesh import make_mesh

d = dict(np.load(r"IN_PATH"))
mesh = make_mesh((4,), ("data",))
out = {}
x = jnp.asarray(d["x"], jnp.float32)
for method in ("none", "bf16", "int8"):
    fn = shard_map(lambda v: psum_compressed(v[0], "data", method),
                   mesh=mesh, in_specs=(P("data", None),), out_specs=P())
    out[f"psum/{method}"] = np.asarray(jax.jit(fn)(x))
for i, (shape, sa, ca, spec) in enumerate(A2A):
    a = jnp.asarray(d[f"a{i}"], jnp.float32)
    for method in ("none", "bf16", "int8"):
        fn = shard_map(lambda v: all_to_all_compressed(v, "data", sa, ca,
                                                       method),
                       mesh=mesh, in_specs=(P(*spec),), out_specs=P(*spec))
        out[f"a2a/{i}/{method}"] = np.asarray(jax.jit(fn)(a))
np.savez(r"OUT_PATH", **out)
print("REF_OK")
"""


def _inputs():
    rng = np.random.default_rng(0)
    d = {"x": rng.standard_normal((4, 64)) * 3.0}
    for i, (shape, *_) in enumerate(A2A):
        d[f"a{i}"] = rng.standard_normal(shape) * (1 + i)
    return d


@functools.lru_cache(maxsize=None)
def _mesh():
    return make_mesh((4,), ("data",), device="cpu")


def _rank_psum(x, method):
    m = _mesh()
    row = torch.from_numpy(np.ascontiguousarray(
        local_block(x, m, ("data", None))[0])).float()
    tree = {"a": row, "b": (row * 2, [row[:8]])}
    out = psum_compressed(tree, m, "data", method)
    assert isinstance(out, dict) and isinstance(out["b"], tuple)
    return out["a"].numpy(), out["b"][0].numpy(), out["b"][1][0].numpy()


def _rank_a2a(a, i, method):
    _, sa, ca, spec = A2A[i]
    m = _mesh()
    blk = torch.from_numpy(np.ascontiguousarray(
        local_block(a, m, spec))).float()
    return all_to_all_compressed(blk, m, "data", sa, ca, method).numpy()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("compression")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    code = (REF_CODE.replace("IN_PATH", str(d / "in.npz"))
            .replace("OUT_PATH", str(d / "ref.npz"))
            .replace("A2A", repr(A2A)))
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


@pytest.mark.parametrize("method", METHODS)
def test_psum_compressed_matches_reference(env, method):
    inputs, group, ref = env
    x = inputs["x"].astype(np.float32)
    want = x.sum(0)
    outs = group.run(_rank_psum, x, method)
    scale = np.abs(want).max()
    for a, b, c in outs:
        np.testing.assert_array_equal(a, outs[0][0])     # replicated
        assert np.abs(a - want).max() / scale < PSUM_TOL[method]
        assert np.abs(a - ref()[f"psum/{method}"]).max() <= 1e-6 * scale
        # each leaf has its own int8 scale: the short leaf is summed alone
        assert np.abs(c - want[:8]).max() / scale < PSUM_TOL[method]
        assert np.abs(b - 2 * want).max() / (2 * scale) < PSUM_TOL[method]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("i", range(len(A2A)))
def test_all_to_all_compressed_matches_reference(env, i, method):
    inputs, group, ref = env
    a = inputs[f"a{i}"].astype(np.float32)
    spec = A2A[i][3]
    got = assemble(group.run(_rank_a2a, a, i, method), FLAT, spec)
    want = ref()[f"a2a/{i}/{method}"]
    if method == "int8":          # XLA's dequantisation rounds an ulp apart
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


def test_unknown_method_is_refused():
    with pytest.raises(ValueError, match="unknown compression method"):
        wire_bytes(torch.zeros(3), "fp8")


TREES = [((4, 8), (16,)), ((3,), (2, 2, 2)), ((1024,), ()), ((5, 7), (7, 5))]
DTYPES = ["float32", "bfloat16", "float16", "int8", "int32"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shapes", TREES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_wire_bytes_matches_reference(method, shapes, dtype):
    """The same trees, as torch tensors and as jax arrays, leaf 0 of
    ``dtype`` and leaf 1 float32: the reference's byte count."""
    import jax.numpy as jnp
    from repro.dist.compression import wire_bytes as ref_wire_bytes
    s0, s1 = shapes
    tree = {"w": torch.zeros(s0, dtype=getattr(torch, dtype)),
            "b": [torch.zeros(s1)]}
    rtree = {"w": jnp.zeros(s0, getattr(jnp, dtype)), "b": [jnp.zeros(s1)]}
    assert wire_bytes(tree, method) == ref_wire_bytes(rtree, method)
    # numpy leaves price the same
    assert wire_bytes((np.zeros(s1, np.float32),), method) \
        == wire_bytes((torch.zeros(s1),), method)
