"""GPipe pipeline parallelism over 4 gloo ranks, one stage a rank:
forward and the gradients with respect to every stage's weights and the
input equal the sequential loop's, and the JAX reference's on 4 emulated
devices (tests/test_pipeline_pp.py), on the same seeded inputs.

Tolerances: the forward within 1e-5 absolute and the gradients within
1e-4 of max|grad| (the reference test's bounds), against the sequential
loop in torch and against the reference."""
import concurrent.futures
import functools

import numpy as np
import pytest
import torch

from _subproc import run_with_devices
from repro_torch.dist import make_mesh
from repro_torch.dist.local import LocalGroup
from repro_torch.dist.pipeline import pipelined_apply

MICRO = [1, 2, 4, 8]

REF_CODE = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.dist.pipeline import pipelined_apply
from repro.launch.mesh import make_mesh

d = dict(np.load(r"IN_PATH"))
mesh = make_mesh((4,), ("pod",))
ws, x = jnp.asarray(d["ws"]), jnp.asarray(d["x"])
def stage_fn(w, v): return jnp.tanh(v @ w)
out = {}
for mb in MICRO:
    f = jax.jit(lambda ws, x: pipelined_apply(mesh, "pod", stage_fn, ws, x,
                                              mb))
    out[f"out/{mb}"] = np.asarray(f(ws, x))
    loss = lambda ws, x: jnp.sum(f(ws, x) ** 2)
    gw, gx = jax.grad(loss, argnums=(0, 1))(ws, x)
    out[f"gw/{mb}"], out[f"gx/{mb}"] = np.asarray(gw), np.asarray(gx)
np.savez(r"OUT_PATH", **out)
print("REF_OK")
"""


def _inputs():
    rng = np.random.default_rng(0)
    return {"ws": (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32),
            "x": rng.standard_normal((8, 16)).astype(np.float32)}


def _stage(w, v):
    return torch.tanh(v @ w)


@functools.lru_cache(maxsize=None)
def _mesh():
    return make_mesh((4,), ("pod",), device="cpu")


def _rank_pipeline(ws, x, n_micro):
    m = _mesh()
    w = torch.from_numpy(ws[m.get_local_rank("pod")]).requires_grad_()
    xx = torch.from_numpy(x).requires_grad_()
    out = pipelined_apply(m, "pod", _stage, w, xx, n_micro)
    (out ** 2).sum().backward()
    return out.detach().numpy(), w.grad.numpy(), xx.grad.numpy()


def _sequential(ws, x):
    w = torch.from_numpy(ws).requires_grad_()
    xx = torch.from_numpy(x).requires_grad_()
    y = xx
    for s in range(w.shape[0]):
        y = _stage(w[s], y)
    (y ** 2).sum().backward()
    return y.detach().numpy(), w.grad.numpy(), xx.grad.numpy()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    code = (REF_CODE.replace("IN_PATH", str(d / "in.npz"))
            .replace("OUT_PATH", str(d / "ref.npz"))
            .replace("MICRO", repr(MICRO)))
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


def _close(got, want, tol):
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("n_micro", MICRO)
def test_pipeline_forward_and_gradients(env, n_micro):
    inputs, group, ref = env
    ws, x = inputs["ws"], inputs["x"]
    outs = group.run(_rank_pipeline, ws, x, n_micro)
    y, gw, gx = _sequential(ws, x)
    r = ref()
    for rank, (out, g_w, g_x) in enumerate(outs):
        assert np.abs(out - y).max() < 1e-5                # every rank
        assert np.abs(out - r[f"out/{n_micro}"]).max() < 1e-5
        _close(g_w, gw[rank], 1e-4)                        # its own stage
        _close(g_w, r[f"gw/{n_micro}"][rank], 1e-4)
        _close(g_x, gx, 1e-4)                              # the whole dx
        _close(g_x, r[f"gx/{n_micro}"], 1e-4)
