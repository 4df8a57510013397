"""The port's real-input pencil FFTs over 4 gloo ranks against the JAX
reference on 4 emulated devices, on the same seeded numpy inputs:
prfft2/pirfft2 (both layouts, the three wire formats, ``s=`` fits, the
cuda backend's plans), the packed layout's pack/unpack, and the halved
exchange bytes — measured by the wire log on every rank, priced by
``exchange_bytes`` and predicted by ``tt.trace_dist`` — against the
reference's.

The reference's calls run under ``jax.jit`` (one compile a call, where
its eager ``shard_map`` compiles every op).  Tolerances: fp32 with the plain wire 1e-6 of max|ref| against the
reference and float64 numpy (the reference test's prfft2 bound); the
compressed wires at the reference test's bounds (bf16 5e-2, int8 0.35);
roundtrips 1e-5 of max|x|; pack/unpack 1e-7; byte counts exact."""
import concurrent.futures
import functools
import math

import numpy as np
import pytest
import torch

from _subproc import run_with_devices
from repro_torch.core import plan as plan_lib
from repro_torch.core.complexmath import SplitComplex
from repro_torch.dist import assemble, local_block, make_mesh, pencil
from repro_torch.dist.local import LocalGroup
from repro_torch.tt import trace as tttrace

TOL = 1e-6
WIRE_TOL = {"none": TOL, "bf16": 5e-2, "int8": 0.35}
FLAT = {"data": 4}
SHAPES = [(64, 64), (32, 128), (128, 64)]
FITS = [None, (64, 32), (64, 128), (32, 64), (32, 48)]
CUDA_SHAPE = (16, 1024)          # the row rfft's inner 512 has a kernel

REF_CODE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.complexmath import SplitComplex
from repro.dist import pencil
from repro.launch.mesh import make_mesh

d = dict(np.load(r"IN_PATH"))
out = {}
m = make_mesh((4,), ("data",))
sh = NamedSharding(m, P("data", None))

def host(y):
    return np.asarray(y.re) + 1j * np.asarray(y.im)

def real(x):
    return jax.device_put(jnp.asarray(x, jnp.float32), sh)

def jit(f, *args):        # one compile a call instead of one an op
    return jax.jit(f)(*args)

for name in NAMES:
    o = jit(lambda x: pencil.prfft2(x, m, "data"), real(d[name]))
    out[f"prfft2/{name}"] = host(o)
    out[f"back/{name}"] = np.asarray(jit(lambda o: pencil.pirfft2(
        o, m, "data"), o))
    out[f"natural/{name}"] = host(jit(lambda x: pencil.prfft2(
        x, m, "data", transposed_output=False), real(d[name])))
for method in ("bf16", "int8"):
    out[f"wire/{method}"] = host(jit(lambda x: pencil.prfft2(
        x, m, "data", compress=method), real(d["x0"])))
packed = SplitComplex(jax.device_put(jnp.asarray(d["packed"].real, jnp.float32), sh),
                      jax.device_put(jnp.asarray(d["packed"].imag, jnp.float32), sh))
for i, s in enumerate(FITS):
    out[f"fit/{i}"] = np.asarray(jit(lambda z: pencil.pirfft2(
        z, m, "data", s=s), packed))
out["pallas"] = host(jit(lambda x: pencil.prfft2(x, m, "data",
                                                 backend="pallas"),
                         real(d["xc"])))
np.savez(r"OUT_PATH", **out)
print("REF_OK")
"""


def _inputs():
    rng = np.random.default_rng(29)
    d = {f"x{i}": rng.standard_normal(s) for i, s in enumerate(SHAPES)}
    d["xc"] = rng.standard_normal(CUDA_SHAPE)
    # the packed transposed half spectrum of x0, from float64 numpy
    spec_t = np.fft.rfft2(d["x0"]).T
    row0 = spec_t[0] + 1j * spec_t[-1]
    d["packed"] = np.concatenate([row0[None], spec_t[1:-1]])
    return d


# -- the rank side ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mesh():
    return make_mesh((4,), ("data",), device="cpu")


def _host(y: SplitComplex):
    return y.re.numpy().astype(np.float64) + 1j * y.im.numpy()


def _rank_prfft2(x, compress="none", transposed=True, backend="torch"):
    m = _mesh()
    xr = torch.from_numpy(np.ascontiguousarray(
        local_block(x, m, ("data", None)))).float()
    pencil.reset_wire_log()
    y = pencil.prfft2(xr, m, transposed_output=transposed, compress=compress,
                      backend=backend)
    return _host(y), pencil.logged_exchange_bytes()


def _rank_pfft2_zero_imag(x, compress):
    m = _mesh()
    xr = torch.from_numpy(np.ascontiguousarray(
        local_block(x, m, ("data", None)))).float()
    pencil.reset_wire_log()
    pencil.pfft2(SplitComplex(xr, torch.zeros_like(xr)), m,
                 compress=compress)
    return pencil.logged_exchange_bytes()


def _rank_pirfft2(packed, s=None, backend="torch"):
    m = _mesh()
    b = local_block(packed, m, ("data", None))
    z = SplitComplex(torch.from_numpy(np.ascontiguousarray(b.real)).float(),
                     torch.from_numpy(np.ascontiguousarray(b.imag)).float())
    return pencil.pirfft2(z, m, s=s, backend=backend).numpy()


def _rank_row_plan(w):
    pl = plan_lib.get_plan((w,), kind="rfft", backend="cuda")
    return pl.backend, pl.algo, pl.demote_reason


# -- fixtures -----------------------------------------------------------------

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_rfft")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    code = (REF_CODE.replace("IN_PATH", str(d / "in.npz"))
            .replace("OUT_PATH", str(d / "ref.npz"))
            .replace("NAMES", repr([f"x{i}" for i in range(len(SHAPES))]))
            .replace("FITS", repr(FITS)))
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


def _unpack(packed_t: np.ndarray) -> np.ndarray:
    y = pencil.unpack_half_spectrum(SplitComplex(
        torch.from_numpy(packed_t.real.copy()),
        torch.from_numpy(packed_t.imag.copy())))
    return y.re.numpy() + 1j * y.im.numpy()


# -- prfft2 / pirfft2 ---------------------------------------------------------

@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_prfft2_matches_reference_and_numpy(env, i):
    inputs, group, ref = env
    x = inputs[f"x{i}"]
    h, w = x.shape
    outs = group.run(_rank_prfft2, x)
    packed = assemble([o[0] for o in outs], FLAT, ("data", None))
    assert packed.shape == (w // 2, h)
    got = _unpack(packed).T
    assert _rel(got, np.fft.rfft2(x)) <= TOL
    assert _rel(packed, ref()[f"prfft2/x{i}"]) <= TOL
    # the halved exchange on every rank, as exchange_bytes prices it
    assert {o[1] for o in outs} == {pencil.exchange_bytes(h, w, 4,
                                                          real=True)}
    back = assemble(group.run(_rank_pirfft2, packed), FLAT, ("data", None))
    assert np.abs(back - x).max() <= 1e-5 * np.abs(x).max()
    assert _rel(back, ref()[f"back/x{i}"]) <= TOL
    # the unpacked DC and Nyquist columns are conjugate-symmetric along H
    for col in (0, w // 2):
        c = got[:, col]
        assert _rel(np.conj(c[(-np.arange(h)) % h]), c) < 1e-5


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_prfft2_natural_layout_matches_reference(env, i):
    inputs, group, ref = env
    x = inputs[f"x{i}"]
    h, w = x.shape
    outs = group.run(_rank_prfft2, x, "none", False)
    packed = assemble([o[0] for o in outs], FLAT, ("data", None))
    assert packed.shape == (h, w // 2)
    assert _rel(_unpack(packed.T).T, np.fft.rfft2(x)) <= TOL
    assert _rel(packed, ref()[f"natural/x{i}"]) <= TOL
    assert {o[1] for o in outs} == {pencil.exchange_bytes(
        h, w, 4, real=True, transposed_output=False)}


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_wire_formats_halve_the_exchange(env, method):
    inputs, group, ref = env
    x = inputs["x0"]
    h, w = x.shape
    outs = group.run(_rank_prfft2, x, method)
    wire_c = group.run(_rank_pfft2_zero_imag, x, method)
    for (_, wire_r), wc in zip(outs, wire_c):
        assert wire_r * 2 == wc
        assert wire_r <= math.ceil((w // 2 + 1) / w * wc)
        assert wire_r == pencil.exchange_bytes(h, w, 4, real=True,
                                               method=method)
    got = _unpack(assemble([o[0] for o in outs], FLAT, ("data", None))).T
    tol = WIRE_TOL[method]
    assert _rel(got, np.fft.rfft2(x)) <= tol
    if method != "none":
        want = _unpack(ref()[f"wire/{method}"]).T
        assert _rel(got, want) <= tol


@pytest.mark.parametrize("k", range(len(FITS)))
def test_pirfft2_fits_match_reference_and_numpy(env, k):
    inputs, group, ref = env
    s = FITS[k]
    spec = np.fft.rfft2(inputs["x0"])
    got = assemble(group.run(_rank_pirfft2, inputs["packed"], s), FLAT,
                   ("data", None))
    want = np.fft.irfft2(spec, s=s) if s else np.fft.irfft2(spec)
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL
    assert _rel(got, ref()[f"fit/{k}"]) <= TOL


def test_cuda_backend_row_plans_and_roundtrip(env):
    inputs, group, ref = env
    x = inputs["xc"]
    h, w = x.shape
    # the rfft row plan each rank runs is the cuda (kernel) plan
    assert group.run(_rank_row_plan, w) == [("cuda", "four_step", None)] * 4
    outs = group.run(_rank_prfft2, x, "none", True, "cuda")
    packed = assemble([o[0] for o in outs], FLAT, ("data", None))
    assert _rel(_unpack(packed).T, np.fft.rfft2(x)) <= TOL
    assert _rel(packed, ref()["pallas"]) <= TOL
    # the same halved wire as the torch backend: backend changes compute
    assert {o[1] for o in outs} == {pencil.exchange_bytes(h, w, 4,
                                                          real=True)}
    back = assemble(group.run(_rank_pirfft2, packed, None, "cuda"), FLAT,
                    ("data", None))
    assert np.abs(back - x).max() <= 1e-5 * np.abs(x).max()


# -- the packed layout, in-process against the reference ---------------------

@pytest.mark.parametrize("shape", [(8, 16), (2, 8, 16), (5, 2)])
def test_pack_unpack_match_reference(shape):
    import jax.numpy as jnp
    from repro.core.complexmath import SplitComplex as RSC
    from repro.dist import pencil as rpencil
    rng = np.random.default_rng(shape[-1])
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    z = z.astype(np.complex64)
    port = SplitComplex(torch.from_numpy(z.real.copy()),
                        torch.from_numpy(z.imag.copy()))
    refz = RSC(jnp.asarray(z.real), jnp.asarray(z.imag))
    for pf, rf in ((pencil.unpack_half_spectrum,
                    rpencil.unpack_half_spectrum),
                   (pencil.pack_half_spectrum, rpencil.pack_half_spectrum)):
        got, want = pf(port), rf(refz)
        for g, r in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=0, atol=1e-7 * np.abs(z).max())
    # pack inverts unpack
    back = pencil.pack_half_spectrum(pencil.unpack_half_spectrum(port))
    assert torch.allclose(back.re, port.re, atol=1e-6)
    assert torch.allclose(back.im, port.im, atol=1e-6)


# -- exchange bytes: helper, wire log and model agree with the reference -----

@pytest.mark.parametrize("n", [512, 1024])
@pytest.mark.parametrize("devices", [2, 4, 8])
@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exchange_bytes_and_trace_dist_match_reference(n, devices, method,
                                                       dtype):
    import jax.numpy as jnp
    from repro.dist import pencil as rpencil
    from repro.tt import trace as rtrace
    rdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    for real in (False, True):
        for transposed in (True, False):
            got = pencil.exchange_bytes(n, n, devices, real=real,
                                        method=method,
                                        dtype=getattr(torch, dtype),
                                        transposed_output=transposed)
            assert got == rpencil.exchange_bytes(
                n, n, devices, real=real, method=method, dtype=rdt,
                transposed_output=transposed)
            tp = tttrace.trace_dist((n, n), devices=devices, real=real,
                                    method=method, dtype=dtype,
                                    transposed_output=transposed)
            tr = rtrace.trace_dist((n, n), devices=devices, real=real,
                                   method=method, dtype=dtype,
                                   transposed_output=transposed)
            assert tp.exchange_wire_bytes == tr.exchange_wire_bytes
            assert tp.exchange_wire_bytes == pytest.approx(
                got * (devices - 1) / devices, rel=1e-12)
            assert tp.seconds == pytest.approx(tr.seconds, rel=1e-12)
