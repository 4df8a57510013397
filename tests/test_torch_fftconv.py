"""The spectral-convolution slice on the CPU: the fused conv kernel's plain
version, the packed-filter operands and their cache, the per-plan
filter-spectrum cache, conv plan resolution, fft_conv/circular_conv end to
end, gradients through the autograd.Function, and fourier_mix, each
against the reference on the same seeded inputs.  On CPU tensors the cuda
backend runs each kernel's plain version; the reference's Pallas kernel
runs in interpret mode, as its own tests run it.

Tolerances: 1e-5 of max|reference| for the plain kernel against the
reference kernel and for the entry points against the reference (the same
fp32 arithmetic summed in another order); a relative norm < 2e-6 against
float64 numpy (the reference's bound, tests/test_fftconv_fused.py); 1e-4 of
max for gradients (the reference's bound for its custom VJP); 1e-6 of max
for the in-graph pack against the float64 pack; plans agree field by
field."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import circular_conv as ref_circular_conv
from repro.core import fft_conv as ref_fft_conv
from repro.core import fourier_mix as ref_fourier_mix
from repro.core import plan as RP
from repro.core.complexmath import SplitComplex as RefSplit
from repro.kernels import fftconv_fused as ref_fconv
from repro.kernels import ops as ref_ops
from repro_torch.core import (SplitComplex, circular_conv, fft_conv,
                              fourier_mix)
from repro_torch.core import fftconv as fftconv_mod
from repro_torch.core import plan as P
from repro_torch.kernels import fftconv_fused as fconv
from repro_torch.kernels import ops

BACKENDS = [("pallas", "cuda"), ("jnp", "torch")]
TOL = 1e-5
TOL_NUMPY = 2e-6
TOL_GRAD = 1e-4


@pytest.fixture(autouse=True)
def _fresh_registries():
    RP.clear_plan_cache()
    P.clear_plan_cache()
    yield
    RP.clear_plan_cache()
    P.clear_plan_cache()


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _kf64(k, m):
    pad = np.zeros(k.shape[:-1] + (m,), np.float64)
    pad[..., : k.shape[-1]] = k
    return np.fft.rfft(pad)


def _split_ref(c):
    return RefSplit(jnp.asarray(c.real, jnp.float32),
                    jnp.asarray(c.imag, jnp.float32))


def _split(c):
    return SplitComplex(torch.from_numpy(np.ascontiguousarray(c.real))
                        .float(),
                        torch.from_numpy(np.ascontiguousarray(c.imag))
                        .float())


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _rel_norm(got, ref):
    got = np.asarray(got, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


# ---------------------------------------------------------------------------
# The kernel's plain version against the interpret-mode reference kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,rows", [(4, 1), (4, 3), (8, 1), (8, 3), (64, 1),
                                    (64, 3), (1024, 1), (1024, 3),
                                    (1024, 64)])
def test_plain_matches_reference_kernel_shared_bank(m, rows):
    """Shared filter bank (rows, m/2+1) against (batch, rows, m): the SSM
    channel-bank layout, odd row counts and the tiny lengths m = 4, 8."""
    rng = np.random.default_rng(m + rows)
    x = rng.standard_normal((2, rows, m)).astype(np.float32)
    kf = _kf64(rng.standard_normal((rows, m)), m)
    want = np.fft.irfft(np.fft.rfft(x.astype(np.float64)) * kf[None], m)
    ref = np.asarray(ref_ops.fftconv_fused(jnp.asarray(x), _split_ref(kf)))
    ef = fconv.pack_filter(_split(kf), m, torch.float32)
    got = fconv.fftconv_fused_plain(torch.from_numpy(x), ef).numpy()
    assert _rel(got, ref) <= TOL
    assert _rel_norm(got, want) < TOL_NUMPY
    assert _rel_norm(ref, want) < TOL_NUMPY
    # the dispatch wrapper runs the plain version on CPU tensors
    out = ops.fftconv_fused(torch.from_numpy(x), _split(kf)).numpy()
    assert np.array_equal(out, got)


def test_plain_matches_reference_kernel_per_batch_banks():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 512)).astype(np.float32)
    kf = _kf64(rng.standard_normal((3, 5, 512)), 512)
    want = np.fft.irfft(np.fft.rfft(x.astype(np.float64)) * kf, 512)
    ref = np.asarray(ref_ops.fftconv_fused(jnp.asarray(x), _split_ref(kf)))
    got = ops.fftconv_fused(torch.from_numpy(x), _split(kf)).numpy()
    assert _rel(got, ref) <= TOL
    assert _rel_norm(got, want) < TOL_NUMPY


@pytest.mark.parametrize("xshape,kshape", [
    ((0, 3, 16), (3, 9)), ((2, 0, 16), (9,)), ((16,), (9,)),
    ((2, 4, 16), (1, 4, 9)), ((4, 16), (2, 1, 9))])
def test_wrapper_broadcast_rules_match_reference(xshape, kshape):
    """Lead shapes broadcast, the last lead dim is the row axis, empty
    batches and row counts return zeros of the broadcast shape."""
    x = _real(xshape, 1)
    kf = _kf64(_real(kshape, 2), 16)
    ref = np.asarray(ref_ops.fftconv_fused(jnp.asarray(x), _split_ref(kf)))
    got = ops.fftconv_fused(torch.from_numpy(x), _split(kf)).numpy()
    assert got.shape == ref.shape
    if ref.size:
        assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("m", [0, 2, 3, 6, 768])
def test_check_len_message_is_the_references(m):
    with pytest.raises(ValueError) as want:
        ref_fconv._check_len(m)
    with pytest.raises(ValueError) as got:
        fconv._check_len(m)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Packed-domain filter operands and their cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,lead", [(4, (2,)), (256, (4,)), (64, (2, 3))])
def test_pack_filter_np_bit_identical(m, lead):
    kf = _kf64(_real(lead + (m,), m), m).astype(np.complex64)
    e_r, f_r = ref_fconv._pack_filter_np(kf.real, kf.imag, m, jnp.float32)
    ks = _split(kf)
    e, f = fconv._pack_filter_np(ks.re, ks.im, m, torch.float32)
    for a, b in ((e, e_r), (f, f_r)):
        assert np.array_equal(a.re.numpy(), np.asarray(b.re))
        assert np.array_equal(a.im.numpy(), np.asarray(b.im))


def test_pack_filter_torch_matches_np():
    """The in-graph pack (filters autograd records through) and the
    float64 pack build the same E/F operands."""
    m = 256
    kf = _split(_kf64(_real((4, m), 1), m))
    e_np, f_np = fconv._pack_filter_np(kf.re, kf.im, m, torch.float32)
    e_tr, f_tr = fconv._pack_filter_torch(kf, m, torch.float32)
    for a, b in ((e_np, e_tr), (f_np, f_tr)):
        scale = a.re.abs().max().item()
        for p, q in zip(a, b):
            assert (p - q).abs().max().item() <= 1e-6 * scale


def test_pack_filter_cache():
    """One filter across calls -> one pack; a fresh filter replaces the
    entry; a filter autograd records through bypasses the cache; a filter
    updated in place repacks (torch tensors are mutable)."""
    fconv.clear_pack_cache()
    m = 128
    kf = _split(_kf64(_real((3, m), 2), m))
    ef1 = fconv.pack_filter(kf, m, torch.float32)
    assert fconv.pack_filter(kf, m, torch.float32) is ef1
    kf3 = _split(_kf64(_real((3, m), 3), m))
    ef3 = fconv.pack_filter(kf3, m, torch.float32)
    assert ef3 is not ef1
    assert len(fconv._PACK_CACHE) == 1     # one entry per shape/length key
    tracked = SplitComplex(kf3.re.clone().requires_grad_(True), kf3.im)
    eft = fconv.pack_filter(tracked, m, torch.float32)
    assert eft[0].re.requires_grad
    assert fconv.pack_filter(kf3, m, torch.float32) is ef3
    kf3.re.mul_(2.0)                       # in place: same object
    ef4 = fconv.pack_filter(kf3, m, torch.float32)
    assert ef4 is not ef3
    want = fconv._pack_filter_np(kf3.re, kf3.im, m, torch.float32)
    assert torch.equal(ef4[0].re, want[0].re)
    fconv.clear_pack_cache()
    assert not fconv._PACK_CACHE


# ---------------------------------------------------------------------------
# Conv plans and the filter-spectrum cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [3, 4, 8, 768, 1024])
@pytest.mark.parametrize("kind", ["conv_causal", "conv_circular"])
@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("algo", ["auto", "fused", "unfused"])
def test_conv_plan_parity(m, kind, backends, algo):
    try:
        ref = RP.get_plan((m,), kind=kind, backend=backends[0], algo=algo)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            P.get_plan((m,), kind=kind, backend=backends[1], algo=algo)
        want = str(e).replace('"pallas"', '"cuda"').replace("jnp", "torch")
        assert str(got.value) == want
        return
    mine = P.get_plan((m,), kind=kind, backend=backends[1], algo=algo)
    for f in ("shape", "dtype", "inverse", "algo", "radix", "block_batch",
              "kind", "variant", "demote_reason", "tuned"):
        assert getattr(mine, f) == getattr(ref, f), (f, mine, ref)
    assert mine.backend == dict(BACKENDS)[ref.backend]
    assert P.plan_from_reference(dataclasses.asdict(ref)) == mine


@pytest.mark.parametrize("kw", [dict(shape=(8, 8)), dict(shape=(4, 4, 4)),
                                dict(shape=(1024,), inverse=True)])
def test_conv_plan_errors_are_the_references(kw):
    with pytest.raises(ValueError) as want:
        RP.get_plan(kind="conv_causal", **kw)
    with pytest.raises(ValueError) as got:
        P.get_plan(kind="conv_causal", **kw)
    assert str(got.value) == str(want.value)


def test_filter_spectrum_cached_once_per_plan_key():
    """With one filter tensor the filter's rfft runs once per conv plan key;
    a fresh filter recomputes; a filter autograd records through bypasses
    the cache."""
    x = torch.from_numpy(_real((2, 4, 200), 3))
    k = torch.from_numpy(_real((4, 33), 4))
    for _ in range(4):
        fft_conv(x, k, backend="cuda")
    (key, stats), = fftconv_mod.SPECTRUM_STATS.items()
    assert key[2:] == ("conv_causal", "cuda", "fused")
    assert stats == {"computes": 1, "hits": 3}
    k2 = torch.from_numpy(_real((4, 33), 5))
    fft_conv(x, k2, backend="cuda")
    assert fftconv_mod.SPECTRUM_STATS[key] == {"computes": 2, "hits": 3}
    fft_conv(x, k2.clone().requires_grad_(True), backend="cuda")
    assert fftconv_mod.SPECTRUM_STATS[key] == {"computes": 2, "hits": 3}
    P.clear_plan_cache()
    assert not fftconv_mod.SPECTRUM_STATS and not fconv._PACK_CACHE


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_filter_updated_in_place_recomputes(backend):
    """A filter updated in place keeps its identity; the spectrum and pack
    caches compare its version too, so the next call is right."""
    xz, kz = _real((2, 4, 200), 6), _real((4, 33), 7)
    x, k = torch.from_numpy(xz), torch.from_numpy(kz.copy())
    fft_conv(x, k, backend=backend)
    fft_conv(x, k, backend=backend)
    with torch.no_grad():
        k.copy_(torch.from_numpy(kz * -3.0))
    got = fft_conv(x, k, backend=backend).numpy()
    (stats,) = fftconv_mod.SPECTRUM_STATS.values()
    assert stats == {"computes": 2, "hits": 1}
    want = np.stack([[np.convolve(xz[b, c], -3.0 * kz[c])[:200]
                      for c in range(4)] for b in range(2)])
    assert _rel_norm(got, want) < TOL_NUMPY


# ---------------------------------------------------------------------------
# Entry points end to end, against the reference on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("causal", [True, False])
def test_fft_conv_matches_reference(backends, causal):
    x, k = _real((4, 16, 1000), 8), _real((16, 65), 9)
    ref = np.asarray(ref_fft_conv(jnp.asarray(x), jnp.asarray(k),
                                  causal=causal, backend=backends[0]))
    got = fft_conv(torch.from_numpy(x), torch.from_numpy(k), causal=causal,
                   backend=backends[1]).numpy()
    full = np.stack([[np.convolve(x[b, c].astype(np.float64), k[c])
                      for c in range(16)] for b in range(4)])
    want = full if not causal else full[..., :1000]
    assert got.shape == ref.shape == want.shape
    assert _rel(got, ref) <= TOL
    assert _rel_norm(got, want) < TOL_NUMPY


@pytest.mark.parametrize("backends", BACKENDS)
def test_fft_conv_ssm_broadcast_pattern(backends):
    """The Mamba2 conv branch: x (B, C, L) against w.T[None] (1, C, K), the
    depthwise filter bank shared across the batch."""
    x, w = _real((2, 24, 120), 10), _real((4, 24), 11)
    ref = np.asarray(ref_fft_conv(jnp.asarray(x), jnp.asarray(w).T[None],
                                  backend=backends[0]))
    got = fft_conv(torch.from_numpy(x), torch.from_numpy(w).T[None],
                   backend=backends[1]).numpy()
    want = np.stack([[np.convolve(x[b, c].astype(np.float64), w[:, c])[:120]
                      for c in range(24)] for b in range(2)])
    assert _rel(got, ref) <= TOL
    assert _rel_norm(got, want) < TOL_NUMPY


@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("m", [256, 768])
def test_circular_conv_matches_reference(backends, m):
    x, k = _real((2, 8, m), 12), _real((8, m), 13)
    ref = np.asarray(ref_circular_conv(jnp.asarray(x), jnp.asarray(k),
                                       backend=backends[0]))
    got = circular_conv(torch.from_numpy(x), torch.from_numpy(k),
                        backend=backends[1]).numpy()
    want = np.real(np.fft.ifft(np.fft.fft(x.astype(np.float64))
                               * np.fft.fft(k.astype(np.float64))[None]))
    assert _rel(got, ref) <= TOL
    assert _rel_norm(got, want) < TOL_NUMPY
    plan = P.get_plan((m,), kind="conv_circular", backend=backends[1])
    rplan = RP.get_plan((m,), kind="conv_circular", backend=backends[0])
    assert plan.demote_reason == rplan.demote_reason


@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("algo", ["stockham", "four_step"])
def test_conv_explicit_algo_matches_reference(backends, algo):
    x, k = _real((2, 3, 300), 14), _real((3, 17), 15)
    ref = np.asarray(ref_fft_conv(jnp.asarray(x), jnp.asarray(k), algo=algo,
                                  backend=backends[0]))
    got = fft_conv(torch.from_numpy(x), torch.from_numpy(k), algo=algo,
                   backend=backends[1]).numpy()
    assert _rel(got, ref) <= TOL
    xc, kc = _real((2, 256), 16), _real((256,), 17)
    ref = np.asarray(ref_circular_conv(jnp.asarray(xc), jnp.asarray(kc),
                                       algo=algo, backend=backends[0]))
    got = circular_conv(torch.from_numpy(xc), torch.from_numpy(kc),
                        algo=algo, backend=backends[1]).numpy()
    assert _rel(got, ref) <= TOL


# ---------------------------------------------------------------------------
# Gradients: the autograd.Function against the reference's custom VJP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xshape,kshape", [((2, 4, 300), (4, 33)),
                                           ((2, 6, 64), (1, 6, 4))])
def test_fused_gradients_match_reference(xshape, kshape):
    xz, kz = _real(xshape, 18), _real(kshape, 19)

    def ref_loss(a, b):
        return jnp.sum(ref_fft_conv(a, b, backend="pallas") ** 2)

    rgx, rgk = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(xz),
                                                  jnp.asarray(kz))

    def grads(backend):
        x = torch.from_numpy(xz).requires_grad_(True)
        k = torch.from_numpy(kz).requires_grad_(True)
        loss = (fft_conv(x, k, backend=backend) ** 2).sum()
        return [g.numpy() for g in torch.autograd.grad(loss, (x, k))]

    gx, gk = grads("cuda")
    assert _rel(gx, rgx) <= TOL_GRAD and _rel(gk, rgk) <= TOL_GRAD
    tx, tk = grads("torch")
    assert _rel(gx, tx) <= TOL_GRAD and _rel(gk, tk) <= TOL_GRAD


def test_autograd_function_returns_no_packed_filter_gradient():
    """Backward gives dx and the whole kf gradient through the kf planes;
    the packed pair (E, F), built in the graph here, gets none, so the
    filter's gradient is counted once: it equals the plain twin's."""
    x = torch.from_numpy(_real((2, 3, 64), 20)).requires_grad_(True)
    kf = SplitComplex(torch.from_numpy(_real((3, 33), 21))
                      .requires_grad_(True),
                      torch.from_numpy(_real((3, 33), 22))
                      .requires_grad_(True))
    y = ops.fftconv_fused(x, kf)
    g = torch.from_numpy(_real((2, 3, 64), 23))
    got = torch.autograd.grad(y, (x, kf.re, kf.im), g)
    want = torch.autograd.grad(ops._fftconv_ref(x, kf), (x, kf.re, kf.im), g)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


# ---------------------------------------------------------------------------
# fourier_mix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("shape", [(2, 64, 32), (3, 24, 16), (512, 8)])
def test_fourier_mix_matches_reference(backends, shape):
    x = _real(shape, 24)
    ref = np.asarray(ref_fourier_mix(jnp.asarray(x), backend=backends[0]))
    got = fourier_mix(torch.from_numpy(x), backend=backends[1]).numpy()
    want = np.real(np.fft.fft2(x.astype(np.float64)))
    assert _rel(got, ref) <= TOL
    assert _rel(got, want) <= TOL
