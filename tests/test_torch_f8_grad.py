"""ROADMAP §3 F8: the kernel wrappers refuse inputs that require grad.

The CUDA kernels write through raw pointers into buffers autograd does
not track, so a wrapper handed an input that requires grad would drop its
gradient without a word.  The reference refuses instead (``jax.grad``
through ``backend="pallas"`` fails to linearize).  The port raises
``kernels.ops.GradientNotSupported`` from every wrapper but the conv's
(an ``autograd.Function``), on both devices, and the guarded executor
never falls back from it.  Under ``torch.no_grad()``, and for inputs that
do not require grad, the same calls run the plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core.spectral import fourier_mix as r_fourier_mix
from repro_torch.core import SplitComplex, fft2, fourier_mix
from repro_torch.kernels import ops
from repro_torch.resilience import executor

MIX = (2, 512, 64)          # 512-point plans resolve to fft_fourstep
IMG = (64, 64)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def test_reference_refuses_grad_through_pallas():
    x = jnp.asarray(_x(MIX))
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda x: r_fourier_mix(x, backend="pallas").sum())(x)
    a = jnp.asarray(_x(IMG))
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda a: rc.fft2(rc.SplitComplex(a, jnp.zeros_like(a)),
                                   backend="pallas").re.sum())(a)


def test_fourier_mix_refuses_grad():
    executor.reset()
    x = torch.from_numpy(_x(MIX)).requires_grad_(True)
    with pytest.raises(ops.GradientNotSupported, match="fft_fourstep"):
        fourier_mix(x, backend="cuda")
    assert all(st["fallbacks"] == 0 for st in executor.stats().values())
    # the torch backend differentiates
    g, = torch.autograd.grad(fourier_mix(x, backend="torch").sum(), x)
    assert bool(torch.isfinite(g).all())


def test_fft2_refuses_grad():
    a = torch.from_numpy(_x(IMG)).requires_grad_(True)
    with pytest.raises(ops.GradientNotSupported):
        fft2(SplitComplex(a, torch.zeros_like(a)), backend="cuda")
    with pytest.raises(ops.GradientNotSupported):
        fft2(SplitComplex(torch.zeros_like(a), a), backend="cuda")


def test_no_grad_and_plain_inputs_still_run():
    x = torch.from_numpy(_x(MIX))
    want = fourier_mix(x, backend="torch")
    with torch.no_grad():
        got = fourier_mix(x.clone().requires_grad_(True), backend="cuda")
    assert not got.requires_grad
    for y in (got, fourier_mix(x, backend="cuda")):
        assert float((y - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
    a = torch.from_numpy(_x(IMG))
    with torch.no_grad():
        y = fft2(SplitComplex(a.requires_grad_(True), torch.zeros_like(a)),
                 backend="cuda")
    ref = np.fft.fft2(_x(IMG).astype(np.float64))
    assert np.abs(y.re.numpy() - ref.real).max() <= 1e-4 * np.abs(ref).max()


def _sc(shape, grad):
    re = torch.from_numpy(_x(shape)).requires_grad_(grad)
    return SplitComplex(re, torch.from_numpy(_x(shape, 1)))


WRAPPERS = {
    "fft_stockham": lambda g: ops.fft_stockham(_sc((2, 64), g)),
    "fft_stockham_r2": lambda g: ops.fft_stockham(_sc((2, 64), g), radix=2),
    "fft_fourstep": lambda g: ops.fft_fourstep(_sc((2, 256), g)),
    "fft_staged": lambda g: ops.fft_staged(_sc((2, 64), g)),
    "fft2d_fused": lambda g: ops.fft2d_fused(_sc((1, 16, 16), g)),
    "fft2d_gemm": lambda g: ops.fft2d_gemm(_sc((1, 16, 16), g)),
    "fft3d_fused": lambda g: ops.fft3d_fused(_sc((1, 4, 8, 8), g)),
    "rfft2d_fused": lambda g: ops.rfft2d_fused(
        torch.from_numpy(_x((1, 16, 16))).requires_grad_(g)),
    "irfft2d_fused": lambda g: ops.irfft2d_fused(_sc((1, 16, 9), g)),
    "decode_attention": lambda g: ops.decode_attention(
        torch.from_numpy(_x((2, 4, 16))).requires_grad_(g),
        torch.from_numpy(_x((2, 8, 2, 16), 1)),
        torch.from_numpy(_x((2, 8, 2, 16), 2)),
        torch.arange(8, dtype=torch.int32).expand(2, 8).contiguous(),
        torch.full((2,), 7, dtype=torch.int32)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_every_kernel_wrapper_refuses_grad(name):
    with pytest.raises(ops.GradientNotSupported, match=name):
        WRAPPERS[name](True)
    WRAPPERS[name](False)                # plain inputs run
    with torch.no_grad():
        WRAPPERS[name](True)


def test_conv_keeps_its_autograd():
    x = torch.from_numpy(_x((2, 3, 16))).requires_grad_(True)
    k = torch.from_numpy(_x((3, 16), 1))
    kf = SplitComplex(*(t.requires_grad_(True) for t in (
        torch.fft.rfft(k).real.contiguous(),
        torch.fft.rfft(k).imag.contiguous())))
    y = ops.fftconv_fused(x, kf)
    gx, gr, gi = torch.autograd.grad(y.square().sum(), (x, kf.re, kf.im))
    assert all(bool(torch.isfinite(g).all()) for g in (gx, gr, gi))


def test_executor_never_recovers_the_refusal():
    err = ops.GradientNotSupported("fft_fourstep: ...")
    assert not executor.recoverable(err, on_card=False)
    assert not executor.recoverable(err, on_card=True)
    assert executor.recoverable(RuntimeError("x"), on_card=False)
