"""Dispatch wrappers around the kernels (counterpart of
:mod:`repro.kernels.ops`).

Each wrapper flattens leading batch dims, guards the empty batch and then
decides by the tensor's device: on a CPU tensor it runs the kernel's plain
PyTorch version (what the CPU tests use); on a CUDA tensor it launches the
CUDA kernel or raises.  There is no fallback from the card to the plain
version.  CUDA kernels need no batch padding, so the complex wrappers
accept ``block_batch`` for plan parity and do not use it.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card (one count per call; a call issues several grid launches, see
PERF.md).  The radix-2 Stockham kernel counts apart from the radix-4 one.
The fused conv counts once per call; at m > 16384 its 1-D transforms run
on the 1-D kernels and count in their own counters too.  ``fft_staged``
(the paper's per-stage Table 1 baseline) counts once per call of its
log2(n) stage launches, ``decode_attention`` (one-token GQA flash-decode)
once per call of its split and merge launches, or of the split launch and
merge into a rank's partial state (:func:`decode_attention_partial`, a
cache split over ranks), and ``decode_merge`` once per merge of the
ranks' gathered partials (:func:`decode_attention_merge`).  Every kernel
takes float32, bfloat16 or float16, the same dtype in and out (decode:
q and the caches).

No kernel has a backward.  Every wrapper but :func:`fftconv_fused` (an
``autograd.Function`` whose backward is its plain twin's VJP) refuses,
on both devices, an input that autograd records through, with
:class:`GradientNotSupported`: the kernels write through raw pointers
into buffers autograd does not track, so a gradient would be dropped
without a word.  The reference's Pallas calls refuse the same way
(``jax.grad`` fails to linearize them).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.complexmath import SplitComplex
from . import _build
from . import fft_stockham as _stockham
from . import fft_fourstep as _fourstep
from . import fft2d_gemm as _gemm2d
from . import fft2d_fused as _fused2d
from . import fft3d_fused as _fused3d
from . import rfft2d_fused as _rfused2d
from . import fftconv_fused as _fconv
from . import fft_stage as _stage
from . import decode_attention as _decode

LAUNCHES = {"fft_stockham": 0, "fft_stockham_r2": 0, "fft_fourstep": 0,
            "fft2d_gemm": 0, "rfft2d_fused": 0, "irfft2d_fused": 0,
            "fftconv_fused": 0, "fft3d_fused": 0, "fft2d_fused": 0,
            "fft_staged": 0, "decode_attention": 0, "decode_merge": 0}


def reset_launches() -> None:
    """Every count to 0: :data:`LAUNCHES` and ``_build.CALLS``."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    _build.CALLS.clear()


class GradientNotSupported(TypeError):
    """A kernel wrapper was handed an input that requires grad while grad
    mode is on.  The guarded executor never recovers it (a fallback to the
    torch twin would let the gradient through on the CPU only)."""


def _refuse_grad(name: str, *operands) -> None:
    if not torch.is_grad_enabled():
        return
    for x in operands:
        planes = (x.re, x.im) if isinstance(x, SplitComplex) else (x,)
        if any(t.requires_grad for t in planes):
            raise GradientNotSupported(
                f"{name}: the kernel has no backward and its input requires "
                "grad; differentiate through backend='torch', or call it "
                "under torch.no_grad()")


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` is a card tensor a kernel can run on.  A fake tensor
    (a dry run's, on a card mesh) holds no data: its ops are the plain
    version's, which count what the kernel's call moves."""
    dev = t.device
    if dev.type == "cuda":
        from torch._subclasses.fake_tensor import FakeTensor
        return not isinstance(t, FakeTensor)
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {dev}")


def _flatten(x: SplitComplex):
    """(batch, n) planes, contiguous (the kernels take dense rows; the
    real-input paths hand in strided even/odd and transposed views)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    return SplitComplex(x.re.reshape(-1, n).contiguous(),
                        x.im.reshape(-1, n).contiguous()), lead


def _unflatten(x: SplitComplex, lead) -> SplitComplex:
    n = x.shape[-1]
    return SplitComplex(x.re.reshape(*lead, n), x.im.reshape(*lead, n))


def _flatten2d(x: SplitComplex):
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    return SplitComplex(x.re.reshape(-1, h, w),
                        x.im.reshape(-1, h, w)), lead


def _flatten3d(x: SplitComplex):
    d, h, w = x.shape[-3:]
    lead = x.shape[:-3]
    return SplitComplex(x.re.reshape(-1, d, h, w).contiguous(),
                        x.im.reshape(-1, d, h, w).contiguous()), lead


def fft_stockham(x: SplitComplex, *, inverse: bool = False, radix: int = 4,
                 block_batch: int = 8) -> SplitComplex:
    """Stockham FFT along the last axis: mixed radix-4/radix-2
    (``radix=4``) or pure radix-2 (``radix=2``, the oracle kernel)."""
    if radix not in (2, 4):
        raise ValueError(f"radix must be 2 or 4, got {radix}")
    _refuse_grad("fft_stockham_r2" if radix == 2 else "fft_stockham", x)
    flat, lead = _flatten(x)
    if flat.shape[0] == 0:
        return x                       # empty batch: nothing to transform
    if radix == 2:
        name, cuda = "fft_stockham_r2", _stockham.fft_stockham_r2_cuda
        plain = _stockham.fft_stockham_r2_plain
    else:
        name, cuda = "fft_stockham", _stockham.fft_stockham_cuda
        plain = _stockham.fft_stockham_plain
    if _on_card(flat.re):
        LAUNCHES[name] += 1
        out = cuda(flat, inverse=inverse)
    else:
        out = plain(flat, inverse=inverse)
    return _unflatten(out, lead)


def fft_fourstep(x: SplitComplex, *, inverse: bool = False,
                 block_batch: int = 4, n1: int = None) -> SplitComplex:
    """Bailey four-step FFT along the last axis."""
    _refuse_grad("fft_fourstep", x)
    flat, lead = _flatten(x)
    if flat.shape[0] == 0:
        return x
    if _on_card(flat.re):
        LAUNCHES["fft_fourstep"] += 1
        out = _fourstep.fft_fourstep_cuda(flat, inverse=inverse, n1=n1)
    else:
        out = _fourstep.fft_fourstep_plain(flat, inverse=inverse, n1=n1)
    return _unflatten(out, lead)


def fft_staged(x: SplitComplex, *, inverse: bool = False,
               block_batch: int = 8) -> SplitComplex:
    """Paper-faithful per-stage radix-2 FFT along the last axis (the
    Table 1 "Initial" baseline): a bit-reverse, then one kernel launch a
    butterfly stage."""
    _refuse_grad("fft_staged", x)
    flat, lead = _flatten(x)
    if flat.shape[0] == 0:
        return x                       # empty batch: nothing to transform
    if _on_card(flat.re):
        LAUNCHES["fft_staged"] += 1
        out = _stage.fft_staged_cuda(flat, inverse=inverse)
    else:
        out = _stage.fft_staged_plain(flat, inverse=inverse)
    return _unflatten(out, lead)


def decode_attention(q, k_cache, v_cache, kv_pos, q_pos, *, window=None,
                     chunk: int = 512, block_batch: int = 8):
    """One-token GQA attention of q (B, H, D) against caches
    (B, S, KV, D) under the position mask of ``kv_pos`` (B, S) (-1 =
    empty) and ``q_pos`` (B,), with an optional sliding ``window``;
    returns (B, H, D) in ``q.dtype``.  As in the reference, ``min(chunk,
    S)`` must divide S."""
    _refuse_grad("decode_attention", q, k_cache, v_cache)
    s = k_cache.shape[1]
    c = min(chunk, s)
    if c <= 0 or s % c:
        raise ValueError(f"chunk {c} must divide the cache length {s} "
                         "(both at least 1)")
    if q.shape[0] == 0:
        return torch.empty_like(q)     # empty batch: nothing to attend
    if _on_card(q):
        LAUNCHES["decode_attention"] += 1
        return _decode.decode_attention_cuda(q, k_cache, v_cache, kv_pos,
                                             q_pos, window=window, chunk=c)
    return _decode.decode_attention_plain(q, k_cache, v_cache, kv_pos,
                                          q_pos, window=window)


def decode_attention_partial(q, k_cache, v_cache, kv_pos, q_pos, *,
                             window=None):
    """:func:`decode_attention` over this rank's slots of a cache split
    over ranks, stopped before the output: the rank's partial softmax
    state (m, l, acc, vsum), fp32 (``kernels/decode_attention.py``)."""
    _refuse_grad("decode_attention", q, k_cache, v_cache)
    if _on_card(q):
        LAUNCHES["decode_attention"] += 1
        return _decode.decode_attention_partial_cuda(
            q, k_cache, v_cache, kv_pos, q_pos, window=window)
    return _decode.decode_attention_partial_plain(
        q, k_cache, v_cache, kv_pos, q_pos, window=window)


def decode_attention_merge(m, l, acc, vsum, slots: int, dtype):
    """The output (B, H, D) in ``dtype`` of the ranks' gathered partial
    states (each with a leading rank axis) over ``slots`` slots in all."""
    if _on_card(m):
        LAUNCHES["decode_merge"] += 1
        return _decode.decode_attention_merge_cuda(m, l, acc, vsum, slots,
                                                   dtype)
    return _decode.decode_attention_merge_plain(m, l, acc, vsum, slots,
                                                dtype)


def fft2d_fused(x: SplitComplex, *, inverse: bool = False,
                block_batch: int = 1) -> SplitComplex:
    """Fused Stockham 2-D FFT over the last two axes (any leading batch
    dims): the ``algo="fused_stockham"`` oracle."""
    _refuse_grad("fft2d_fused", x)
    flat, lead = _flatten2d(x)
    h, w = flat.shape[-2:]
    if flat.shape[0] == 0:
        return x                       # empty batch: nothing to transform
    if _on_card(flat.re):
        LAUNCHES["fft2d_fused"] += 1
        out = _fused2d.fft2d_fused_cuda(flat, inverse=inverse)
    else:
        out = _fused2d.fft2d_fused_plain(flat, inverse=inverse)
    return SplitComplex(out.re.reshape(*lead, h, w),
                        out.im.reshape(*lead, h, w))


def fft2d_gemm(x: SplitComplex, *, inverse: bool = False,
               block_batch: int = 1, variant: str = "plain") -> SplitComplex:
    """GEMM-formulated 2-D FFT over the last two axes (any leading batch
    dims), float32, bfloat16 or float16; ``variant="compensated"`` is the
    precision-compensated sub-fp32 path."""
    _refuse_grad("fft2d_gemm", x)
    flat, lead = _flatten2d(x)
    h, w = flat.shape[-2:]
    if flat.shape[0] == 0:
        _gemm2d.check_variant(variant)
        return x
    if _on_card(flat.re):
        LAUNCHES["fft2d_gemm"] += 1
        out = _gemm2d.fft2d_gemm_cuda(flat, inverse=inverse, variant=variant)
    else:
        out = _gemm2d.fft2d_gemm_plain(flat, inverse=inverse, variant=variant)
    return SplitComplex(out.re.reshape(*lead, h, w),
                        out.im.reshape(*lead, h, w))


def fft3d_fused(x: SplitComplex, *, inverse: bool = False,
                block_batch: int = 1, variant: str = "plain") -> SplitComplex:
    """Fused 3-D FFT over the last three axes (any leading batch dims),
    float32, bfloat16 or float16, the W, H and D GEMM passes with no
    relayout."""
    _refuse_grad("fft3d_fused", x)
    flat, lead = _flatten3d(x)
    d, h, w = flat.shape[-3:]
    if flat.shape[0] == 0:
        _gemm2d.check_variant(variant)
        return x                       # empty batch: nothing to transform
    if _on_card(flat.re):
        LAUNCHES["fft3d_fused"] += 1
        out = _fused3d.fft3d_fused_cuda(flat, inverse=inverse,
                                        variant=variant)
    else:
        out = _fused3d.fft3d_fused_plain(flat, inverse=inverse,
                                         variant=variant)
    return SplitComplex(out.re.reshape(*lead, d, h, w),
                        out.im.reshape(*lead, d, h, w))


def rfft2d_fused(x: torch.Tensor) -> SplitComplex:
    """Real-input 2-D FFT over the last two axes (any leading batch dims):
    real (..., h, w) -> (..., h, w//2+1) half spectra."""
    _refuse_grad("rfft2d_fused", x)
    h, w = x.shape[-2:]
    lead = tuple(x.shape[:-2])
    batch = math.prod(lead)
    if batch == 0:
        return SplitComplex(x.new_zeros((*lead, h, w // 2 + 1)),
                            x.new_zeros((*lead, h, w // 2 + 1)))
    flat = x.reshape(batch, h, w).contiguous()
    if _on_card(flat):
        LAUNCHES["rfft2d_fused"] += 1
        out = _rfused2d.rfft2d_fused_cuda(flat)
    else:
        out = _rfused2d.rfft2d_fused_plain(flat)
    return SplitComplex(out.re.reshape(*lead, h, w // 2 + 1),
                        out.im.reshape(*lead, h, w // 2 + 1))


def irfft2d_fused(xf: SplitComplex) -> torch.Tensor:
    """Inverse of :func:`rfft2d_fused`: (..., h, w/2+1) half spectra ->
    real (..., h, w)."""
    _refuse_grad("irfft2d_fused", xf)
    h, bins = xf.shape[-2:]
    w = 2 * (bins - 1)
    lead = tuple(xf.shape[:-2])
    batch = math.prod(lead)
    if batch == 0:
        return xf.re.new_zeros((*lead, h, w))
    flat = SplitComplex(xf.re.reshape(batch, h, bins).contiguous(),
                        xf.im.reshape(batch, h, bins).contiguous())
    if _on_card(flat.re):
        LAUNCHES["irfft2d_fused"] += 1
        out = _rfused2d.irfft2d_fused_cuda(flat)
    else:
        out = _rfused2d.irfft2d_fused_plain(flat)
    return out.reshape(*lead, h, w)


def _fftconv_ref(x3: torch.Tensor, kf: SplitComplex) -> torch.Tensor:
    """Differentiable plain twin of the fused conv core: the same
    rfft -> pointwise multiply -> irfft at the padded length, through the
    port's plain rfft/irfft (the unfused plan's gradient)."""
    from repro_torch.core import complexmath as cm
    from repro_torch.core import fft1d
    m = x3.shape[-1]
    return fft1d.irfft(cm.mul(fft1d.rfft(x3), kf), m)


def _fftconv_launch(x3: torch.Tensor, ef) -> torch.Tensor:
    if _on_card(x3):
        LAUNCHES["fftconv_fused"] += 1
        return _fconv.fftconv_fused_cuda(x3, ef)
    return _fconv.fftconv_fused_plain(x3, ef)


class _FFTConvCore(torch.autograd.Function):
    """The kernel has no autograd of its own, but the conv core is
    bilinear in (x, kf), so the plain twin's gradient is exact: forward
    runs the fused kernel on the packed pair (E, F), backward the twin's
    vector-Jacobian product.  E/F derive linearly from kf
    (:func:`repro_torch.kernels.fftconv_fused.pack_filter`), so backward
    returns the whole kf gradient through the kf planes and None for
    E/F: anything there would count the filter's gradient twice."""

    @staticmethod
    def forward(ctx, x3, kre, kim, ere, eim, fre, fim):
        ctx.save_for_backward(x3, kre, kim)
        return _fftconv_launch(x3, (SplitComplex(ere, eim),
                                    SplitComplex(fre, fim)))

    @staticmethod
    def backward(ctx, g):
        x3, kre, kim = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (x3, kre, kim)]
            y = _fftconv_ref(ins[0], SplitComplex(ins[1], ins[2]))
            dx, dkr, dki = torch.autograd.grad(y, ins, g)
        return dx, dkr, dki, None, None, None, None


def fftconv_fused(x: torch.Tensor, kf: SplitComplex) -> torch.Tensor:
    """Fused FFT convolution over the last axis: real x (..., m)
    circularly convolved per row with the filter half spectra
    kf (..., m//2+1) -> real of the broadcast shape.

    The leading dims of x and kf broadcast; the last lead dim becomes the
    kernel's row axis.  A kf whose lead dims broadcast to just the row
    axis (the SSM channel bank (C, K) against (B, C, L) activations) stays
    a (rows, m//2) shared operand instead of per-batch copies.  The filter
    packs in its own lead shape, so the pack cache sees the caller's
    filter, and E/F then broadcast as kf does."""
    m = x.shape[-1]
    hm = m // 2
    lead = tuple(torch.broadcast_shapes(x.shape[:-1], kf.re.shape[:-1]))
    out_shape = lead + (m,)
    lead = lead if lead else (1,)
    r = lead[-1]
    batch = math.prod(lead[:-1])
    if batch == 0 or r == 0:
        return x.new_zeros(out_shape)
    xb = x.broadcast_to(lead + (m,)).reshape(batch, r, m).contiguous()
    klead = tuple(kf.re.shape[:-1])
    e, f = _fconv.pack_filter(kf, m, x.dtype)
    # shared bank iff the filter's lead dims broadcast to one row axis
    to2 = tuple(np.broadcast_shapes(klead, (r,)))
    shared = math.prod(to2) == r

    def bcast(t, bins):
        if shared:
            return t.broadcast_to(to2 + (bins,)).reshape(r, bins) \
                .contiguous()
        return t.broadcast_to(lead + (bins,)).reshape(batch, r, bins) \
            .contiguous()

    out = _FFTConvCore.apply(
        xb, bcast(kf.re, hm + 1), bcast(kf.im, hm + 1), bcast(e.re, hm),
        bcast(e.im, hm), bcast(f.re, hm), bcast(f.im, hm))
    return out.reshape(out_shape)
