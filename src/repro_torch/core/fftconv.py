"""FFT-based long convolution (O(L log L)) on real signals.

Counterpart of :mod:`repro.core.fftconv`: SSM/hybrid mixers evaluate their
long-convolution view through the FFT library instead of a direct O(L*K)
conv.

With ``algo="auto"`` every convolution routes through a conv-kind plan
(:mod:`repro_torch.core.plan`, ``kind="conv_causal"`` /
``"conv_circular"``), keyed on the padded FFT length, dtype, backend and
mode.  On ``backend="cuda"`` the plan runs the fused spectral-convolution
kernel (:mod:`repro_torch.kernels.fftconv_fused`); lengths with no kernel
path (non-power-of-two circular lengths, m < 4) demote to the unfused
rfft -> multiply -> irfft schedule with the reference's ``demote_reason``.

The filter half spectrum is cached per plan key: repeated calls at one
length with the same filter tensor (the SSM/Hyena serving pattern) skip
the filter's rfft (``SPECTRUM_STATS`` counts computes and hits).  The hit
test is the tensor's identity and its ``_version``, so a filter updated
in place recomputes: torch tensors are mutable where the reference's
arrays are not.  Filters that autograd records through bypass the cache.

An explicit ``algo=`` (e.g. ``"stockham"``) keeps the direct path:
rfft/irfft with that inner algo, no conv plan, no caching.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import complexmath as cm
from . import fft1d


def _next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(max(n, 1))))


def _pad_last(t: torch.Tensor, to: int) -> torch.Tensor:
    return F.pad(t, (0, to - t.shape[-1]))


# -- per-plan filter-spectrum cache -----------------------------------------

_SPECTRUM_CACHE = {}   # spectrum key -> (filter, its _version, half spectrum)
SPECTRUM_STATS = {}    # spectrum key -> {"computes": int, "hits": int}


def _spectrum_key(plan):
    return (plan.shape, plan.dtype, plan.kind, plan.backend, plan.algo)


def clear_spectrum_cache() -> None:
    """Drop every cached filter spectrum (called by
    :func:`repro_torch.core.plan.clear_plan_cache`: spectra key on plans)
    and the fused kernel's packed-filter cache (packed operands derive
    from spectra)."""
    _SPECTRUM_CACHE.clear()
    SPECTRUM_STATS.clear()
    from repro_torch.kernels import fftconv_fused as _fconv
    _fconv.clear_pack_cache()


def _compute_kf(k: torch.Tensor, m: int) -> cm.SplitComplex:
    return fft1d.rfft(_pad_last(k, m))    # torch registry key: one-time cost


def _filter_spectrum(plan, k: torch.Tensor, m: int) -> cm.SplitComplex:
    """The filter's half spectrum at the plan's padded length, cached per
    plan key.  A hit needs the same tensor at the same ``_version``; a
    fresh tensor, or one updated in place, recomputes and replaces the
    entry (never staler than the filter actually passed).  A filter that
    autograd records through is recomputed every call, in the graph, and
    so is an inference-mode tensor, which has no version to test."""
    from repro_torch.kernels.fftconv_fused import uncacheable
    if uncacheable(k):
        return _compute_kf(k, m)
    key = _spectrum_key(plan)
    stats = SPECTRUM_STATS.setdefault(key, {"computes": 0, "hits": 0})
    ent = _SPECTRUM_CACHE.get(key)
    if ent is not None and ent[0] is k and ent[1] == k._version:
        stats["hits"] += 1
        return ent[2]
    kf = _compute_kf(k, m)
    _SPECTRUM_CACHE[key] = (k, k._version, kf)
    stats["computes"] += 1
    return kf


# -- public entry points -----------------------------------------------------

def _conv_plan(x, k, *, m: int, out_len: int, kind: str, backend: str):
    from . import plan as _plan        # deferred: plan imports fftconv
    plan = _plan.get_plan((m,), dtype=x.dtype, kind=kind, backend=backend)
    kf = _filter_spectrum(plan, k, m)
    xp = _pad_last(x, m) if m > x.shape[-1] else x
    return plan(xp, kf)[..., :out_len]


def _conv_direct(x, k, *, m: int, out_len: int, algo: str, backend: str):
    """The explicit-algo path: rfft -> mul -> irfft with the requested
    inner algo, no conv plan, no spectrum caching."""
    xf = fft1d.rfft(_pad_last(x, m), algo=algo, backend=backend)
    kf = fft1d.rfft(_pad_last(k, m), algo=algo, backend=backend)
    y = fft1d.irfft(cm.mul(xf, kf), m, algo=algo, backend=backend)
    return y[..., :out_len]


def fft_conv(x: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
             algo: str = "auto", backend: str = "torch") -> torch.Tensor:
    """Convolve signal x (..., L) with kernel k (..., K) via rfft.

    causal=True returns y[t] = sum_{s<=t} x[s] k[t-s] truncated to length L
    (the long-conv form of SSM token mixers); causal=False returns the full
    L + K - 1 samples.  ``backend="cuda"`` routes the ``conv_causal`` plan
    to the fused kernel."""
    L = x.shape[-1]
    K = k.shape[-1]
    m = _next_pow2(L + K - 1)
    out_len = L if causal else L + K - 1
    if algo != "auto":
        return _conv_direct(x, k, m=m, out_len=out_len, algo=algo,
                            backend=backend)
    return _conv_plan(x, k, m=m, out_len=out_len, kind="conv_causal",
                      backend=backend)


def circular_conv(x: torch.Tensor, k: torch.Tensor, *, algo: str = "auto",
                  backend: str = "torch") -> torch.Tensor:
    """Circular convolution of equal-length real signals.  The FFT length
    is the signal length itself, so non-power-of-two lengths demote the
    cuda request to the unfused torch schedule (registry-visible)."""
    if x.shape[-1] != k.shape[-1]:
        raise ValueError("circular_conv needs equal lengths, got "
                         f"{x.shape[-1]} and {k.shape[-1]}")
    m = x.shape[-1]
    if algo != "auto":
        return _conv_direct(x, k, m=m, out_len=m, algo=algo,
                            backend=backend)
    return _conv_plan(x, k, m=m, out_len=m, kind="conv_circular",
                      backend=backend)
