"""1-D FFT algorithms on split-complex tensors, batched over leading axes.

Counterpart of :mod:`repro.core.fft1d`:

- :func:`dft_naive`        O(N^2) dense DFT matmul (oracle + leaf).
- :func:`fft_cooley_tukey` the paper's iterative radix-2 with explicit
  read/write reorders (both reorder variants).
- :func:`fft_stockham`     mixed radix-4/radix-2 autosort FFT.
- :func:`fft_stockham_radix2`  pure radix-2 Stockham oracle.
- :func:`fft_four_step`    Bailey four-step as DFT-matrix matmuls.
- :func:`fft_bluestein`    chirp-z for arbitrary N.
- :func:`fft` / :func:`ifft` / :func:`fft_axis`  dispatching API.
- :func:`rfft` / :func:`irfft`  real-input transforms via the packed
  half-length complex transform, whose inner transform runs on the kernels
  for ``backend="cuda"``.

Every function runs on the device of its input; tables come from
:mod:`repro_torch.core.twiddle` on that device.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import complexmath as cm
from .complexmath import SplitComplex
from . import twiddle as tw


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _log2(n: int) -> int:
    return int(n).bit_length() - 1


def assert_full_fp32() -> None:
    """A float32 matmul on the card must run in full fp32 (no TF32): the
    plain versions are the parity oracles of the kernels."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("TF32 matmuls are enabled; the plain FFT versions "
                           "need torch.backends.cuda.matmul.allow_tf32=False "
                           "and float32 matmul precision 'highest'")


def _matmul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if p.is_cuda:
        assert_full_fp32()
    return torch.matmul(p, q)


# ---------------------------------------------------------------------------
# Naive dense DFT (oracle + leaf)
# ---------------------------------------------------------------------------

def dft_naive(x: SplitComplex, *, inverse: bool = False) -> SplitComplex:
    """X = W_N x as a complex matmul: (..., N) @ (N, N)."""
    n = x.shape[-1]
    w = tw.dft_matrix(n, inverse=inverse, dtype=x.dtype, device=x.device)
    re = _matmul(x.re, w.re) - _matmul(x.im, w.im)
    im = _matmul(x.re, w.im) + _matmul(x.im, w.re)
    out = SplitComplex(re, im)
    return cm.scale(out, 1.0 / n) if inverse else out


# ---------------------------------------------------------------------------
# Paper-faithful iterative radix-2 Cooley-Tukey
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _ct_stage_indices(n: int):
    """Host-side index plan for every radix-2 stage of a DIT FFT.

    Returns (rev, stages) where each stage is (idx0, idx1, tw_idx, inv_perm):
      idx0/idx1   natural-order indices of the butterfly pair elements
                  ("read reorder" gather),
      tw_idx      index into the size-n twiddle table for each pair,
      inv_perm    permutation scattering concat(out0, out1) back to natural
                  order ("write reorder").
    """
    rev = tw.bit_reverse_indices(n)
    half_n = n // 2
    stages = []
    for s in range(_log2(n)):
        half = 1 << s
        block = half << 1
        pair = np.arange(half_n, dtype=np.int64)
        idx0 = (pair // half) * block + (pair % half)
        idx1 = idx0 + half
        tw_idx = (pair % half) * (n // block)
        perm = np.concatenate([idx0, idx1])         # z -> natural position
        inv_perm = np.argsort(perm)                 # natural -> z position
        stages.append((idx0, idx1, tw_idx, inv_perm))
    return rev, tuple(stages)


@functools.lru_cache(maxsize=64)
def _ct_fused_indices(n: int):
    """Index plan for the one-reorder-per-step variant (paper Fig. 5): the
    data stays in the stage's paired layout and one composed permutation
    carries it to the next stage's layout."""
    rev, stages = _ct_stage_indices(n)
    g0 = np.concatenate([stages[0][0], stages[0][1]])
    initial = rev[g0]                                # x -> z_0 (incl. bitrev)
    hops = []
    for s in range(len(stages) - 1):
        _, _, _, inv_perm_s = stages[s]
        idx0n, idx1n, _, _ = stages[s + 1]
        g_next = np.concatenate([idx0n, idx1n])
        hops.append(inv_perm_s[g_next])              # z_s out -> z_{s+1}
    final = stages[-1][3]                            # z_last out -> natural
    tw_idx = tuple(st[2] for st in stages)
    return initial, tuple(hops), final, tw_idx


def _take(x: SplitComplex, idx) -> SplitComplex:
    idx = torch.as_tensor(idx, device=x.device)
    return SplitComplex(torch.index_select(x.re, -1, idx),
                        torch.index_select(x.im, -1, idx))


def _cat(a: SplitComplex, b: SplitComplex) -> SplitComplex:
    return SplitComplex(torch.cat([a.re, b.re], dim=-1),
                        torch.cat([a.im, b.im], dim=-1))


def fft_cooley_tukey(x: SplitComplex, *, inverse: bool = False,
                     variant: str = "two_reorder") -> SplitComplex:
    """Iterative radix-2 Cooley-Tukey, faithful to the paper's structure.

    variant="two_reorder": gather pairs into contiguous LHS/RHS tiles, run
    the butterfly, scatter back to natural order (the paper's *Initial*
    design, Table 1 row 2, Fig. 4).

    variant="one_reorder": stay in the paired layout and apply one composed
    permutation per stage (the paper's *Single data copy*, Table 1 row 6,
    Fig. 5).  Identical arithmetic, half the data movement.
    """
    n = x.shape[-1]
    assert _is_pow2(n), f"radix-2 CT needs power-of-two length, got {n}"
    if n == 1:
        return x
    w_table = tw.twiddles(n, inverse=inverse, dtype=x.dtype, device=x.device)
    half_n = n // 2

    if variant == "two_reorder":
        rev, stages = _ct_stage_indices(n)
        z = _take(x, rev)                         # initial bit-reversal read
        for (idx0, idx1, tw_idx, inv_perm) in stages:
            lhs = _take(z, idx0)                  # read reorder (gather)
            rhs = _take(z, idx1)
            f = cm.mul(rhs, _take(w_table, tw_idx))
            z = _take(_cat(cm.add(lhs, f), cm.sub(lhs, f)),
                      inv_perm)                   # write reorder (scatter)
    elif variant == "one_reorder":
        initial, hops, final, tw_idx = _ct_fused_indices(n)
        z = _take(x, initial)                     # single fused read reorder
        n_stages = len(tw_idx)
        for s in range(n_stages):
            lhs = SplitComplex(z.re[..., :half_n], z.im[..., :half_n])
            rhs = SplitComplex(z.re[..., half_n:], z.im[..., half_n:])
            f = cm.mul(rhs, _take(w_table, tw_idx[s]))
            z = _take(_cat(cm.add(lhs, f), cm.sub(lhs, f)),
                      hops[s] if s < n_stages - 1 else final)
    else:
        raise ValueError(f"unknown variant {variant!r}")

    return cm.scale(z, 1.0 / n) if inverse else z


# ---------------------------------------------------------------------------
# Stockham autosort
# ---------------------------------------------------------------------------

def stockham_stages(re, im, wr, wi, n: int, radices, *, inverse: bool = False):
    """Run every mixed-radix Stockham stage on (..., n) planes; returns
    (re, im).

    Stage invariant: the length-n axis viewed as (n_cur, stride) is
    row-major contiguous, so the radix-4 sub-sequences are the four
    contiguous quarter slices, and the stride-broadcast packed twiddles
    ``wr``/``wi`` (s4, 3, n//4) line up element-wise.  Writes interleave as
    (m, 4, stride) — the autosort store.  The radix-2 tail runs last
    (m == 1), where its twiddle is identically 1.
    """
    batch = re.shape[:-1]
    q = n // 4
    s4 = 0
    for radix in radices:
        if radix == 4:
            a0r, a1r = re[..., 0 * q:1 * q], re[..., 1 * q:2 * q]
            a2r, a3r = re[..., 2 * q:3 * q], re[..., 3 * q:4 * q]
            a0i, a1i = im[..., 0 * q:1 * q], im[..., 1 * q:2 * q]
            a2i, a3i = im[..., 2 * q:3 * q], im[..., 3 * q:4 * q]
            e0r, e0i = a0r + a2r, a0i + a2i            # a0 + a2
            d0r, d0i = a0r - a2r, a0i - a2i            # a0 - a2
            e1r, e1i = a1r + a3r, a1i + a3i            # a1 + a3
            d1r, d1i = a1r - a3r, a1i - a3i            # a1 - a3
            y0r, y0i = e0r + e1r, e0i + e1i
            y2r, y2i = e0r - e1r, e0i - e1i
            if inverse:                                # +i (a1 - a3)
                y1r, y1i = d0r - d1i, d0i + d1r
                y3r, y3i = d0r + d1i, d0i - d1r
            else:                                      # -i (a1 - a3)
                y1r, y1i = d0r + d1i, d0i - d1r
                y3r, y3i = d0r - d1i, d0i + d1r
            w1r, w1i = wr[s4, 0], wi[s4, 0]
            w2r, w2i = wr[s4, 1], wi[s4, 1]
            w3r, w3i = wr[s4, 2], wi[s4, 2]
            b1r = y1r * w1r - y1i * w1i
            b1i = y1r * w1i + y1i * w1r
            b2r = y2r * w2r - y2i * w2i
            b2i = y2r * w2i + y2i * w2r
            b3r = y3r * w3r - y3i * w3i
            b3i = y3r * w3i + y3i * w3r
            stride = 4 ** s4                           # n_cur = n / 4^s4
            m = q // stride                            # m * stride == n // 4
            re = torch.stack([y0r.reshape(*batch, m, stride),
                              b1r.reshape(*batch, m, stride),
                              b2r.reshape(*batch, m, stride),
                              b3r.reshape(*batch, m, stride)],
                             dim=-2).reshape(*batch, n)
            im = torch.stack([y0i.reshape(*batch, m, stride),
                              b1i.reshape(*batch, m, stride),
                              b2i.reshape(*batch, m, stride),
                              b3i.reshape(*batch, m, stride)],
                             dim=-2).reshape(*batch, n)
            s4 += 1
        else:                                          # radix-2 tail, m == 1
            h = n // 2
            ar, ai = re[..., :h], im[..., :h]
            br, bi = re[..., h:], im[..., h:]
            re = torch.stack([ar + br, ar - br], dim=-2).reshape(*batch, n)
            im = torch.stack([ai + bi, ai - bi], dim=-2).reshape(*batch, n)
    return re, im


def fft_stockham(x: SplitComplex, *, inverse: bool = False) -> SplitComplex:
    """Mixed radix-4/radix-2 DIF Stockham with the packed (s4, 3, N/4)
    twiddle table."""
    n = x.shape[-1]
    assert _is_pow2(n), f"Stockham needs power-of-two length, got {n}"
    if n == 1:
        return x
    w = tw.packed_radix4_twiddles(n, inverse=inverse, dtype=x.dtype,
                                  device=x.device)
    re, im = stockham_stages(x.re, x.im, w.re, w.im, n,
                             tw.stockham_radices(n), inverse=inverse)
    out = SplitComplex(re, im)
    return cm.scale(out, 1.0 / n) if inverse else out


def stockham_radix2_stages(re, im, wr, wi, n: int):
    """Run every pure radix-2 Stockham stage on (..., n) planes with the
    packed (stages, n/2) table."""
    batch = re.shape[:-1]
    h = n // 2
    for s in range(_log2(n)):
        stride = 1 << s
        m = n >> (s + 1)
        ar, ai = re[..., :h], im[..., :h]          # contiguous halves
        br, bi = re[..., h:], im[..., h:]
        sr, si = ar - br, ai - bi                  # a - b
        tr = sr * wr[s] - si * wi[s]               # (a-b) * w
        ti = sr * wi[s] + si * wr[s]
        re = torch.stack([(ar + br).reshape(*batch, m, stride),
                          tr.reshape(*batch, m, stride)],
                         dim=-2).reshape(*batch, n)
        im = torch.stack([(ai + bi).reshape(*batch, m, stride),
                          ti.reshape(*batch, m, stride)],
                         dim=-2).reshape(*batch, n)
    return re, im


def fft_stockham_radix2(x: SplitComplex, *,
                        inverse: bool = False) -> SplitComplex:
    """Pure radix-2 DIF Stockham — the oracle for the radix-4 path."""
    n = x.shape[-1]
    assert _is_pow2(n), f"Stockham needs power-of-two length, got {n}"
    if n == 1:
        return x
    w = tw.packed_radix2_twiddles(n, inverse=inverse, dtype=x.dtype,
                                  device=x.device)
    re, im = stockham_radix2_stages(x.re, x.im, w.re, w.im, n)
    out = SplitComplex(re, im)
    return cm.scale(out, 1.0 / n) if inverse else out


# ---------------------------------------------------------------------------
# Bailey four-step
# ---------------------------------------------------------------------------

def _best_split(n: int) -> int:
    """The largest n1 | n with n1 <= sqrt(n)."""
    best = 1
    for n1 in range(1, int(np.sqrt(n)) + 1):
        if n % n1 == 0:
            best = n1
    return best


def _swap(x: SplitComplex, a: int, b: int) -> SplitComplex:
    return SplitComplex(x.re.transpose(a, b), x.im.transpose(a, b))


def fft_four_step(x: SplitComplex, *, inverse: bool = False,
                  n1: Optional[int] = None,
                  leaf: int = 256) -> SplitComplex:
    """Four-step FFT: N = n1*n2; DFTs over the n1 axis, twiddle, DFTs over
    the n2 axis, transpose.  Factors larger than ``leaf`` recurse; leaves
    use the dense DFT matrix."""
    n = x.shape[-1]
    if n <= leaf:
        return dft_naive(x, inverse=inverse)
    if n1 is None:
        n1 = _best_split(n)
    if n1 == 1 or n1 == n:           # prime beyond leaf: fall back
        return fft_bluestein(x, inverse=inverse)
    n2 = n // n1
    lead = x.shape[:-1]

    a = SplitComplex(x.re.reshape(*lead, n1, n2), x.im.reshape(*lead, n1, n2))
    # (1) DFT over the n1 axis: move it last, transform, move back.
    b = _swap(_fft_len(_swap(a, -1, -2), n1, inverse=inverse, leaf=leaf),
              -1, -2)
    if inverse:                       # recursion already divided by n1; undo
        b = cm.scale(b, float(n1))
    # (2) pointwise twiddle T[k1, n2]
    t = tw.fourstep_twiddle(n1, n2, inverse=inverse, dtype=x.dtype,
                            device=x.device)
    c = cm.mul(b, t)
    # (3) DFT over the n2 axis (already last)
    d = _fft_len(c, n2, inverse=inverse, leaf=leaf)
    if inverse:
        d = cm.scale(d, float(n2))
    # (4) output transpose: X[k2*n1 + k1] = D[k1, k2]
    out = SplitComplex(d.re.transpose(-1, -2).reshape(*lead, n),
                       d.im.transpose(-1, -2).reshape(*lead, n))
    return cm.scale(out, 1.0 / n) if inverse else out


def _fft_len(x: SplitComplex, n: int, *, inverse: bool,
             leaf: int) -> SplitComplex:
    if n <= leaf:
        return dft_naive(x, inverse=inverse)
    return fft_four_step(x, inverse=inverse, leaf=leaf)


# ---------------------------------------------------------------------------
# Bluestein chirp-z (arbitrary N)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _bluestein_tables_np(n: int, m: int, sign: float):
    k = np.arange(n, dtype=np.float64)
    # n^2 mod 2n keeps the angle argument small (precision guard)
    ang = sign * np.pi * ((k * k) % (2 * n)) / n
    a_c, a_s = np.cos(ang), np.sin(ang)
    b = np.zeros(m, dtype=np.complex128)
    chirp = np.exp(-1j * ang)                        # conj of a (sign folded)
    b[:n] = chirp
    b[m - n + 1:] = chirp[1:][::-1]
    bf = np.fft.fft(b)
    return a_c, a_s, bf.real, bf.imag


def fft_bluestein(x: SplitComplex, *, inverse: bool = False) -> SplitComplex:
    """Chirp-z transform: arbitrary-N DFT via one power-of-two convolution."""
    n = x.shape[-1]
    m = 1 << int(np.ceil(np.log2(2 * n - 1)))
    sign = 1.0 if inverse else -1.0
    planes = [torch.from_numpy(np.ascontiguousarray(p)).to(x.device, x.dtype)
              for p in _bluestein_tables_np(n, m, sign)]
    a = SplitComplex(planes[0], planes[1])
    bf = SplitComplex(planes[2], planes[3])

    xa = cm.mul(x, a)
    pad = (0, m - n)
    xa_p = SplitComplex(torch.nn.functional.pad(xa.re, pad),
                        torch.nn.functional.pad(xa.im, pad))
    xf = fft_stockham(xa_p)
    prod = cm.mul(xf, bf)
    conv = fft_stockham(prod, inverse=True)
    out = cm.mul(SplitComplex(conv.re[..., :n], conv.im[..., :n]), a)
    return cm.scale(out, 1.0 / n) if inverse else out


# ---------------------------------------------------------------------------
# Dispatch API
# ---------------------------------------------------------------------------

_ALGOS = {
    "naive": dft_naive,
    "cooley_tukey": functools.partial(fft_cooley_tukey, variant="two_reorder"),
    "cooley_tukey_fused": functools.partial(fft_cooley_tukey,
                                            variant="one_reorder"),
    "stockham": fft_stockham,
    "stockham2": fft_stockham_radix2,
    "four_step": fft_four_step,
    "bluestein": fft_bluestein,
}


def resolve_algo(n: int) -> str:
    """The auto-dispatch size table (thresholds identical to the
    reference): dense matmul for tiny N, four-step up to 2^20, Stockham
    beyond, Bluestein for non-pow2 N above 512."""
    if not _is_pow2(n):
        return "naive" if n <= 512 else "bluestein"
    if n <= 256:
        return "naive"
    if n <= (1 << 20):
        return "four_step"
    return "stockham"


def fft(x: SplitComplex, *, inverse: bool = False,
        algo: str = "auto") -> SplitComplex:
    """Forward/inverse DFT along the last axis.  ``algo="auto"`` routes
    through the plan registry with ``backend="torch"``; an explicit algo
    dispatches directly."""
    if algo == "auto":
        from . import plan as _plan            # deferred: plan imports fft1d
        return _plan.get_plan((x.shape[-1],), dtype=x.dtype,
                              inverse=inverse, backend="torch")(x)
    if algo not in _ALGOS:
        raise ValueError(f"unknown algo {algo!r}; use one of "
                         f"{sorted(_ALGOS)} or 'auto'")
    return _ALGOS[algo](x, inverse=inverse)


def ifft(x: SplitComplex, *, algo: str = "auto") -> SplitComplex:
    return fft(x, inverse=True, algo=algo)


def fft_axis(x: SplitComplex, axis: int, *, inverse: bool = False,
             algo: str = "auto") -> SplitComplex:
    """Transform an arbitrary axis by moving it last and back."""
    y = fft(SplitComplex(x.re.movedim(axis, -1), x.im.movedim(axis, -1)),
            inverse=inverse, algo=algo)
    return SplitComplex(y.re.movedim(-1, axis), y.im.movedim(-1, axis))


# ---------------------------------------------------------------------------
# Real-input transforms
# ---------------------------------------------------------------------------

# the 1-D algos with a kernel path: _fft_inner dispatches these to
# repro_torch.kernels.ops, and the plan registry demotes cuda rfft requests
# whose inner algo is not in this set
KERNEL_INNER_ALGOS = ("stockham", "stockham2", "four_step")


def _fft_inner(z: SplitComplex, *, inverse: bool = False, algo: str,
               backend: str = "torch", radix: int = 4) -> SplitComplex:
    """The inner complex transform of the real-input paths.  On
    ``backend="cuda"`` the kernel-backed algos (:data:`KERNEL_INNER_ALGOS`)
    dispatch to :mod:`repro_torch.kernels.ops`; everything else runs the
    plain algorithms."""
    if backend == "cuda" and algo in KERNEL_INNER_ALGOS:
        from repro_torch.kernels import ops as kops
        if algo == "four_step":
            return kops.fft_fourstep(z, inverse=inverse)
        return kops.fft_stockham(z, inverse=inverse,
                                 radix=2 if algo == "stockham2" else radix)
    return fft(z, inverse=inverse, algo=algo)


def rfft(x: torch.Tensor, *, algo: str = "auto",
         backend: str = "torch") -> SplitComplex:
    """Real-input FFT via the packed half-size complex transform: even/odd
    samples become one complex sequence of length N/2, whose spectrum
    untangles into the (..., N/2+1) half spectrum.

    ``algo="auto"`` routes through the plan registry under an rfft-kind
    key; ``backend="cuda"`` runs the inner transform on the kernels
    (demoting with a registry-visible reason when none exists)."""
    if algo == "auto":
        from . import plan as _plan
        return _plan.get_plan((x.shape[-1],), dtype=x.dtype,
                              kind="rfft", backend=backend)(x)
    return _rfft_direct(x, algo=algo, backend=backend)


def _rfft_direct(x: torch.Tensor, *, algo: str, backend: str = "torch",
                 radix: int = 4) -> SplitComplex:
    """rfft body with an explicitly resolved inner algo (no registry)."""
    n = x.shape[-1]
    if n % 2:
        raise ValueError(f"rfft requires an even length, got {n}")
    h = n // 2
    z = SplitComplex(x[..., 0::2], x[..., 1::2])
    zf = _fft_inner(z, algo=algo, backend=backend, radix=radix)  # (..., h)
    # untangle: Xe[k] = (Z[k] + conj(Z[h-k]))/2,
    #           Xo[k] = -i(Z[k] - conj(Z[h-k]))/2
    idx = (-torch.arange(h, device=x.device)) % h     # Z[h-k] with wrap
    zr_f = torch.index_select(zf.re, -1, idx)
    zi_f = torch.index_select(zf.im, -1, idx)
    xe = SplitComplex((zf.re + zr_f) * 0.5, (zf.im - zi_f) * 0.5)
    xo = SplitComplex((zf.im + zi_f) * 0.5, (zr_f - zf.re) * 0.5)
    w = tw.twiddles(n, dtype=x.dtype, device=x.device)   # e^{-2pi i k/N}
    xo_t = cm.mul(xo, SplitComplex(w.re[:h], w.im[:h]))
    full = cm.add(xe, xo_t)                           # k = 0..h-1
    # k = h term: X[h] = Xe[0] - Xo[0]  (twiddle at k=h is -1)
    last = SplitComplex(xe.re[..., :1] - xo.re[..., :1],
                        xe.im[..., :1] - xo.im[..., :1])
    return _cat(full, last)


def irfft(xf: SplitComplex, n: Optional[int] = None, *,
          algo: str = "auto", backend: str = "torch") -> torch.Tensor:
    """Inverse real FFT from the (..., N/2+1) half spectrum.

    An explicit ``n`` truncates or zero-pads the spectrum to n//2+1 bins
    first (numpy semantics; odd ``n`` is served by the direct Hermitian
    extension, since the registry's rfft keys cover even lengths only).
    ``algo="auto"`` routes through the registry's rfft-kind inverse key
    (the resolved algo is the full-length inner complex ifft)."""
    if n is None:
        n = 2 * (xf.shape[-1] - 1)
    xf = _fit_half_spectrum(xf, n)
    if n % 2 or algo != "auto":
        return _irfft_direct(xf, n, algo=algo, backend=backend)
    from . import plan as _plan
    return _plan.get_plan((n,), dtype=xf.dtype, inverse=True,
                          kind="rfft", backend=backend)(xf)


def _fit_half_spectrum(xf: SplitComplex, n: int) -> SplitComplex:
    """Truncate/zero-pad a half spectrum to the n/2+1 bins of length n."""
    h = n // 2 + 1
    bins = xf.shape[-1]
    if bins == h:
        return xf
    if bins > h:
        return SplitComplex(xf.re[..., :h], xf.im[..., :h])
    pad = (0, h - bins)
    return SplitComplex(torch.nn.functional.pad(xf.re, pad),
                        torch.nn.functional.pad(xf.im, pad))


def _irfft_direct(xf: SplitComplex, n: int, *, algo: str,
                  backend: str = "torch", radix: int = 4) -> torch.Tensor:
    # Hermitian-extend then complex ifft; take the real plane.  For even n
    # the Nyquist bin (last) is excluded from the mirrored body; odd n has
    # no Nyquist bin, so the body is every bin past DC (numpy semantics).
    body_r = xf.re[..., 1:(n + 1) // 2]
    body_i = xf.im[..., 1:(n + 1) // 2]
    full = SplitComplex(torch.cat([xf.re, body_r.flip(-1)], dim=-1),
                        torch.cat([xf.im, -body_i.flip(-1)], dim=-1))
    out = _fft_inner(full, inverse=True, algo=algo, backend=backend,
                     radix=radix)
    return out.re
