"""Single-device 2-D / 3-D FFTs (the paper's Section 5 workload, one card).

Counterpart of :mod:`repro.core.fft2d` (``fft2``, ``fft3``, ``rfft2`` and
``irfft2``):

- ``backend="torch"`` — row-column decomposition with the plain 1-D
  algorithms and an explicit transpose between the passes.
- ``backend="cuda"`` — ``algo="fused"`` (the ``auto`` choice) runs the
  GEMM-formulated kernels (:mod:`repro_torch.kernels.fft2d_gemm` for 2-D,
  :mod:`repro_torch.kernels.fft3d_fused` for 3-D; float32 or bfloat16,
  ``variant`` plain or compensated); ``algo="fused_stockham"`` (2-D) the
  Stockham-stage fused kernel (:mod:`repro_torch.kernels.fft2d_fused`),
  the explicit-algo oracle; ``algo="row_col"`` runs one Stockham kernel
  pass per axis with explicit swaps between them, the measured baseline.

``rfft2``/``irfft2`` on ``backend="cuda"`` run the fused real-input
kernels (:mod:`repro_torch.kernels.rfft2d_fused`); an explicit 1-D algo
runs the row-column schedule (1-D rfft rows, c2c columns) on the 1-D
kernels.

Every entry point with ``algo="auto"`` routes through the plan registry
(:func:`repro_torch.core.plan.get_plan`).
"""
from __future__ import annotations

import torch

from .complexmath import SplitComplex
from . import fft1d


def _swap(x: SplitComplex, a: int, b: int) -> SplitComplex:
    return SplitComplex(x.re.transpose(a, b), x.im.transpose(a, b))


def _swap_contig(x: SplitComplex) -> SplitComplex:
    """Swap the last two axes into a new contiguous layout (the global
    transpose of the row-column schedule)."""
    return SplitComplex(x.re.transpose(-1, -2).contiguous(),
                        x.im.transpose(-1, -2).contiguous())


def _fft2_direct(x: SplitComplex, *, inverse: bool = False,
                 algo: str = "auto", backend: str = "torch",
                 block_batch: int = None,
                 variant: str = "plain") -> SplitComplex:
    """Execute a resolved 2-D plan config (no registry lookup)."""
    if backend == "cuda":
        from repro_torch.kernels import ops as kops
        if algo not in ("auto", "fused", "fused_stockham", "row_col"):
            raise ValueError(f'algo={algo!r} has no cuda 2-D path; use '
                             '"fused", "fused_stockham" or "row_col" '
                             '(or backend="torch")')
        if algo in ("auto", "fused"):
            return kops.fft2d_gemm(x, inverse=inverse,
                                   block_batch=block_batch or 1,
                                   variant=variant)
        if algo == "fused_stockham":
            # the explicit-algo oracle: the Stockham-stage fused kernel
            return kops.fft2d_fused(x, inverse=inverse,
                                    block_batch=block_batch or 1)
        bb = block_batch or 8
        y = kops.fft_stockham(x, inverse=inverse, block_batch=bb)
        y = kops.fft_stockham(_swap_contig(y), inverse=inverse,
                              block_batch=bb)
        return _swap_contig(y)
    if algo in ("fused", "fused_stockham"):
        raise ValueError(f'algo={algo!r} requires backend="cuda" '
                         '(the fused kernels have no torch equivalent)')
    row_algo = "auto" if algo in ("auto", "row_col") else algo
    y = fft1d.fft(x, inverse=inverse, algo=row_algo)   # FFT each row
    y = _swap(y, -1, -2)                               # global transpose
    y = fft1d.fft(y, inverse=inverse, algo=row_algo)   # FFT each column
    return _swap(y, -1, -2)


def fft2(x: SplitComplex, *, inverse: bool = False, algo: str = "auto",
         backend: str = "torch") -> SplitComplex:
    """2-D FFT over the last two axes, routed through the plan registry."""
    if len(x.shape) < 2:
        raise ValueError(f"fft2 needs at least 2 axes, got shape {x.shape}")
    if algo == "auto":
        from . import plan as _plan
        return _plan.get_plan(x.shape[-2:], dtype=x.dtype, inverse=inverse,
                              backend=backend)(x)
    return _fft2_direct(x, inverse=inverse, algo=algo, backend=backend)


def _fft3_direct(x: SplitComplex, *, inverse: bool = False,
                 algo: str = "auto", backend: str = "torch",
                 block_batch: int = None,
                 variant: str = "plain") -> SplitComplex:
    """Execute a resolved 3-D plan config (no registry lookup)."""
    if backend == "cuda":
        from repro_torch.kernels import ops as kops
        if algo not in ("auto", "fused", "row_col"):
            raise ValueError(f'algo={algo!r} has no cuda 3-D path; use '
                             '"fused" or "row_col" (or backend="torch")')
        if algo in ("auto", "fused"):
            return kops.fft3d_fused(x, inverse=inverse,
                                    block_batch=block_batch or 1,
                                    variant=variant)
        # transpose-based baseline: three 1-D kernel passes with explicit
        # global (HBM) relayouts between them
        bb = block_batch or 8
        y = kops.fft_stockham(x, inverse=inverse, block_batch=bb)
        y = kops.fft_stockham(_swap_contig(y), inverse=inverse,
                              block_batch=bb)
        y = _swap_contig(y)
        y = kops.fft_stockham(_swap(y, -1, -3), inverse=inverse,
                              block_batch=bb)
        return _swap(y, -1, -3)
    if algo == "fused":
        raise ValueError('algo="fused" requires backend="cuda" '
                         '(the fused 3-D kernel has no torch equivalent)')
    pass_algo = "auto" if algo in ("auto", "row_col") else algo
    y = fft1d.fft(x, inverse=inverse, algo=pass_algo)
    y = _swap(y, -1, -2)
    y = fft1d.fft(y, inverse=inverse, algo=pass_algo)
    y = _swap(y, -1, -2)
    y = _swap(y, -1, -3)
    y = fft1d.fft(y, inverse=inverse, algo=pass_algo)
    return _swap(y, -1, -3)


def fft3(x: SplitComplex, *, inverse: bool = False, algo: str = "auto",
         backend: str = "torch") -> SplitComplex:
    """3-D FFT over the last three axes, routed through the plan registry:
    ``algo="auto"`` resolves the (d, h, w) key once per shape; cuda keys
    select the fused 3-D kernel and demote to torch with a
    registry-visible reason when the shape has no kernel path."""
    if len(x.shape) < 3:
        raise ValueError(f"fft3 needs at least 3 axes, got shape {x.shape}")
    if algo == "auto":
        from . import plan as _plan
        return _plan.get_plan(x.shape[-3:], dtype=x.dtype, inverse=inverse,
                              backend=backend)(x)
    return _fft3_direct(x, inverse=inverse, algo=algo, backend=backend)


def rfft2(x: torch.Tensor, *, algo: str = "auto",
          backend: str = "torch") -> SplitComplex:
    """Real-input 2-D FFT: rfft rows (half spectrum), full FFT columns;
    real (..., H, W) -> (..., H, W/2+1).  ``algo="auto"`` routes through
    the registry's rfft-kind (h, w) key: ``backend="cuda"`` selects the
    fused real-input kernels, demoting to torch with a registry-visible
    reason when the shape has no kernel path."""
    if algo == "auto":
        from . import plan as _plan
        return _plan.get_plan(x.shape[-2:], dtype=x.dtype, kind="rfft",
                              backend=backend)(x)
    if algo == "fused":
        if backend != "cuda":
            raise ValueError('algo="fused" requires backend="cuda" '
                             '(the fused rfft kernel has no torch equivalent)')
        from repro_torch.kernels import ops as kops
        return kops.rfft2d_fused(x)
    return _rfft2_direct(x, row_algo=algo, col_algo=algo, backend=backend)


def _rfft2_direct(x: torch.Tensor, *, row_algo: str, col_algo: str = "auto",
                  backend: str = "torch") -> SplitComplex:
    """Execute a resolved rfft2 config.  ``row_algo`` is the inner complex
    algo of the packed row rfft (explicit, never "auto"); the column pass
    is an ordinary c2c transform that may route through its own plan key.
    ``backend="cuda"`` runs both passes on the 1-D kernels where the algo
    has one (:func:`repro_torch.core.fft1d._fft_inner`)."""
    y = fft1d._rfft_direct(x, algo=row_algo,
                           backend=backend)            # (..., H, W/2+1)
    y = _swap(y, -1, -2)
    y = fft1d._fft_inner(y, algo=col_algo, backend=backend)
    return _swap(y, -1, -2)


def irfft2(xf: SplitComplex, s=None, *, algo: str = "auto",
           backend: str = "torch") -> torch.Tensor:
    """Inverse real 2-D FFT from the (..., H, W/2+1) half spectrum.

    ``s=(h, w)`` follows ``numpy.fft.irfft2``: the spectrum is truncated or
    trailing-zero-padded to h rows and w//2+1 bins, then transformed with
    an output width of ``w``.  Odd widths follow numpy's odd-``s``
    semantics on the direct (torch) path; the registry's rfft keys and the
    fused kernels cover even widths.  The fit happens before plan
    dispatch, so every path sees the same spectrum."""
    if s is not None:
        h, w = (int(d) for d in s)
        if h < 1 or w < 1:
            raise ValueError(f"irfft2 output shape must be positive, "
                             f"got s={s}")
        xf = _fit_spectrum2(xf, h, w)
    else:
        w = 2 * (xf.shape[-1] - 1)
    h = xf.shape[-2]
    if w % 2:                     # odd width: numpy semantics, direct path
        if algo == "fused":
            raise ValueError(f"the fused rfft kernel needs an even output "
                             f"width, got s={s}")
        return _irfft2_direct(xf, row_algo=algo, col_algo=algo, w=w,
                              backend=backend)
    if algo == "fused":
        if backend != "cuda":
            raise ValueError('algo="fused" requires backend="cuda" '
                             '(the fused rfft kernel has no torch equivalent)')
        from repro_torch.kernels import ops as kops
        return kops.irfft2d_fused(xf)
    if algo == "auto":
        from . import plan as _plan
        return _plan.get_plan((h, w), dtype=xf.dtype, inverse=True,
                              kind="rfft", backend=backend)(xf)
    return _irfft2_direct(xf, row_algo=algo, col_algo=algo, w=w,
                          backend=backend)


def _fit_spectrum2(xf: SplitComplex, h: int, w: int) -> SplitComplex:
    """Truncate / zero-pad a 2-D half spectrum to (h, w//2+1): numpy's
    ``ifft(a, n=h)`` trailing fit on axis -2, then the 1-D half-spectrum
    fit on the last axis."""
    rows = xf.shape[-2]
    if rows > h:
        xf = SplitComplex(xf.re[..., :h, :], xf.im[..., :h, :])
    elif rows < h:
        pad = (0, 0, 0, h - rows)
        xf = SplitComplex(torch.nn.functional.pad(xf.re, pad),
                          torch.nn.functional.pad(xf.im, pad))
    return fft1d._fit_half_spectrum(xf, w)


def _irfft2_direct(xf: SplitComplex, *, row_algo: str,
                   col_algo: str = "auto", w: int = None,
                   backend: str = "torch") -> torch.Tensor:
    y = _swap(xf, -1, -2)
    y = fft1d._fft_inner(y, inverse=True, algo=col_algo, backend=backend)
    y = _swap(y, -1, -2)
    n = w if w is not None else 2 * (xf.shape[-1] - 1)
    return fft1d._irfft_direct(y, n, algo=row_algo, backend=backend)
