"""Single-device 2-D FFT (the paper's Section 5 workload, one card).

Counterpart of :mod:`repro.core.fft2d` (``fft2`` of this slice):

- ``backend="torch"`` — row-column decomposition with the plain 1-D
  algorithms and an explicit transpose between the passes.
- ``backend="cuda"`` — ``algo="fused"`` (the ``auto`` choice) runs the
  GEMM-formulated 2-D kernel (:mod:`repro_torch.kernels.fft2d_gemm`);
  ``algo="row_col"`` runs two Stockham kernel passes with an explicit
  swap between them, the measured baseline.

``fft2`` with ``algo="auto"`` routes through the plan registry
(:func:`repro_torch.core.plan.get_plan`).
"""
from __future__ import annotations

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
            raise NotImplementedError(
                'algo="fused_stockham" needs the _fft2d_kernel port: '
                "ROADMAP 'TPU kernels to port' item 7")
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
