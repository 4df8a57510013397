"""The paper's per-stage "Initial" radix-2 FFT: the CUDA kernel and its
plain PyTorch version.

Replaces ``repro/kernels/fft_stage.py::_stage_kernel`` (driven by
``fft_staged_pallas``): a bit-reverse, then one launch per butterfly stage
that gathers the stage's pairs, twiddles, butterflies and scatters back to
natural order, and 1/n on the inverse.  It is the measured baseline of the
Table 1 reorder-elimination ladder; the Stockham kernels are where the
ladder ends.  ``csrc/fft_stage.cu`` keeps the structure, one launch a stage
over device memory, so the card's Table 1 has the same first rung.  What
bounds it: bytes, one pass over the planes a stage.  So the design moves no
other bytes: the bit-reverse is folded into stage 0's launch (whole rows
permuted in shared memory below 2^10 points, 32x32 tiles above), and every
stage reads and writes whole 16-byte float4s, so a call is log2(n)
launches (one copy for n = 1).
"""
from __future__ import annotations

import torch

from repro_torch.core.complexmath import SplitComplex
from repro_torch.core import twiddle as tw
from repro_torch.core.fft1d import fft_cooley_tukey
from . import _build


def _check_n(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"the staged FFT needs a power-of-two n, got {n}")


def fft_staged_plain(x: SplitComplex, *, inverse: bool = False
                     ) -> SplitComplex:
    """The kernel's arithmetic in plain PyTorch on (batch, n) planes: the
    two-reorder Cooley-Tukey (bit-reverse; per stage gather by
    ``idx0``/``idx1``, twiddle by ``W[tw_idx]``, butterfly, scatter by
    ``inv_perm``; 1/n on the inverse), from the tables of
    :func:`repro_torch.core.fft1d._ct_stage_indices`."""
    _check_n(x.shape[-1])
    return fft_cooley_tukey(x, inverse=inverse, variant="two_reorder")


_ARGS = [_build.P] * 6 + [_build.L, _build.I, _build.I, _build.I, _build.P]


def fft_staged_cuda(x: SplitComplex, *, inverse: bool = False
                    ) -> SplitComplex:
    """Launch the log2(n) stage kernels (stage 0 with the bit-reverse) on
    (batch, n) CUDA planes, float32, bfloat16 or float16 (each stage's
    output rounded to the planes' dtype, as the reference's arrays are)."""
    _build.check_operands(x, 2, _build.FFT_DTYPES)
    batch, n = x.shape
    _check_n(n)
    w = tw.twiddles(n, inverse=inverse, dtype=torch.float32, device=x.device)
    out = x.re.new_empty((2, batch, n))
    fn = _build.function("fft_stage", "fft_staged_pass", _ARGS)
    ptrs = [x.re, x.im, out[0], out[1], w.re, w.im]
    _build.launch(fn, [p.data_ptr() for p in ptrs] + [
        batch, n, int(inverse), _build.store_code(x.dtype)],
        "fft_staged_pass", x.device)
    return SplitComplex(out[0], out[1])
