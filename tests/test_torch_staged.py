"""The paper's per-stage "Initial" FFT on the CPU: ``ops.fft_staged`` (on a
CPU tensor, the stage kernel's plain version) against the reference's
``ops.fft_staged`` (the Pallas stage kernel in interpret mode) on the same
seeded inputs, against numpy, and the stage tables bit for bit.

Tolerances, as max error / max |reference|: 1e-5 against the reference
(the same fp32 stage arithmetic in the same order) and 3e-4 against
``np.fft``, the reference test's own bound
(``tests/test_kernels.py::test_staged_kernel_paper_baseline``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fft1d as ref_fft1d
from repro.core import twiddle as ref_tw
from repro.core.complexmath import SplitComplex as RefSplit
from repro.kernels import ops as ref_ops
from repro_torch.core import fft1d, from_numpy, to_complex
from repro_torch.core import twiddle as tw
from repro_torch.kernels import fft_stage, ops

TOL_REF = 1e-5
TOL_NUMPY = 3e-4


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _both(z, inverse):
    """(port, reference) outputs of fft_staged on the same input."""
    got = to_complex(ops.fft_staged(from_numpy(z, device="cpu"),
                                    inverse=inverse)).numpy()
    ref = ref_ops.fft_staged(RefSplit(jnp.asarray(z.real),
                                      jnp.asarray(z.imag)), inverse=inverse)
    return got, np.asarray(ref.re) + 1j * np.asarray(ref.im)


def _rel(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("n", [16, 256, 2048])
@pytest.mark.parametrize("inverse", [False, True])
def test_staged_matches_reference(n, inverse):
    z = _rand((4, n), seed=n)
    got, ref = _both(z, inverse)
    assert got.shape == ref.shape == (4, n)
    assert _rel(got, ref) <= TOL_REF
    want = np.fft.ifft(z) if inverse else np.fft.fft(z)
    assert _rel(got, want) <= TOL_NUMPY


@pytest.mark.parametrize("shape", [(3, 256), (2, 3, 16), (1, 2)])
def test_staged_batch_shapes_match_reference(shape):
    """Batch 3 is the reference's padding path (to its block of 8); leading
    dims flatten and come back."""
    z = _rand(shape, seed=sum(shape))
    got, ref = _both(z, False)
    assert got.shape == ref.shape == shape
    assert _rel(got, ref) <= TOL_REF
    assert _rel(got, np.fft.fft(z)) <= TOL_NUMPY


def test_staged_roundtrip():
    z = _rand((2, 512), seed=1)
    x = from_numpy(z, device="cpu")
    back = to_complex(ops.fft_staged(ops.fft_staged(x), inverse=True))
    assert _rel(back.numpy(), z) <= 1e-4


def test_staged_empty_batch():
    x = from_numpy(np.zeros((0, 64), np.complex64), device="cpu")
    out = ops.fft_staged(x)
    assert out.shape == (0, 64)


def test_staged_refuses_non_pow2():
    with pytest.raises(ValueError, match="power-of-two"):
        fft_stage.fft_staged_plain(from_numpy(_rand((2, 12), 0),
                                              device="cpu"))


def test_staged_counts_no_launch_on_cpu():
    ops.reset_launches()
    ops.fft_staged(from_numpy(_rand((2, 16), 0), device="cpu"))
    assert ops.LAUNCHES["fft_staged"] == 0


@pytest.mark.parametrize("n", [1 << k for k in range(1, 15)])
def test_stage_tables_bit_identical(n):
    """The bit-reverse, the per-stage index plan and each stage's fp32
    twiddles W[tw_idx] equal the reference's (``fft_stage_pallas``'s
    ``c[tw_idx]`` cast) bit for bit."""
    assert np.array_equal(tw.bit_reverse_indices(n),
                          ref_tw.bit_reverse_indices(n))
    rev, stages = fft1d._ct_stage_indices(n)
    ref_rev, ref_stages = ref_fft1d._ct_stage_indices(n)
    assert np.array_equal(rev, ref_rev) and len(stages) == len(ref_stages)
    for mine, ref in zip(stages, ref_stages):
        for a, b in zip(mine, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for inverse in (False, True):
        c, s = ref_tw._twiddle_np(n, 1.0 if inverse else -1.0)
        w = tw.twiddles(n, inverse=inverse, dtype=torch.float32,
                        device="cpu")
        for _, _, tw_idx, _ in stages:
            idx = torch.from_numpy(tw_idx)
            assert np.array_equal(w.re[idx].numpy(),
                                  np.asarray(jnp.asarray(c[tw_idx],
                                                         jnp.float32)))
            assert np.array_equal(w.im[idx].numpy(),
                                  np.asarray(jnp.asarray(s[tw_idx],
                                                         jnp.float32)))


def _rev(v, bits):
    """``v`` with its low ``bits`` bits reversed (0 for bits = 0)."""
    v = np.asarray(v, dtype=np.int64)
    r = np.zeros_like(v)
    for b in range(bits):
        r |= ((v >> b) & 1) << (bits - 1 - b)
    return r


def _tiled_bit_reverse(n):
    """The input index that ``csrc/fft_stage.cu``'s first_stage_tiled reads
    for each output j, in its loop order: tile ``mid`` loads the inputs
    a*2^(ln-5) + rev(mid)*32 + c (a, c < 32) and writes the outputs
    hi*2^(ln-5) + mid*32 + lo from tile entry (rev(lo), rev(hi))."""
    ln = n.bit_length() - 1
    lm = ln - 10
    a, c = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    r5 = _rev(np.arange(32), 5)
    src = np.empty(n, dtype=np.int64)
    for mid in range(1 << lm):
        tile = (a << (ln - 5)) + (int(_rev(mid, lm)) << 5) + c
        src[(a << (ln - 5)) + (mid << 5) + c] = tile[r5[c], r5[a]]
    return src


@pytest.mark.parametrize("n", [1 << k for k in range(10, 17)])
def test_tiled_bit_reverse_map(n):
    """Stage 0's 32x32-tile index map, which the kernel takes from 2^10
    points on, is the bit reversal at every n up to 2^16."""
    assert np.array_equal(_tiled_bit_reverse(n), tw.bit_reverse_indices(n))
