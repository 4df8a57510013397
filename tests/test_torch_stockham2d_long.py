"""The fused Stockham 2-D kernel's axes past 2^24 (``kernels/
fft2d_fused.py``: the 1-D kernel's three launches along either axis,
"split_cols", "split_mid", then "split_rows" or "split_tcols"), run on the
CPU under ``tools/cuda_emu/emulate.py`` with ``TWO_MAX`` lowered to 2^16,
against the plain version: fp32 within 1e-5 of max|plain| in both
directions, bf16 and float16 against float64 numpy of the rounded input
within 6e-2 and 1e-3 of max|X| and the plain version's error + 2^-7 and
2^-10.  Also launch B on columns in tiles of 16384 points that hold whole
images (2048-point columns of 4-wide images).  The plan and the launches'
plain-torch model are in ``test_torch_long_axes.py``; the kernel on the
card in ``test_torch_cuda.py`` and ``chip_smoke.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _emulated import emulated_fixture, planes
from repro_torch.core import SplitComplex
from repro_torch.kernels import _build, fft2d_fused as S2

emulated = emulated_fixture("fft2d_fused", reset=S2._launch_args.cache_clear)


def _f64(y: SplitComplex) -> np.ndarray:
    return y.re.double().numpy() + 1j * y.im.double().numpy()


def _err(y, want) -> float:
    return float(np.abs(_f64(y) - want).max() / np.abs(want).max())


def _against_plain(emulated, x, routes):
    """Both directions through ``fft2d_fused_cuda``: its planned routes,
    one C entry call a launch, and the bounds of the module's
    docstring."""
    dtype = x.re.dtype
    assert [r for r, _ in S2.plan(*x.shape)] == routes
    for inverse in (False, True):
        _build.CALLS.clear()
        got = S2.fft2d_fused_cuda(x, inverse=inverse)
        assert sum(_build.CALLS.values()) == len(routes)
        assert got.re.dtype == dtype and got.re.shape == x.re.shape
        ref = S2.fft2d_fused_plain(x, inverse=inverse)
        if dtype == torch.float32:
            assert emulated.rel(got, ref) <= 1e-5, inverse
            continue
        want = (np.fft.ifft2 if inverse else np.fft.fft2)(_f64(x))
        bound, slack = ((6e-2, 2.0 ** -7) if dtype == torch.bfloat16
                        else (1e-3, 2.0 ** -10))
        assert _err(got, want) <= bound, inverse
        assert _err(got, want) <= _err(ref, want) + slack, inverse


@pytest.mark.parametrize("shape,dtype", [
    ((1, 2, 1 << 17), torch.float32), ((1, 1 << 17, 2), torch.float32),
    ((1, 2, 1 << 17), torch.bfloat16), ((1, 1 << 17, 2), torch.float16)],
    ids=str)
def test_emulated_three_launches(emulated, monkeypatch, shape, dtype):
    """With TWO_MAX at 2^16 an axis of 2^17 takes the three launches
    (split (8, 2, 7)): on rows the 1-D kernel's, on columns of 2-wide
    images the middle launch with q = column >> 1 on tiles of whole
    images and launch 3 as "split_tcols"."""
    monkeypatch.setattr(S2, "TWO_MAX", 1 << 16)
    S2._launch_args.cache_clear()
    long = ["split_cols", "split_mid"]
    routes = (long + ["split_rows", "cols"] if shape[2] > S2.TWO_MAX
              else ["rows"] + long + ["split_tcols"])
    _against_plain(emulated, planes(shape, dtype, shape[1]), routes)
    S2._launch_args.cache_clear()


def test_emulated_tcols_tiles_of_whole_images(emulated, monkeypatch):
    """Launch B on columns of 2048 points of 4-wide images (launch A's 2^8
    bits of a 2^19-point axis): 16384-point tiles of two whole images at
    1024 threads, the tiling that h = 2^23 with w = 4 gets on the card."""
    monkeypatch.setattr(S2, "split", lambda n, radix: 8)
    S2._launch_args.cache_clear()
    x = planes((1, 1 << 19, 4), torch.float32, 19)
    b = S2.plan(*x.shape)[-1][1]
    assert (b.n, b.inner, b.c, b.g) == (2048, 4, 4, 2)
    _against_plain(emulated, x, ["rows", "split_cols", "split_tcols"])
    S2._launch_args.cache_clear()
