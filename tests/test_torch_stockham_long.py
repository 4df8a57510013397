"""The Stockham kernels' three-launch route past 2^24
(``kernels/fft_stockham.py``: ``split3``, ``plan``; ``csrc/stockham.cuh``:
``ST_MID``, ``st_pick<RX, T, true>``): the plan at every power of two from
2^25 to 2^36 for both radices and every storage dtype, each launch one
the kernel takes; and the kernels themselves run on the CPU under
``tools/cuda_emu/emulate.py`` with the thresholds lowered, against their
plain versions (fp32 within 1e-5 of max|plain|; bf16 and float16 against
float64 numpy of the rounded input, within 6e-2 and 1e-3 of max|X| and the
plain version's error + 2^-7 and 2^-10).  The plain-torch models of the
three launches are in ``test_torch_stockham_r2.py`` and
``test_torch_stockham_r4.py``; the kernels on the card in
``test_torch_cuda.py`` and ``chip_smoke.py``."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import SplitComplex, from_numpy
from repro_torch.kernels import _build, axis_fft as A, fft_stockham as S

ROOT = Path(__file__).resolve().parents[1]
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the instances of st_pick<RX, T, true>: log2 of a launch's transform ->
# the threads its kernel is built for
INSTANCES = {
    ("cols", 2): {8: 512, 9: 512, 10: 512, 11: 1024, 12: 1024},
    ("cols", 4): {8: 512, 10: 512, 12: 1024},
    ("mid", 2): {**{ln: 512 for ln in range(2, 11)}, 11: 1024},
    ("mid", 4): {ln: 512 for ln in (2, 4, 6, 8, 10)},
    ("transposed", 2): {**{ln: 512 for ln in range(7, 14)}, 14: 1024},
    ("transposed", 4): {**{ln: 512 for ln in range(7, 14)}, 14: 1024}}


def _lg(v: int) -> int:
    return v.bit_length() - 1


def _smem(route, lp) -> int:
    """The kernel's shared memory a block (stockham_pass)."""
    if route == "transposed":
        wf = A.pitch(lp.n, min(_lg(lp.g), 3)) * lp.g
    else:
        wf = lp.points
    return lp.nbuf * 2 * 4 * (-(-wf // 32) * 32)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("k", range(25, 37))
def test_three_launches_the_kernel_takes(monkeypatch, k, radix, dtype):
    """At most three launches, each one that stockham_pass takes: a
    built instance with at least the block's threads, 512 to 16384 points
    a tile within a block's shared memory, every point of the view in
    exactly one tile, radix 4's launches 1 and 2 whole radix-4 stages
    (l1, l2 even; the tail in launch 3), the whole transform in each
    launch's view; column launches in tiles of C >= 8 columns (32-byte
    segments of an fp32 plane) but radix 4 at 2^35 and 2^36, whose rows
    would pass 2^14, in 4096-point columns of C = 4 in launch 1.  The
    launch arguments carry the shifts l1, l1, l1 + l2, the planned grid
    and 1/n at the last store; the plan does not depend on the dtype."""
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    S._launch_args.cache_clear()
    n = 1 << k
    batch = 2
    plan = S.plan(batch, n, radix)
    l1, l2, lq = S.split3(n, radix)
    assert [r for r, _ in plan] == ["cols", "mid", "transposed"]
    assert l1 + l2 + lq == k and 8 <= l1 and 2 <= l2 and 7 <= lq <= 14
    if radix == 4:
        assert l1 % 2 == 0 and l2 % 2 == 0
    views = [(batch, 1 << l1, n >> l1), (batch << l1, 1 << l2, 1 << lq),
             (batch << (l1 + l2), 1 << lq, 1)]
    for (route, lp), view in zip(plan, views):
        assert (lp.outer, lp.n, lp.inner) == view
        assert lp.outer * lp.n * lp.inner == batch * n
        assert A.MIN_POINTS <= lp.points <= A.TILE_BIG
        assert lp.threads == lp.points // 16
        assert INSTANCES[route, radix][_lg(lp.n)] >= lp.threads
        assert _smem(route, lp) <= A.SMEM_MAX
        assert lp.inner % lp.c == 0 and (lp.c == lp.inner or lp.g == 1)
        assert lp.tiles * lp.points == -(-lp.outer // lp.g) * lp.g * lp.n \
            * lp.inner
        if route != "transposed":
            wide = radix == 4 and k >= 35 and route == "cols"
            assert lp.c == (4 if wide else lp.c) and (wide or lp.c >= 8)
    args = S._launch_args(radix, batch, n, True, torch.device("cpu"))
    assert [a[5] for a in args] == [1, 4, 2]
    assert [a[6] for a in args] == [l1, l1, l1 + l2]
    assert [a[8] for a in args] == [1.0, 1.0, 1.0 / n]
    assert all(1 <= a[7] <= lp.tiles for a, (_, lp) in zip(args, plan))
    assert _build.store_code(dtype) == DTYPES.index(dtype)
    S._launch_args.cache_clear()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``fft_stockham.cu`` built once with g++ under the CUDA stand-in,
    ``_build`` routed to it for this module's tests."""
    spec = importlib.util.spec_from_file_location(
        "cuda_emu_emulate_st", ROOT / "tools" / "cuda_emu" / "emulate.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    emu.build(("fft_stockham",), tmp_path_factory.mktemp("cuda_emu"))
    mp = pytest.MonkeyPatch()
    for name in ("function", "check_operands", "launch", "launch_all"):
        mp.setattr(_build, name, getattr(emu, f"_{name}"))
    mp.setattr(_build, "sm_count", lambda device: 2)   # blocks walk tiles
    yield emu
    mp.undo()


def _f64(y: SplitComplex) -> np.ndarray:
    return y.re.double().numpy() + 1j * y.im.double().numpy()


def _err(y, want) -> float:
    return float(np.abs(_f64(y) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape,dtype", [
    ((2, 1 << 17), torch.float32), ((2, 1 << 17), torch.bfloat16),
    ((2, 1 << 17), torch.float16), ((1, 1 << 18), torch.float32)],
    ids=str)
@pytest.mark.parametrize("radix", [2, 4])
def test_emulated_three_launches(emulated, monkeypatch, shape, radix,
                                 dtype):
    """The three launches under the emulator with TWO_MAX lowered to 2^16
    (2^17: split (8, 2, 7), the middle launch on tiles of 16 whole (4, 128)
    images; 2^18: radix 2 (8, 3, 7), radix 4 (8, 2, 8), even log2 Q), both
    directions, three C entry calls a transform: fp32 within 1e-5 of
    max|plain|, bf16 and float16 against float64 numpy of the rounded
    input within PERF.md's bounds."""
    monkeypatch.setattr(S, "TWO_MAX", 1 << 16)
    S._launch_args.cache_clear()
    kern, plain, symbol = (
        (S.fft_stockham_r2_cuda, S.fft_stockham_r2_plain,
         "fft_stockham_r2_pass") if radix == 2 else
        (S.fft_stockham_cuda, S.fft_stockham_plain, "fft_stockham_r4_pass"))
    rng = np.random.default_rng(shape[1] + radix)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    x = from_numpy(z, device="cpu")
    x = SplitComplex(x.re.to(dtype), x.im.to(dtype))
    try:
        for inverse in (False, True):
            _build.CALLS.clear()
            got = kern(x, inverse=inverse)
            assert _build.CALLS[symbol] == 3 and got.re.dtype == dtype
            ref = plain(x, inverse=inverse)
            if dtype == torch.float32:
                assert emulated.rel(got, ref) <= 1e-5
                continue
            want = (np.fft.ifft if inverse else np.fft.fft)(_f64(x))
            bound, slack = ((6e-2, 2.0 ** -7) if dtype == torch.bfloat16
                            else (1e-3, 2.0 ** -10))
            assert _err(got, want) <= bound
            assert _err(got, want) <= _err(ref, want) + slack
    finally:
        S._launch_args.cache_clear()
