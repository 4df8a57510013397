"""Check and time the Stockham kernels' three-launch route on the card.

    python3 tools/stockham_long.py [--forced] [--sweep] [--three22] [--tiles]

Past 2^24 both Stockham kernels (radix 4, ``fft_stockham_cuda``, and
radix 2, ``fft_stockham_r2_cuda``) run three fused launches
(``kernels/fft_stockham.py::split3``).  Prints one JSON line each:

- ``nvcc``: the seconds of one nvcc of ``fft_stockham.cu`` (null when the
  library was current);
- ``check`` at 1 x 2^25 for each radix, forward and inverse: fp32 against
  float64 numpy (bound 5e-5 of max|X|), bf16 and float16 against float64
  numpy of the rounded input (6e-2 and 1e-3 of max|X|);
- ``round_trip``: forward then inverse at 1 x 2^27, fp32, within 1e-4 of
  max|x|;
- ``timing`` at 1 x 2^25 for each radix, fp32: the kernel's ms (median of
  25 CUDA-event timings after 3 warm-ups), each grid launch's device us
  (CUDA events around each launch, median of 10 calls), the C entry calls
  of one call
  (``_build.CALLS``), ``torch.fft.fft`` on complex64, the bound (16 bytes
  a point at 3.35 TB/s) and the three-pass floor;
- with ``--forced``: the kernel instances that no plan reaches at a size
  an 80 GB card holds, reached through a patched ``split3`` (columns of
  2^11 in the middle launch, rows of 2^13 and 2^14 in the last, radix 4's
  4096-point columns in the first and 1024-point columns in the middle),
  fp32 forward and inverse against float64 numpy;
- with ``--sweep``: other splits at 1 x 2^25, ms and device us a launch;
- with ``--three22``: radix 4 at 2 x 2^22 on its two launches and on
  three (``TWO_MAX`` lowered to 2^21), ms and device us a launch;
- with ``--tiles``: a few splits at 1 x 2^25 on other tiles (the
  points a tile of each launch, ``axis_fft.plan_axis``'s 8192 patched to
  4096 or 2048 launch by launch), ms and device us a launch;

then the card's nvidia-smi name and power limit.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import SplitComplex  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fft_stockham as S  # noqa: E402

N = 1 << 25
KERNELS = {2: (S.fft_stockham_r2_cuda, "fft_stockham_r2_pass"),
           4: (S.fft_stockham_cuda, "fft_stockham_r4_pass")}
TOL = {torch.float32: 5e-5, torch.bfloat16: 6e-2, torch.float16: 1e-3}
PEAK_HBM_BYTES = 3.35e12
# (radix, log2 n, (l1, l2, lq)) reaching the instances no default plan
# reaches below 2^33
FORCED = [(2, 26, (8, 11, 7)), (2, 23, (8, 2, 13)), (2, 24, (8, 2, 14)),
          (4, 23, (8, 2, 13)), (4, 24, (8, 2, 14)), (4, 21, (12, 2, 7)),
          (4, 25, (8, 10, 7))]
TILE_SPLITS = [(4, (8, 8, 9)), (4, (10, 8, 7)), (2, (8, 8, 9)),
               (2, (8, 7, 10))]
SWEEP = {2: [(8, 8, 9), (9, 8, 8), (8, 9, 8), (9, 9, 7), (10, 8, 7),
             (8, 10, 7), (10, 7, 8), (8, 7, 10), (8, 6, 11)],
         4: [(8, 8, 9), (10, 8, 7), (8, 10, 7), (8, 6, 11), (10, 6, 9)]}


def emit(d) -> None:
    print(json.dumps(d), flush=True)


def ms(fn, runs=25, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def launches_us(fn, runs=10) -> list:
    """Each grid launch's device us in a call of ``fn``, in order: CUDA
    events around each C entry call (``_build.launch_all``), the median of
    ``runs`` calls."""
    real = _build.launch_all
    events = []

    def timed(entry, arg_lists, what, device):
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for args in arg_lists:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                _build.check(entry(*args, stream), what)
                b.record()
                if events:              # not the warm-up call
                    events[-1].append((a, b))
    _build.launch_all = timed
    try:
        fn()
        for _ in range(runs):
            events.append([])
            fn()
        torch.cuda.synchronize()
    finally:
        _build.launch_all = real
    per = [sorted(a.elapsed_time(b) for a, b in col)[len(col) // 2]
           for col in zip(*events)]
    return [round(1e3 * t, 1) for t in per]


def rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def on_card(z, dtype=torch.float32) -> SplitComplex:
    return SplitComplex(torch.from_numpy(z.real).to("cuda", dtype),
                        torch.from_numpy(z.imag).to("cuda", dtype))


def host(y: SplitComplex) -> np.ndarray:
    return y.re.double().cpu().numpy() + 1j * y.im.double().cpu().numpy()


def err(y, want) -> float:
    return float(np.abs(host(y) - want).max() / np.abs(want).max())


def forced(split):
    """Patch ``split3`` to return ``split`` (None: restore it)."""
    if not hasattr(forced, "real"):
        forced.real = S.split3
    S.split3 = forced.real if split is None else (lambda n, radix: split)
    S._launch_args.cache_clear()


def tiled(caps):
    """Patch ``plan_axis`` to cap launch i's tiles at ``caps[i]`` points
    (None: restore it); the three launches plan in order."""
    from repro_torch.kernels import axis_fft as A
    if not hasattr(tiled, "real"):
        tiled.real = A.plan_axis
    if caps is None:
        S._axis.plan_axis = tiled.real
        S._launch_args.cache_clear()
        return
    order = iter(caps * 64)

    def plan_axis(outer, n, inner):
        cap = next(order)
        if inner == 1:
            return A.Launch("rows", outer, n, 1, 1,
                            A._images(cap, n, outer))
        c = min(inner, cap // n)
        return A.Launch("cols", outer, n, inner, c, 1)
    S._axis.plan_axis = plan_axis
    S._launch_args.cache_clear()


def check(radices, z, label, dtypes=(torch.float32,)) -> bool:
    """Each radix's forward and inverse of ``z`` in each dtype against
    float64 numpy of the rounded input."""
    ok = True
    for dtype in dtypes:
        x = on_card(z, dtype)
        z64 = host(x)
        for inverse in (False, True):
            want = np.fft.ifft(z64) if inverse else np.fft.fft(z64)
            for radix in radices:
                e = err(KERNELS[radix][0](x, inverse=inverse), want)
                ok &= e <= TOL[dtype]
                emit({"phase": label, "radix": radix, "n": z.shape[-1],
                      "split": S.split3(z.shape[-1], radix),
                      "dtype": str(dtype)[6:], "inverse": inverse,
                      "err_over_max": e, "tol": TOL[dtype]})
            del want
        del x
    torch.cuda.empty_cache()
    return ok


def timing(radix, x, label, **extra) -> None:
    kern, symbol = KERNELS[radix]
    _build.CALLS.clear()
    kern(x)
    calls = _build.CALLS[symbol]
    k_ms = ms(lambda: kern(x))
    emit({"phase": label, "radix": radix, "shape": list(x.shape),
          "kernel_ms": k_ms, "launch_us": launches_us(lambda: kern(x)),
          "grid_launches": calls, **extra})


def main() -> int:
    argv = sys.argv[1:]
    t0 = time.perf_counter()
    fresh = not _build.library_path("fft_stockham").exists()
    _build.build_all(("fft_stockham",))
    emit({"phase": "nvcc", "source": "fft_stockham.cu",
          "seconds": time.perf_counter() - t0 if fresh else None})
    ok = True
    z = rand((1, N), 25)
    ok &= check((4, 2), z, "check", tuple(TOL))
    for radix in (4, 2):
        x = on_card(z)
        c = torch.complex(x.re, x.im)
        b_ms = 16 * N / PEAK_HBM_BYTES * 1e3
        timing(radix, x, "timing", split=S.split3(N, radix),
               library_ms=ms(lambda: torch.fft.fft(c)), bound_ms=b_ms,
               floor_ms=3 * b_ms)
        del x, c
    del z
    torch.cuda.empty_cache()
    z = rand((1, 1 << 27), 27)
    for radix in (4, 2):
        kern = KERNELS[radix][0]
        x = on_card(z)
        back = kern(kern(x), inverse=True)
        e = float(max((back.re - x.re).abs().max(),
                      (back.im - x.im).abs().max())
                  / max(x.re.abs().max(), x.im.abs().max()))
        ok &= e <= 1e-4
        emit({"phase": "round_trip", "radix": radix, "n": 1 << 27,
              "split": S.split3(1 << 27, radix), "err_over_max": e,
              "tol": 1e-4})
        del x, back
        torch.cuda.empty_cache()
    del z
    if "--forced" in argv:
        S.TWO_MAX = 1 << 16            # 2^21 .. 2^24 on three launches too
        for radix, ln, split in FORCED:
            forced(split)
            ok &= check((radix,), rand((1, 1 << ln), ln), "forced")
        forced(None)
        S.TWO_MAX = 1 << 24
    if "--sweep" in argv:
        x = on_card(rand((1, N), 5))
        for radix, splits in SWEEP.items():
            for split in splits:
                forced(split)
                timing(radix, x, "sweep", split=split)
        forced(None)
        del x
    if "--tiles" in argv:
        x = on_card(rand((1, N), 5))
        for radix, split in TILE_SPLITS:
            forced(split)
            for caps in [(8192, 8192, 8192), (4096, 8192, 8192),
                         (8192, 4096, 8192), (8192, 8192, 4096),
                         (4096, 4096, 4096), (8192, 2048, 8192),
                         (2048, 2048, 8192)]:
                tiled(caps)
                timing(radix, x, "tiles", split=S.split3(N, radix),
                       caps=caps, tiles=[(lp.c, lp.g) for _, lp in
                                         S.plan(1, N, radix)])
        tiled(None)
        forced(None)
        del x
    if "--three22" in argv:
        x = on_card(rand((2, 1 << 22), 22))
        timing(4, x, "three22", launches=2)
        S.TWO_MAX = 1 << 21
        S._launch_args.cache_clear()
        timing(4, x, "three22", launches=3, split=S.split3(1 << 22, 4))
        S.TWO_MAX = 1 << 24
        S._launch_args.cache_clear()
        del x
    emit({"phase": "done", "ok": bool(ok)})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
