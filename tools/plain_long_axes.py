"""Check and time the plain route's long-axis products on the card.

    python3 tools/plain_long_axes.py [--big]

Axes past one tile's threshold run as two tiled products through a scratch
pair (``csrc/dft_mma.cuh``, ``dft_gemm``).  For each shape, in bf16 and in
float16, forward and inverse: the wrapper's error against its plain
version over max|plain| (bounds 2^-7 and 2^-10); beside it the kernel's
and the plain version's errors against the plain version with every
product summed in float64 (a second witness of the same rounded
products); the C entry calls of one call (``_build.CALLS``), and the
device ms of the kernel and of the plain version (median of 5 CUDA-event
timings after 2 warm-ups), and beside them ``torch.fft.fft2`` on the
same values as complex64 (``library_ms``: the library has no bf16
transform), printed as one JSON line each; then the card's nvidia-smi name
and power limit.  Shapes: rows of 2^20 and 2^24 points
(factors 1024 and 4096) and columns of 2^22 over 2 columns; ``--big``
adds rows of 2^26 (factors 8192).  float16 inputs are scaled by 2^-4
for the forward and 2^-1 for the inverse: the plain variant applies the
inverse's 1/N at its last rounding, so at 2^27 points the unscaled sums
must stay under float16's 65504 and the outputs above its smallest
normal, 6.1e-5 (unscaled, the forward overflows; at 2^-4 the inverse's
outputs are subnormal, and one subnormal step is 1.8e-3 of max|plain|).
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import SplitComplex  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import fft2d_gemm as G  # noqa: E402
from repro_torch.kernels import rfft2d_fused as R  # noqa: E402

SHAPES = [(2, 2, 1 << 20), (1, 2, 1 << 24), (1, 1 << 22, 2)]
TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def ms(fn, runs=5, warmup=2) -> float:
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


def plain64(x, inverse):
    """The plain version with every product's sums taken in float64 (then
    rounded to fp32, where the plain version's sums are fp32)."""
    matmul = R._matmul
    R._matmul = lambda p, q: torch.matmul(p.double(), q.double()).float()
    try:
        return G.fft2d_gemm_plain(x, inverse=inverse, variant="plain")
    finally:
        R._matmul = matmul


def rel(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want)) / max(
        float(b.float().abs().max()) for b in want)


def main() -> int:
    shapes = SHAPES + ([(1, 2, 1 << 26)] if "--big" in sys.argv else [])
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    ok = True
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float16):
            z = SplitComplex(*(torch.randn(shape, generator=g,
                                           device="cuda") for _ in "ri"))
            for inverse in (False, True):
                amp = 1.0 if dtype == torch.bfloat16 else (
                    2.0 ** -1 if inverse else 2.0 ** -4)
                x = SplitComplex((amp * z.re).to(dtype),
                                 (amp * z.im).to(dtype))
                ops.reset_launches()
                got = G.fft2d_gemm_cuda(x, inverse=inverse, variant="plain")
                torch.cuda.synchronize()
                calls = dict(_build.CALLS)
                want = G.fft2d_gemm_plain(x, inverse=inverse,
                                          variant="plain")
                w64 = plain64(x, inverse)
                err = rel(got, want)
                rec = {"shape": shape, "dtype": str(dtype)[6:],
                       "inverse": inverse, "err_over_max_plain": err,
                       "bound": TOL[dtype],
                       "err_over_max_f64": rel(got, w64),
                       "plain_err_over_max_f64": rel(want, w64),
                       "calls": calls, "ok": err <= TOL[dtype]}
                del got, want, w64
                if not inverse:
                    rec["kernel_ms"] = ms(lambda: G.fft2d_gemm_cuda(
                        x, variant="plain"))
                    rec["plain_ms"] = ms(lambda: G.fft2d_gemm_plain(
                        x, variant="plain"), runs=3, warmup=1)
                    c = torch.complex(x.re.float(), x.im.float())
                    rec["library_ms"] = ms(lambda: torch.fft.fft2(c))
                    del c
                ok &= rec["ok"]
                print(json.dumps(rec), flush=True)
                del x
            del z
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
