#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
kernel against its plain PyTorch version at the main path's shapes, drives
the main path (``repro_torch.core.fft2(x, backend="cuda")`` at 1024x1024
fp32 through the plan registry, its ``algo="row_col"`` Stockham baseline,
and the 1-D plans at n = 2^20 and 2^22),
checks it against float64 numpy, and times every kernel beside its plain
version, ``torch.fft`` and its bound.  Each phase prints one JSON line; the
last line is the device record.  Exits non-zero, with no device record,
when CUDA is missing, a kernel fails to build or launch, or any check fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TOL_2D = 1e-5           # kernel vs plain, error / max|plain|
TOL_1D = 5e-5
TOL_NUMPY = 1e-5        # fft2 vs float64 numpy, error / max|ref|
TOL_ROUNDTRIP = 1e-4

# the main path's shapes: the paper's 1024x1024 complex fp32 images in a
# batch of 16 (and 1), and the 1-D plans on either side of 2^20
MAIN_2D = (16, 1024, 1024)
MAIN_2D_SINGLE = (1, 1024, 1024)
MAIN_FOURSTEP = (4, 1 << 20)
MAIN_STOCKHAM = (2, 1 << 22)
# (kernel, shape) pairs held against the plain version, forward and inverse
CHECKS = [("fft2d_gemm", MAIN_2D), ("fft2d_gemm", (2, 8, 4)),
          ("fft2d_gemm", (3, 256, 512)), ("fft2d_gemm", (1, 4096, 2048)),
          ("fft_fourstep", (64, 4096)), ("fft_fourstep", MAIN_FOURSTEP),
          ("fft_stockham", MAIN_STOCKHAM), ("fft_stockham", (64, 1024)),
          ("fft_stockham", (3, 2)), ("fft_stockham", (5, 8))]
DEMOTED_2D = (1, 1000, 1000)
MAIN_SHAPE = {"fft2d_gemm": MAIN_2D, "fft_fourstep": MAIN_FOURSTEP,
              "fft_stockham": MAIN_STOCKHAM}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# -- operation and byte counts ------------------------------------------------
#
# The bound is the function's, not the method's: ``batch`` complex FFTs of
# n points (n = H*W for a 2-D image) need 5*n*log2(n) flops each, and each
# input and output point is read or written once, 8 bytes a point.  The
# method's own counts (dense-DFT contractions at 8 flops per complex
# multiply-add, and the twiddle tables it streams) are printed beside it.

def fft_counts(batch: int, n: int):
    """(flops, bytes) that ``batch`` complex fp32 FFTs of n points need."""
    return 5 * batch * n * (n.bit_length() - 1), 16 * batch * n


def _fourstep_flops(n: int, n1: int) -> int:
    """Method flops of one length-n row: both DFT contractions and the
    twiddle (6 per point), or one dense DFT when n1 = 1."""
    n2 = n // n1
    if n1 == 1:
        return 8 * n * n
    return 8 * n1 * n1 * n2 + 6 * n + 8 * n1 * n2 * n2


def method_fft2d(b, h, w, fac):
    """(method flops, table bytes) of the GEMM 2-D kernel."""
    n1w, n1h = fac(w)[0], fac(h)[0]
    flops = b * (h * _fourstep_flops(w, n1w) + w * _fourstep_flops(h, n1h))
    tables = sum(8 * (n1 * n1 + (n // n1) ** 2 + n)
                 for n, n1 in ((w, n1w), (h, n1h)))
    return flops, tables


def method_fourstep(b, n, n1):
    return b * _fourstep_flops(n, n1), 8 * (n1 * n1 + (n // n1) ** 2 + n)


def method_stockham(b, n):
    ln = n.bit_length() - 1
    s4, tail = ln // 2, ln % 2
    flops = b * (s4 * (n // 4) * 34 + tail * (n // 2) * 4)
    return flops, 8 * max(s4, 1) * 3 * max(n // 4, 1)


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


# -- helpers ------------------------------------------------------------------

def time_ms(fn, torch, runs=25, warmup=3):
    """Median of ``runs`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def errors(got, ref):
    """(max abs error, max abs error / max |ref|) over both planes."""
    d = max((got.re - ref.re).abs().max().item(),
            (got.im - ref.im).abs().max().item())
    m = max(ref.re.abs().max().item(), ref.im.abs().max().item())
    return d, d / m


def np_errors(got, ref):
    import numpy as np
    z = got.re.double().cpu().numpy() + 1j * got.im.double().cpu().numpy()
    return float(np.abs(z - ref).max() / np.abs(ref).max())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import (from_numpy, fft2, get_plan, plan_fft,
                                  clear_plan_cache)
    from repro_torch.core.fft1d import assert_full_fp32
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fft2d_gemm as G
    from repro_torch.kernels import fft_fourstep as F
    from repro_torch.kernels import fft_stockham as S
    from repro_torch.kernels.rfft2d_fused import fourstep_factors

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert_full_fp32()
    failures = []
    dev = "cuda"
    rng = np.random.default_rng(0)

    def rand(shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "Used" in ln]
             for n, log in logs.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": [_build.library_path(n).name for n in _build.SOURCES],
          "ptxas": ptxas})

    # 3. kernel vs plain version, forward and inverse
    impls = {"fft2d_gemm": (G.fft2d_gemm_cuda, G.fft2d_gemm_plain, TOL_2D),
             "fft_fourstep": (F.fft_fourstep_cuda, F.fft_fourstep_plain,
                              TOL_1D),
             "fft_stockham": (S.fft_stockham_cuda, S.fft_stockham_plain,
                              TOL_1D)}
    main_err = {}
    for name, shape in CHECKS:
        kern, plain, tol = impls[name]
        x = from_numpy(rand(shape), device=dev)
        for inverse in (False, True):
            got = kern(x, inverse=inverse)
            torch.cuda.synchronize()
            ref = plain(x, inverse=inverse)
            abs_err, rel = errors(got, ref)
            ok = rel <= tol
            if not ok:
                failures.append(f"{name}{shape} inverse={inverse}: {rel}")
            if not inverse and shape == MAIN_SHAPE[name]:
                main_err[name] = abs_err
            emit({"phase": "kernel_vs_plain", "kernel": name,
                  "shape": shape, "inverse": inverse,
                  "max_abs_err": abs_err, "err_over_max": rel, "tol": tol,
                  "ok": ok})
        del x, got, ref
    torch.cuda.empty_cache()

    # 4. main path through the registry
    clear_plan_cache()
    z16, z1 = rand(MAIN_2D), rand(MAIN_2D_SINGLE)
    za, zb = rand(MAIN_FOURSTEP), rand(MAIN_STOCKHAM)
    x16, x1 = from_numpy(z16, device=dev), from_numpy(z1, device=dev)
    xa, xb = from_numpy(za, device=dev), from_numpy(zb, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    y16 = fft2(x16, backend="cuda")
    back16 = fft2(y16, inverse=True, backend="cuda")
    y1 = fft2(x1, backend="cuda")
    back1 = fft2(y1, inverse=True, backend="cuda")
    yr = fft2(x1, algo="row_col", backend="cuda")   # two Stockham passes
    backr = fft2(yr, inverse=True, algo="row_col", backend="cuda")
    ya = plan_fft(MAIN_FOURSTEP[1], backend="cuda")(xa)
    yb = plan_fft(MAIN_STOCKHAM[1], backend="cuda")(xb)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    p2 = get_plan(MAIN_2D[1:], backend="cuda")
    pa = plan_fft(MAIN_FOURSTEP[1], backend="cuda")
    pb = plan_fft(MAIN_STOCKHAM[1], backend="cuda")
    checks = {
        "fft2_b16_vs_numpy": np_errors(y16, np.fft.fft2(z16)),
        "fft2_b16_roundtrip": np_errors(back16, z16),
        "fft2_b1_vs_numpy": np_errors(y1, np.fft.fft2(z1)),
        "fft2_b1_roundtrip": np_errors(back1, z1),
        "fft2_row_col_b1_vs_numpy": np_errors(yr, np.fft.fft2(z1)),
        "fft2_row_col_b1_roundtrip": np_errors(backr, z1),
        "fft_2^20_vs_numpy": np_errors(ya, np.fft.fft(za)),
        "fft_2^22_vs_numpy": np_errors(yb, np.fft.fft(zb)),
    }
    limits = {"fft2_b16_vs_numpy": TOL_NUMPY, "fft2_b1_vs_numpy": TOL_NUMPY,
              "fft2_b16_roundtrip": TOL_ROUNDTRIP,
              "fft2_b1_roundtrip": TOL_ROUNDTRIP,
              "fft2_row_col_b1_vs_numpy": TOL_NUMPY,
              "fft2_row_col_b1_roundtrip": TOL_ROUNDTRIP,
              "fft_2^20_vs_numpy": TOL_1D, "fft_2^22_vs_numpy": TOL_1D}
    for k, v in checks.items():
        if not (v <= limits[k]):
            failures.append(f"main path {k}: {v} > {limits[k]}")
    if (p2.algo, p2.backend, p2.demote_reason) != ("fused", "cuda", None):
        failures.append(f"1024x1024 plan resolved to {p2}")
    if (pa.algo, pb.algo) != ("four_step", "stockham") or \
            pa.backend != "cuda" or pb.backend != "cuda":
        failures.append(f"1-D plans resolved to {pa}, {pb}")
    for k, v in launches.items():
        if v <= 0:
            failures.append(f"kernel {k} was not launched on the main path")
    del x16, y16, back16, xa, ya, xb, yb, yr, backr
    torch.cuda.empty_cache()
    # a shape with no kernel path demotes to the torch backend
    zd = rand(DEMOTED_2D)
    yd = fft2(from_numpy(zd, device=dev), backend="cuda")
    pd = get_plan(DEMOTED_2D[1:], backend="cuda")
    reason = ("kernels need power-of-two tile dims >= 2, "
              f"got {DEMOTED_2D[1:]}")
    demote_err = np_errors(yd, np.fft.fft2(zd))
    if pd.backend != "torch" or pd.demote_reason != reason:
        failures.append(f"1000x1000 plan: {pd}")
    if not demote_err <= TOL_NUMPY:
        failures.append(f"1000x1000 torch path error {demote_err}")
    emit({"phase": "main_path", "launches": launches, "errors": checks,
          "limits": limits,
          "plans": {"fft2_1024": [p2.algo, p2.backend, p2.demote_reason],
                    "fft_2^20": [pa.algo, pa.backend],
                    "fft_2^22": [pb.algo, pb.backend]},
          "demoted_1000x1000": {"backend": pd.backend,
                                "demote_reason": pd.demote_reason,
                                "err_vs_numpy": demote_err}})

    # 5. timing at the main path's shapes
    kernels = []
    specs = [
        ("fft2d_gemm", MAIN_2D, G.fft2d_gemm_cuda,
         G.fft2d_gemm_plain, lambda c: torch.fft.fft2(c),
         fft_counts(MAIN_2D[0], MAIN_2D[1] * MAIN_2D[2]),
         method_fft2d(*MAIN_2D, fourstep_factors),
         "src/repro/kernels/fft2d_gemm.py:79"),
        ("fft_fourstep", MAIN_FOURSTEP, F.fft_fourstep_cuda,
         F.fft_fourstep_plain, lambda c: torch.fft.fft(c),
         fft_counts(*MAIN_FOURSTEP),
         method_fourstep(*MAIN_FOURSTEP, F._split_n(MAIN_FOURSTEP[1])[0]),
         "src/repro/kernels/fft_fourstep.py:45"),
        ("fft_stockham", MAIN_STOCKHAM, S.fft_stockham_cuda,
         S.fft_stockham_plain, lambda c: torch.fft.fft(c),
         fft_counts(*MAIN_STOCKHAM), method_stockham(*MAIN_STOCKHAM),
         "src/repro/kernels/fft_stockham.py:45"),
    ]
    for name, shape, kern, plain, lib, (flops, nbytes), \
            (method_flops, table_bytes), replaces in specs:
        x = from_numpy(rand(shape), device=dev)
        c = torch.complex(x.re, x.im)
        k_ms = time_ms(lambda: kern(x), torch)
        p_ms = time_ms(lambda: plain(x), torch)
        l_ms = time_ms(lambda: lib(c), torch)
        b_ms, b_by = bound_ms(flops, nbytes)
        emit({"phase": "timing", "kernel": name, "shape": shape,
              "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
              "bound_us": b_ms * 1e3, "bound_by": b_by, "fft_flops": flops,
              "io_bytes": nbytes, "method_flops": method_flops,
              "table_bytes": table_bytes,
              "method_tflops": method_flops / k_ms / 1e9})
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": main_err[name], "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": l_ms})
        del x, c
        torch.cuda.empty_cache()

    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:                     # report, then exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
