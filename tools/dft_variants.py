"""Split the plain route's time on the card into its copies and its steps.

    python3 tools/dft_variants.py

Builds ``src/repro_torch/kernels/csrc/dft_mma.cuh`` alone (one nvcc a
variant, in parallel, into ``build/dft_variants/``) as it is ("whole"),
with its two DFT steps removed ("copies": the tiles' copies in and out
only) and with its copies removed ("steps": the steps on whatever the
buffers hold), and prints one JSON line a variant and tile size: the
device µs of one bf16 call (``torch.profiler``, the mean of 5 after 3
warm-ups) at 16 x 1024^2 and 2 x 256^3 through
``kernels/dft_mma.run``, the whole variant's error against the plain
version, and each variant's registers; then the card's nvidia-smi name
and power limit.  The variants compute nothing meaningful but "whole":
they bound what the copies and the steps cost alone.
"""
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from repro_torch.core import SplitComplex  # noqa: E402
from repro_torch.kernels import _build, dft_mma as D  # noqa: E402
from repro_torch.kernels import fft2d_gemm as G  # noqa: E402
from repro_torch.kernels import fft3d_fused as V  # noqa: E402
from repro_torch.kernels.rfft2d_fused import fourstep_factors  # noqa: E402

OUT = ROOT / "build" / "dft_variants"
ENTRY = """#include "dft_mma.cuh"
extern "C" int plain_pass(const void* xr, const void* xi, void* yr,
    void* yi, const void* a1, const void* tr, const void* ti, const void* a2,
    int route, long long outer, int n, long long inner, int n1, int lines,
    int sms, float scale, int f16, void* stream) {
  return (int)dm::dft_launch(xr, xi, yr, yi, a1, tr, ti, a2, route, outer,
      n, inner, n1, lines, sms, scale, f16, (cudaStream_t)stream);
}
"""
STEPS = ("run_step<F16, true, C>(g.s1,", "run_step<F16, C, C>(g.s2, g.lu,",
         "run_step<F16, C, C>(g.s2, g.lx,")
COPIES = ("copy_out<C>(g, b0,", "copy_out<C>(g, b1,",
          "load<C>(g, tile<C>(g, t), xb);",
          "load<C>(g, tile<C>(g, t + gridDim.x),", "load<C>(g, tl, b0);")
VARIANTS = {"whole": (), "copies": STEPS, "steps": COPIES}
CELLS = {"16x1024^2": ((16, 1024, 1024), fourstep_factors),
         "2x256^3": ((2, 256, 256, 256), V.fourstep_factors3)}


def source(removed) -> str:
    """dft_mma.cuh with each call that starts with one of ``removed``
    turned off (``if (0)``); a call not found stops the tool."""
    text = (_build.CSRC / "dft_mma.cuh").read_text()
    for call in removed:
        assert call in text, call
        text = text.replace(call, "if (0) " + call)
    return text


def device_us(fn, calls=5) -> float:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / calls


def main() -> int:
    procs = {}
    for name, removed in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for h in ("bf16.cuh", "f16.cuh", "mma.cuh"):
            shutil.copy(_build.CSRC / h, d / h)
        (d / "dft_mma.cuh").write_text(source(removed))
        (d / "entry.cu").write_text(ENTRY)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-I", str(d), "-o",
             str(d / "lib.so"), str(d / "entry.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    regs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(log, file=sys.stderr)
            return 1
        regs[name] = [int(r) for r in re.findall(r"Used (\d+) registers",
                                                 log)]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    xs = {c: SplitComplex(*(torch.randn(shape, generator=g, device="cuda")
                            .bfloat16() for _ in "ri"))
          for c, (shape, _) in CELLS.items()}
    want = {"16x1024^2": G.fft2d_gemm_plain(xs["16x1024^2"],
                                            variant="plain"),
            "2x256^3": V.fft3d_fused_plain(xs["2x256^3"], variant="plain")}
    for name in VARIANTS:
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).plain_pass
        fn.argtypes = D.ARGS
        fn.restype = ctypes.c_int
        for tile in (8192, 16384):
            limits = D.Limits(tile=tile)
            rec = {"variant": name, "tile": tile, "registers": regs[name]}
            for cell, (shape, factors) in CELLS.items():
                x = xs[cell]
                out = SplitComplex(torch.empty_like(x.re),
                                   torch.empty_like(x.im))
                call = lambda: D.run(fn, shape[1:], factors, x, out,  # noqa
                                     False, "dft_variants", limits)
                rec[cell] = device_us(call)
                if name == "whole":
                    d = max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(out, want[cell]))
                    rec[cell + " err_over_max"] = d / max(
                        b.float().abs().max().item() for b in want[cell])
            print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
