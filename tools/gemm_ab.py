"""Time the GEMM-core kernels of one checkout of the port on the card, to
compare two commits within one call (parent, change, change, parent, ...).

    python3 tools/gemm_ab.py <tree>     # <tree>/src/repro_torch is imported

Builds that tree's fft2d_gemm, rfft2d_fused and fft_fourstep libraries and
prints one JSON line: the card's nvidia-smi name and power limit, the
median of 50 CUDA-event timings (after 5 warm-ups) of fp32 fft2d_gemm at
16x1024^2, rfft2d_fused at 16x1024^2 and fft_fourstep at 4x2^20, on
seeded inputs, and the ptxas lines of fft2d_gemm's kernels.  Unpack the
parent with ``git archive <commit> src/repro_torch`` into a directory
that .gitignore lists and alternate the two trees, one process each:

    for t in parent . . parent . parent; do python3 tools/gemm_ab.py $t; done
"""
import json, subprocess, sys
root = sys.argv[1]
sys.path.insert(0, root + "/src")
import numpy as np
import torch
from repro_torch.core import from_numpy
from repro_torch.kernels import _build, fft2d_gemm as G, rfft2d_fused as R, fft_fourstep as F

def time_ms(fn, runs=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True); e = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); e.record(); e.synchronize(); t.append(a.elapsed_time(e))
    t.sort()
    return t[len(t) // 2]

logs = _build.build_all(("fft2d_gemm", "rfft2d_fused", "fft_fourstep"))
regs = [l.split(":", 1)[1].strip() for l in logs["fft2d_gemm"].splitlines() if "Used" in l]
rng = np.random.default_rng(0)
x = from_numpy(rng.standard_normal((16, 1024, 1024)) + 1j * rng.standard_normal((16, 1024, 1024)), device="cuda")
r = torch.from_numpy(rng.standard_normal((16, 1024, 1024))).float().cuda()
f = from_numpy(rng.standard_normal((4, 1 << 20)) + 1j * rng.standard_normal((4, 1 << 20)), device="cuda")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
print(json.dumps({"tree": root, "nvidia_smi": smi,
                  "fft2d_gemm_ms": time_ms(lambda: G.fft2d_gemm_cuda(x)),
                  "rfft2d_fused_ms": time_ms(lambda: R.rfft2d_fused_cuda(r)),
                  "fft_fourstep_ms": time_ms(lambda: F.fft_fourstep_cuda(f)),
                  "fft2d_gemm_ptxas": regs[:3]}), flush=True)
