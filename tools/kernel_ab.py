"""Time the redesigned 1-D kernels and the ``cgemm.cuh`` users of one
checkout of the port on the card, to compare two commits within one call.

    python3 tools/kernel_ab.py <tree> [--launches]

``<tree>/src/repro_torch`` is imported and its kernels are built into
``<tree>/build``.  Prints one JSON line: the tree, the card's nvidia-smi
name and power limit, and the median of 50 CUDA-event timings (after 5
warm-ups) of each call on inputs made on the card from a fixed seed
(``ms``: a call as a caller sees it, host time to its first launch
included), and for the four-step and staged kernels the kernels' own
device time a call (``device_us``: the sum of their launches' durations
in a ``torch.profiler`` trace of 5 calls, divided by 5):

- ``fft_fourstep`` at every shape ``chip_smoke.py`` runs it: 4 x 2^20 (also
  ``rfft``'s inner transform at 4 x 2^21), 64 x 4096, ``fourier_mix``'s
  32768 x 512 and 4096 x 4096, and Table 1's 512 x 16384;
- ``fft_staged`` at 512 x 16384 and 8 x 16384;
- the kernels that share ``cgemm.cuh``: ``fft2d_gemm``, ``rfft2d_fused``
  and ``irfft2d_fused`` at 16 x 1024^2 and ``fft3d_fused`` at 256^3 x 2,
  with the fp32 GEMM instance's ptxas line.

With ``--launches`` it also lists every grid launch of one call of
``fft_fourstep`` at 4 x 2^20 and of ``fft_staged`` at 512 x 16384 with its
device time, from a ``torch.profiler`` trace.  Unpack the parent into a
directory that .gitignore lists and alternate the trees, one process each:

    mkdir -p build/ab_parent
    git archive <parent> src/repro_torch | tar -x -C build/ab_parent
    for t in build/ab_parent . . build/ab_parent; do
        python3 tools/kernel_ab.py $t --launches; done
"""
import json
import subprocess
import sys

ROOT = sys.argv[1]
sys.path.insert(0, ROOT + "/src")

import torch  # noqa: E402
from repro_torch.core import SplitComplex  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fft_fourstep as F  # noqa: E402
from repro_torch.kernels import fft_stage as ST  # noqa: E402
from repro_torch.kernels import fft2d_gemm as G  # noqa: E402
from repro_torch.kernels import rfft2d_fused as R  # noqa: E402
from repro_torch.kernels import fft3d_fused as V  # noqa: E402

FOURSTEP = [(4, 1 << 20), (64, 4096), (32768, 512), (4096, 4096),
            (512, 16384)]
STAGED = [(512, 16384), (8, 16384)]
IMAGES = (16, 1024, 1024)
VOLUME = (2, 256, 256, 256)


def time_ms(fn, runs=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        e.synchronize()
        t.append(a.elapsed_time(e))
    t.sort()
    return t[len(t) // 2]


def launches(fn, calls=1):
    """[(kernel name, device us)] of ``calls`` calls of ``fn``, in launch
    order."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    ev.sort(key=lambda e: e.time_range.start)
    return [(e.name[:60], e.time_range.elapsed_us()) for e in ev]


def device_us(fn, calls=5):
    return sum(us for _, us in launches(fn, calls)) / calls


def ptxas_lines(log):
    """{kernel symbol: registers, stack and spills} from nvcc's -Xptxas -v
    log ('' when the library was already built)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("stack frame" in line or "Used" in line):
            out[name] = (out.get(name, "") + " " + line.split(":")[-1]
                         .strip()).strip()
    return out


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    logs = _build.build_all(("fft_fourstep", "fft_stage", "fft2d_gemm",
                             "rfft2d_fused", "fft3d_fused"))
    ptxas = {n: ptxas_lines(log) for n, log in logs.items()}
    gemm_f32 = [line for n in ("fft2d_gemm", "rfft2d_fused", "fft3d_fused")
                for k, line in ptxas[n].items() if "Lb0ELb0ELi0E" in k]
    ptxas = {n: ptxas[n] for n in ("fft_fourstep", "fft_stage")}
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def cplx(shape):
        return SplitComplex(torch.randn(shape, generator=g, device="cuda"),
                            torch.randn(shape, generator=g, device="cuda"))

    ms, dev = {}, {}
    for kern, shapes in ((F.fft_fourstep_cuda, FOURSTEP),
                         (ST.fft_staged_cuda, STAGED)):
        for shape in shapes:
            x = cplx(shape)
            key = f"{kern.__name__[:-5]} {shape[0]}x{shape[1]}"
            ms[key] = time_ms(lambda: kern(x))
            dev[key] = device_us(lambda: kern(x))
    x = cplx(IMAGES)
    ms["fft2d_gemm 16x1024^2"] = time_ms(lambda: G.fft2d_gemm_cuda(x))
    r = torch.randn(IMAGES, generator=g, device="cuda")
    ms["rfft2d_fused 16x1024^2"] = time_ms(lambda: R.rfft2d_fused_cuda(r))
    h = cplx(IMAGES[:2] + (IMAGES[2] // 2 + 1,))
    ms["irfft2d_fused 16x1024^2"] = time_ms(lambda: R.irfft2d_fused_cuda(h))
    del x, r, h
    v = cplx(VOLUME)
    ms["fft3d_fused 2x256^3"] = time_ms(lambda: V.fft3d_fused_cuda(v))
    del v
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"tree": ROOT, "nvidia_smi": smi, "ms": ms, "device_us": dev,
           "cgemm_f32_ptxas": gemm_f32, "ptxas": ptxas}
    if "--launches" in sys.argv:
        x = cplx(FOURSTEP[0])
        out["fft_fourstep 4x2^20 launches"] = launches(
            lambda: F.fft_fourstep_cuda(x))
        x = cplx(STAGED[0])
        out["fft_staged 512x16384 launches"] = launches(
            lambda: ST.fft_staged_cuda(x))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
