"""Time the redesigned kernels of one checkout of the port on the card, to
compare two commits within one call.

    python3 tools/kernel_ab.py <tree> [--launches] [--gemm | --stockham]

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
- ``fft2d_gemm`` at 16 x 1024^2 and 1 x 1024^2 in fp32, bf16 compensated
  and bf16 plain (the tensor-core route, or the GEMM chain in a tree
  before it), and at 16 x 1024^2 in float16 plain (null where the tree
  refuses it), and ``fft3d_fused`` at
  2 x 256^3, 8 x 128^3 (and its three-launch route, where the tree has
  one) and 2 x 256^3 bf16 compensated, bf16 plain and float16 plain,
  with ``fft3(algo="row_col")`` at 2 x 256^3 beside them, each with its
  device time a call;
- ``rfft2d_fused`` at 16 x 1024^2 and 1 x 1024^2, and ``irfft2d_fused``
  at 16 x 1024^2, each with its device time a call;
- ``fft_stockham_r2`` at 2 x 2^20 and at the shapes ``rfft2(algo=
  "stockham2")`` gives it at 1024^2: 1024 x 512, 513 x 1024, 1024 x 1024;
- ``fft_stockham`` (radix 4) at 2 x 2^22 (the 1-D main path), 2 x 2^23
  and 4 x 2^21 (``irfft``'s inner transforms), and ``fft2``/``fft3`` with
  ``algo="row_col"`` (its 1024- and 256-point rows) at 16 x 1024^2 and
  2 x 256^3, each with its device time a call;
- ``fft2d_fused`` (the ``fused_stockham`` oracle) at 16 x 1024^2 and
  1 x 1024^2, forward and inverse, with its device time a call;
- ``fftconv_fused`` at the SSM conv shape 8 x 576 x 8192 and table 11's
  64-row banks at m = 1024, 4096, 16384 (one pass) and 32768 (the 1-D
  kernels around the section kernel), with its device time a call; and
  the conv entry points (``fft_conv`` at the SSM shape, ``circular_conv``
  on each table 11 bank) traced: device-busy share of 20 calls (the sum of
  their kernels' device time over the host time the calls take, synced)
  and each launch's device time;
- the long-axis routes, where the tree has them (a tree without them
  refuses, and its entry is null): ``fft2d_gemm`` at 1 x 8192^2,
  ``fft_fourstep`` at 1 x 2^21 (1024 x 2048) and both Stockham kernels
  at 1 x 2^25;
- ``decode_attention`` in bf16 at ``chip_smoke.py``'s two decode cells,
  starcoder2-15b (16 x 32768 slots filled to a quarter .. all, GQA 48/4,
  D 128) and h2o-danube-1.8b (128 rings of 4096, window 4096, GQA 32/8,
  D 80, the last row with no visible slot), with its device time a call;
- the seconds of one nvcc each for ``fft2d_gemm.cu`` and
  ``fft3d_fused.cu`` (``nvcc_s``) and the ptxas lines of the plain
  route's kernels (``plain_route_ptxas``: ``dft_tile`` and ``dft_gemm``
  instances, or the GEMM core's in a tree before them);
- the ptxas lines of the four-step kernels, of every 2-D and 3-D kernel
  instance, of the radix-2, radix-4 and real-input kernels, of the fused
  Stockham 2-D kernel, of the conv kernels and of the decode kernels the
  tree builds.

With ``--stockham`` it keeps only the users of ``stockham.cuh`` and the
controls of a Stockham change: ``fft_stockham`` at 2 x 2^22 and 1 x 2^25,
``fft_stockham_r2`` at 2 x 2^20 and 1 x 2^25 (past 2^24: a launch a stage,
or the three fused launches, whichever the tree has), ``fft2d_fused`` and
``fft2d_gemm`` fp32 at 16 x 1024^2, ``fft2d_fused`` with an axis of 2^25
at 1 x 2 x 2^25 (rows) and 1 x 2^25 x 8 (columns; past 2^24 a launch a
stage, or the three fused launches) and ``fftconv_fused`` at 8 x 576 x
8192, each with its device time a call (``device_us``: a
``torch.profiler`` trace of 10 calls; ``loop_us``: 20 calls back to back
between CUDA events, the median of 7 loops) and its grid launches (a
trace of one call); ``fft_stockham`` at 2 x 2^22 on
three launches (``TWO_MAX`` lowered to 2^21) where the tree has them; and
the seconds of each source's nvcc (every source of ``_build.SOURCES``,
all started together, ``nvcc_s``), with the ptxas lines of the Stockham
kernels.

With ``--launches`` it also lists every grid launch of one call of
``fft_fourstep`` at 4 x 2^20, of ``fft_staged`` at 512 x 16384, of
``fft2d_gemm`` and ``fft3d_fused`` at their main shapes (fp32 and bf16
compensated), of ``rfft2d_fused`` and ``irfft2d_fused`` at 16 x 1024^2, of
``fft_stockham_r2`` at 2 x 2^20, of ``fft_stockham`` at 2 x 2^22,
2 x 2^23 and 4 x 2^21, of ``fft2``/``fft3(algo="row_col")`` at 16 x 1024^2 and
2 x 256^3, of ``fft2d_fused`` at 16 x 1024^2 (forward and inverse) and of
``decode_attention`` at both cells, with its device time, from a
``torch.profiler`` trace.  ``--gemm`` keeps the 2-D and 3-D GEMM
transforms (every variant and dtype) and decode attention, the users of
the plain route's headers, and builds only their sources.  Unpack the parent into a
directory that .gitignore lists and alternate the trees, one process each:

    mkdir -p build/ab_parent
    git archive <parent> src/repro_torch | tar -x -C build/ab_parent
    for t in build/ab_parent . . build/ab_parent; do
        python3 tools/kernel_ab.py $t --launches; done
"""
import json
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = sys.argv[1]
GEMM_ONLY = "--gemm" in sys.argv
STOCKHAM_ONLY = "--stockham" in sys.argv
sys.path.insert(0, ROOT + "/src")

import torch  # noqa: E402
from repro_torch.core import (SplitComplex, fft2, fft3, fft_conv,  # noqa
                              circular_conv)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fft_fourstep as F  # noqa: E402
from repro_torch.kernels import fft_stage as ST  # noqa: E402
from repro_torch.kernels import fft2d_gemm as G  # noqa: E402
from repro_torch.kernels import rfft2d_fused as R  # noqa: E402
from repro_torch.kernels import fft3d_fused as V  # noqa: E402
from repro_torch.kernels import fft_stockham as S  # noqa: E402
from repro_torch.kernels import fft2d_fused as S2  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import fftconv_fused as C  # noqa: E402

FOURSTEP = [(4, 1 << 20), (64, 4096), (32768, 512), (4096, 4096),
            (512, 16384)]
STAGED = [(512, 16384), (8, 16384)]
IMAGES = (16, 1024, 1024)
IMAGE = (1, 1024, 1024)
VOLUME = (2, 256, 256, 256)
PME = (8, 128, 128, 128)
R2 = [(2, 1 << 20), (1024, 512), (513, 1024), (1024, 1024)]
R4 = [(2, 1 << 22), (2, 1 << 23), (4, 1 << 21)]
CONV = [(8, 576, 8192), (1, 64, 1024), (1, 64, 4096), (1, 64, 16384),
        (1, 64, 32768)]
SSM = ((8, 576, 4096), (1, 576, 4))     # fft_conv's x and filter bank
LONG = [("fft2d_gemm", (1, 8192, 8192)), ("fft_fourstep", (1, 1 << 21)),
        ("fft_stockham_r2", (1, 1 << 25)), ("fft_stockham", (1, 1 << 25))]
# (B, S, H, KV, D, window, ring) of chip_smoke.py's decode cells
DECODE = {"starcoder2-15b": (16, 32768, 48, 4, 128, None, False),
          "h2o-danube-1.8b": (128, 4096, 32, 8, 80, 4096, True)}


def decode_case(b, s, h, kv, d, window, ring, seed):
    """chip_smoke.py's decode_case in bf16: q, K, V from a seeded
    generator on the card, positions from numpy (full rows of a quarter to
    all of S, or rings wrapping mid-array with short rows and an empty last
    row)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").bfloat16()
               for shape in ((b, h, d), (b, s, kv, d), (b, s, kv, d)))
    prng = np.random.default_rng(seed)
    slot = np.arange(s)
    if ring:
        q_pos = prng.integers(s, 8 * s, b)
        q_pos[(q_pos + 1) % s == 0] += 1
        q_pos[1:4] = (s // 3, 17, s - 2)
        kv_pos = q_pos[:, None] - (q_pos[:, None] - slot) % s
        kv_pos[kv_pos < 0] = -1
        kv_pos[-1] = -1
    else:
        n = prng.integers(s // 4, s + 1, b)
        n[0] = s
        q_pos = n - 1
        kv_pos = np.where(slot < n[:, None], slot, -1)
    return (q, k, v, torch.from_numpy(kv_pos).to("cuda", torch.int32),
            torch.from_numpy(q_pos).to("cuda", torch.int32))


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


def busy_share(fn, calls=20):
    """(device-busy share, host ms a call) of ``calls`` calls: their
    kernels' device time over the host time from the first call to the
    synchronize after the last."""
    import time
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / (wall * 1e6), wall * 1e3 / calls


def ptxas_lines(log):
    """{kernel symbol: registers, stack and spills} from nvcc's -Xptxas -v
    log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("stack frame" in line or "Used" in line):
            out[name] = (out.get(name, "") + " " + line.split(":")[-1]
                         .strip()).strip()
    return out


def others(ms, dev, traced, cplx, g):
    """The real-input, fused Stockham and conv kernels (skipped with
    ``--gemm``); returns the conv entry points' traces."""
    for shape in (IMAGES, IMAGE):
        r = torch.randn(shape, generator=g, device="cuda")
        key = f"rfft2d_fused {shape[0]}x1024^2"
        ms[key] = time_ms(lambda: R.rfft2d_fused_cuda(r))
        dev[key] = device_us(lambda: R.rfft2d_fused_cuda(r))
        if "--launches" in sys.argv and shape == IMAGES:
            traced[f"{key} launches"] = launches(
                lambda: R.rfft2d_fused_cuda(r))
    h = cplx(IMAGES[:2] + (IMAGES[2] // 2 + 1,))
    key = "irfft2d_fused 16x1024^2"
    ms[key] = time_ms(lambda: R.irfft2d_fused_cuda(h))
    dev[key] = device_us(lambda: R.irfft2d_fused_cuda(h))
    if "--launches" in sys.argv:
        traced[f"{key} launches"] = launches(
            lambda: R.irfft2d_fused_cuda(h))
    del r, h
    torch.cuda.empty_cache()
    for shape in (IMAGES, IMAGE):
        x = cplx(shape)
        for inv in (False, True):
            key = f"fft2d_fused {shape[0]}x1024^2" + (" inverse" if inv
                                                     else "")
            ms[key] = time_ms(lambda: S2.fft2d_fused_cuda(x, inverse=inv))
            dev[key] = device_us(lambda: S2.fft2d_fused_cuda(x, inverse=inv))
            if "--launches" in sys.argv and shape == IMAGES:
                traced[f"{key} launches"] = launches(
                    lambda: S2.fft2d_fused_cuda(x, inverse=inv))
        del x
    torch.cuda.empty_cache()
    conv_trace = {}
    for shape in CONV:
        m = shape[-1]
        x = torch.randn(shape, generator=g, device="cuda")
        kf = cplx((shape[1], m // 2 + 1))
        ef = C.pack_filter(kf, m, torch.float32)
        key = f"fftconv_fused {'x'.join(map(str, shape))}"
        ms[key] = time_ms(lambda: C.fftconv_fused_cuda(x, ef))
        dev[key] = device_us(lambda: C.fftconv_fused_cuda(x, ef))
        if "--launches" in sys.argv:
            traced[f"{key} launches"] = launches(
                lambda: C.fftconv_fused_cuda(x, ef))
        if shape[1] == 64 and m <= 16384:      # table 11's bank, entry point
            kk = torch.zeros((64, m), device="cuda")
            kk[:, :129] = torch.randn((64, 129), generator=g, device="cuda")
            conv_trace[f"circular_conv 64x{m}"] = busy_share(
                lambda: circular_conv(x[0], kk, backend="cuda"))
            conv_trace[f"circular_conv 64x{m} launches"] = launches(
                lambda: circular_conv(x[0], kk, backend="cuda"))
        del x, kf, ef
    xs = torch.randn(SSM[0], generator=g, device="cuda")
    ks = torch.randn(SSM[1], generator=g, device="cuda")
    conv_trace["fft_conv ssm"] = busy_share(
        lambda: fft_conv(xs, ks, backend="cuda"))
    conv_trace["fft_conv ssm launches"] = launches(
        lambda: fft_conv(xs, ks, backend="cuda"))
    del xs, ks
    torch.cuda.empty_cache()
    return conv_trace


def nvcc_seconds(names) -> dict:
    """One nvcc a source, all started together: the seconds each took
    (null for a library that was current)."""
    t0 = time.perf_counter()
    jobs = {n: _build._start(n) for n in names}
    secs = dict.fromkeys(names)

    def finish(n):
        _build._finish(n, jobs[n])
        secs[n] = time.perf_counter() - t0
    threads = [threading.Thread(target=finish, args=(n,)) for n in names
               if jobs[n] is not None]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return secs


def loop_us(fn, calls=20, loops=7):
    """Device us a call with the host ahead of the card: ``calls`` calls
    back to back between two CUDA events, the median of ``loops`` such
    loops (the card's time a call, launch gaps included, without the
    host's set-up before the first launch)."""
    fn()
    torch.cuda.synchronize()
    t = []
    for _ in range(loops):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        t.append(a.elapsed_time(e) * 1e3 / calls)
    return sorted(t)[loops // 2]


def stockham_main():
    """``--stockham``: the Stockham kernels and their controls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("fft_stockham", "fft2d_fused", "fftconv_fused", "fft2d_gemm")
    nvcc_s = nvcc_seconds(_build.SOURCES)
    _build.build_all(names)
    ptxas = {n: ptxas_lines(_build.library_path(n).with_suffix(".log")
                            .read_text())
             for n in ("fft_stockham", "fft2d_fused")}
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def cplx(shape):
        return SplitComplex(torch.randn(shape, generator=g, device="cuda"),
                            torch.randn(shape, generator=g, device="cuda"))
    calls = [("fft_stockham 2x2^22", S.fft_stockham_cuda, (2, 1 << 22)),
             ("fft_stockham_r2 2x2^20", S.fft_stockham_r2_cuda,
              (2, 1 << 20)),
             ("fft2d_fused 16x1024^2", S2.fft2d_fused_cuda, IMAGES),
             ("fft2d_gemm 16x1024^2", G.fft2d_gemm_cuda, IMAGES),
             ("fft_stockham 1x2^25", S.fft_stockham_cuda, (1, 1 << 25)),
             ("fft_stockham_r2 1x2^25", S.fft_stockham_r2_cuda,
              (1, 1 << 25)),
             ("fft2d_fused 1x2x2^25", S2.fft2d_fused_cuda, (1, 2, 1 << 25)),
             ("fft2d_fused 1x2^25x8", S2.fft2d_fused_cuda, (1, 1 << 25, 8))]
    ms, dev, loop, grids = {}, {}, {}, {}

    def measure(key, fn):
        try:                        # a shape the tree refuses: null
            fn()
        except _build.KernelLaunchError:
            ms[key] = loop[key] = dev[key] = grids[key] = None
            return
        ms[key] = time_ms(fn)
        loop[key] = loop_us(fn)
        dev[key] = device_us(fn, calls=10)
        grids[key] = [round(us, 1) for _, us in launches(fn)]
    for key, kern, shape in calls:
        x = cplx(shape)
        measure(key, lambda: kern(x))
        del x
        torch.cuda.empty_cache()
    x = torch.randn(CONV[0], generator=g, device="cuda")
    ef = C.pack_filter(cplx((CONV[0][1], CONV[0][2] // 2 + 1)),
                       CONV[0][2], torch.float32)
    measure("fftconv_fused 8x576x8192", lambda: C.fftconv_fused_cuda(x, ef))
    del x, ef
    if hasattr(S, "split3"):        # a tree with the three launches
        x = cplx((2, 1 << 22))
        S.TWO_MAX = 1 << 21
        S._launch_args.cache_clear()
        measure("fft_stockham 2x2^22 three launches",
                lambda: S.fft_stockham_cuda(x))
        S.TWO_MAX = 1 << 24
        S._launch_args.cache_clear()
        del x
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"tree": ROOT, "nvidia_smi": smi, "ms": ms,
                      "loop_us": loop, "device_us": dev, "launch_us": grids,
                      "nvcc_s": nvcc_s, "ptxas": ptxas}), flush=True)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # the GEMM transforms' two sources alone first, one nvcc each, timed
    import time
    nvcc_s = {}
    for name in ("fft2d_gemm", "fft3d_fused"):
        t0 = time.perf_counter()
        _build.build_all((name,))
        nvcc_s[name] = time.perf_counter() - t0
    names = (("fft2d_gemm", "fft3d_fused", "decode_attention") if GEMM_ONLY
             else ("fft_fourstep", "fft_stage", "fft2d_gemm", "rfft2d_fused",
                   "fft3d_fused", "fft_stockham", "fft2d_fused",
                   "fftconv_fused", "decode_attention"))
    logs = _build.build_all(names)
    # a library built earlier (above, by chip_smoke.py, or a run before)
    # left its compiler log beside it
    ptxas = {n: ptxas_lines(logs.get(n) or _build.library_path(n)
                            .with_suffix(".log").read_text())
             for n in names}
    # the plain route's kernels: the tensor-core tiles and long-axis
    # products (dm::dft_tile, dm::dft_gemm), or the GEMM core's instances
    # in a tree that still has it (cg::cgemm)
    marks = ("dft_tile", "dft_gemm", "cgemm")
    plain_route = {n: {k: line for k, line in ptxas[n].items()
                       if any(m in k for m in marks)}
                   for n in ("fft2d_gemm", "fft3d_fused")}
    ptxas = {n: {k: line for k, line in ptxas[n].items()
                 if not any(m in k for m in marks)}
             for n in names}
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def cplx(shape):
        return SplitComplex(torch.randn(shape, generator=g, device="cuda"),
                            torch.randn(shape, generator=g, device="cuda"))

    ms, dev = {}, {}
    traced = {}
    for kern, shapes in () if GEMM_ONLY else (
            (F.fft_fourstep_cuda, FOURSTEP), (ST.fft_staged_cuda, STAGED),
            (S.fft_stockham_r2_cuda, R2), (S.fft_stockham_cuda, R4)):
        for shape in shapes:
            x = cplx(shape)
            key = f"{kern.__name__[:-5]} {shape[0]}x{shape[1]}"
            ms[key] = time_ms(lambda: kern(x))
            dev[key] = device_us(lambda: kern(x))
            if "--launches" in sys.argv and shapes is R4:
                traced[f"{key} launches"] = launches(lambda: kern(x))
            del x
    torch.cuda.empty_cache()

    def bf16(x):
        return SplitComplex(x.re.bfloat16(), x.im.bfloat16())

    three = getattr(V, "_fft3d_cuda", None)   # the route A/B, where it is
    calls = {}
    for shape in (IMAGES, IMAGE):
        tag = f"{shape[0]}x1024^2"
        calls[f"fft2d_gemm {tag}"] = (G.fft2d_gemm_cuda, shape, False, {})
        for v in ("compensated", "plain"):
            calls[f"fft2d_gemm {tag} bf16 {v}"] = (
                G.fft2d_gemm_cuda, shape, True, {"variant": v})
    calls["fft3d_fused 2x256^3"] = (V.fft3d_fused_cuda, VOLUME, False, {})
    calls["fft3d_fused 2x256^3 bf16 compensated"] = (
        V.fft3d_fused_cuda, VOLUME, True, {"variant": "compensated"})
    calls["fft3d_fused 2x256^3 bf16 plain"] = (
        V.fft3d_fused_cuda, VOLUME, True, {"variant": "plain"})
    # plain float16, where the tree takes it (null where it refuses)
    calls["fft2d_gemm 16x1024^2 float16 plain"] = (
        G.fft2d_gemm_cuda, IMAGES, "half", {"variant": "plain"})
    calls["fft3d_fused 2x256^3 float16 plain"] = (
        V.fft3d_fused_cuda, VOLUME, "half", {"variant": "plain"})
    calls["fft3d_fused 8x128^3"] = (V.fft3d_fused_cuda, PME, False, {})
    if three is not None:
        calls["fft3d_fused 8x128^3 three launches"] = (
            three, PME, False, {"planes": False})
    if not GEMM_ONLY:
        calls["fft3 row_col 2x256^3"] = (
            lambda x: fft3(x, algo="row_col", backend="cuda"), VOLUME, False,
            {})
        calls["fft2 row_col 16x1024^2"] = (
            lambda x: fft2(x, algo="row_col", backend="cuda"), IMAGES, False,
            {})
    for key, (kern, shape, low, kw) in calls.items():
        x = cplx(shape)
        if low == "half":
            x = SplitComplex(x.re.half(), x.im.half())
            try:
                kern(x, **kw)
            except TypeError:            # a tree that refuses it
                ms[key] = dev[key] = None
                continue
        elif low:
            x = bf16(x)
        ms[key] = time_ms(lambda: kern(x, **kw))
        dev[key] = device_us(lambda: kern(x, **kw))
        if "--launches" in sys.argv and shape != IMAGE:
            traced[f"{key} launches"] = launches(lambda: kern(x, **kw))
        del x
    torch.cuda.empty_cache()
    conv_trace = {} if GEMM_ONLY else others(ms, dev, traced, cplx, g)
    for name, shape in () if GEMM_ONLY else LONG:
        x = cplx(shape)
        kern = {"fft2d_gemm": G.fft2d_gemm_cuda,
                "fft_fourstep": F.fft_fourstep_cuda,
                "fft_stockham_r2": S.fft_stockham_r2_cuda,
                "fft_stockham": S.fft_stockham_cuda}[name]
        key = f"{name} {'x'.join(map(str, shape))}"
        try:
            kern(x)
        except (ValueError, TypeError):      # a tree that refuses it
            ms[key] = dev[key] = None
        else:
            ms[key] = time_ms(lambda: kern(x))
            dev[key] = device_us(lambda: kern(x))
        del x
        torch.cuda.empty_cache()
    for i, (name, c) in enumerate(DECODE.items()):
        case = decode_case(*c, seed=7 + i)
        key = f"decode_attention {name} bf16"
        ms[key] = time_ms(lambda: DA.decode_attention_cuda(*case,
                                                          window=c[5]))
        dev[key] = device_us(lambda: DA.decode_attention_cuda(*case,
                                                             window=c[5]))
        if "--launches" in sys.argv:
            traced[f"{key} launches"] = launches(
                lambda: DA.decode_attention_cuda(*case, window=c[5]))
        del case
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"tree": ROOT, "nvidia_smi": smi, "ms": ms, "device_us": dev,
           "conv_trace": conv_trace, "plain_route_ptxas": plain_route,
           "nvcc_s": nvcc_s,
           "ptxas": ptxas, **traced}
    if "--launches" in sys.argv and not GEMM_ONLY:
        x = cplx(FOURSTEP[0])
        out["fft_fourstep 4x2^20 launches"] = launches(
            lambda: F.fft_fourstep_cuda(x))
        x = cplx(STAGED[0])
        out["fft_staged 512x16384 launches"] = launches(
            lambda: ST.fft_staged_cuda(x))
        x = cplx(R2[0])
        out["fft_stockham_r2 2x2^20 launches"] = launches(
            lambda: S.fft_stockham_r2_cuda(x))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    stockham_main() if STOCKHAM_ONLY else main()
