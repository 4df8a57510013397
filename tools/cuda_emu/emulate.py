"""Run the CUDA kernels' host code on the CPU, without nvcc or a GPU.

    PYTHONPATH=src python tools/cuda_emu/emulate.py

Compiles each ``src/repro_torch/kernels/csrc/*.cu`` with g++ (C++20)
against the stand-in ``cuda_runtime.h`` in this directory
(``<<<grid, block, shmem, s>>>`` launches become one
thread per CUDA thread of a block, walking the blocks in turn, with
``__syncthreads()`` a barrier; ``extern __shared__`` arrays point at a
buffer of ``shmem`` bytes), loads the libraries with ctypes in place of
``repro_torch.kernels._build``'s, and calls the real CUDA wrappers
(``*_cuda``) on CPU tensors against their plain versions at small shapes.

What it checks: the index maps, buffer chaining, scales and launch
parameters of every entry point, the bf16 storage modes of the GEMM
transforms (bf16.cuh's conversions run as written), the plain variant's
tensor-core DFT steps (dft_mma.cuh: its ldmatrix and mma.sync fragments,
swizzled tiles and epilogues, the rows and column tiles, and the long-axis
route's tiled products with lowered thresholds), the shared-memory stages of the fused conv and
fused Stockham 2-D kernel's row and column passes (odd log2 h and w,
h = 2, whole images a tile), the four-step kernel's shared-memory FFTs
(one- and two-launch routes), the 2-D and 3-D kernels' planned routes
(plane, rows and column tiles, persistent blocks walking several tiles
through both buffers; a cp.async becomes a plain copy), the real-input
forward's packed-row tiles with the untangle at their store and its
ragged column tiles, the real-input inverse's column pass read at the
input's odd pitch (ragged and whole-image tiles) and its row pass building
the packed rows at its load, the radix-4 and radix-2 Stockham kernels'
one-, two- and three-launch routes (odd log2 n, n = 2 and 8), the staged FFT's folded bit-reverse (rows and
tiles) and float4 stages, and decode attention's split and merge kernels
on both routes (warp shuffles and ballots, the tensor-core route's
ldmatrix and mma.sync fragments, its cp.async ring, skipped tiles and
splits and the merge's mean of V).  What it cannot check: warp
scheduling, shared-memory limits or timing.  Libraries go to
``build/cuda_emu/``.  Exits non-zero if a shape disagrees beyond 1e-5 of
max|plain| (fp32) or one bf16 ulp at the top of the range, 2^-7 of
max|plain| (bf16 on the GEMM transforms and decode), or, for bf16 planes
on the other kernels, if the kernel's error against float64 numpy of the
bf16-rounded input passes 6e-2 of max|X| or the plain version's own error
plus 2^-7, or for float16 planes on every FFT kernel (the compensated 2-D
and 3-D GEMM transforms included) if the kernel's error against float64
numpy of the float16-rounded input passes 1e-3 of max|X| (not for the
staged FFT, which rounds every stage) or the plain version's error plus
2^-10, and the float16 routes of ROADMAP §2e (the plain GEMM chain,
decode attention whole and as merged partials) within 2^-10 of max|plain|
(the plain route's float16 products, 2-D and 3-D, included).
``f16_conversions`` compiles ``csrc/f16.cuh``'s conversions alone
(``tests/test_torch_f16.py`` holds them to torch's casts).  It also runs the long-axis routes scaled down (the split
launches with lowered thresholds, the real-input steps at 8192, the
four-step kernel's axis route, the fused Stockham 2-D kernel's and the
Stockham kernels' three launches); the conv's multi-launch
schedule takes the emulated 1-D kernels (``install``).
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import SplitComplex, from_numpy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "cuda_emu"
TOL = 1e-5
TOL_BF16 = 2.0 ** -7
_LIBS: dict = {}
_LAUNCH = re.compile(
    r"(\w+(?:<[^<>]*>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*\w+>>>\(")
_DYNAMIC_SHARED = re.compile(r"extern\s+__shared__\s+(\w+)\s+(\w+)\[\];")


def _rewrite(src: str) -> str:
    """A source's launches and dynamic shared memory in the stand-in's
    terms."""
    src = _LAUNCH.sub(r"EMU_LAUNCH(\2, \3, \4, \1)(", src)
    return _DYNAMIC_SHARED.sub(
        r"\1* \2 = reinterpret_cast<\1*>(emu_shared);", src)


def build(names=_build.SOURCES, out=None) -> None:
    """g++ each listed source into ``lib<name>.so`` in ``out`` (default
    ``build/cuda_emu/``), in parallel; :func:`install` loads them from
    there."""
    global OUT
    OUT = Path(out) if out is not None else OUT
    OUT.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        (OUT / h.name).write_text(_rewrite(h.read_text()))
    shutil.copy(HERE / "cuda_runtime.h", OUT / "cuda_runtime.h")
    procs = []
    for name in names:
        src = (_build.CSRC / f"{name}.cu").read_text()
        cpp = OUT / f"{name}.cpp"
        cpp.write_text(_rewrite(src))
        procs.append(subprocess.Popen(
            ["g++", "-O2", "-std=c++20", "-pthread", "-shared", "-fPIC",
             "-I", str(OUT), "-o", str(OUT / f"lib{name}.so"), str(cpp)]))
    codes = [p.wait() for p in procs]
    if any(codes):
        raise subprocess.CalledProcessError(max(codes), "g++")


def f16_conversions(out_dir) -> ctypes.CDLL:
    """``csrc/f16.cuh``'s conversions compiled with g++ into ``out_dir``:
    ``f32_to_f16(const float*, unsigned short*, n)`` and
    ``f16_to_f32(const unsigned short*, float*, n)`` over n values."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cpp = out_dir / "f16_conversions.cpp"
    cpp.write_text(
        '#include "cuda_runtime.h"\n#include "f16.cuh"\n'
        'extern "C" void f32_to_f16(const float* x, unsigned short* y, '
        'long long n) { for (long long i = 0; i < n; ++i) '
        'y[i] = cg::f32_to_f16(x[i]); }\n'
        'extern "C" void f16_to_f32(const unsigned short* x, float* y, '
        'long long n) { for (long long i = 0; i < n; ++i) '
        'y[i] = cg::f16_to_f32(x[i]); }\n')
    so = out_dir / "libf16_conversions.so"
    subprocess.run(["g++", "-O2", "-std=c++20", "-shared", "-fPIC", "-I",
                    str(HERE), "-I", str(_build.CSRC), "-o", str(so),
                    str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    for fn in (lib.f32_to_f16, lib.f16_to_f32):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
        fn.restype = None
    return lib


def _function(name, symbol, argtypes):
    lib = _LIBS.setdefault(name, ctypes.CDLL(str(OUT / f"lib{name}.so")))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _check_operands(x, ndim, dtypes=(torch.float32,)):
    planes = tuple(x) if isinstance(x, SplitComplex) else (x,)
    for t in planes:
        if t.dtype not in dtypes or t.dim() != ndim \
                or not t.is_contiguous():
            raise ValueError(f"bad operand {t.dtype} {tuple(t.shape)}")


def _check_decode_operands(*ops):
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("non-contiguous decode operand")


def _check_merge_operands(*ops):
    if any(t.dtype != torch.float32 for t in ops):
        raise ValueError("non-fp32 partial")


def _launch_all(fn, arg_lists, what, device):
    for args in arg_lists:
        _build.check(fn(*args, None), what)
        _build.CALLS[fn.__name__] += 1


def _launch(fn, args, what, device):
    _launch_all(fn, [args], what, device)


def install() -> None:
    """Route the CUDA wrappers to the emulated libraries, and the kernel
    dispatch of ``repro_torch.kernels.ops`` too: every tensor here lies on
    the CPU, where ``ops`` would run the plain versions, so the wrappers
    that dispatch through it (the conv's multi-launch schedule, its 1-D
    transforms) take the emulated kernels."""
    from repro_torch.kernels import ops
    ops._on_card = lambda t: True
    _build.function = _function
    _build.check_operands = _check_operands
    _build.check_decode_operands = _check_decode_operands
    _build.check_merge_operands = _check_merge_operands
    _build.launch = _launch
    _build.launch_all = _launch_all
    _build.sm_count = lambda device: 2     # persistent blocks walk tiles


def rel(a, b) -> float:
    pa = tuple(a) if isinstance(a, SplitComplex) else (a,)
    pb = tuple(b) if isinstance(b, SplitComplex) else (b,)
    d = max((x.float() - y.float()).abs().max().item()
            for x, y in zip(pa, pb))
    return d / max(y.float().abs().max().item() for y in pb)


def main() -> int:
    from repro_torch.kernels import fft2d_gemm as G
    from repro_torch.kernels import fft_fourstep as F
    from repro_torch.kernels import fft_stockham as S
    from repro_torch.kernels import rfft2d_fused as R
    from repro_torch.kernels import fftconv_fused as C
    from repro_torch.kernels import fft3d_fused as V
    from repro_torch.kernels import fft2d_fused as S2
    from repro_torch.kernels import fft_stage as ST
    from repro_torch.kernels import decode_attention as DA
    build()
    install()
    rng = np.random.default_rng(0)

    def cplx(shape):
        return from_numpy(rng.standard_normal(shape)
                          + 1j * rng.standard_normal(shape), device="cpu")

    results = []
    for shape in [(2, 2, 2), (3, 8, 4), (2, 4, 8), (1, 2, 16), (2, 16, 2),
                  (1, 4, 512), (1, 512, 8), (1, 512, 1024)]:
        x = torch.from_numpy(rng.standard_normal(shape)).float()
        results.append(("rfft2d_fused", shape, False,
                        rel(R.rfft2d_fused_cuda(x), R.rfft2d_fused_plain(x))))
        b, h, w = shape
        xf = cplx((b, h, w // 2 + 1))
        results.append(("irfft2d_fused", shape, True,
                        rel(R.irfft2d_fused_cuda(xf),
                            R.irfft2d_fused_plain(xf))))
    # the forward's packed row tiles (rows past the batch zero-filled) and
    # its column pass: ragged last tiles (C = 32, 16, 8, 4, 1024 columns of
    # 260, 36, 132, 8, 2052), whole images of pitch 4 at h = 4096; the
    # inverse's column pass on the same tiles read at the odd pitch w/2+1
    for shape in [(3, 256, 512), (2, 512, 64), (3, 2048, 256), (1, 4096, 8),
                  (3, 4096, 4), (1, 8, 4096), (1, 1024, 1024)]:
        x = torch.from_numpy(rng.standard_normal(shape)).float()
        results.append(("rfft2d_fused", shape, False,
                        rel(R.rfft2d_fused_cuda(x), R.rfft2d_fused_plain(x))))
        b, h, w = shape
        xf = cplx((b, h, w // 2 + 1))
        results.append(("irfft2d_fused", shape, True,
                        rel(R.irfft2d_fused_cuda(xf),
                            R.irfft2d_fused_plain(xf))))
    # the planned routes: one plane launch (h*w <= 16384; 128^2 in one
    # single-buffered tile), rows then columns above (C = 8 at h = 1024 and
    # 2048, C = 4 at h = 4096, whole images where w < C)
    for shape in [(2, 2, 2), (2, 8, 8), (1, 8, 512), (1, 512, 8),
                  (1, 512, 512), (1, 128, 128), (3, 128, 256),
                  (1, 1024, 64), (1, 2048, 16), (1, 4096, 8), (1, 8, 4096),
                  (2, 4096, 4)]:
        x = cplx(shape)
        for inv in (False, True):
            results.append(("fft2d_gemm", shape, inv,
                            rel(G.fft2d_gemm_cuda(x, inverse=inv),
                                G.fft2d_gemm_plain(x, inverse=inv))))
    # the GEMM transforms in bf16, both variants; the 3-D kernel in fp32
    # and bf16 (dense and four-step axes, unequal factors)
    bf16 = []
    for shape in [(2, 8, 4), (1, 512, 512), (2, 64, 1024), (1, 128, 128),
                  (1, 4096, 8)]:
        x = cplx(shape)
        xb = SplitComplex(x.re.bfloat16(), x.im.bfloat16())
        for variant in ("compensated", "plain"):
            for inv in (False, True):
                bf16.append((f"fft2d_gemm/{variant}", shape, inv, rel(
                    G.fft2d_gemm_cuda(xb, inverse=inv, variant=variant),
                    G.fft2d_gemm_plain(xb, inverse=inv, variant=variant))))
    for shape in [(1, 4, 8, 16), (2, 2, 4, 256), (1, 256, 4, 4),
                  (2, 8, 8, 8), (1, 4, 256, 512), (1, 4, 128, 128)]:
        x = cplx(shape)
        for inv in (False, True):
            results.append(("fft3d_fused", shape, inv,
                            rel(V.fft3d_fused_cuda(x, inverse=inv),
                                V.fft3d_fused_plain(x, inverse=inv))))
            if shape[2] * shape[3] <= 16384:    # the three-launch route too
                results.append(("fft3d_fused planes=False", shape, inv, rel(
                    V._fft3d_cuda(x, inverse=inv, planes=False),
                    V.fft3d_fused_plain(x, inverse=inv))))
        xb = SplitComplex(x.re.bfloat16(), x.im.bfloat16())
        for variant in ("compensated", "plain"):
            bf16.append((f"fft3d_fused/{variant}", shape, False, rel(
                V.fft3d_fused_cuda(xb, variant=variant),
                V.fft3d_fused_plain(xb, variant=variant))))
    # the fused Stockham 2-D kernel's two passes: odd log2 h and w (the
    # radix-2 tail in both), h = 2 and w = 2, whole images a column tile
    # (w < C, several images a tile), 16384-point column tiles (h = 2048,
    # 4096), narrow rows whose tile the plan halves (w = 4 at 4096 rows)
    for shape in [(2, 2, 2), (2, 8, 16), (1, 64, 32), (3, 4, 1024),
                  (1, 256, 256), (1, 4096, 4), (1, 2, 4096), (3, 2, 4096),
                  (2, 32, 8), (1, 128, 512), (1, 1024, 8), (1, 2048, 16),
                  (1, 8, 2048), (2, 2048, 2)]:
        x = cplx(shape)
        for inv in (False, True):
            results.append(("fft2d_fused", shape, inv,
                            rel(S2.fft2d_fused_cuda(x, inverse=inv),
                                S2.fft2d_fused_plain(x, inverse=inv))))
    for name, kern, plain, shapes in [
            # one launch (up to 2^14, odd log2 n, n = 2 and 8, rows a tile
            # ragged at batch 7) and two (2^15 and 2^17: the tail in launch
            # B; 2^16, 2^18; 2^21: 4096-point columns, 1024 threads)
            ("fft_stockham", S.fft_stockham_cuda, S.fft_stockham_plain,
             [(3, 2), (5, 8), (2, 2048), (7, 512), (1, 1 << 13),
              (2, 1 << 14), (3, 1 << 15), (1, 1 << 16), (1, 1 << 17),
              (1, 1 << 18), (1, 1 << 21)]),
            # one launch (up to 2^14, rows a tile ragged at batch 7) and
            # two (2^15, 2^16, and 2^17: an unequal split, 512 x 256)
            ("fft_stockham_r2", S.fft_stockham_r2_cuda,
             S.fft_stockham_r2_plain, [(3, 2), (5, 8), (2, 2048), (7, 512),
                                       (1, 1 << 13), (2, 1 << 14),
                                       (3, 1 << 15), (1, 1 << 16),
                                       (1, 1 << 17)]),
            # one launch (n <= 2^14, ragged row blocks) and two (2^15)
            ("fft_fourstep", F.fft_fourstep_cuda, F.fft_fourstep_plain,
             [(3, 4), (5, 32), (2, 512), (2, 1024), (3, 4096),
              (1, 1 << 14), (2, 1 << 15)]),
            # stage 0 through shared rows (n < 2^10) and 32x32 tiles
            ("fft_staged", ST.fft_staged_cuda, ST.fft_staged_plain,
             [(3, 1), (3, 2), (3, 4), (5, 8), (2, 16), (2, 512), (1, 1024),
              (2, 2048)])]:
        for shape in shapes:
            x = cplx(shape)
            for inv in (False, True):
                results.append((name, shape, inv,
                                rel(kern(x, inverse=inv),
                                    plain(x, inverse=inv))))
    # four-step splits other than the default: n1 > n2 in both routes,
    # factors at the kernel's bounds
    for shape, n1 in [((2, 512), 32), ((1, 1 << 15), 256), ((1, 2048), 2),
                      ((1, 1 << 15), 1024)]:
        x = cplx(shape)
        for inv in (False, True):
            results.append((f"fft_fourstep n1={n1}", shape, inv,
                            rel(F.fft_fourstep_cuda(x, inverse=inv, n1=n1),
                                F.fft_fourstep_plain(x, inverse=inv,
                                                     n1=n1))))
    # the fused conv: shared banks (odd row counts, rows packed per block
    # for small m, a ragged last block) and per-batch banks; m = 32768
    # runs the multi-launch schedule (its 1-D transforms on the emulated
    # four-step kernel through ops, see install; the section kernel)
    for m, lead, klead in [(4, (2, 3), (3,)), (8, (3, 5), (3, 5)),
                           (64, (2, 3), (3,)), (512, (3, 5), (5,)),
                           (512, (2, 3), (2, 3)), (32768, (2, 3), (3,)),
                           (32768, (2, 1), (2, 1))]:
        x = torch.from_numpy(rng.standard_normal(lead + (m,))).float()
        kf = cplx(klead + (m // 2 + 1,))
        ef = C.pack_filter(kf, m, torch.float32)
        results.append(("fftconv_fused", lead + (m,), len(klead) == 1,
                        rel(C.fftconv_fused_cuda(x, ef),
                            C.fftconv_fused_plain(x, ef))))
    # decode attention on both routes (fp32 and mixed dtypes, D not a
    # multiple of 16, D = 8 at a group of 40: the CUDA-core route; bf16 at
    # D = 16..128, groups 1..16: the tensor cores, ragged tiles and splits):
    # a part-filled row (whole splits and tiles skipped), a window, a
    # wrapped ring, a fully masked row (the merge's mean of V)
    cases = [(2, 128, 4, 2, 16, 64, None), (3, 100, 8, 8, 18, 100, 40),
             (2, 200, 12, 1, 80, 200, 50), (2, 512, 40, 1, 8, 512, None),
             (2, 256, 12, 1, 80, 64, None), (2, 300, 8, 2, 80, 300, 64),
             (1, 384, 48, 4, 128, 128, None), (3, 96, 16, 1, 32, 96, None),
             (2, 160, 2, 2, 64, 160, 100)]
    for b, s, h, kvh, d, chunk, window in cases:
        for qt, kt in [(torch.float32, torch.float32),
                       (torch.bfloat16, torch.bfloat16),
                       (torch.bfloat16, torch.float32)]:
            q = torch.from_numpy(rng.standard_normal((b, h, d))).to(qt)
            k, v = (torch.from_numpy(rng.standard_normal((b, s, kvh, d)))
                    .to(kt) for _ in range(2))
            q_pos = torch.from_numpy(rng.integers(s // 2, 3 * s, b)).int()
            slot = torch.arange(s)
            kv_pos = (q_pos[:, None] - (q_pos[:, None] - slot) % s).int()
            kv_pos[0, s // 3:] = -1                 # a part-filled row
            kv_pos[-1] = -1                         # a row with no slot
            got = DA.decode_attention_cuda(q, k, v, kv_pos, q_pos,
                                           window=window, chunk=chunk)
            want = DA.decode_attention_plain(q, k, v, kv_pos, q_pos,
                                             window=window)
            tag = DA.route(qt, kt, d, h // kvh)
            (bf16 if qt == torch.bfloat16 else results).append(
                (f"decode_attention/{tag}", (b, s, h, kvh, d), window,
                 rel(got, want)))
    half = half_routes(rng, cplx)
    results += long_axes(rng, cplx)
    f4 = bf16_planes(rng, cplx)
    f11 = bf16_planes(rng, cplx, torch.float16)
    bf16 += plain_long_axes()
    for r in results + bf16:
        print(*r)
    for r in f4 + f11 + half:
        print(*r)
    worst = max(r[3] for r in results)
    worst_half = max(r[3] for r in half)
    print("worst float16 route", worst_half, "tol", TOL_F16)
    worst_bf16 = max(r[3] for r in bf16)
    f4_ok = all(k <= TOL_BF16_REF and k <= p + TOL_BF16 for *_, k, p in f4)
    print("worst", worst, "tol", TOL)
    print("worst bf16", worst_bf16, "tol", TOL_BF16)
    f11_ok = all(f16_ok(name, k, p) for name, _, _, k, p in f11)
    print("bf16 planes within 6e-2 and the plain version's error + 2^-7:",
          f4_ok)
    print("float16 planes within 1e-3 and the plain version's error + "
          "2^-10:", f11_ok)
    return 0 if (worst <= TOL and worst_bf16 <= TOL_BF16 and f4_ok
                 and f11_ok and worst_half <= TOL_F16) else 1


def half_routes(rng, cplx) -> list:
    """ROADMAP §2e's float16 routes against their plain versions: the
    plain-float16 GEMM chain (2-D and 3-D, both directions) and decode
    attention in float16 (the tensor cores' .f16 form and the CUDA cores),
    whole and as two slot halves' partials merged across "ranks"."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import fft2d_gemm as G
    from repro_torch.kernels import fft3d_fused as V
    out = []
    for shape, kern, plain in (((2, 8, 16), G.fft2d_gemm_cuda,
                                G.fft2d_gemm_plain),
                               ((1, 32, 64), G.fft2d_gemm_cuda,
                                G.fft2d_gemm_plain),
                               ((1, 4, 8, 16), V.fft3d_fused_cuda,
                                V.fft3d_fused_plain)):
        x = cplx(shape)
        xh = SplitComplex(x.re.half(), x.im.half())
        for inv in (False, True):
            out.append((f"{kern.__name__}/plain float16", shape, inv, rel(
                kern(xh, inverse=inv, variant="plain"),
                plain(xh, inverse=inv, variant="plain"))))
    for b, s, h, kvh, d, window in ((2, 128, 4, 2, 16, None),
                                    (3, 100, 8, 8, 18, 40),
                                    (2, 256, 12, 1, 80, None)):
        q = torch.from_numpy(rng.standard_normal((b, h, d))).half()
        k, v = (torch.from_numpy(rng.standard_normal((b, s, kvh, d)))
                .half() for _ in range(2))
        q_pos = torch.from_numpy(rng.integers(s // 2, 3 * s, b)).int()
        slot = torch.arange(s)
        kv_pos = (q_pos[:, None] - (q_pos[:, None] - slot) % s).int()
        kv_pos[-1] = -1                              # a row with no slot
        tag = DA.route(q.dtype, k.dtype, d, h // kvh)
        want = DA.decode_attention_plain(q, k, v, kv_pos, q_pos,
                                         window=window)
        out.append((f"decode_attention/{tag} float16", (b, s, h, kvh, d),
                    window, rel(DA.decode_attention_cuda(
                        q, k, v, kv_pos, q_pos, window=window), want)))
        half = s // 2
        parts = [DA.decode_attention_partial_cuda(
            q, k[:, i * half:(i + 1) * half].contiguous(),
            v[:, i * half:(i + 1) * half].contiguous(),
            kv_pos[:, i * half:(i + 1) * half].contiguous(), q_pos,
            window=window) for i in range(2)]
        merged = DA.decode_attention_merge_cuda(
            *(torch.stack([p[j] for p in parts]) for j in range(4)),
            2 * half, q.dtype)
        want = DA.decode_attention_plain(
            q, k[:, :2 * half], v[:, :2 * half], kv_pos[:, :2 * half],
            q_pos, window=window)
        out.append((f"decode_attention/{tag} float16 partial + merge",
                    (b, s, h, kvh, d), window, rel(merged, want)))
    return out


def long_axes(rng, cplx) -> list:
    """The long-axis routes, scaled down: the 2-D and 3-D kernels' split
    with AXIS_MAX at 16 (three factors past 2^8 with FACTOR_MAX at 16),
    the real-input kernels' split steps at 8192 and 16384 (their packed
    rows need 8192-point tiles), the fused Stockham 2-D kernel's 1-D
    routes at 2^13 .. 2^16 and its three launches with TWO_MAX at 2^16
    (rows and columns of 2^17),
    the four-step kernel's axis route (factors 2 .. 2^14), both Stockham
    kernels' three launches with TWO_MAX at 2^16 (2^17 and 2^18: the
    middle launch on tiles of whole images; 2^22: on column tiles)."""
    from repro_torch.kernels import axis_fft as A
    from repro_torch.kernels import fft2d_gemm as G
    from repro_torch.kernels import fft3d_fused as V
    from repro_torch.kernels import rfft2d_fused as R
    from repro_torch.kernels import fft2d_fused as S2
    from repro_torch.kernels import fft_fourstep as F
    from repro_torch.kernels import fft_stockham as S
    out = []
    limits = A.AXIS_MAX, A.FACTOR_MAX
    A.AXIS_MAX, A.FACTOR_MAX = 16, 16
    A._launch_args.cache_clear()
    try:
        for shape in [(2, 2, 64), (1, 64, 4), (2, 32, 32), (1, 2, 512)]:
            x = cplx(shape)
            for inv in (False, True):
                out.append(("fft2d_gemm split", shape, inv, rel(
                    G.fft2d_gemm_cuda(x, inverse=inv),
                    G.fft2d_gemm_plain(x, inverse=inv))))
        for shape in [(1, 2, 2, 64), (1, 64, 2, 4), (1, 2, 64, 4)]:
            x = cplx(shape)
            out.append(("fft3d_fused split", shape, False, rel(
                V.fft3d_fused_cuda(x), V.fft3d_fused_plain(x))))
    finally:
        A.AXIS_MAX, A.FACTOR_MAX = limits
        A._launch_args.cache_clear()
    for shape in [(1, 2, 8192), (1, 8192, 4), (1, 4, 16384)]:
        x = torch.from_numpy(rng.standard_normal(shape)).float()
        out.append(("rfft2d_fused split", shape, False,
                    rel(R.rfft2d_fused_cuda(x), R.rfft2d_fused_plain(x))))
        b, h, w = shape
        xf = cplx((b, h, w // 2 + 1))
        out.append(("irfft2d_fused split", shape, True,
                    rel(R.irfft2d_fused_cuda(xf), R.irfft2d_fused_plain(xf))))
    for shape in [(1, 2, 8192), (1, 8192, 2), (1, 2, 1 << 15),
                  (1, 1 << 15, 2), (2, 1 << 15, 4)]:
        x = cplx(shape)
        out.append(("fft2d_fused long", shape, True, rel(
            S2.fft2d_fused_cuda(x, inverse=True),
            S2.fft2d_fused_plain(x, inverse=True))))
    S2.TWO_MAX = 1 << 16
    S2._launch_args.cache_clear()
    try:
        for shape in [(1, 2, 1 << 17), (1, 1 << 17, 2)]:
            x = cplx(shape)
            for inv in (False, True):
                out.append(("fft2d_fused three launches", shape, inv, rel(
                    S2.fft2d_fused_cuda(x, inverse=inv),
                    S2.fft2d_fused_plain(x, inverse=inv))))
    finally:
        S2.TWO_MAX = 1 << 24
        S2._launch_args.cache_clear()
    for shape, n1 in [((3, 4096), 2), ((2, 8192), 8192), ((1, 16384), 16384),
                      ((1, 1 << 15), 2), ((2, 4096), 2048)]:
        x = cplx(shape)
        out.append((f"fft_fourstep axis n1={n1}", shape, False, rel(
            F.fft_fourstep_cuda(x, n1=n1), F.fft_fourstep_plain(x, n1=n1))))
    S.TWO_MAX = 1 << 16
    S._launch_args.cache_clear()
    try:
        for shape, dirs in [((2, 1 << 17), (False, True)),
                            ((1, 1 << 18), (False, True)),
                            ((1, 1 << 22), (False,))]:
            x = cplx(shape)
            for name, kern, plain in (
                    ("fft_stockham_r2", S.fft_stockham_r2_cuda,
                     S.fft_stockham_r2_plain),
                    ("fft_stockham", S.fft_stockham_cuda,
                     S.fft_stockham_plain)):
                for inv in dirs:
                    out.append((f"{name} three launches", shape, inv, rel(
                        kern(x, inverse=inv), plain(x, inverse=inv))))
    finally:
        S.TWO_MAX = 1 << 24
        S._launch_args.cache_clear()
    return out


def plain_long_axes(seed: int = 29) -> list:
    """The plain variant's long-axis route in bf16 (two tiled products an
    axis through the scratch pair), its thresholds lowered to 256 points,
    on inputs from its own generator (``seed``): rows of 1024 (32 x 32),
    columns of 512 (16 x 32: one image of 16 columns, 3-D columns of 8)
    and 3-D columns of 512 over 2 columns (the element-wise loads)."""
    from repro_torch.kernels import _build as B
    from repro_torch.kernels import dft_mma as D
    from repro_torch.kernels import fft2d_gemm as G
    from repro_torch.kernels import fft3d_fused as V
    from repro_torch.kernels.rfft2d_fused import fourstep_factors
    rng = np.random.default_rng(seed)
    low = D.Limits(rows_max=256, cols_max=256)
    out = []
    for shape in [(2, 2, 1024), (1, 512, 16), (1, 4, 512, 8),
                  (1, 512, 2, 2)]:
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        x = from_numpy(z, device="cpu")
        xb = SplitComplex(x.re.bfloat16(), x.im.bfloat16())
        name, plain, factors = (
            ("fft2d_gemm", G.fft2d_gemm_plain, fourstep_factors)
            if len(shape) == 3 else
            ("fft3d_fused", V.fft3d_fused_plain, V.fourstep_factors3))
        fn = B.function(name, f"{name}_plain_pass", D.ARGS)
        for inv in (False, True):
            got = SplitComplex(torch.empty_like(xb.re),
                               torch.empty_like(xb.im))
            D.run(fn, shape[1:], factors, xb, got, inv, name, low)
            out.append(("plain long axis", shape, inv, rel(
                got, plain(xb, inverse=inv, variant="plain"))))
    return out


TOL_BF16_REF = 6e-2
TOL_F16_REF = 1e-3
TOL_F16 = 2.0 ** -10


def f16_ok(name, kern_err, plain_err) -> bool:
    """float16 planes: within 1e-3 of max|X| of float64 numpy and within
    the plain version's error + 2^-10; the staged FFT, which rounds every
    stage to float16 as the reference does, within the second only."""
    near_plain = kern_err <= plain_err + TOL_F16
    return near_plain if name == "fft_staged" else \
        near_plain and kern_err <= TOL_F16_REF


def bf16_planes(rng, cplx, dtype=torch.bfloat16) -> list:
    """bf16 planes on the kernels that took float32 only: (name, shape,
    kernel error, plain error), each of max|X| against float64 of the
    bf16-rounded input (the kernel within 6e-2 and within the plain
    version's error + 2^-7).  With ``dtype`` float16 the same kernels and
    the compensated 2-D and 3-D GEMM transforms, in float16 (bounds in
    :func:`f16_ok`)."""
    from repro_torch.kernels import fft_stockham as S
    from repro_torch.kernels import fft_fourstep as F
    from repro_torch.kernels import fft_stage as ST
    from repro_torch.kernels import fft2d_fused as S2
    from repro_torch.kernels import rfft2d_fused as R
    from repro_torch.kernels import fftconv_fused as C
    from repro_torch.kernels import fft2d_gemm as G
    from repro_torch.kernels import fft3d_fused as V
    out = []
    tag = "bf16" if dtype == torch.bfloat16 else "f16"

    def f64(y):
        if isinstance(y, SplitComplex):
            return f64(y.re) + 1j * f64(y.im)
        return y.double().numpy()

    def err(y, want):
        return float(np.abs(f64(y) - want).max() / np.abs(want).max())

    def c2c(name, kern, plain, shape, numpy_fn):
        x = cplx(shape)
        xb = SplitComplex(x.re.to(dtype), x.im.to(dtype))
        want = numpy_fn(f64(xb))
        got = kern(xb)
        assert got.re.dtype == dtype
        out.append((name, shape, tag, err(got, want), err(plain(xb), want)))

    fft1 = np.fft.fft
    for shape in [(4, 256), (3, 2), (1, 1 << 15)]:
        c2c("fft_stockham", S.fft_stockham_cuda, S.fft_stockham_plain,
            shape, fft1)
        c2c("fft_stockham_r2", S.fft_stockham_r2_cuda,
            S.fft_stockham_r2_plain, shape, fft1)
    for shape in [(4, 256), (2, 1 << 15)]:
        c2c("fft_fourstep", F.fft_fourstep_cuda, F.fft_fourstep_plain,
            shape, fft1)
    for shape in [(4, 256), (2, 2048)]:
        c2c("fft_staged", ST.fft_staged_cuda, ST.fft_staged_plain, shape,
            fft1)
    for shape in [(2, 64, 64), (1, 2, 8192)]:
        c2c("fft2d_fused", S2.fft2d_fused_cuda, S2.fft2d_fused_plain, shape,
            np.fft.fft2)
    if dtype == torch.float16:
        for shape in [(2, 64, 64), (1, 512, 512), (2, 8, 4)]:
            c2c("fft2d_gemm/compensated",
                lambda x: G.fft2d_gemm_cuda(x, variant="compensated"),
                lambda x: G.fft2d_gemm_plain(x, variant="compensated"),
                shape, np.fft.fft2)
        for shape in [(1, 4, 8, 16), (1, 4, 256, 512), (2, 8, 8, 8)]:
            c2c("fft3d_fused/compensated",
                lambda x: V.fft3d_fused_cuda(x, variant="compensated"),
                lambda x: V.fft3d_fused_plain(x, variant="compensated"),
                shape, lambda a: np.fft.fftn(a, axes=(1, 2, 3)))
    for shape in [(2, 64, 64), (3, 8, 4), (1, 2, 8192)]:
        x = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
        got = R.rfft2d_fused_cuda(x)
        want = np.fft.rfft2(f64(x))
        out.append(("rfft2d_fused", shape, tag, err(got, want),
                    err(R.rfft2d_fused_plain(x), want)))
        b, h, w = shape
        xf = cplx((b, h, w // 2 + 1))
        xf = SplitComplex(xf.re.to(dtype), xf.im.to(dtype))
        want = np.fft.irfft2(f64(xf), s=(h, w))
        out.append(("irfft2d_fused", shape, tag,
                    err(R.irfft2d_fused_cuda(xf), want),
                    err(R.irfft2d_fused_plain(xf), want)))
    # float16: x at 2^-8 keeps the spectra and the unscaled inverse's
    # partial sums at m = 32768 (its two-launch 1-D transforms store them
    # between launches) under 65504, where the reference overflows too
    amp = 2.0 ** -8 if dtype == torch.float16 else 1.0
    for lead, m in [((2, 3), 64), ((1, 2), 4096), ((2, 1), 32768)]:
        x = torch.from_numpy(amp * rng.standard_normal(lead + (m,))).to(dtype)
        kz = rng.standard_normal((lead[-1], m // 2 + 1)) \
            + 1j * rng.standard_normal((lead[-1], m // 2 + 1))
        kz[:, 0], kz[:, -1] = kz[:, 0].real, kz[:, -1].real
        ef = C.pack_filter(from_numpy(kz, device="cpu"), m, dtype)
        want = np.fft.irfft(np.fft.rfft(f64(x)) * kz, m)
        out.append(("fftconv_fused", lead + (m,), tag,
                    err(C.fftconv_fused_cuda(x, ef), want),
                    err(C.fftconv_fused_plain(x, ef), want)))
    return out


if __name__ == "__main__":
    sys.exit(main())
