"""Build ``csrc/*.cu`` with nvcc into shared libraries and load them with
ctypes.

Each source becomes its own library (``<name>-<hash>.so``) under
``build/repro_torch_kernels/`` at the repository root.  The hash covers
the source, every header in ``csrc/`` and the compiler flags, so an edited
source is rebuilt and a stale library is never loaded.  A library is built
at first use, once per process; :func:`build_all` builds every source in
parallel (one nvcc process each).  A finished build is moved into place
with an atomic rename, so concurrent processes never see a partial file
and no lock file can be left behind.

Every C entry point returns ``cudaGetLastError()`` of its launches;
:func:`launch` calls it on the operands' device and stream and raises on a
non-zero code, and :func:`check_operands` (the FFT kernels) and
:func:`check_decode_operands` (decode attention) are what the wrappers
require of their data before passing pointers.  Nothing here falls back: a
missing nvcc, a failed build or a failed launch raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.core.complexmath import SplitComplex

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# --split-compile=0: cicc runs its optimisation passes on every host core.
# The nine sources then build in 134 s in place of ~212 s (H100 host, 8
# cores, nvcc 12.9), and ptxas gives 1756 of the 1760 kernels the same
# registers and stack (the other four: 88 in place of 96 stack bytes).
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--split-compile=0", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")
SOURCES = ("fft_stockham", "fft_fourstep", "fft2d_gemm", "rfft2d_fused",
           "fftconv_fused", "fft3d_fused", "fft2d_fused", "fft_stage",
           "decode_attention")

_LOCK = threading.Lock()
_LIBS: dict = {}
# C entry points that returned success from :func:`launch_all`, by symbol
# (``ops.reset_launches`` sets them to 0 with the wrappers' counts): one
# grid launch each for the planned passes (``*_pass``) and the plain
# route's (``*_plain_pass``)
CALLS: collections.Counter = collections.Counter()


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(path).exists():
        raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc "
                               "on PATH); the CUDA kernels cannot be built")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is current; returns
    (final path, temp path, process) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    cmd = [nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, job) -> None:
    out, tmp, proc = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict:
    """Build every listed source in parallel and load the libraries;
    returns {name: compiler log or '' when the library was current}."""
    with _LOCK:
        jobs = {n: _start(n) for n in names if n not in _LIBS}
        logs = {}
        try:
            for n, job in jobs.items():
                if job is not None:
                    _finish(n, job)
        finally:
            for job in jobs.values():      # stop any nvcc still running
                if job is not None and job[2].poll() is None:
                    job[2].kill()
                    job[2].wait()
        for n in jobs:
            path = library_path(n)
            log = path.with_suffix(".log")
            logs[n] = log.read_text() if jobs[n] is not None else ""
            _LIBS[n] = ctypes.CDLL(str(path))
    return logs


def function(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of library ``name`` (built on first
    use), with explicit argtypes and an int return code."""
    if name not in _LIBS:
        build_all((name,))
    fn = getattr(_LIBS[name], symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


FFT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_STORE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def store_code(dtype: torch.dtype) -> int:
    """The C entry points' ``store`` argument: 0 float32, 1 bfloat16 (raw
    16 bits, ``csrc/bf16.cuh``), 2 float16 (``csrc/f16.cuh``)."""
    return _STORE[dtype]


def refuse_dtensor(*operands) -> None:
    """A DTensor's ``data_ptr`` is not its shard's data, so a kernel
    handed one would read the wrong memory: run the kernel on local
    shards (``torch.distributed.tensor.experimental.local_map``, or
    ``to_local()``) instead."""
    from torch.distributed.tensor import DTensor
    for x in operands:
        planes = tuple(x) if isinstance(x, SplitComplex) else (x,)
        if any(isinstance(t, DTensor) for t in planes):
            raise TypeError("a CUDA kernel got a DTensor; call it on the "
                            "local shards under torch.distributed.tensor."
                            "experimental.local_map (or on to_local())")


def check_operands(x, ndim: int, dtypes=(torch.float32,)) -> None:
    """What every CUDA wrapper requires of its data operand, a
    :class:`SplitComplex` or one real tensor: a plain CUDA tensor (no
    DTensor), one of ``dtypes`` (:data:`FFT_DTYPES` for the FFT kernels),
    ``ndim`` dims, contiguous."""
    refuse_dtensor(x)
    planes = tuple(x) if isinstance(x, SplitComplex) else (x,)
    for t in planes:
        if not t.is_cuda:
            raise ValueError("the CUDA kernel needs CUDA tensors")
        if t.dtype not in dtypes:
            raise TypeError(f"the CUDA kernel takes {_dtype_name(dtypes)}, "
                            f"got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"expected {ndim}-D planes, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels need contiguous planes")
    if len(planes) == 2 and (x.re.shape != x.im.shape
                             or x.re.device != x.im.device
                             or x.re.dtype != x.im.dtype):
        raise ValueError("re and im planes differ in shape, device or dtype")


def _dtype_name(dtypes) -> str:
    return " or ".join(str(d).replace("torch.", "") for d in dtypes)


def check_decode_operands(q, k, v, kv_pos, q_pos) -> None:
    """What the decode attention kernel requires: q (B, H, D) and the
    caches (B, S, KV, D) float32, bfloat16 or float16 (the caches one
    dtype), with H a multiple of KV; kv_pos (B, S) and q_pos (B,) int32;
    every operand contiguous on q's CUDA device, none a DTensor."""
    refuse_dtensor(q, k, v, kv_pos, q_pos)
    ops = {"q": q, "k_cache": k, "v_cache": v, "kv_pos": kv_pos,
           "q_pos": q_pos}
    for name, t in ops.items():
        want = (torch.int32,) if name.endswith("pos") else FFT_DTYPES
        if t.dtype not in want:
            raise TypeError(f"the decode kernel takes {name} as "
                            f"{_dtype_name(want)}, got {t.dtype}")
    for name, t in ops.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"the decode kernel needs every operand on "
                             f"q's CUDA device; {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"the decode kernel needs a contiguous {name}")
    if k.dtype != v.dtype:
        raise TypeError(f"k_cache and v_cache differ in dtype: {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, H, D) and equal caches "
                         f"(B, S, KV, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or not k.shape[2] \
            or h % k.shape[2]:
        raise ValueError(f"caches {tuple(k.shape)} do not serve q "
                         f"{tuple(q.shape)} (H a multiple of KV)")
    if kv_pos.shape != k.shape[:2] or q_pos.shape != (b,):
        raise ValueError(f"expected kv_pos {tuple(k.shape[:2])} and q_pos "
                         f"({b},), got {tuple(kv_pos.shape)}, "
                         f"{tuple(q_pos.shape)}")


def check_merge_operands(m, l, acc, vsum) -> None:
    """What the decode kernel's cross-rank merge requires: the ranks'
    gathered partials m, l (R, B, KV, G), acc (R, B, KV, G, D) and vsum
    (R, B, KV, D), fp32 on one CUDA device, none a DTensor."""
    refuse_dtensor(m, l, acc, vsum)
    r, b, kv, g = m.shape
    d = acc.shape[-1]
    if l.shape != m.shape or acc.shape != (r, b, kv, g, d) or \
            vsum.shape != (r, b, kv, d):
        raise ValueError(f"partials do not match: m {tuple(m.shape)}, l "
                         f"{tuple(l.shape)}, acc {tuple(acc.shape)}, vsum "
                         f"{tuple(vsum.shape)}")
    if any(t.dtype != torch.float32 or not t.is_cuda or t.device != m.device
           for t in (m, l, acc, vsum)):
        raise TypeError("the merge takes fp32 partials on one CUDA device")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of ``device``'s card (the persistent
    grids' size)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelLaunchError(f"{what} failed with CUDA error {code}")


def launch(fn, args: list, what: str, device: torch.device) -> None:
    """Call the C entry point ``fn`` with ``device`` made the current
    device and its current stream as the last argument; raise on error."""
    launch_all(fn, [args], what, device)


def launch_all(fn, arg_lists: list, what: str, device: torch.device) -> None:
    """:func:`launch` for each argument list in turn, raising at the first
    error, with one switch to ``device``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for args in arg_lists:
            check(fn(*args, stream), what)
            CALLS[fn.__name__] += 1


P = ctypes.c_void_p          # pointers and the stream
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
