"""Split the Stockham kernels' three-launch time on the card into the
twiddle gathers and the rest.

    python3 tools/stockham_variants.py

Builds ``src/repro_torch/kernels/csrc/fft_stockham.cu`` twice (one nvcc a
variant, in parallel, into ``build/stockham_variants/``): as it is
("whole"), and with every twiddle of the fused launches read at entry 0
of the table ("no_gather": ``TwiddleOf::at`` returns 0, so each twiddle
load hits one cached entry, and the arithmetic is unchanged), and prints
one JSON line a variant and radix: the ms of one call at 1 x 2^25 and
each grid launch's device us (CUDA events around each launch, the median
of 10 calls, ``tools/stockham_long.py``'s ``launches_us``), the whole
variant's error against float64 numpy; then the card's nvidia-smi name
and power limit.  "no_gather" computes nothing meaningful: it bounds
what the launches cost without the table's scattered reads.
"""
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fft_stockham as S  # noqa: E402

OUT = ROOT / "build" / "stockham_variants"
AT = ("    return ((I)(((q0 + (qb ? t : 0)) & qm) >> lin) + ((I)p << qb)) "
      "<< (s + s0);")
VARIANTS = {"whole": None, "no_gather": "    return 0;"}
N = 1 << 25


def _long():
    spec = importlib.util.spec_from_file_location(
        "stockham_long", ROOT / "tools" / "stockham_long.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build() -> dict:
    """One nvcc a variant, all started together; {variant: library}."""
    procs = {}
    for name, body in VARIANTS.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(_build.CSRC, d)
        if body is not None:
            head = (d / "stockham.cuh").read_text()
            assert AT in head, "TwiddleOf::at changed: update the tool"
            (d / "stockham.cuh").write_text(head.replace(AT, body))
        lib = d / "libfft_stockham.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-I", str(d), "-o", str(lib),
             str(d / "fft_stockham.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    libs = build()
    L = _long()
    real = _build.function
    z = L.rand((1, N), 25)
    x = L.on_card(z)
    want = np.fft.fft(L.host(x))
    for name, lib in libs.items():
        def function(source, symbol, argtypes, lib=lib):
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            return fn
        _build.function = function
        for radix in (4, 2):
            kern = L.KERNELS[radix][0]
            rec = {"variant": name, "radix": radix, "shape": [1, N],
                   "split": S.split3(N, radix),
                   "kernel_ms": L.ms(lambda: kern(x)),
                   "launch_us": L.launches_us(lambda: kern(x))}
            if name == "whole":
                rec["err_over_max"] = L.err(kern(x), want)
            print(json.dumps(rec), flush=True)
        _build.function = real
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
