"""Read the float16 fused conv's error at 2 x 1 x 32768 over several seeds.

    PYTHONPATH=src python3 tools/fftconv_f16_seeds.py [--seeds N] [--card]

The case of ``tools/cuda_emu/emulate.py``'s float16 planes (x at 2^-8
times a standard normal, a random complex filter spectrum with real ends),
drawn from ``numpy.random.default_rng(seed)`` for seeds 0 .. N-1 (default
8).  Without ``--card`` the kernel runs under the emulator on the CPU
(``fftconv_fused.cu`` and ``fft_fourstep.cu``, whose kernel takes the
schedule's 1-D transforms, are built into ``build/fftconv_f16_seeds/``);
with it, on the card.  Prints one JSON line a seed: the kernel's and the plain
version's error against float64 numpy of the float16-rounded input, each
over max|want|, beside the emulator's bound of 1e-3; then, on the card,
the nvidia-smi name and power limit.
"""
import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import from_numpy  # noqa: E402
from repro_torch.kernels import fftconv_fused as C  # noqa: E402

SHAPE = (2, 1, 32768)
BOUND = 1e-3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--card", action="store_true")
    a = ap.parse_args()
    dev = "cuda" if a.card else "cpu"
    if not a.card:
        spec = importlib.util.spec_from_file_location(
            "cuda_emu_emulate", ROOT / "tools" / "cuda_emu" / "emulate.py")
        emu = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(emu)
        emu.build(("fftconv_fused", "fft_fourstep"),
                  ROOT / "build" / "fftconv_f16_seeds")
        emu.install()
    lead, m = SHAPE[:2], SHAPE[2]
    for seed in range(a.seeds):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(2.0 ** -8 * rng.standard_normal(SHAPE)).half()
        kz = rng.standard_normal((lead[-1], m // 2 + 1)) \
            + 1j * rng.standard_normal((lead[-1], m // 2 + 1))
        kz[:, 0], kz[:, -1] = kz[:, 0].real, kz[:, -1].real
        ef = C.pack_filter(from_numpy(kz, device=dev), m, torch.float16)
        want = np.fft.irfft(np.fft.rfft(x.double().numpy()) * kz, m)
        scale = np.abs(want).max()
        xd = x.to(dev)
        got = C.fftconv_fused_cuda(xd, ef).double().cpu().numpy()
        plain = C.fftconv_fused_plain(xd, ef).double().cpu().numpy()
        print(json.dumps({
            "seed": seed, "shape": SHAPE, "device": dev,
            "kernel_err_over_max": float(np.abs(got - want).max() / scale),
            "plain_err_over_max": float(np.abs(plain - want).max() / scale),
            "bound": BOUND}), flush=True)
    if a.card:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
