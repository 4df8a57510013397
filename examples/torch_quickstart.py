"""Quickstart: the PyTorch port's public FFT API (counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]

Every transform asks for the kernel backend (``backend="cuda"``): on the
card the plans resolve to the hand-written kernels (the 1-D four-step
kernel at n = 4096, the 2-D GEMM kernel for the image, the radix-4
Stockham kernel through ``kernels.ops``); on the CPU each kernel wrapper
runs its plain version.  ``main`` returns each error against numpy over
the reference's max|X|.
"""
import argparse

import numpy as np
import torch

import repro_torch.core as rc
from repro_torch.kernels import ops


def _err(got, ref) -> float:
    got = rc.to_complex(got) if isinstance(got, rc.SplitComplex) else got
    got = got.detach().cpu().numpy()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    rng = np.random.default_rng(0)
    errs = {}

    # --- 1-D FFT, algorithm auto-selected (four-step at this size)
    x = rng.standard_normal(4096).astype(np.float32)
    z = rc.from_real(torch.from_numpy(x).to(dev))
    plan = rc.get_plan((4096,), backend="cuda")
    errs["fft_auto"] = _err(plan(z), np.fft.fft(x))
    print(f"1-D fft (auto, {plan.algo})  rel err vs numpy: "
          f"{errs['fft_auto']:.2e}")

    # --- pick algorithms explicitly: the paper's ladder (torch twins)
    for algo in ("cooley_tukey", "cooley_tukey_fused", "stockham",
                 "four_step"):
        errs[f"fft_{algo}"] = _err(rc.fft(z, algo=algo), np.fft.fft(x))
        print(f"1-D fft ({algo:20s}) rel err: {errs[f'fft_{algo}']:.2e}")

    # --- real-input transforms (half spectrum)
    xf = rc.rfft(torch.from_numpy(x).to(dev), backend="cuda")
    errs["rfft"] = _err(xf, np.fft.rfft(x))
    print(f"rfft output bins: {xf.re.shape[-1]} (= n/2+1), rel err "
          f"{errs['rfft']:.2e}")

    # --- 2-D FFT (the paper's Section 5 workload)
    img = rng.standard_normal((256, 256)).astype(np.float32)
    f2 = rc.fft2(rc.from_real(torch.from_numpy(img).to(dev)),
                 backend="cuda")
    errs["fft2"] = _err(f2, np.fft.fft2(img))
    print(f"2-D fft 256x256           rel err: {errs['fft2']:.2e}")

    # --- FFT long convolution (the LM integration point)
    sig = rng.standard_normal((2, 512)).astype(np.float32)
    ker = rng.standard_normal((2, 64)).astype(np.float32)
    y = rc.fft_conv(torch.from_numpy(sig).to(dev),
                    torch.from_numpy(ker).to(dev), backend="cuda")
    ref = np.stack([np.convolve(s, k)[:512] for s, k in zip(sig, ker)])
    errs["fft_conv"] = _err(y, ref)
    print(f"fft_conv causal           rel err: {errs['fft_conv']:.2e}")

    # --- a kernel wrapper called directly
    zz = rc.SplitComplex(
        torch.from_numpy(rng.standard_normal((4, 1024))).to(dev,
                                                            torch.float32),
        torch.zeros((4, 1024), device=dev))
    errs["stockham_kernel"] = _err(ops.fft_stockham(zz),
                                   np.fft.fft(zz.re.cpu().numpy()))
    print(f"stockham kernel           rel err: "
          f"{errs['stockham_kernel']:.2e}")
    return errs


if __name__ == "__main__":
    main()
