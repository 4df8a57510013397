"""End-to-end training driver example on the PyTorch port (counterpart of
``examples/train_lm.py``): a small FNet-style LM (the paper's FFT as the
token mixer) trained for a few hundred steps, with checkpointing and
resume.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] \\
        [--device cuda|cpu]

``--ssm`` swaps in the small Mamba2 config whose causal-conv branch runs
through the fused spectral-convolution plan (``ssm_demo``:
``use_fft_conv=True``, ``fft_backend="cuda"``: the conv kernel on the
card); pair it with ``--fft-backend torch`` for a tokens/sec A/B of the
conv backends.  Any other flag goes to the launcher this drives, the one
a cluster run uses:

    python -m repro_torch.launch.train --arch fnet_demo --steps 200 ...
"""
import sys

from repro_torch.launch import train as train_mod


def main(argv=None) -> None:
    extra = list(sys.argv[1:] if argv is None else argv)
    if "--ssm" in extra:
        extra = [a for a in extra if a != "--ssm"]
        base = ["--arch", "ssm_demo", "--reduced",
                "--steps", "60", "--seq-len", "128", "--global-batch", "8",
                "--lr", "3e-3", "--ckpt-dir", "runs/ckpt_example_ssm",
                "--ckpt-every", "0", "--log-every", "20"]
    else:
        base = ["--arch", "fnet_demo", "--reduced",
                "--steps", "200", "--seq-len", "128", "--global-batch", "8",
                "--lr", "3e-3", "--ckpt-dir", "runs/ckpt_example",
                "--ckpt-every", "100", "--log-every", "20"]
    # later flags win: the caller's override the example's
    train_mod.main(base + extra)


if __name__ == "__main__":
    main()
