"""STFT audio frontend on the PyTorch port (counterpart of
``examples/audio_frontend.py``): the frame features a waveform frontend
computes for the hubert-xlarge stub, each frame's real FFT through the
plan registry.

    PYTHONPATH=src python examples/torch_audio_frontend.py \\
        [--backend cuda|torch] [--algo auto|stockham2] [--device cuda|cpu]

``--backend cuda`` (the default) asks for the kernel route of the
(frame,) rfft key: on the card the real-input route's kernels, on the
CPU their plain versions (``--algo stockham2`` puts the frames on the
radix-2 Stockham kernel; ``auto`` demotes at this frame, see
:func:`stft`).
"""
import argparse

import numpy as np
import torch

import repro_torch.core as rc


def stft(wave: torch.Tensor, frame: int = 512, hop: int = 160,
         backend: str = "cuda", algo: str = "auto") -> torch.Tensor:
    """Frames (..., T) -> magnitude spectrogram (..., n_frames,
    frame//2+1).  At a 512-sample frame ``algo="auto"`` resolves the
    inner 256-point transform to the dense DFT, which has no kernel and
    demotes to torch with the registry's reason, as the reference's does;
    ``algo="stockham2"`` runs the frames on the radix-2 Stockham
    kernel."""
    t = wave.shape[-1]
    n_frames = 1 + (t - frame) // hop
    idx = torch.arange(frame, device=wave.device)[None, :] + \
        hop * torch.arange(n_frames, device=wave.device)[:, None]
    frames = wave[..., idx]                                # gather windows
    window = torch.from_numpy(np.hanning(frame)).to(wave.device,
                                                    torch.float32)
    spec = rc.rfft(frames * window, algo=algo, backend=backend)
    return torch.sqrt(spec.re ** 2 + spec.im ** 2)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--algo", default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    sr = 16_000
    t = np.arange(sr, dtype=np.float32) / sr
    wave = (np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 1320 * t)
            + 0.1 * rng.standard_normal(sr).astype(np.float32))
    mag = stft(torch.from_numpy(wave).to(args.device), backend=args.backend,
               algo=args.algo)
    print(f"waveform {wave.shape} -> spectrogram {tuple(mag.shape)}")
    peaks = torch.argmax(mag, dim=-1).cpu().numpy()
    dominant = float(np.median(peaks) * sr / 512)
    print(f"dominant bin ~{dominant:.0f} Hz (expected 440 Hz)")
    ref = np.abs(np.fft.rfft(wave[:512] * np.hanning(512)))
    err = float(np.abs(mag[0].cpu().numpy() - ref).max() / ref.max())
    print(f"first-frame vs numpy rel err: {err:.2e}")
    # these (n_frames, 257) features are the `embeds` input the
    # hubert-xlarge config consumes (after a linear projection to d_model)
    return {"shape": tuple(mag.shape), "dominant_hz": dominant,
            "first_frame_rel_err": err}


if __name__ == "__main__":
    main()
