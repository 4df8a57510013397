"""The port's examples (``examples/torch_*.py``) run on the CPU at smoke
sizes through their ``main(argv)``; where the reference example prints an
error against numpy, the port's is held to the reference's bound for that
transform (ROADMAP's parity rules, ``PERF.md`` §2): of max|X|, 5e-5 for a
1-D FFT, 1e-5 for a 2-D (or 3-D) FFT and a convolution, 1e-4 for a round
trip."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import torch_audio_frontend  # noqa: E402
import torch_distributed_fft  # noqa: E402
import torch_quickstart  # noqa: E402
import torch_serve_batched  # noqa: E402
import torch_train_lm  # noqa: E402

TOL_1D, TOL_2D, TOL_ROUNDTRIP = 5e-5, 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_errors_within_the_reference_bounds(capsys):
    errs = torch_quickstart.main(["--device", "cpu"])
    assert "2-D fft 256x256" in capsys.readouterr().out
    for name, err in errs.items():
        tol = TOL_2D if name in ("fft2", "fft_conv") else TOL_1D
        assert err <= tol, (name, err)
    assert set(errs) >= {"fft_auto", "fft_cooley_tukey", "fft_stockham",
                         "fft_four_step", "rfft", "fft2", "fft_conv",
                         "stockham_kernel"}


@pytest.mark.parametrize("algo", ["auto", "stockham2"])
def test_audio_frontend_spectrogram(algo):
    got = torch_audio_frontend.main(["--device", "cpu", "--algo", algo])
    assert got["shape"] == (97, 257)
    assert abs(got["dominant_hz"] - 440) < 16000 / 512
    assert got["first_frame_rel_err"] <= TOL_1D


def test_serve_batched_completes_every_request(capsys):
    got = torch_serve_batched.main(["--device", "cpu", "--requests", "24"])
    assert got["completed"] == 24 and not got["degraded"]
    assert got["totals"]["fallback_served"] == 0
    assert "[serve] totals:" in capsys.readouterr().out


@pytest.mark.parametrize("ssm", [False, True])
def test_train_lm_takes_steps(ssm, tmp_path, capsys):
    torch_train_lm.main((["--ssm"] if ssm else []) + [
        "--device", "cpu", "--steps", "2", "--seq-len", "32",
        "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "0",
        "--log-every", "1"])
    out = capsys.readouterr().out
    assert ("ssm_demo" in out) == ssm and ("fnet_demo" in out) != ssm
    assert "[train] done" in out


def test_distributed_fft_on_local_ranks():
    got = torch_distributed_fft.main(["--device", "cpu", "--ranks", "4",
                                      "--size", "64"])
    errs = got["errors"]
    for name in ("pfft2", "pfft2_chunks4", "pfft2_hierarchical", "pfft3"):
        assert errs[name] <= TOL_2D, (name, errs[name])
    assert errs["pfft1d_roundtrip"] <= TOL_ROUNDTRIP
