"""Helpers that the emulated kernel tests share: a module fixture that
builds sources under ``tools/cuda_emu/emulate.py``, seeded complex planes,
the error against max|plain|, and the plain bf16/float16 route's long-axis
check that the ``test_torch_gemm_tc_long*.py`` files run, one file a shape
group (each case takes 1-3 minutes emulated, so that ``--dist loadfile``
puts the groups on different workers)."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import SplitComplex, from_numpy
from repro_torch.kernels import _build, dft_mma as D
from repro_torch.kernels import fft2d_gemm as G
from repro_torch.kernels import fft3d_fused as V
from repro_torch.kernels.rfft2d_fused import fourstep_factors

ROOT = Path(__file__).resolve().parents[1]
TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def emulated_fixture(*names: str, reset=None):
    """A module fixture: the sources ``names`` built once with g++ under
    the CUDA stand-in, and ``_build`` routed to them for the module's
    tests; ``reset`` (a cache's ``cache_clear``, say) runs before and
    after them."""
    @pytest.fixture(scope="module")
    def emulated(tmp_path_factory):
        spec = importlib.util.spec_from_file_location(
            "cuda_emu_emulate_" + "_".join(names),
            ROOT / "tools" / "cuda_emu" / "emulate.py")
        emu = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(emu)
        emu.build(names, tmp_path_factory.mktemp("cuda_emu"))
        mp = pytest.MonkeyPatch()
        for fn in ("function", "check_operands", "launch", "launch_all"):
            mp.setattr(_build, fn, getattr(emu, f"_{fn}"))
        mp.setattr(_build, "sm_count", lambda device: 2)   # blocks walk
        if reset is not None:
            reset()
        yield emu
        mp.undo()
        if reset is not None:
            reset()
    return emulated


def planes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    x = from_numpy(z, device="cpu")
    return SplitComplex(x.re.to(dtype), x.im.to(dtype))


def rel(got, want) -> float:
    d = max((a.float() - b.float()).abs().max().item()
            for a, b in zip(got, want))
    return d / max(b.float().abs().max().item() for b in want)


def long_axis_route(shape, dtype) -> None:
    """The long-axis products with the thresholds lowered to 256, both
    directions, against the plain version within ``TOL`` of max|plain|."""
    low = D.Limits(rows_max=256, cols_max=256)
    name, plain, factors = (
        ("fft2d_gemm", G.fft2d_gemm_plain, fourstep_factors)
        if len(shape) == 3 else
        ("fft3d_fused", V.fft3d_fused_plain, V.fourstep_factors3))
    plan, _ = D.prepare(shape[0], shape[1:], factors, low)
    assert any(lp.route == "long2" for lp in plan)
    fn = _build.function(name, f"{name}_plain_pass", D.ARGS)
    x = planes(shape, dtype, sum(shape))
    for inverse in (False, True):
        got = SplitComplex(torch.empty_like(x.re), torch.empty_like(x.im))
        D.run(fn, shape[1:], factors, x, got, inverse, name, low)
        want = plain(x, inverse=inverse, variant="plain")
        assert rel(got, want) <= TOL[dtype], (shape, dtype, inverse)
