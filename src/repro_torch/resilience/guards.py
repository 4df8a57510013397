"""Cheap numerical integrity checks for FFT executions (counterpart of
:mod:`repro.resilience.guards`).

Three guards, ordered by cost:

- :func:`finite_check`: NaN/Inf scan over every output plane, the whole of
  ``guard_level="basic"``.  One max-abs reduction a plane (the inf-norm:
  NaN propagates through it, an infinity is its own maximum, and a
  maximum cannot overflow) and one host sync for all of them: the scan
  sits on the hot path of every kernel execution.  On the H100 it is the
  fastest of the scans ``chip_smoke.py``'s ``resilience_path`` times
  (min/max, ``isfinite``, float64 and float32 sums).
- :func:`parseval_ratio`: Parseval's theorem as a checksum: the output
  spectrum's energy must equal ``N x`` the input energy (direction- and
  kind-aware).  Catches corruption that stays finite (a scaled block, a
  zeroed payload) for two extra reductions.
- :func:`hermitian_residual`: rfft outputs only: the DC/Nyquist bins of a
  real transform are exactly real (1-D), and the DC/Nyquist *columns* of a
  2-D half spectrum are Hermitian along the column axis.

All guards read values, so each costs a host sync.  Tolerances come from
:mod:`repro_torch.resilience.config` (fp32 vs low-precision dtypes).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.complexmath import SplitComplex
from . import config

_EPS = 1e-30


class GuardViolation(RuntimeError):
    """An execution produced output that failed an integrity check."""

    def __init__(self, report: "GuardReport"):
        self.report = report
        super().__init__(f"guard violation: {report.reason} "
                         f"(checks: {report.checks})")


@dataclasses.dataclass
class GuardReport:
    ok: bool
    checks: dict                    # name -> measured value
    reason: Optional[str] = None    # first failing check, None when ok


def _planes(y):
    if isinstance(y, SplitComplex):
        return (y.re, y.im)
    return (y,)


def _energy(y) -> torch.Tensor:
    """Sum of squared magnitudes over every plane, accumulated in fp32."""
    return sum(torch.sum(torch.square(p.float())) for p in _planes(y))


def _half_axis_energy(y: SplitComplex) -> torch.Tensor:
    """Full-spectrum energy recovered from a half spectrum whose *last*
    axis holds bins 0..n/2: interior bins count twice (their Hermitian
    mirrors), DC and Nyquist once."""
    full = 2.0 * _energy(y)
    ends = (_energy(SplitComplex(y.re[..., 0], y.im[..., 0]))
            + _energy(SplitComplex(y.re[..., -1], y.im[..., -1])))
    return full - ends


def finite_check(y) -> bool:
    ends = [torch.linalg.vector_norm(p, ord=float("inf"))
            for p in _planes(y) if p.numel()]
    return not ends or bool(torch.isfinite(functools.reduce(torch.maximum,
                                                            ends)))


def parseval_ratio(plan, x, y) -> float:
    """Energy ratio (expected 1.0) between output and input of one plan
    execution, with the transform's 1/N scalings folded in.  Returns 1.0
    when the input energy is ~0 (nothing to compare against).  conv-kind
    plans have no input->output energy identity (the filter reshapes the
    spectrum arbitrarily), so the check is vacuously 1.0 for them: conv
    executions are covered by the finite scan."""
    if plan.kind.startswith("conv"):
        return 1.0
    n = 1
    for d in plan.shape:
        n *= int(d)
    if plan.kind == "rfft":
        if plan.inverse:     # half spectrum in -> real out
            e_in, e_out = _half_axis_energy(x), _energy(y) * n
        else:                # real in -> half spectrum out
            e_in, e_out = _energy(x) * n, _half_axis_energy(y)
    elif plan.inverse:       # c2c inverse carries the 1/N scaling
        e_in, e_out = _energy(x), _energy(y) * n
    else:
        e_in, e_out = _energy(x) * n, _energy(y)
    e_in, e_out = float(e_in), float(e_out)
    if e_in < _EPS:
        return 1.0
    return e_out / e_in


def hermitian_residual(plan, y) -> float:
    """rfft *forward* outputs: relative residual of the real-transform
    symmetry constraints (0.0 = exactly symmetric).  Returns 0.0 for plans
    the check does not apply to."""
    if plan.kind != "rfft" or plan.inverse:
        return 0.0
    scale = max(float(p.abs().max()) for p in _planes(y))
    if scale < _EPS:
        return 0.0
    if plan.ndim == 1:       # DC and Nyquist bins are exactly real
        res = torch.maximum(y.im[..., 0].abs().max(),
                            y.im[..., -1].abs().max())
        return float(res) / scale
    # 2-D (..., h, w/2+1): the DC (c=0) and Nyquist (c=-1) columns are the
    # rffts of real column signals -> Hermitian along the h axis
    h = y.shape[-2]
    idx = (-torch.arange(h, device=y.re.device)) % h
    res = 0.0
    for c in (0, -1):
        cr, ci = y.re[..., :, c], y.im[..., :, c]
        res = max(res,
                  float((cr - cr.index_select(-1, idx)).abs().max()),
                  float((ci + ci.index_select(-1, idx)).abs().max()))
    return res / scale


def _is_lowp(dtype) -> bool:
    if not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, str(dtype))
    return dtype.itemsize < 4


def check_output(plan, x, y, level: Optional[str] = None) -> GuardReport:
    """Run the guard stack for one execution of ``plan`` on input ``x``
    producing ``y``.  ``level`` defaults to the configured
    ``guard_level``."""
    level = level if level is not None else config.get("guard_level")
    if level == "off":
        return GuardReport(ok=True, checks={})
    with torch.no_grad():               # checks, not part of any graph
        return _check(plan, x, y, level)


def _check(plan, x, y, level: str) -> GuardReport:
    checks: dict = {}
    finite = finite_check(y)
    checks["finite"] = finite
    if not finite:
        return GuardReport(ok=False, checks=checks,
                           reason="non-finite output (NaN/Inf scan)")
    if level == "basic":
        return GuardReport(ok=True, checks=checks)
    tol = config.get("parseval_tol_lowp") if _is_lowp(plan.dtype) \
        else config.get("parseval_tol")
    ratio = parseval_ratio(plan, x, y)
    checks["parseval_ratio"] = ratio
    if abs(ratio - 1.0) > tol:
        return GuardReport(ok=False, checks=checks,
                           reason=f"Parseval energy ratio {ratio:.6g} "
                                  f"outside 1±{tol:g}")
    herm = hermitian_residual(plan, y)
    checks["hermitian_residual"] = herm
    htol = config.get("hermitian_tol_lowp") if _is_lowp(plan.dtype) \
        else config.get("hermitian_tol")
    if herm > htol:
        return GuardReport(ok=False, checks=checks,
                           reason=f"Hermitian residual {herm:.6g} > {htol:g}")
    return GuardReport(ok=True, checks=checks)
