"""Resilience knobs: one process-wide settings dict, overridable per test
(counterpart of :mod:`repro.resilience.config`).

Everything in :mod:`repro_torch.resilience` reads its tunables from here so
a single ``configure(...)`` call (or the :func:`overrides` context manager
in tests) changes the behaviour of the guarded executor, the circuit
breaker and the autotune watchdog coherently.

Knobs
-----
enabled              master switch for the guarded executor; ``False``
                     restores the raw execution path.
guard_level          "off" | "basic" | "full".  "basic" is the default and
                     runs only the NaN/Inf scan on kernel-backed
                     executions; "full" adds the Parseval energy-ratio and
                     Hermitian-symmetry checks.
guard_torch          also guard ``backend="torch"`` executions (default
                     off: the plain path has no launch failure mode and the
                     scan would tax every eager call).  The reference's
                     ``guard_jnp``.
failure_threshold    consecutive guarded failures of a cuda key before its
                     circuit opens.
cooldown_calls       calls served by the torch schedule while a circuit is
                     open before one half-open probe is allowed.  Counted
                     in calls, not wall time, so breaker tests are
                     deterministic.
parseval_tol         relative energy-ratio tolerance for fp32 plans.
parseval_tol_lowp    the same for sub-fp32 dtypes (bf16 plans).
hermitian_tol        relative residual tolerance of the rfft symmetry
                     checks (fp32 plans).
hermitian_tol_lowp   the same for sub-fp32 dtypes: a healthy bf16 kernel's
                     symmetry residual sits at the bf16 quantisation floor
                     (~1e-2 relative), far above the fp32 tolerance.
measure_timeout_s    per-candidate autotune measurement watchdog (seconds);
                     ``None`` disables the watchdog thread entirely.
"""
from __future__ import annotations

import contextlib

GUARD_LEVELS = ("off", "basic", "full")

DEFAULTS = dict(
    enabled=True,
    guard_level="basic",
    guard_torch=False,
    failure_threshold=3,
    cooldown_calls=4,
    parseval_tol=1e-3,
    parseval_tol_lowp=5e-2,
    hermitian_tol=1e-3,
    hermitian_tol_lowp=5e-2,
    measure_timeout_s=120.0,
)

_state = dict(DEFAULTS)


def get(key: str):
    return _state[key]


def configure(**kw) -> dict:
    """Update resilience knobs; unknown keys raise.  Returns the previous
    values of the keys that changed (handy for manual restore)."""
    bad = set(kw) - set(DEFAULTS)
    if bad:
        raise KeyError(f"unknown resilience option(s): {sorted(bad)}; "
                       f"valid: {sorted(DEFAULTS)}")
    if "guard_level" in kw and kw["guard_level"] not in GUARD_LEVELS:
        raise ValueError(f"guard_level must be one of {GUARD_LEVELS}, "
                         f"got {kw['guard_level']!r}")
    prev = {k: _state[k] for k in kw}
    _state.update(kw)
    return prev


def reset() -> None:
    _state.clear()
    _state.update(DEFAULTS)


@contextlib.contextmanager
def overrides(**kw):
    """Temporarily apply knobs (tests): restores prior values on exit."""
    prev = configure(**kw)
    try:
        yield
    finally:
        _state.update(prev)
