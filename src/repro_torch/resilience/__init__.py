"""repro_torch.resilience — fault injection, numerical guards, runtime
fallback (counterpart of :mod:`repro.resilience`).

- :mod:`~repro_torch.resilience.faults`    deterministic seeded fault
  injection at named sites (kernel launch/output, autotune measurement,
  wisdom writes, serve pre-warm/step).
- :mod:`~repro_torch.resilience.guards`    cheap integrity checks: NaN/Inf
  scan, Parseval energy ratio, Hermitian symmetry of rfft outputs.
- :mod:`~repro_torch.resilience.policy`    per-plan-key circuit breaker
  (closed -> open -> half-open), call-counted and deterministic.
- :mod:`~repro_torch.resilience.executor`  the guarded executor every
  ``FFTPlan.__call__`` routes through: guard, retry on the torch schedule
  on the input's device, demote the registry key after repeated failures
  (``demote_reason="runtime_circuit_open"``), re-promote on probe success.
- :mod:`~repro_torch.resilience.config`    the knobs (guard level, breaker
  thresholds, autotune watchdog timeout).
"""
from . import config, executor, faults, guards, policy  # noqa: F401
from .config import configure, overrides  # noqa: F401
from .faults import FaultInjected, FaultPlan, inject  # noqa: F401
from .guards import GuardReport, GuardViolation, check_output  # noqa: F401
from .policy import RUNTIME_DEMOTE_REASON, breaker_state  # noqa: F401


def reset() -> None:
    """Restore default config, clear breakers/stats, re-promote any
    runtime-demoted registry entries.  Tests call this for isolation."""
    executor.reset()
    config.reset()
