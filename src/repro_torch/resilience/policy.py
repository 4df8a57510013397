"""Per-plan-key circuit breaker: demote a failing kernel path at runtime,
probe it back to health (counterpart of :mod:`repro.resilience.policy`).

One :class:`CircuitBreaker` exists per cuda plan key that has ever failed
a guarded execution.  Lifecycle (all transitions counted in *calls*, never
wall time, so tests are deterministic):

- ``closed``     normal operation; ``failure_threshold`` *consecutive*
                 guarded failures open the circuit.
- ``open``       every execution short-circuits to the key's torch
                 schedule (the registry entry itself is demoted with
                 ``demote_reason="runtime_circuit_open"`` so the state is
                 visible to anyone holding, or fetching, the plan).
                 After ``cooldown_calls`` short-circuited calls the
                 breaker goes half-open.
- ``half_open``  the next execution is a *probe* on the original cuda
                 plan: success closes the circuit and re-promotes the
                 registry entry; failure re-opens it (cooldown restarts).

The breaker registry here is pure state machine; the guarded executor
(:mod:`repro_torch.resilience.executor`) drives it and performs the actual
registry demotion and restoration.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from . import config

RUNTIME_DEMOTE_REASON = "runtime_circuit_open"

STATES = ("closed", "open", "half_open")


@dataclasses.dataclass
class CircuitBreaker:
    key: tuple                       # the cuda plan key this guards
    original_plan: object            # the healthy cuda FFTPlan to restore
    state: str = "closed"
    consecutive_failures: int = 0
    open_calls: int = 0              # short-circuited calls while open
    failures: int = 0                # lifetime counters (introspection)
    successes: int = 0
    probes: int = 0
    transitions: List[str] = dataclasses.field(default_factory=list)

    def _move(self, state: str) -> None:
        self.state = state
        self.transitions.append(state)

    def allow_attempt(self) -> bool:
        """May this call try the cuda path?  ``open`` counts the call
        toward the cooldown and answers False until the half-open probe
        is due."""
        if self.state in ("closed", "half_open"):
            return True
        self.open_calls += 1
        if self.open_calls >= config.get("cooldown_calls"):
            self._move("half_open")
            return True
        return False

    def record_success(self) -> bool:
        """Returns True when this success *closed* a non-closed circuit
        (the executor must then re-promote the registry entry)."""
        self.successes += 1
        self.consecutive_failures = 0
        if self.state in ("half_open", "open"):
            self.probes += 1
            self._move("closed")
            self.open_calls = 0
            return True
        return False

    def record_failure(self) -> bool:
        """Returns True when this failure *opened* a closed/half-open
        circuit (the executor must then demote the registry entry)."""
        self.failures += 1
        self.consecutive_failures += 1
        if self.state == "half_open":
            self.probes += 1
            self._move("open")
            self.open_calls = 0
            return True
        if (self.state == "closed"
                and self.consecutive_failures
                >= config.get("failure_threshold")):
            self._move("open")
            self.open_calls = 0
            return True
        return False


_BREAKERS: Dict[tuple, CircuitBreaker] = {}


def breaker(key: tuple, *, create: bool = False,
            original_plan=None) -> Optional[CircuitBreaker]:
    br = _BREAKERS.get(key)
    if br is None and create:
        br = CircuitBreaker(key=key, original_plan=original_plan)
        _BREAKERS[key] = br
    return br


def breaker_state(key: tuple) -> Optional[str]:
    br = _BREAKERS.get(key)
    return None if br is None else br.state


def all_breakers() -> Dict[tuple, CircuitBreaker]:
    return dict(_BREAKERS)


def reset() -> None:
    _BREAKERS.clear()
