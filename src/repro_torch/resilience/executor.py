"""The guarded executor: every :class:`repro_torch.core.plan.FFTPlan` call
routes through :func:`execute` (counterpart of
:mod:`repro.resilience.executor`).

Behaviour matrix:

- **Resilience disabled** (``enabled=False``): raw execution.  The port
  has no tracing, so the guards engage on every other call; code that must
  not pay for them (the spectral server's dispatch, the autotuner's
  measured candidates) calls ``plan._execute`` directly.
- **cuda execution**: consult the key's circuit breaker, then attempt the
  kernel inside a try/guard: a raised kernel failure (including the
  injected ``plan.execute`` site) or a guard violation on the output
  (``plan.output`` corruption, NaN/Inf, energy mismatch) records a breaker
  failure and falls back to the key's **torch schedule**, on the input's
  device, for this call: the caller still gets a correct result.  On a
  tensor on the card only an injected fault or a guard violation falls
  back (:func:`recoverable`): a kernel that fails to build or launch
  raises, so no broken kernel hides behind its plain version.  After
  ``failure_threshold`` consecutive failures the breaker opens and the
  registry entry itself is demoted
  (``demote_reason="runtime_circuit_open"``); cooldown and half-open
  probing re-promote it once the kernel path behaves again.  A CUDA fault
  that poisons the context (an illegal address) fails every later call in
  the process, the fallback's too: nothing here can recover it.
- **torch execution**: raw (plus the basic guard when ``guard_torch`` is
  configured); a runtime-demoted entry still drives its breaker so the
  half-open probe happens even for callers that fetched the plan *after*
  demotion.
"""
from __future__ import annotations

from typing import Dict, Optional

from . import config, faults, guards, policy
from .faults import FaultInjected
from .guards import GuardViolation
from .policy import RUNTIME_DEMOTE_REASON

_STATS: Dict[tuple, dict] = {}


def _stat(key: tuple) -> dict:
    st = _STATS.get(key)
    if st is None:
        st = _STATS[key] = {"attempts": 0, "failures": 0, "fallbacks": 0,
                            "short_circuits": 0, "last_reason": None}
    return st


def stats(key: Optional[tuple] = None):
    """Per-cuda-key executor counters (all keys when ``key`` is None)."""
    return dict(_STATS) if key is None else dict(_stat(key))


def reset() -> None:
    """Clear executor stats AND breaker state, and restore any
    runtime-demoted registry entries (test isolation)."""
    from repro_torch.core import plan as plan_mod
    for key, br in policy.all_breakers().items():
        if br.state != "closed":
            plan_mod._runtime_restore(key, br.original_plan)
    policy.reset()
    _STATS.clear()


def recoverable(exc: BaseException, on_card: bool) -> bool:
    """Whether a failure may fall back to the torch twin.  On the CPU any
    ``Exception`` may (the reference's rule); on the card only an injected
    fault or a guard violation: a build error, a CUDA runtime error or a
    wrapper's refusal there is a broken kernel, and it raises.  A
    wrapper's refusal of an input that requires grad
    (``kernels.ops.GradientNotSupported``) never falls back, on either
    device: the torch twin would differentiate where the kernel cannot."""
    from repro_torch.kernels.ops import GradientNotSupported
    if isinstance(exc, GradientNotSupported):
        return False
    if on_card:
        return isinstance(exc, (FaultInjected, GuardViolation))
    return isinstance(exc, Exception)


def on_card(x) -> bool:
    """Whether a plan input (a tensor or a SplitComplex) lies on the card."""
    return getattr(x, "re", x).is_cuda


def _label(plan) -> str:
    shp = "x".join(map(str, plan.shape))
    return f"{plan.backend}/{plan.algo}/{shp}"


def _cuda_key(plan_mod, plan) -> tuple:
    return plan_mod._plan_key(plan.shape, plan.dtype, plan.inverse,
                              "cuda", plan.kind)


def execute(plan, x, *args):
    """Entry point: ``FFTPlan.__call__`` delegates here.  conv-kind plans
    carry the filter half spectrum as an extra operand (``*args``), which
    rides through attempt and fallback unchanged."""
    if not config.get("enabled"):
        return plan._execute(x, *args)
    from repro_torch.core import plan as plan_mod
    if plan.backend == "cuda":
        key = _cuda_key(plan_mod, plan)
        br = policy.breaker(key)
        if br is None or br.allow_attempt():
            return _guarded_attempt(plan_mod, plan, x, key, args)
        _stat(key)["short_circuits"] += 1
        return _fallback(plan_mod, plan, x, args)
    if plan.demote_reason == RUNTIME_DEMOTE_REASON:
        # a runtime-demoted registry entry: the breaker still owns this
        # key, so cooldown ticks and half-open probes run from here too
        key = _cuda_key(plan_mod, plan)
        br = policy.breaker(key)
        if br is not None and br.state != "closed":
            if br.allow_attempt():
                return _guarded_attempt(plan_mod, br.original_plan, x, key,
                                        args)
            _stat(key)["short_circuits"] += 1
    y = plan._execute(x, *args)
    if config.get("guard_torch"):
        rep = guards.check_output(plan, x, y, level="basic")
        if not rep.ok:
            raise GuardViolation(rep)
    return y


def _guarded_attempt(plan_mod, plan, x, key: tuple, args=()):
    """Try the cuda plan under guards; fall back to torch on a
    :func:`recoverable` failure."""
    st = _stat(key)
    st["attempts"] += 1
    try:
        faults.check("plan.execute", tag=_label(plan))
        y = plan._execute(x, *args)
        y = faults.corrupt("plan.output", y, tag=_label(plan))
        rep = guards.check_output(plan, x, y)
        if not rep.ok:
            raise GuardViolation(rep)
    except Exception as e:          # noqa: BLE001 — resilience boundary
        if not recoverable(e, on_card(x)):
            raise
        st["failures"] += 1
        st["last_reason"] = f"{type(e).__name__}: {e}"
        br = policy.breaker(key, create=True,
                            original_plan=plan_mod._PLAN_CACHE.get(key, plan))
        if br.record_failure():
            plan_mod._runtime_demote(key)
        st["fallbacks"] += 1
        return _fallback(plan_mod, plan, x, args)
    br = policy.breaker(key)
    if br is not None and br.record_success():
        plan_mod._runtime_restore(key, br.original_plan)
    return y


def _fallback(plan_mod, plan, x, args=()):
    """Execute the key's torch schedule (guarded basic) for this call, on
    the input's device."""
    fb = plan_mod.get_plan(plan.shape, dtype=plan.dtype,
                           inverse=plan.inverse, kind=plan.kind,
                           backend="torch")
    y = fb._execute(x, *args)
    rep = guards.check_output(fb, x, y, level="basic")
    if not rep.ok:
        # the fallback failed too: nothing left to recover with — report
        raise GuardViolation(rep)
    return y
