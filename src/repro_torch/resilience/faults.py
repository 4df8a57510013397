"""Deterministic, seeded fault injection at named sites (counterpart of
:mod:`repro.resilience.faults`).

A :class:`FaultPlan` is a list of :class:`FaultSpec` triggers plus a seeded
RNG; installing it (``with plan:`` or :func:`inject`) arms the named sites
that production code consults through the cheap module-level hooks
(:func:`check` / :func:`corrupt` / :func:`scaled`).  With no plan installed
every hook is a near-free no-op (one global ``is None`` test), so the
instrumented hot paths cost nothing in normal operation.

Sites are plain strings; the reference's eight:

=====================  =====================================================
site                   where it fires / kinds that make sense there
=====================  =====================================================
``plan.execute``       guarded executor, before a cuda kernel launch
                       (``kind="error"`` = kernel-launch failure)
``plan.output``        guarded executor, on a cuda kernel's output
                       (``kind="nan"/"inf"/"corrupt"`` = bad numerics)
``autotune.measure``   inside each autotune candidate measurement
                       (``kind="hang"`` = a candidate that never returns;
                       ``duration`` = seconds it stalls)
``dist.exchange``      every exchange of ``dist/pencil.py``: every rank
                       consults it, and the rank at index 0 of the axis
                       corrupts what it received
                       (``kind="drop"/"corrupt"/"nan"``)
``wisdom.save``        mid-write inside
                       :func:`repro_torch.core.plan.save_wisdom`
                       (``kind="error"`` = crash leaving a torn temp file)
``serve.prewarm``      :func:`repro_torch.core.plan.warm`, per key
                       (``kind="error"``)
``serve.step``         every spectral-server dispatch (``kind="hang"``
                       drives the per-request deadline path)
``straggler.times``    test harnesses perturbing gossip timings
                       (``kind="slow"``, ``scale`` = slowdown factor)
=====================  =====================================================

Determinism: every spec fires on an explicit visit schedule: skip the
first ``after`` matching visits, then fire up to ``times`` times (``None``
= unlimited), each firing additionally gated by ``prob`` drawn from the
plan's seeded ``numpy`` generator.  Two runs with the same plan, seed and
call sequence inject the identical faults.  Every firing is appended to
``plan.log`` for assertions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.complexmath import SplitComplex

KINDS = ("error", "nan", "inf", "drop", "corrupt", "hang", "slow")


class FaultInjected(RuntimeError):
    """Raised by ``kind="error"`` firings (a simulated hard failure)."""

    def __init__(self, site: str, tag: Optional[str] = None):
        self.site, self.tag = site, tag
        super().__init__(f"injected fault at site {site!r}"
                         + (f" (tag {tag!r})" if tag else ""))


@dataclasses.dataclass
class FaultSpec:
    site: str
    kind: str
    prob: float = 1.0          # firing probability per eligible visit
    times: Optional[int] = 1   # max firings (None = every eligible visit)
    after: int = 0             # skip this many matching visits first
    duration: float = 0.0      # kind="hang": seconds to stall
    scale: float = 8.0         # kind="slow"/"corrupt": perturbation factor
    tag: Optional[str] = None  # only visits whose tag contains this fire
    seen: int = 0              # matching visits so far (mutable counter)
    fired: int = 0             # firings so far (mutable counter)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, "
                             f"got {self.kind!r}")


class FaultPlan:
    """A seeded set of fault triggers, installable as a context manager."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.specs: List[FaultSpec] = []
        self.log: List[dict] = []

    def add(self, site: str, kind: str, **kw) -> "FaultPlan":
        self.specs.append(FaultSpec(site=site, kind=kind, **kw))
        return self

    def _fire(self, site: str, tag: Optional[str]) -> Optional[FaultSpec]:
        for spec in self.specs:
            if spec.site != site:
                continue
            if spec.tag is not None and spec.tag not in (tag or ""):
                continue
            spec.seen += 1
            if spec.seen <= spec.after:
                continue
            if spec.times is not None and spec.fired >= spec.times:
                continue
            if spec.prob < 1.0 and self.rng.random() >= spec.prob:
                continue
            spec.fired += 1
            self.log.append({"site": site, "tag": tag, "kind": spec.kind,
                             "firing": spec.fired})
            return spec
        return None

    def fired(self, site: Optional[str] = None) -> int:
        """Total firings so far (optionally of one site)."""
        return sum(1 for e in self.log if site is None or e["site"] == site)

    def __enter__(self) -> "FaultPlan":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already installed "
                               "(nesting is not supported)")
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None


_ACTIVE: Optional[FaultPlan] = None


def inject(site: str, kind: str, *, seed: int = 0, **kw) -> FaultPlan:
    """One-liner for the single-fault case::

        with faults.inject("plan.execute", "error"):
            ...
    """
    return FaultPlan(seed=seed).add(site, kind, **kw)


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def fire(site: str, tag: Optional[str] = None) -> Optional[FaultSpec]:
    """Consult a site: returns the firing spec, or None (the fast path)."""
    if _ACTIVE is None:
        return None
    return _ACTIVE._fire(site, tag)


def check(site: str, tag: Optional[str] = None) -> None:
    """Raise/stall sites: ``error`` raises :class:`FaultInjected`,
    ``hang`` sleeps ``duration`` seconds; other kinds are ignored here."""
    spec = fire(site, tag)
    if spec is None:
        return
    if spec.kind == "error":
        raise FaultInjected(site, tag)
    if spec.kind == "hang":
        time.sleep(spec.duration)


def scaled(site: str, value: float, tag: Optional[str] = None) -> float:
    """``slow`` sites: returns ``value * scale`` when the fault fires."""
    spec = fire(site, tag)
    if spec is not None and spec.kind == "slow":
        return value * spec.scale
    return value


def corrupt(site: str, value, tag: Optional[str] = None):
    """Tensor-corruption sites: perturb ``value`` (a tensor or a
    SplitComplex) when a ``nan``/``inf``/``corrupt``/``drop`` spec fires."""
    spec = fire(site, tag)
    if spec is None:
        return value
    return apply_corruption(value, spec)


def apply_corruption(value, spec: FaultSpec):
    """Deterministically mangle ``value`` per ``spec.kind``, on the
    tensor's own device (the input is never written):

    - ``nan``/``inf``: poison the first element of every component plane;
    - ``corrupt``: scale-and-shift every element (energy-visible);
    - ``drop``: replace the payload with zeros (a lost message).
    """
    def one(a: torch.Tensor) -> torch.Tensor:
        if spec.kind in ("nan", "inf"):
            out = a.clone(memory_format=torch.contiguous_format)
            out.view(-1)[0] = float(spec.kind)
            return out
        if spec.kind == "corrupt":
            return a * spec.scale + 1.0
        if spec.kind == "drop":
            return torch.zeros_like(a)
        raise ValueError(f"kind {spec.kind!r} is not an array corruption")

    if isinstance(value, SplitComplex):
        return SplitComplex(one(value.re), one(value.im))
    return one(value)
