"""FFTW-style plan registry: resolve once, apply many times.

Counterpart of :mod:`repro.core.plan`: c2c 1-D, 2-D and 3-D keys, rfft
1-D and 2-D keys and the conv kinds.  A :class:`FFTPlan` captures (shape,
dtype, direction, backend, kind) plus the resolved execution config
(algo, radix, block_batch, variant).  Plans are interned: two requests with the same key
return the same object.

``backend="torch"`` runs the plain algorithms of
:mod:`repro_torch.core.fft1d`; ``backend="cuda"`` runs the kernels through
:mod:`repro_torch.kernels.ops`.  Shapes with no kernel path demote to
``"torch"`` with the reference's ``demote_reason`` wording.

3-D c2c keys ``(d, h, w)`` on ``"cuda"`` resolve to the fused 3-D GEMM
kernel (:mod:`repro_torch.kernels.fft3d_fused`, ``algo="fused"``);
``"row_col"`` runs three Stockham kernel passes.  GEMM-fused 2-D/3-D
plans carry a ``variant``: ``"auto"`` resolves to ``"compensated"`` for
sub-fp32 dtypes (the bf16 path), ``"plain"`` otherwise.

``kind="rfft"`` interns a real-input plan keyed on the *real* shape: 1-D
keys resolve the inner complex transform (length n/2 forward, n inverse),
2-D keys on ``"cuda"`` resolve to the fused real-input kernels
(:mod:`repro_torch.kernels.rfft2d_fused`, ``algo="fused"``).

The conv kinds (``"conv_causal"``, ``"conv_circular"``) are 1-D forward
keys on the padded FFT length m: ``"cuda"`` resolves power-of-two m >= 4
to the fused conv kernel (:mod:`repro_torch.kernels.fftconv_fused`,
``algo="fused"``), everything else to the unfused rfft -> multiply ->
irfft schedule (``algo="unfused"``).  A conv plan takes the filter half
spectrum as a second operand: ``plan(x, kf)``.

``FFTPlan.__call__`` runs through the guarded executor
(:mod:`repro_torch.resilience.executor`): kernel executions are
integrity-checked and fall back to the torch schedule, on the input's
device, on failure (on the card only on an injected fault or a guard
violation: a kernel that fails to build or launch raises); repeated
failures demote the registry key with
``demote_reason="runtime_circuit_open"``.

``tune=True`` runs the measuring autotuner: every candidate (algo, radix,
block_batch, variant) config is timed on synthetic data on ``device`` and
the winner is recorded in the registry, at most once per key.  Tuned
winners persist FFTW-"wisdom" style (:func:`save_wisdom` /
:func:`load_wisdom`, autoloaded at import from ``$REPRO_TORCH_FFT_WISDOM``);
the port reads only wisdom it wrote itself.  :func:`warm` bulk-resolves
keys for the serving pre-warm.  ``prune="model"`` ranks the candidates
with the Tensix cost model (:func:`repro_torch.tt.trace.predict_cost`)
and measures only the most promising.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

import repro_torch
from .complexmath import SplitComplex
from . import fft1d
from .fft1d import KERNEL_INNER_ALGOS, resolve_algo


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


PlanKey = Tuple[Tuple[int, ...], str, bool, str, str]

_PLAN_CACHE: Dict[PlanKey, "FFTPlan"] = {}      # algo="auto" plans
_OVERRIDE_CACHE: Dict[tuple, "FFTPlan"] = {}    # (key, algo, radix) overrides
_AUTOTUNE_RUNS: Dict[tuple, int] = {}

CONV_KINDS = ("conv_causal", "conv_circular")
PLAN_KINDS = ("c2c", "rfft") + CONV_KINDS
BACKENDS = ("torch", "cuda")
# the reference's backend names and the port's
REFERENCE_BACKENDS = {"jnp": "torch", "pallas": "cuda"}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(getattr(torch, str(dtype), None), torch.dtype):
        return str(dtype)           # a plan's own dtype name ("bfloat16")
    return np.dtype(dtype).name


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) \
        else getattr(torch, _dtype_name(dtype))


def _itemsize(dtype) -> int:
    return _torch_dtype(dtype).itemsize


def _plan_key(shape, dtype, inverse, backend, kind="c2c") -> PlanKey:
    return (tuple(int(d) for d in shape), _dtype_name(dtype),
            bool(inverse), backend, kind)


@dataclasses.dataclass(frozen=True)
class FFTPlan:
    shape: Tuple[int, ...]            # (n,), (h, w) or (d, h, w)
    dtype: str = "float32"
    inverse: bool = False
    algo: str = "auto"                # resolved at construction, never "auto"
    backend: str = "torch"            # "torch" | "cuda"
    radix: int = 4                    # Stockham radix (4 = mixed 4/2, 2 = oracle)
    block_batch: int = 8              # batch tile (resolution parity only)
    kind: str = "c2c"
    variant: str = "plain"            # GEMM kernels: "plain" | "compensated"
    tuned: bool = False
    tune_report: Optional[dict] = None
    demote_reason: Optional[str] = None  # why a cuda request fell to torch

    @property
    def n(self) -> int:
        return self.shape[-1]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @staticmethod
    def create(n: int, *, inverse: bool = False, algo: str = "auto",
               backend: str = "torch", dtype=torch.float32,
               tune: bool = False, device="cuda") -> "FFTPlan":
        """1-D plan through the registry (``device``: where ``tune=True``
        measures)."""
        return get_plan((n,), dtype=dtype, inverse=inverse, algo=algo,
                        backend=backend, tune=tune, device=device)

    def __call__(self, x, *args):
        """Execute through the guarded executor
        (:mod:`repro_torch.resilience.executor`): kernel executions are
        integrity-checked and fall back to the torch schedule on a
        recoverable failure (repeated failures open the key's circuit breaker and demote the
        registry entry with ``demote_reason="runtime_circuit_open"``);
        disabled resilience takes the raw path.  conv-kind plans take the
        filter half spectrum as a second operand: ``plan(x, kf)``."""
        from repro_torch.resilience import executor as _rexec
        return _rexec.execute(self, x, *args)

    def _execute(self, x, *args):
        """The raw execution path (no guards, no fallback); conv-kind
        plans take the filter half spectrum as a second operand."""
        if self.kind in CONV_KINDS:
            return self._call_conv(x, *args)
        if args:
            raise TypeError("only conv-kind plans take extra operands")
        if self.kind == "rfft":
            return self._call_rfft(x)
        if tuple(x.shape[-self.ndim:]) != self.shape:
            raise ValueError(f"plan for {self.shape} got input {x.shape}")
        if self.ndim == 2:
            from . import fft2d
            return fft2d._fft2_direct(x, inverse=self.inverse, algo=self.algo,
                                      backend=self.backend,
                                      block_batch=self.block_batch,
                                      variant=self.variant)
        if self.ndim == 3:
            from . import fft2d
            return fft2d._fft3_direct(x, inverse=self.inverse, algo=self.algo,
                                      backend=self.backend,
                                      block_batch=self.block_batch,
                                      variant=self.variant)
        if self.backend == "cuda":
            from repro_torch.kernels import ops as kops
            if self.algo == "four_step":
                return kops.fft_fourstep(x, inverse=self.inverse,
                                         block_batch=self.block_batch)
            return kops.fft_stockham(x, inverse=self.inverse,
                                     radix=self.radix,
                                     block_batch=self.block_batch)
        algo = "stockham2" if (self.algo == "stockham" and self.radix == 2) \
            else self.algo
        return fft1d.fft(x, inverse=self.inverse, algo=algo)

    def _check_input(self, x, shape) -> None:
        if tuple(x.shape[-len(shape):]) != tuple(shape):
            raise ValueError(f"{self.kind} plan for {self.shape} "
                             f"(inverse={self.inverse}) got input {x.shape}")

    def _call_rfft(self, x):
        """Execute a real-input plan.  On ``backend="torch"`` the resolved
        ``algo`` is the inner complex transform of the rfft/irfft axis, and
        the 2-D column pass is a c2c transform routed through its own
        registry key.  On ``backend="cuda"`` 2-D plans run the fused
        real-input kernels (``algo="fused"``) and 1-D plans run their inner
        complex transform on the 1-D kernels."""
        if self.ndim == 1:
            kw = dict(algo=self.algo, backend=self.backend, radix=self.radix)
            if self.inverse:            # input: (..., n/2+1) half spectrum
                self._check_input(x, (self.n // 2 + 1,))
                return fft1d._irfft_direct(x, self.n, **kw)
            self._check_input(x, self.shape)
            return fft1d._rfft_direct(x, **kw)
        h, w = self.shape
        from . import fft2d
        self._check_input(x, (h, w // 2 + 1) if self.inverse else self.shape)
        if self.backend == "cuda" and self.algo == "fused":
            from repro_torch.kernels import ops as kops
            if self.inverse:
                return kops.irfft2d_fused(x)
            return kops.rfft2d_fused(x)
        # torch plans run the row-column schedule with plain passes; a cuda
        # plan with an explicit non-fused algo runs the same schedule with
        # kernel 1-D passes, as the direct rfft2()/irfft2() path does
        col = self.algo if self.backend == "cuda" else "auto"
        if self.inverse:
            return fft2d._irfft2_direct(x, row_algo=self.algo, col_algo=col,
                                        backend=self.backend)
        return fft2d._rfft2_direct(x, row_algo=self.algo, col_algo=col,
                                   backend=self.backend)

    def _call_conv(self, x, kf):
        """Execute a conv plan: circularly convolve real signals x (..., m)
        with the filter half spectra kf (..., m//2+1) over the plan's
        padded FFT length m.  ``algo="fused"`` runs the fused conv kernel
        (:mod:`repro_torch.kernels.fftconv_fused`); ``algo="unfused"`` is
        the registry-composed rfft -> mul -> irfft baseline (the demotion
        target).  Causal padding and truncation happen upstream in
        :func:`repro_torch.core.fftconv.fft_conv`."""
        m = self.n
        self._check_input(x, self.shape)
        if self.algo == "fused":
            from repro_torch.kernels import ops as kops
            return kops.fftconv_fused(x, kf)
        from . import complexmath as cm
        xf = fft1d.rfft(x, backend=self.backend)
        return fft1d.irfft(cm.mul(xf, kf), m, backend=self.backend)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def get_plan(shape, *, dtype=torch.float32, inverse: bool = False,
             algo: str = "auto", backend: str = "torch", kind: str = "c2c",
             variant: str = "auto", tune: bool = False, tune_batch: int = 8,
             prune: str = "none", prune_k: Optional[int] = None,
             model_arch: str = "tpu_v5e",
             measure_timeout_s: Optional[float] = "config",
             device="cuda") -> FFTPlan:
    """Return the interned plan for this key, resolving (or autotuning) it
    on first request (same resolution rules as the reference's
    ``get_plan`` for c2c, rfft and conv keys).  Requests with an explicit
    ``algo`` or ``variant`` are interned separately and never replace the
    auto-resolved plan.

    ``tune=True`` measures the candidate configs once per cache entry on
    ``tune_batch`` synthetic rows made on ``device``; an explicit algo
    measures only that algo's variants.  ``measure_timeout_s`` is the
    per-candidate watchdog (one retry, then the candidate is excluded);
    the default defers to ``resilience.config.get("measure_timeout_s")``,
    ``None`` disables it.

    ``prune="model"`` makes the autotuner rank candidates with the
    :mod:`repro_torch.tt.trace` cost model on ``model_arch`` (one of the
    reference's arches, :mod:`repro_torch.tt.arch`) and measure only the
    ``prune_k`` most promising (default: half, min 2 — the heuristic
    default config is always measured)."""
    shape = tuple(int(d) for d in shape)
    if kind not in PLAN_KINDS:
        raise ValueError(f"kind must be one of {PLAN_KINDS}, got {kind}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if variant not in ("auto", "plain", "compensated"):
        raise ValueError(f"unknown variant {variant!r}")
    if kind == "rfft" and len(shape) == 3:
        raise ValueError("rfft plans are 1-D or 2-D; 3-D real transforms "
                         "compose rfft2 with a c2c depth pass")
    if kind in CONV_KINDS:
        if len(shape) != 1:
            raise ValueError("conv plans are 1-D (keyed on the padded FFT "
                             f"length), got {shape}")
        if inverse:
            raise ValueError("conv plans have no inverse direction (the "
                             "irfft is fused inside the plan)")
    if len(shape) not in (1, 2, 3):
        raise ValueError(f"1-D/2-D/3-D plans only, got {shape}")
    if prune not in ("none", "model"):
        raise ValueError(f'prune must be "none" or "model", got {prune!r}')
    # the kernels need power-of-two tile dims of at least 2
    kernel_ok = all(_is_pow2(d) and d >= 2 for d in shape)
    radix = 4
    fixed_radix = False
    demote = None

    if kind in CONV_KINDS:
        m = shape[0]
        if backend == "cuda" and not (_is_pow2(m) and m >= 4):
            demote = ("fused conv kernel needs a power-of-two FFT length "
                      f">= 4, got {m}")
            if algo == "fused":
                algo = "auto"         # fused demotes with its backend
            backend = "torch"
        if algo == "auto":
            resolved = "fused" if backend == "cuda" else "unfused"
        else:
            resolved = algo
        if backend == "torch" and resolved == "fused":
            raise ValueError('algo="fused" requires backend="cuda" (the '
                             'fused conv kernel has no torch equivalent)')
        if resolved not in ("fused", "unfused"):
            raise ValueError(f'algo={resolved!r} is not a conv plan algo; '
                             'use "fused", "unfused" or "auto"')
        block_batch = 1 if resolved == "fused" else 8
    elif kind == "rfft":
        n = shape[-1]
        if n % 2:
            raise ValueError(f"rfft plans need an even last dim, "
                             f"got {shape}")
        inner = n if inverse else n // 2
        inner_ok = _is_pow2(inner) and inner >= 2
        if len(shape) == 1:
            # 1-D: the pack/untangle stays plain torch; the inner complex
            # transform runs on the 1-D kernels when one exists
            resolved = resolve_algo(inner) if algo == "auto" else algo
            if backend == "cuda" and (resolved not in KERNEL_INNER_ALGOS
                                      or not inner_ok):
                demote = (f"inner algo {resolved!r} at inner length "
                          f"{inner} has no kernel path")
                backend = "torch"
            block_batch = 8
        else:
            # 2-D: the fused real-input kernels (rfft2d_fused)
            if backend == "cuda" and not kernel_ok:
                demote = ("fused rfft kernel needs power-of-two dims "
                          f">= 2, got {shape}")
                if algo == "fused":
                    algo = "auto"
                backend = "torch"
            if algo == "auto":
                resolved = "fused" if backend == "cuda" \
                    else resolve_algo(inner)
            else:
                resolved = algo
            if backend == "cuda" and resolved != "fused" and (
                    resolved not in KERNEL_INNER_ALGOS or not inner_ok):
                # an explicit non-fused algo runs the row-column schedule
                # with kernel 1-D passes; algos outside _fft_inner's kernel
                # set demote visibly
                demote = (f"explicit inner algo {resolved!r} at inner "
                          f"length {inner} has no kernel path")
                backend = "torch"
            if backend == "torch" and resolved == "fused":
                raise ValueError('algo="fused" requires backend="cuda" '
                                 '(the fused rfft kernel has no torch '
                                 'equivalent)')
            block_batch = 1 if resolved == "fused" else 8
    elif len(shape) == 1:
        resolved = resolve_algo(shape[0]) if algo == "auto" else algo
        if resolved == "stockham2":   # radix-2 oracle: a stockham radix config
            resolved, radix, fixed_radix = "stockham", 2, True
        if backend == "cuda" and (resolved in ("naive", "bluestein")
                                  or not kernel_ok):
            demote = f"algo {resolved!r} at {shape} has no kernel path"
            backend = "torch"
        block_batch = 8
    else:
        fused_algos = ("fused", "fused_stockham") if len(shape) == 2 \
            else ("fused",)           # no 3-D Stockham oracle
        if backend == "cuda" and not kernel_ok:
            demote = ("kernels need power-of-two tile dims >= 2, "
                      f"got {shape}")
            if algo in fused_algos:
                algo = "auto"         # fused demotes with its backend
            backend = "torch"
        if algo == "auto":
            resolved = "fused" if backend == "cuda" else "row_col"
        else:
            resolved = algo
        if backend == "torch" and resolved in fused_algos:
            raise ValueError(f'algo={resolved!r} requires backend="cuda" '
                             '(the fused kernels have no torch equivalent)')
        if resolved not in fused_algos + ("row_col",):
            raise ValueError(
                f'algo={resolved!r} is not a {len(shape)}-D plan algo; '
                f'use one of {fused_algos + ("row_col",)} or "auto"')
        block_batch = 1 if resolved in fused_algos else 8

    # the GEMM kernels (complex fused 2-D/3-D) are the only variant-aware
    # paths; "auto" picks the compensated tables for sub-fp32 dtypes, as
    # the reference does
    gemm_path = (kind == "c2c" and len(shape) >= 2 and backend == "cuda"
                 and resolved == "fused")
    if variant == "auto":
        res_variant = "compensated" if gemm_path and \
            _itemsize(dtype) < 4 else "plain"
    elif variant == "compensated" and not gemm_path:
        if demote is None:
            raise ValueError('variant="compensated" requires a GEMM fused '
                             'plan (2-D/3-D c2c, backend="cuda", '
                             'algo="fused")')
        res_variant = "plain"         # the kernel path demoted away
    else:
        res_variant = variant

    key = _plan_key(shape, dtype, inverse, backend, kind)
    explicit = algo != "auto" or variant != "auto"
    cache_key = key if not explicit else key + (resolved, radix, res_variant)
    cache = _PLAN_CACHE if not explicit else _OVERRIDE_CACHE
    plan = cache.get(cache_key)
    if plan is None:
        plan = FFTPlan(shape=shape, dtype=key[1], inverse=inverse,
                       algo=resolved, radix=radix, backend=backend,
                       block_batch=block_batch, kind=kind,
                       variant=res_variant, demote_reason=demote)
        cache[cache_key] = plan
    if tune and not plan.tuned:
        plan = _autotune(cache_key, plan, batch=tune_batch,
                         fixed_algo=algo != "auto", fixed_radix=fixed_radix,
                         fixed_variant=variant != "auto",
                         prune=prune, prune_k=prune_k, model_arch=model_arch,
                         measure_timeout_s=measure_timeout_s, device=device)
        cache[cache_key] = plan
    return plan


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _OVERRIDE_CACHE.clear()
    _AUTOTUNE_RUNS.clear()
    from . import fftconv as _fftconv   # deferred: fftconv imports plan
    _fftconv.clear_spectrum_cache()     # per-plan filter spectra key on plans


# -- runtime demotion (driven by the resilience circuit breaker) ------------

def _runtime_demote(key: PlanKey, reason: str = "runtime_circuit_open"):
    """Swap the auto registry entry for ``key`` (a cuda key) with its torch
    schedule, carrying a registry-visible ``demote_reason``.  Anyone calling
    :func:`get_plan` for this key now receives the demoted plan; holders of
    the old object still route through the same circuit breaker.  Returns
    the entry that was displaced (None if the key was never interned)."""
    shape, dtype, inverse, _backend, kind = key
    orig = _PLAN_CACHE.get(key)
    twin = get_plan(shape, dtype=dtype, inverse=inverse, kind=kind,
                    backend="torch")
    _PLAN_CACHE[key] = dataclasses.replace(twin, demote_reason=reason)
    return orig


def _runtime_restore(key: PlanKey, plan: "FFTPlan") -> None:
    """Undo :func:`_runtime_demote`: re-promote the healthy plan."""
    if plan is None:
        _PLAN_CACHE.pop(key, None)
    else:
        _PLAN_CACHE[key] = plan


def plan_cache_size() -> int:
    return len(_PLAN_CACHE)


# -- bulk pre-warm -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WarmResult:
    """One key's outcome from :func:`warm`: the plan that will serve it
    (possibly the torch twin), whether resolution degraded, and why."""
    plan: "FFTPlan"
    requested_backend: str
    degraded: bool = False
    reason: Optional[str] = None


def warm(keys, *, backend: str = "cuda", tune: bool = False,
         tune_batch: int = 8, fault_site: Optional[str] = "serve.prewarm",
         on_error: str = "degrade", device="cuda"):
    """Bulk-resolve (and optionally tune, on ``device``) N plan keys in one
    call: the single "resolve these plans now or degrade" path of the
    serving pre-warm (:mod:`repro_torch.serve.spectral.prewarm`).

    ``keys`` is an iterable of shape tuples or dicts
    ``{"shape": (h, w), "dtype": ..., "kind": "c2c"|"rfft",
    "inverse": bool, "backend": ...}`` (dict fields beyond ``shape`` are
    optional; a per-key ``backend`` overrides the call-wide one).  Each key
    is consulted at ``fault_site`` (:func:`repro_torch.resilience.faults.
    check`, tagged ``kind/shape``) before resolution.

    A key whose resolution raises never takes the others down: with
    ``on_error="degrade"`` (default) it falls back to the always-available
    torch schedule and the :class:`WarmResult` records ``degraded=True``
    plus the reason; ``on_error="raise"`` propagates instead.  On the card
    only an injected fault degrades (:func:`repro_torch.resilience.
    executor.recoverable`): a kernel that fails to build or launch while
    tuning raises.  Results come back in input order.
    """
    if on_error not in ("degrade", "raise"):
        raise ValueError(f'on_error must be "degrade" or "raise", '
                         f"got {on_error!r}")
    from repro_torch.resilience import faults as _faults
    from repro_torch.resilience.executor import recoverable
    # only a tuning warm launches kernels, on ``device``
    on_card = tune and torch.device(device).type == "cuda"
    out = []
    for spec in keys:
        if not isinstance(spec, dict):
            spec = {"shape": spec}
        shape = tuple(int(d) for d in spec["shape"])
        kw = dict(dtype=spec.get("dtype", torch.float32),
                  inverse=bool(spec.get("inverse", False)),
                  kind=spec.get("kind", "c2c"))
        bk = spec.get("backend", backend)
        tag = f"{kw['kind']}/{'x'.join(map(str, shape))}"
        try:
            if fault_site:
                _faults.check(fault_site, tag=tag)
            plan = get_plan(shape, backend=bk, tune=tune,
                            tune_batch=spec.get("tune_batch", tune_batch),
                            device=device, **kw)
            out.append(WarmResult(plan=plan, requested_backend=bk))
        except Exception as e:      # noqa: BLE001 — degrade, never crash
            if on_error == "raise" or not recoverable(e, on_card):
                raise
            plan = get_plan(shape, backend="torch", **kw)
            out.append(WarmResult(plan=plan, requested_backend=bk,
                                  degraded=True,
                                  reason=f"{type(e).__name__}: {e}"))
    return out


def autotune_count(shape, *, dtype=torch.float32, inverse: bool = False,
                   backend: str = "torch", kind: str = "c2c") -> int:
    """How many times the measuring autotuner ran for this key, counting
    both the auto plan and any explicit-algo override tunes under it.
    ``backend`` is the post-demotion backend (a cuda request that fell back
    to torch is counted under "torch")."""
    base = _plan_key(shape, dtype, inverse, backend, kind)
    return sum(v for k, v in _AUTOTUNE_RUNS.items() if k[:5] == base)


# ---------------------------------------------------------------------------
# Wisdom (FFTW-style persisted plans)
# ---------------------------------------------------------------------------

# v3, as the reference's: entries carry the tuned variant.  The file also
# names its writer: the port installs only wisdom that it measured itself
# (a reference file's pallas/jnp winners are TPU facts, not H100 ones), so
# a file without WISDOM_WRITER is refused like a wrong version.
WISDOM_VERSION = 3
WISDOM_WRITER = "repro_torch"


def _wisdom_key_str(key: PlanKey) -> str:
    shape, dtype, inverse, backend, kind = key
    return (f"shape={'x'.join(map(str, shape))};dtype={dtype};"
            f"inverse={int(inverse)};backend={backend};kind={kind}")


def _wisdom_key_parse(s: str) -> PlanKey:
    parts = dict(p.split("=", 1) for p in s.split(";"))
    return (tuple(int(d) for d in parts["shape"].split("x")), parts["dtype"],
            bool(int(parts["inverse"])), parts["backend"], parts["kind"])


def _wisdom_hash(key_str: str, algo, radix, block_batch, backend,
                 variant) -> str:
    """Guard hash over the version, the key AND the tuned values, so a
    stale or hand-edited entry cannot install a bogus tuned plan."""
    payload = (f"v{WISDOM_VERSION}:{key_str}:{algo}:{radix}:{block_batch}"
               f":{backend}:{variant}")
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _wisdom_refusal(data, path: str) -> Optional[str]:
    """Why a wisdom file is refused whole (wrong version or writer), or
    None when its entries may be read."""
    version, writer = data.get("version"), data.get("writer")
    if version == WISDOM_VERSION and writer == WISDOM_WRITER:
        return None
    return (f"wisdom version {version!r} written by {writer!r} != "
            f"{WISDOM_VERSION} written by {WISDOM_WRITER!r} in {path}")


def save_wisdom(path: str) -> int:
    """Persist every *tuned* auto-keyed plan to ``path`` as JSON, FFTW
    "wisdom" style.  Each entry carries a hash of its (version, key, tuned
    values).  Returns the number of entries written.

    The write is **atomic**: the payload lands in a same-directory temp
    file that is ``os.replace``-d over ``path``, so a crash mid-write can
    never leave a torn wisdom file.  A crash leaves only a stale
    ``.tmp.<pid>`` sibling behind.
    """
    entries = []
    for key, plan in sorted(_PLAN_CACHE.items(), key=lambda kv: repr(kv[0])):
        if not plan.tuned:
            continue
        ks = _wisdom_key_str(key)
        entries.append({
            "key": ks,
            "key_hash": _wisdom_hash(ks, plan.algo, plan.radix,
                                     plan.block_batch, plan.backend,
                                     plan.variant),
            "algo": plan.algo, "radix": plan.radix,
            "block_batch": plan.block_batch,
            # the *tuned* backend: a cuda key's winner may be the torch
            # schedule (and the key records the requested backend)
            "backend": plan.backend,
            "variant": plan.variant,
            "tune_report": plan.tune_report,
        })
    payload = json.dumps({"version": WISDOM_VERSION, "writer": WISDOM_WRITER,
                          "entries": entries}, indent=2) + "\n"
    tmp = f"{path}.tmp.{os.getpid()}"
    from repro_torch.resilience import faults as _faults
    with open(tmp, "w") as fh:
        fh.write(payload[:len(payload) // 2])
        # crash-simulation point: a "wisdom.save" error fault aborts here,
        # after a partial write but before the atomic rename
        _faults.check("wisdom.save", tag=path)
        fh.write(payload[len(payload) // 2:])
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return len(entries)


def load_wisdom(path: str, *, strict: bool = False) -> int:
    """Load wisdom saved by :func:`save_wisdom` into the registry.

    Files of another version or writer (the reference's among them) and
    hash-mismatched entries are skipped (raised with ``strict=True``); an
    in-process plan that is *already tuned* is never overwritten.  Loaded
    plans arrive ``tuned=True``, so a later ``tune=True`` request for the
    same key skips the measuring autotuner.  Returns the number of entries
    installed.
    """
    with open(path) as fh:
        data = json.load(fh)
    refusal = _wisdom_refusal(data, path)
    if refusal is not None:
        if strict:
            raise ValueError(refusal)
        return 0
    loaded = 0
    for e in data.get("entries", ()):
        try:
            ks = e["key"]
            algo = e["algo"]
            radix = int(e["radix"])
            block_batch = int(e["block_batch"])
            backend = e["backend"]
            variant = e["variant"]
            if _wisdom_hash(ks, algo, radix, block_batch, backend,
                            variant) != e["key_hash"]:
                raise ValueError(f"wisdom key-hash mismatch for {ks!r}")
            key = _wisdom_key_parse(ks)
        except (KeyError, ValueError, TypeError) as ex:
            if strict:
                raise ValueError(f"malformed wisdom entry {e!r}: hash or "
                                 f"field error ({ex})") from ex
            continue
        live = _PLAN_CACHE.get(key)
        if live is not None and live.tuned:
            continue
        report = dict(e.get("tune_report") or {})
        report.setdefault("winner", "wisdom")
        report["source"] = "wisdom"
        _PLAN_CACHE[key] = FFTPlan(
            shape=key[0], dtype=key[1], inverse=key[2], backend=backend,
            kind=key[4], algo=algo, radix=radix,
            block_batch=block_batch, variant=variant,
            tuned=True, tune_report=report)
        loaded += 1
    return loaded


# the port's own variable: it never reads the reference's REPRO_FFT_WISDOM
WISDOM_ENV = "REPRO_TORCH_FFT_WISDOM"

_WISDOM_WARNED = False


def _warn_wisdom_once(msg: str) -> None:
    """One-shot observability for a bad ``$REPRO_TORCH_FFT_WISDOM`` file:
    warn exactly once per process and never raise."""
    global _WISDOM_WARNED
    if _WISDOM_WARNED:
        return
    _WISDOM_WARNED = True
    import warnings
    warnings.warn(f"{WISDOM_ENV}: {msg}; starting with a cold plan registry",
                  RuntimeWarning, stacklevel=3)


def _autoload_wisdom() -> int:
    """Load wisdom from ``$REPRO_TORCH_FFT_WISDOM`` at import, FFTW style.

    Best-effort: an unset/empty variable is a no-op and a missing or
    corrupt file never breaks the import, but an unreadable, non-JSON,
    wrong-shape, version- or writer-mismatched file emits a one-shot
    :class:`RuntimeWarning` naming the path and the error.  Returns the
    number of entries installed (kept in ``WISDOM_AUTOLOADED``).
    """
    path = os.environ.get(WISDOM_ENV, "").strip()
    if not path:
        return 0
    try:
        loaded = load_wisdom(path)
    except (OSError, ValueError, TypeError, AttributeError, KeyError,
            json.JSONDecodeError) as e:
        _warn_wisdom_once(f"failed to load wisdom from {path!r}: "
                          f"{type(e).__name__}: {e}")
        return 0
    if loaded == 0:
        # loaded-but-empty is legitimate (a fresh save with no tuned
        # plans); a version or writer mismatch is not: name it
        try:
            with open(path) as fh:
                refusal = _wisdom_refusal(json.load(fh), path)
        except Exception:  # noqa: BLE001 — diagnosis only, already loaded=0
            refusal = None
        if refusal is not None:
            _warn_wisdom_once(f"{refusal} (all entries skipped)")
    return loaded


WISDOM_AUTOLOADED = _autoload_wisdom()


# ---------------------------------------------------------------------------
# Autotuner
# ---------------------------------------------------------------------------

class CandidateTimeout(RuntimeError):
    """An autotune candidate measurement exceeded the watchdog timeout."""


def _watchdog_call(work, timeout_s: Optional[float]):
    """Run ``work()`` with a timeout: the call executes on a daemon thread
    and :class:`CandidateTimeout` is raised if it does not return in time
    (the stuck thread is abandoned — a daemon can never block exit)."""
    if timeout_s is None:
        return work()
    import threading
    out, err = [], []

    def runner():
        try:
            out.append(work())
        except BaseException as e:  # noqa: BLE001 — reraised on the caller
            err.append(e)

    th = threading.Thread(target=runner, daemon=True,
                          name="repro-torch-autotune-measure")
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        raise CandidateTimeout(f"measurement exceeded {timeout_s:g}s")
    if err:
        raise err[0]
    return out[0]


def _sync(x) -> None:
    """Wait for the card when ``x`` lives on one (a no-op on the CPU)."""
    t = x.re if isinstance(x, SplitComplex) else x
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _time_candidates(plans, x, *, warmup: int = 1, iters: int = 5,
                     labels=None, timeout_s: Optional[float] = None,
                     extra=()):
    """Best-of-iters wall time (us) per candidate, measured round-robin so
    machine-load drift hits every candidate equally.  Each measurement runs
    a candidate's raw ``_execute`` (no guards, as the reference's jitted
    candidates) between two device synchronizations.

    Every measurement runs under a per-candidate watchdog (``timeout_s``,
    None = off): a candidate that hangs gets ONE retry during warmup and is
    then excluded (time = +inf).  Returns ``(times_us, timed_out_labels)``.
    """
    from repro_torch.resilience import faults as _faults
    labels = labels if labels is not None else [str(i) for i in
                                                range(len(plans))]
    best = [float("inf")] * len(plans)
    dead = [False] * len(plans)
    timed_out = []

    def measure(i):
        def work():
            _faults.check("autotune.measure", tag=labels[i])
            _sync(x)
            t0 = time.perf_counter()
            plans[i]._execute(x, *extra)
            _sync(x)
            return time.perf_counter() - t0
        return _watchdog_call(work, timeout_s)

    for i in range(len(plans)):
        for attempt in range(1 + warmup):        # warmup + one retry
            try:
                measure(i)
                break
            except CandidateTimeout:
                if attempt == warmup:            # retries exhausted
                    dead[i] = True
                    timed_out.append(labels[i])
    for _ in range(iters):
        for i in range(len(plans)):
            if dead[i]:
                continue
            try:
                best[i] = min(best[i], measure(i))
            except CandidateTimeout:
                dead[i] = True
                best[i] = float("inf")           # a hanger can never win
                if labels[i] not in timed_out:
                    timed_out.append(labels[i])
    return [b * 1e6 for b in best], timed_out


def _dedup(out, fields):
    seen, uniq = set(), []
    for lbl, c in out:
        cfg = tuple(getattr(c, f) for f in fields)
        if cfg not in seen:
            seen.add(cfg)
            uniq.append((lbl, c))
    return uniq


def _candidates(plan: FFTPlan, *, fixed_algo: bool = False,
                fixed_radix: bool = False, fixed_variant: bool = False,
                batch: int = 8):
    """(label, plan) candidate configs for this key: the reference's
    (algo, radix, block_batch) grid and labels, backend names mapped.  The
    heuristic default is always candidate 0.  With ``fixed_algo`` only
    that algo's variants are measured.  block_batch candidates are clamped
    to ``batch``.  The CUDA kernels take no batch tile (``block_batch`` is
    resolution parity only), so their ``bb`` candidates time the same
    launches."""
    base = dataclasses.replace
    out = [("default", plan)]
    if plan.kind in CONV_KINDS:
        if plan.backend != "cuda":
            # the unfused torch conv composes rfft/irfft keys that tune
            # independently; nothing plan-level to vary here
            return out
        for bb in sorted({min(b, batch) for b in (1, 2)}):
            out.append((f"fused/bb{bb}",
                        base(plan, algo="fused", block_batch=bb)))
        # the registry-composed unfused path as the cross-backend baseline
        out.append(("unfused/torch", base(plan, backend="torch",
                                          algo="unfused", block_batch=8)))
        if fixed_algo:
            out = [(lbl, c) for lbl, c in out if c.algo == plan.algo]
        return _dedup(out, ("algo", "radix", "block_batch", "backend"))
    if plan.kind == "rfft":
        if plan.backend != "cuda":
            # torch rfft wraps an inner c2c transform whose own key is
            # tuned independently; nothing plan-level to vary here
            return out
        inner = plan.n if plan.inverse else plan.n // 2
        if plan.ndim == 2:
            for bb in sorted({min(b, batch) for b in (1, 2)}):
                out.append((f"fused/bb{bb}",
                            base(plan, algo="fused", block_batch=bb)))
        else:
            for bb in sorted({min(b, batch) for b in (4, 8, 16)}):
                out.append((f"stockham/r4/bb{bb}",
                            base(plan, algo="stockham", radix=4,
                                 block_batch=bb)))
            bb4s = min(4, batch)
            out.append((f"four_step/bb{bb4s}",
                        base(plan, algo="four_step", block_batch=bb4s)))
        out.append(("torch", base(plan, backend="torch",
                                  algo=resolve_algo(inner), block_batch=8)))
        if fixed_algo:
            out = [(lbl, c) for lbl, c in out if c.algo == plan.algo]
        return _dedup(out, ("algo", "radix", "block_batch", "backend"))
    if plan.ndim == 1:
        n = plan.n
        if not _is_pow2(n):
            return out                       # naive/bluestein: nothing to tune
        if plan.backend == "cuda":
            for bb in sorted({min(b, batch) for b in (4, 8, 16)}):
                out.append((f"stockham/r4/bb{bb}",
                            base(plan, algo="stockham", radix=4,
                                 block_batch=bb)))
            bb2 = min(8, batch)
            out.append((f"stockham/r2/bb{bb2}",
                        base(plan, algo="stockham", radix=2,
                             block_batch=bb2)))
            bb4s = min(4, batch)
            out.append((f"four_step/bb{bb4s}",
                        base(plan, algo="four_step", block_batch=bb4s)))
        else:
            out.append(("stockham/r4", base(plan, algo="stockham", radix=4)))
            out.append(("stockham/r2", base(plan, algo="stockham", radix=2)))
            out.append(("four_step", base(plan, algo="four_step")))
            if n <= 2048:
                out.append(("naive", base(plan, algo="naive")))
    else:
        if plan.backend == "cuda":
            for bb in sorted({min(b, batch) for b in (1, 2)}):
                out.append((f"fused/bb{bb}",
                            base(plan, algo="fused", block_batch=bb)))
            if _itemsize(plan.dtype) < 4 and not fixed_variant:
                # sub-fp32 GEMM keys also measure the *other* precision
                # variant: which side wins is a measurement question
                other = "plain" if plan.variant == "compensated" \
                    else "compensated"
                out.append((f"fused/{other}/bb1",
                            base(plan, algo="fused", block_batch=1,
                                 variant=other)))
            if plan.ndim == 2:
                out.append(("fused_stockham/bb1",
                            base(plan, algo="fused_stockham", block_batch=1,
                                 variant="plain")))
            out.append(("row_col", base(plan, algo="row_col",
                                        variant="plain")))
        else:
            out.append(("row_col", base(plan, algo="row_col")))
    if fixed_algo:
        out = [(lbl, c) for lbl, c in out if c.algo == plan.algo]
    if fixed_radix:                   # e.g. the "stockham2" radix-2 oracle
        out = [(lbl, c) for lbl, c in out if c.radix == plan.radix]
    # drop configs identical to the default
    return _dedup(out, ("algo", "radix", "block_batch", "variant"))


def _tune_inputs(plan: FFTPlan, batch: int, device):
    """The autotuner's seeded synthetic operands on ``device``: the input,
    and for conv plans the filter half spectrum as the extra operand."""
    dev = repro_torch.device(device)
    rng = np.random.default_rng(0)
    dt = _torch_dtype(plan.dtype)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, dt)

    shp = (batch,) + plan.shape
    if plan.kind in CONV_KINDS:
        x = t(shp)
        hshp = (plan.n // 2 + 1,)
        return x, (SplitComplex(t(hshp), t(hshp)),)
    if plan.kind == "rfft":
        x = t(shp)
        if plan.inverse:                       # half-spectrum input
            hshp = shp[:-1] + (plan.shape[-1] // 2 + 1,)
            x = SplitComplex(t(hshp), t(hshp))
        return x, ()
    return SplitComplex(t(shp), t(shp)), ()


def _model_prune(cands, *, batch: int, prune_k: Optional[int],
                 model_arch: str):
    """Rank candidates with the analytic cost model and keep the top-k.

    The heuristic default (candidate 0) is always kept, so pruning can
    only *add* model-favoured configs to the measured set, never remove
    the config the registry would have used untuned.  Candidates on a
    *different backend* than the default are also always kept: the model
    is an intra-backend ranker, and the cross-backend wall-clock question
    is exactly what it cannot see.  Candidates whose working set busts the
    arch's SRAM budget rank last (predict_cost is +inf for them).  Returns
    (kept, pruned_labels).
    """
    if len(cands) <= 2:
        return cands, []
    from repro_torch.tt.trace import predict_cost
    k = prune_k if prune_k is not None else max(2, (len(cands) + 1) // 2)
    k = max(2, min(k, len(cands)))
    if k >= len(cands):
        return cands, []
    base_backend = cands[0][1].backend
    forced = [i for i in range(1, len(cands))
              if cands[i][1].backend != base_backend]
    costs = [predict_cost(c, arch=model_arch, batch=batch)
             for _, c in cands]
    rest = sorted((i for i in range(1, len(cands)) if i not in forced),
                  key=costs.__getitem__)
    keep_idx = sorted(set([0] + forced + rest[:max(0, k - 1 - len(forced))]))
    kept = [cands[i] for i in keep_idx]
    pruned = [cands[i][0] for i in range(len(cands)) if i not in keep_idx]
    return kept, pruned


def _autotune(key, plan: FFTPlan, *, batch: int = 8,
              fixed_algo: bool = False, fixed_radix: bool = False,
              fixed_variant: bool = False,
              prune: str = "none", prune_k: Optional[int] = None,
              model_arch: str = "tpu_v5e",
              measure_timeout_s: Optional[float] = "config",
              device="cuda") -> FFTPlan:
    """Measure every candidate config (or, with ``prune="model"``, the
    model-ranked top-k) on ``device`` and return the winner (tuned=True).  Candidates that exceed the per-measurement watchdog are
    excluded (one retry first) and named in ``tune_report["timeouts"]``;
    if *every* candidate times out the heuristic default is kept untouched
    (winner ``"default/untimed"``)."""
    x, extra = _tune_inputs(plan, batch, device)
    _AUTOTUNE_RUNS[key] = _AUTOTUNE_RUNS.get(key, 0) + 1
    if measure_timeout_s == "config":
        from repro_torch.resilience import config as _rcfg
        measure_timeout_s = _rcfg.get("measure_timeout_s")
    cands = _candidates(plan, fixed_algo=fixed_algo, fixed_radix=fixed_radix,
                        fixed_variant=fixed_variant, batch=batch)
    n_all = len(cands)
    pruned_labels = []
    if prune == "model":
        cands, pruned_labels = _model_prune(cands, batch=batch,
                                            prune_k=prune_k,
                                            model_arch=model_arch)
    times, timed_out = _time_candidates(
        [c for _, c in cands], x, labels=[lbl for lbl, _ in cands],
        timeout_s=measure_timeout_s, extra=extra)
    report = {label: (round(us, 1) if us != float("inf") else "timeout")
              for (label, _), us in zip(cands, times)}
    report["n_candidates"] = n_all
    report["n_measured"] = len(cands)
    if pruned_labels:
        report["model_pruned"] = "|".join(pruned_labels)
    if timed_out:
        report["timeouts"] = "|".join(timed_out)
    if all(t == float("inf") for t in times):
        # every candidate hung: keep the heuristic default, but mark the
        # key tuned so the pathological measurement is not re-run per call
        report["winner"] = "default/untimed"
        return dataclasses.replace(plan, tuned=True, tune_report=report)
    best = min(range(len(cands)), key=times.__getitem__)
    report["winner"] = cands[best][0]
    return dataclasses.replace(cands[best][1], tuned=True, tune_report=report)


def _port_label(label: str) -> str:
    """A reference candidate label with its backend names mapped."""
    return "/".join(REFERENCE_BACKENDS.get(p, p) for p in label.split("/"))


def plan_from_reference(fields: dict) -> FFTPlan:
    """Build a port plan from a reference plan's ``dataclasses.asdict()``
    (plain values), mapping the backend names ``pallas -> cuda`` and
    ``jnp -> torch``, in the plan and in a tuned plan's ``tune_report``
    (its candidate labels, ``winner``, ``timeouts`` and
    ``model_pruned``)."""
    f = dict(fields)
    f["shape"] = tuple(int(d) for d in f["shape"])
    f["backend"] = REFERENCE_BACKENDS[f["backend"]]
    if f.get("tune_report") is not None:
        report = {}
        for k, v in f["tune_report"].items():
            if k in ("winner", "timeouts", "model_pruned"):
                v = "|".join(_port_label(p) for p in v.split("|"))
            report[_port_label(k)] = v
        f["tune_report"] = report
    return FFTPlan(**f)


def plan_fft(n: int, **kw) -> FFTPlan:
    return FFTPlan.create(n, **kw)


def plan_ifft(n: int, **kw) -> FFTPlan:
    return FFTPlan.create(n, inverse=True, **kw)


def plan_fft2(h: int, w: int, **kw) -> FFTPlan:
    return get_plan((h, w), **kw)


def plan_ifft2(h: int, w: int, **kw) -> FFTPlan:
    return get_plan((h, w), inverse=True, **kw)
