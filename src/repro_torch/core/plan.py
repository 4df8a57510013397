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

Not ported yet (raises ``NotImplementedError``): ``tune=True`` and wisdom
(ROADMAP 'Modules to port' item 10).
``FFTPlan.__call__`` runs ``_execute`` directly; the guarded executor is
item 9.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .complexmath import SplitComplex
from . import fft1d
from .fft1d import KERNEL_INNER_ALGOS, resolve_algo


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


PlanKey = Tuple[Tuple[int, ...], str, bool, str, str]

_PLAN_CACHE: Dict[PlanKey, "FFTPlan"] = {}      # algo="auto" plans
_OVERRIDE_CACHE: Dict[tuple, "FFTPlan"] = {}    # (key, algo, radix) overrides

CONV_KINDS = ("conv_causal", "conv_circular")
PLAN_KINDS = ("c2c", "rfft") + CONV_KINDS
BACKENDS = ("torch", "cuda")
# the reference's backend names and the port's
REFERENCE_BACKENDS = {"jnp": "torch", "pallas": "cuda"}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return getattr(torch, _dtype_name(dtype)).itemsize


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
               tune: bool = False) -> "FFTPlan":
        """1-D plan through the registry."""
        return get_plan((n,), dtype=dtype, inverse=inverse, algo=algo,
                        backend=backend, tune=tune)

    def __call__(self, x, *args):
        return self._execute(x, *args)

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
             variant: str = "auto", tune: bool = False) -> FFTPlan:
    """Return the interned plan for this key, resolving it on first
    request (same resolution rules as the reference's ``get_plan`` for c2c,
    rfft and conv keys).  Requests with an explicit ``algo`` or ``variant``
    are interned separately and never replace the auto-resolved plan."""
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
    if tune:
        raise NotImplementedError("plan autotuning and wisdom are not ported "
                                  "yet: ROADMAP 'Modules to port' item 10")
    # the kernels need power-of-two tile dims of at least 2
    kernel_ok = all(_is_pow2(d) and d >= 2 for d in shape)
    radix = 4
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
            resolved, radix = "stockham", 2
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
    return plan


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _OVERRIDE_CACHE.clear()
    from . import fftconv as _fftconv   # deferred: fftconv imports plan
    _fftconv.clear_spectrum_cache()     # per-plan filter spectra key on plans


def plan_cache_size() -> int:
    return len(_PLAN_CACHE)


def plan_from_reference(fields: dict) -> FFTPlan:
    """Build a port plan from a reference plan's ``dataclasses.asdict()``
    (plain values), mapping the backend names ``pallas -> cuda`` and
    ``jnp -> torch``."""
    f = dict(fields)
    f["shape"] = tuple(int(d) for d in f["shape"])
    f["backend"] = REFERENCE_BACKENDS[f["backend"]]
    return FFTPlan(**f)


def plan_fft(n: int, **kw) -> FFTPlan:
    return FFTPlan.create(n, **kw)


def plan_ifft(n: int, **kw) -> FFTPlan:
    return FFTPlan.create(n, inverse=True, **kw)


def plan_fft2(h: int, w: int, **kw) -> FFTPlan:
    return get_plan((h, w), **kw)


def plan_ifft2(h: int, w: int, **kw) -> FFTPlan:
    return get_plan((h, w), inverse=True, **kw)
