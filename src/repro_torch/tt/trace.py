"""Walk an FFTPlan into a stage-level time / traffic / energy trace
(counterpart of :mod:`repro.tt.trace`).

Each :class:`TraceStage` is one sequentially-executed step of the plan —
a kernel launch group, a global transpose, an HBM round-trip — annotated
with the FLOPs and bytes it moves at every level of the hierarchy (DRAM,
NoC, core-local SRAM), its modelled wall time on the chosen
:class:`repro_torch.tt.arch.Arch`, and its energy integral.  The fused 2-D
kernel traces to a *single* stage while the transpose-based path traces
to four: the collapse of the stage list is the paper's §5 optimisation
made visible.

Time per stage:

- ``kind == "tensix"`` — the five-unit pipeline timeline of
  :mod:`repro_torch.tt.tensix` (unpacker/math/packer with double-buffered
  circular buffers; DRAM movers at the ends), plus NoC time where a
  stage crosses the mesh.
- ``kind in ("tpu", "cpu")`` — a per-stage roofline:
  max(compute, DRAM, SRAM, NoC) + launch overhead.

Energy per stage: pJ/op coefficients from the arch table times the op
counts, plus idle power burning for the stage's duration.  SRAM
high-water marks are checked against the arch budget (1.5 MB/core L1 on
Tensix, 16 MiB VMEM on TPU): a plan that does not fit gets
``fits=False`` and an infinite :func:`predict_cost`, which is how the
ROADMAP's "does the 1024x1024 fused tile fit?" question becomes a model
query.  ``prune="model"`` in :func:`repro_torch.core.plan.get_plan`
ranks autotune candidates with :func:`predict_cost`.

The arches are the reference's model inputs (:mod:`repro_torch.tt.arch`):
every number here is a prediction for the arch it names, never a
measurement of the card the port runs on.  Plans are the port's
(``backend`` ``"torch"`` / ``"cuda"`` in place of ``"jnp"`` /
``"pallas"``); tracing resolves plans and launches nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from .arch import Arch, get_arch
from . import noc as ttnoc
from . import tensix as tt


def _log2(n: int) -> int:
    return int(n).bit_length() - 1


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def fft_flops(n: int) -> float:
    """Canonical 5 N log2 N real-op count of one complex FFT."""
    return 5.0 * n * _log2(n) if n > 1 else 0.0


def stockham_stage_count(n: int, radix: int) -> int:
    if radix == 2:
        return _log2(n)
    from repro_torch.core.twiddle import stockham_radices
    return len(stockham_radices(n))


def twiddle_bytes(n: int, radix: int, *, elem_bytes: int = 4) -> int:
    """Bytes of the packed twiddle tables staged alongside the data
    (wr+wi planes; see :mod:`repro_torch.core.twiddle`)."""
    if n < 4:
        return 2 * max(n // 4, 1) * elem_bytes
    if radix == 2:
        return 2 * _log2(n) * (n // 2) * elem_bytes
    s4 = _log2(n) // 2
    return 2 * s4 * 3 * (n // 4) * elem_bytes


@dataclasses.dataclass(frozen=True)
class TraceStage:
    name: str
    seconds: float
    flops: float = 0.0
    dram_bytes: float = 0.0          # DRAM read + write
    noc_bytes: float = 0.0           # bytes crossing the NoC/mesh
    sram_bytes: float = 0.0          # core-local SRAM traffic (read + write)
    sram_high_water: int = 0         # peak live working set of this stage
    energy_j: float = 0.0
    bound: str = ""                  # what set the stage's rate

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class PlanTrace:
    arch: str
    shape: Tuple[int, ...]
    batch: int
    algo: str
    radix: int
    block_batch: int
    backend: str
    stages: Tuple[TraceStage, ...]
    sram_budget: int
    variant: str = "plain"           # GEMM kernels: "plain" | "compensated"

    @property
    def seconds(self) -> float:
        return sum(s.seconds for s in self.stages)

    @property
    def flops(self) -> float:
        return sum(s.flops for s in self.stages)

    @property
    def dram_bytes(self) -> float:
        return sum(s.dram_bytes for s in self.stages)

    @property
    def noc_bytes(self) -> float:
        return sum(s.noc_bytes for s in self.stages)

    @property
    def energy_j(self) -> float:
        return sum(s.energy_j for s in self.stages)

    @property
    def sram_high_water(self) -> int:
        return max((s.sram_high_water for s in self.stages), default=0)

    @property
    def fits(self) -> bool:
        return self.sram_high_water <= self.sram_budget

    @property
    def power_w(self) -> float:
        return self.energy_j / self.seconds if self.seconds > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": list(self.shape), "batch": self.batch,
            "algo": self.algo, "radix": self.radix,
            "block_batch": self.block_batch, "backend": self.backend,
            "variant": self.variant,
            "seconds": self.seconds, "flops": self.flops,
            "dram_bytes": self.dram_bytes, "noc_bytes": self.noc_bytes,
            "energy_j": self.energy_j, "power_w": self.power_w,
            "sram_high_water": self.sram_high_water,
            "sram_budget": self.sram_budget, "fits": self.fits,
            "stages": [s.to_dict() for s in self.stages],
        }


# ---------------------------------------------------------------------------
# Stage construction
# ---------------------------------------------------------------------------

def _mk_stage(name: str, arch: Arch, *, flops: float = 0.0,
              dram_in: float = 0.0, dram_out: float = 0.0,
              sram_read: float = 0.0, sram_write: float = 0.0,
              sram_high_water: int = 0, noc_bytes: float = 0.0,
              noc_s: float = 0.0, launches: int = 1,
              grid_steps: int = 0) -> TraceStage:
    overhead = launches * arch.launch_overhead_s \
        + grid_steps * arch.launch_overhead_s / 8.0
    if arch.kind == "tensix":
        tl = tt.kernel_timeline(flops=flops, dram_in=dram_in,
                                dram_out=dram_out, sram_read=sram_read,
                                sram_write=sram_write, arch=arch)
        busy = tl.total_s
        bound = tl.bottleneck if busy >= noc_s else "noc"
        seconds = max(busy, noc_s) + overhead
    else:
        terms = {
            "math": flops / arch.peak_flops_f32,
            "dram": (dram_in + dram_out) / arch.dram_bw,
            "sram": (sram_read + sram_write) / (arch.l1_bw * arch.cores),
            "noc": noc_s,
        }
        bound = max(terms, key=terms.get)
        seconds = max(terms.values()) + overhead
    energy = (flops * arch.energy_per_flop_j
              + (dram_in + dram_out) * arch.energy_per_dram_byte_j
              + noc_bytes * arch.energy_per_noc_byte_j
              + (sram_read + sram_write) * arch.energy_per_sram_byte_j
              + arch.idle_power_w * seconds)
    return TraceStage(name=name, seconds=seconds, flops=flops,
                      dram_bytes=dram_in + dram_out, noc_bytes=noc_bytes,
                      sram_bytes=sram_read + sram_write,
                      sram_high_water=int(sram_high_water),
                      energy_j=energy, bound=bound)


def _fft_pass_stage(name: str, arch: Arch, *, n: int, rows: int, algo: str,
                    radix: int, block_batch: int,
                    elem_bytes: int = 8) -> TraceStage:
    """One batched 1-D FFT pass: ``rows`` transforms of length ``n``.

    ``elem_bytes`` is per split-complex element (re+im), 8 for float32.
    Covers every 1-D algo the plan registry dispatches; used both for 1-D
    plans and for the row/column passes of the 2-D row-column path.
    """
    if algo == "auto":
        from repro_torch.core.fft1d import resolve_algo
        algo = resolve_algo(n)
    plane = float(rows) * n * elem_bytes
    bb = max(1, min(block_batch, rows))
    grid_steps = math.ceil(rows / bb)
    half = elem_bytes // 2                    # bytes per component plane elem

    if algo in ("stockham", "stockham2", "cooley_tukey", "cooley_tukey_fused"):
        r = 2 if algo == "stockham2" else radix
        stages = stockham_stage_count(n, r)
        if algo.startswith("cooley_tukey"):   # explicit reorder copies on top
            stages = _log2(n) * (2 if algo == "cooley_tukey" else 1)
            r = 2
        tw = twiddle_bytes(n, r, elem_bytes=half)
        return _mk_stage(name, arch, flops=rows * fft_flops(n),
                         dram_in=plane + tw, dram_out=plane,
                         sram_read=stages * plane, sram_write=stages * plane,
                         sram_high_water=bb * n * elem_bytes * 2 + tw,
                         grid_steps=grid_steps)
    if algo == "four_step":
        from repro_torch.core.fft1d import _best_split
        n1 = _best_split(n)
        n2 = n // max(n1, 1)
        if n1 <= 1:                            # prime: bluestein fallback
            return _fft_pass_stage(name, arch, n=n, rows=rows,
                                   algo="bluestein", radix=radix,
                                   block_batch=block_batch,
                                   elem_bytes=elem_bytes)
        flops = rows * (8.0 * n * (n1 + n2) + 6.0 * n)
        mats = (n1 * n1 + n2 * n2) * elem_bytes
        return _mk_stage(name, arch, flops=flops,
                         dram_in=plane + mats, dram_out=plane,
                         sram_read=3 * plane, sram_write=3 * plane,
                         sram_high_water=bb * n * elem_bytes * 2 + mats,
                         grid_steps=grid_steps)
    if algo == "naive":
        mat = float(n) * n * elem_bytes
        return _mk_stage(name, arch, flops=rows * 8.0 * n * n,
                         dram_in=plane + mat, dram_out=plane,
                         sram_read=plane + mat, sram_write=plane,
                         sram_high_water=int(mat) + bb * n * elem_bytes * 2,
                         grid_steps=grid_steps)
    if algo == "bluestein":
        m = 1 << int(math.ceil(math.log2(max(2 * n - 1, 2))))
        mplane = float(rows) * m * elem_bytes
        stages = 3 * stockham_stage_count(m, 4)
        tw = twiddle_bytes(m, 4, elem_bytes=half)
        return _mk_stage(name, arch, flops=rows * (3 * fft_flops(m) + 10.0 * m),
                         dram_in=plane + tw, dram_out=plane,
                         sram_read=stages * mplane, sram_write=stages * mplane,
                         sram_high_water=bb * m * elem_bytes * 2 + tw,
                         grid_steps=grid_steps)
    raise ValueError(f"no trace model for 1-D algo {algo!r}")


def _transpose_stage(name: str, arch: Arch, *, h: int, w: int, batch: int,
                     elem_bytes: int = 8) -> TraceStage:
    """The global transpose between the two passes of the row-column path:
    a full plane DRAM round-trip, and on a Tensix mesh additionally an
    all-to-all of (P-1)/P of the plane across the NoC (§5)."""
    plane = float(batch) * h * w * elem_bytes
    noc_bytes = noc_s = 0.0
    if arch.kind == "tensix":
        x = ttnoc.global_transpose(h, w, arch=arch, elem_bytes=elem_bytes)
        noc_bytes = batch * x["noc_bytes"]
        noc_s = batch * x["seconds"]
    return _mk_stage(name, arch, dram_in=plane, dram_out=plane,
                     noc_bytes=noc_bytes, noc_s=noc_s,
                     sram_high_water=2 * tt.TILE_ELEMS * elem_bytes)


# ---------------------------------------------------------------------------
# Plan walkers
# ---------------------------------------------------------------------------

def plan_elem_bytes(plan) -> int:
    """Bytes per split-complex element (re+im) of this plan's dtype (a
    torch dtype or its name): 8 for float32, 4 for bfloat16/float16 — how
    the tracer knows a bf16 plan moves half the DRAM/NoC/SRAM bytes of an
    f32 one."""
    from repro_torch.dist.compression import torch_dtype
    return 2 * torch_dtype(getattr(plan, "dtype", "float32")).itemsize


def trace_plan(plan, *, arch="wormhole_n300", batch: int = 1) -> PlanTrace:
    """Trace one :class:`repro_torch.core.plan.FFTPlan` (any object exposing
    ``shape / algo / radix / block_batch / backend``, plus ``kind`` and
    ``inverse`` for rfft plans) on ``arch``.

    ``batch`` is the number of independent transforms executed together
    (the leading batch dim).  rfft-kind plans trace their actual schedule
    — inner half-length complex pass plus the O(n) untangle, half-width
    spectrum planes downstream — so the half-spectrum saving shows up in
    the bytes, not as a fudge factor.  Element width comes from the plan's
    dtype (:func:`plan_elem_bytes`): a bfloat16 plan traces at half the
    DRAM/NoC/SRAM cost of the float32 plan of the same shape.
    """
    a = get_arch(arch)
    elem = plan_elem_bytes(plan)
    variant = getattr(plan, "variant", "plain")
    stages: List[TraceStage] = []

    if getattr(plan, "kind", "c2c") == "rfft":
        stages = _rfft_stages(plan, a, batch=batch, elem_bytes=elem)
    elif getattr(plan, "kind", "c2c").startswith("conv"):
        stages = _conv_stages(plan, a, batch=batch, elem_bytes=elem)
    elif len(plan.shape) == 1:
        n = plan.shape[0]
        stages.append(_fft_pass_stage(
            f"fft1d_{plan.algo}", a, n=n, rows=batch, algo=plan.algo,
            radix=plan.radix, block_batch=plan.block_batch,
            elem_bytes=elem))
    elif len(plan.shape) == 2:
        h, w = plan.shape
        if plan.algo == "fused":
            stages.append(_gemm2d_stage(a, h=h, w=w, batch=batch,
                                        block_batch=plan.block_batch,
                                        variant=variant, elem_bytes=elem))
        elif plan.algo == "fused_stockham":
            stages.append(_fused2d_stage(a, h=h, w=w, batch=batch,
                                         radix=plan.radix,
                                         block_batch=plan.block_batch,
                                         elem_bytes=elem))
        elif plan.algo in ("row_col", "auto"):
            bb = plan.block_batch
            stages.append(_fft_pass_stage(
                "row_fft", a, n=w, rows=batch * h,
                algo="stockham" if plan.backend == "cuda" else "auto",
                radix=plan.radix, block_batch=bb, elem_bytes=elem))
            stages.append(_transpose_stage("global_transpose", a, h=h, w=w,
                                           batch=batch, elem_bytes=elem))
            stages.append(_fft_pass_stage(
                "col_fft", a, n=h, rows=batch * w,
                algo="stockham" if plan.backend == "cuda" else "auto",
                radix=plan.radix, block_batch=bb, elem_bytes=elem))
            stages.append(_transpose_stage("output_transpose", a, h=w, w=h,
                                           batch=batch, elem_bytes=elem))
        else:
            raise ValueError(f"no trace model for 2-D algo {plan.algo!r}")
    else:
        d, h, w = plan.shape
        if plan.algo == "fused":
            stages.append(_gemm3d_stage(a, d=d, h=h, w=w, batch=batch,
                                        block_batch=plan.block_batch,
                                        variant=variant, elem_bytes=elem))
        elif plan.algo in ("row_col", "auto"):
            bb = plan.block_batch
            p_algo = "stockham" if plan.backend == "cuda" else "auto"
            # the direct path's per-axis schedule: W pass in place, then
            # each of the H and D passes brackets its 1-D pass with a
            # swap-in/swap-out relayout pair — four full-volume
            # round-trips the fused kernel's absorbed contractions skip
            stages.append(_fft_pass_stage(
                "w_fft", a, n=w, rows=batch * d * h, algo=p_algo,
                radix=plan.radix, block_batch=bb, elem_bytes=elem))
            stages.append(_transpose_stage("transpose_wh_in", a, h=h, w=w,
                                           batch=batch * d,
                                           elem_bytes=elem))
            stages.append(_fft_pass_stage(
                "h_fft", a, n=h, rows=batch * d * w, algo=p_algo,
                radix=plan.radix, block_batch=bb, elem_bytes=elem))
            stages.append(_transpose_stage("transpose_wh_out", a, h=w, w=h,
                                           batch=batch * d,
                                           elem_bytes=elem))
            stages.append(_transpose_stage("transpose_wd_in", a, h=d,
                                           w=h * w, batch=batch,
                                           elem_bytes=elem))
            stages.append(_fft_pass_stage(
                "d_fft", a, n=d, rows=batch * h * w, algo=p_algo,
                radix=plan.radix, block_batch=bb, elem_bytes=elem))
            stages.append(_transpose_stage("transpose_wd_out", a, h=h * w,
                                           w=d, batch=batch,
                                           elem_bytes=elem))
        else:
            raise ValueError(f"no trace model for 3-D algo {plan.algo!r}")

    return PlanTrace(arch=a.name, shape=tuple(plan.shape), batch=batch,
                     algo=plan.algo, radix=plan.radix,
                     block_batch=plan.block_batch, backend=plan.backend,
                     stages=tuple(stages), sram_budget=a.sram_budget,
                     variant=variant)


def _untangle_stage(name: str, a: Arch, *, n: int, rows: int,
                    elem_bytes: int) -> TraceStage:
    """The O(n) rfft pack/untangle (or irfft Hermitian extension): one
    pointwise pass over the half spectrum."""
    half = float(rows) * (n // 2 + 1) * elem_bytes
    return _mk_stage(name, a, flops=10.0 * rows * (n // 2),
                     dram_in=half, dram_out=half,
                     sram_read=half, sram_write=half,
                     sram_high_water=2 * (n // 2 + 1) * elem_bytes)


def _rfft_stages(plan, a: Arch, *, batch: int,
                 elem_bytes: int) -> List[TraceStage]:
    """The real-input schedules as executed by :mod:`repro_torch.core.fft1d`
    / :mod:`repro_torch.core.fft2d`: ``plan.algo`` is the *inner* complex algo —
    half-length (n/2) for the forward packed rfft, full-length for the
    inverse's Hermitian-extended ifft.  The 2-D row pass works on the
    real axis, the column pass on the (w/2+1)-wide half spectrum — the
    halved-transpose-bytes saving the ROADMAP notes for dist.rfft2.
    ``algo="fused"`` (the real-input kernel) traces to ONE stage
    at half-width bytes (:func:`_rfft_fused2d_stage`).
    """
    kw = dict(radix=plan.radix, block_batch=plan.block_batch,
              elem_bytes=elem_bytes)
    if plan.ndim == 2 and plan.algo == "fused":
        h, w = plan.shape
        return [_rfft_fused2d_stage(a, h=h, w=w, batch=batch,
                                    inverse=plan.inverse,
                                    block_batch=plan.block_batch,
                                    elem_bytes=elem_bytes)]
    if plan.ndim == 1:
        n = plan.shape[0]
        inner = n if plan.inverse else n // 2
        tag = "irfft" if plan.inverse else "rfft"
        return [
            _fft_pass_stage(f"{tag}_inner_{plan.algo}", a, n=inner,
                            rows=batch, algo=plan.algo, **kw),
            _untangle_stage(f"{tag}_untangle", a, n=n, rows=batch,
                            elem_bytes=elem_bytes),
        ]
    h, w = plan.shape
    wh = w // 2 + 1
    if plan.inverse:
        return [
            _fft_pass_stage("col_ifft", a, n=h, rows=batch * wh,
                            algo="auto", **kw),
            _transpose_stage("global_transpose", a, h=h, w=wh, batch=batch,
                             elem_bytes=elem_bytes),
            _fft_pass_stage(f"irfft_rows_{plan.algo}", a, n=w,
                            rows=batch * h, algo=plan.algo, **kw),
            _untangle_stage("irfft_extend", a, n=w, rows=batch * h,
                            elem_bytes=elem_bytes),
        ]
    return [
        _fft_pass_stage(f"rfft_rows_{plan.algo}", a, n=w // 2,
                        rows=batch * h, algo=plan.algo, **kw),
        _untangle_stage("rfft_untangle", a, n=w, rows=batch * h,
                        elem_bytes=elem_bytes),
        _transpose_stage("global_transpose", a, h=h, w=wh, batch=batch,
                         elem_bytes=elem_bytes),
        _fft_pass_stage("col_fft", a, n=h, rows=batch * wh, algo="auto",
                        **kw),
    ]


def _fused2d_stage(a: Arch, *, h: int, w: int, batch: int, radix: int,
                   block_batch: int, elem_bytes: int) -> TraceStage:
    """The Stockham-stage fused 2-D kernel (the explicit-algo oracle,
    ``algo="fused_stockham"``): one stage, 2 DRAM plane traversals
    (read + write), everything else VMEM/L1-resident — row pass, in-SRAM
    tile transpose, column pass (:mod:`repro_torch.kernels.fft2d_fused`)."""
    plane = float(h) * w * elem_bytes              # one split-complex image
    total = batch * plane
    bb = max(1, min(block_batch, batch))
    grid_steps = math.ceil(batch / bb)
    half = elem_bytes // 2
    tw = twiddle_bytes(w, radix, elem_bytes=half) \
        + twiddle_bytes(h, radix, elem_bytes=half)
    s_passes = stockham_stage_count(w, radix) + stockham_stage_count(h, radix)
    # each Stockham stage reads+writes the tile in SRAM; the tile transpose
    # adds one more read+write — the round-trip this kernel keeps off DRAM
    sram_rw = (s_passes + 1) * total
    # ping-pong working set: the live tile plus the stage being written,
    # i.e. 2 planes per image in the block, plus both twiddle tables —
    # 2 x 8 MiB at 1024x1024/bb=1, the ROADMAP's 16 MiB VMEM question
    high_water = 2 * bb * int(h * w * elem_bytes) + tw
    return _mk_stage("fused_fft2d_stockham", a,
                     flops=batch * fft_flops(h * w),
                     dram_in=total + tw, dram_out=total,
                     sram_read=sram_rw, sram_write=sram_rw,
                     sram_high_water=high_water, grid_steps=grid_steps)


def fourstep_table_bytes(n: int, *, elem_bytes: int = 8,
                         factors=None) -> int:
    """Bytes of the one-level four-step operand tables the fused rfft
    kernel stages per axis: both factor DFT matrices plus the (n1, n2)
    inter-factor twiddle, re+im planes (``elem_bytes`` per split-complex
    element, matching :func:`repro_torch.kernels.rfft2d_fused.
    fourstep_tables_np`).
    ``factors`` overrides the 2-D kernel's split rule (the 3-D kernel's
    leaf crossover sits one octave lower)."""
    if factors is None:
        from repro_torch.kernels.rfft2d_fused import fourstep_factors
        factors = fourstep_factors(n)
    n1, n2 = factors
    return (n1 * n1 + n2 * n2 + n1 * n2) * elem_bytes


def _fourstep_pass_flops(n: int, rows: float, factors=None) -> float:
    """Real-op count of ``rows`` one-level four-step passes of length
    ``n``: both factor DFT matmuls (8 real ops per complex MAC) plus the
    pointwise inter-factor twiddle — the 8*n*(n1+n2) + 6*n accounting of
    :func:`_fft_pass_stage`'s four_step arm."""
    if factors is None:
        from repro_torch.kernels.rfft2d_fused import fourstep_factors
        factors = fourstep_factors(n)
    n1, n2 = factors
    return rows * (8.0 * n * (n1 + n2) + 6.0 * n)


def _gemm2d_stage(a: Arch, *, h: int, w: int, batch: int, block_batch: int,
                  variant: str, elem_bytes: int) -> TraceStage:
    """The GEMM-formulated fused 2-D kernel
    (:mod:`repro_torch.kernels.fft2d_gemm`, ``algo="fused"``): ONE stage, 2 DRAM
    plane traversals plus the four-step operand tables, both passes dense
    DFT matmuls with the column transpose absorbed into the contraction.
    The ``compensated`` variant doubles the table bytes (split hi/lo
    pairs) and the table-side flops (two-operand reconstruction + fp32
    accumulation) but keeps the *resident tile* at the storage dtype —
    which is why the bf16 1024x1024 working set fits the 16 MiB budget
    the fp32 one busts."""
    plane = float(h) * w * elem_bytes              # one split-complex image
    total = batch * plane
    bb = max(1, min(block_batch, batch))
    grid_steps = math.ceil(batch / bb)
    tw = fourstep_table_bytes(w, elem_bytes=elem_bytes) \
        + fourstep_table_bytes(h, elem_bytes=elem_bytes)
    flops = batch * (_fourstep_pass_flops(w, float(h))
                     + _fourstep_pass_flops(h, float(w)))
    if variant == "compensated":
        tw *= 2
        flops *= 2
    # each GEMM pass streams its tile through SRAM ~3x: matmul read +
    # write plus the inter-factor twiddle round
    sram_rw = 2 * 3 * total
    # ping-pong working set: live tile + the pass being written, plus the
    # staged operand tables
    high_water = 2 * bb * int(h * w * elem_bytes) + tw
    return _mk_stage("fused_fft2d", a, flops=flops,
                     dram_in=total + tw, dram_out=total,
                     sram_read=sram_rw, sram_write=sram_rw,
                     sram_high_water=high_water, grid_steps=grid_steps)


def _gemm3d_stage(a: Arch, *, d: int, h: int, w: int, batch: int,
                  block_batch: int, variant: str,
                  elem_bytes: int) -> TraceStage:
    """The fused 3-D kernel (:mod:`repro_torch.kernels.fft3d_fused`,
    ``algo="fused"``): ONE stage for all three four-step GEMM passes on a
    VMEM-resident (bb, d, h, w) brick — 2 DRAM volume traversals plus
    three axes of operand tables, both inter-pass relayouts absorbed into
    left-side contractions (vs the row-column schedule's four full-volume
    round-trips)."""
    vol = float(d) * h * w * elem_bytes            # one split-complex volume
    total = batch * vol
    bb = max(1, min(block_batch, batch))
    grid_steps = math.ceil(batch / bb)
    from repro_torch.kernels.fft3d_fused import fourstep_factors3
    fw, fh, fd = (fourstep_factors3(w), fourstep_factors3(h),
                  fourstep_factors3(d))
    tw = (fourstep_table_bytes(w, elem_bytes=elem_bytes, factors=fw)
          + fourstep_table_bytes(h, elem_bytes=elem_bytes, factors=fh)
          + fourstep_table_bytes(d, elem_bytes=elem_bytes, factors=fd))
    flops = batch * (_fourstep_pass_flops(w, float(d) * h, factors=fw)
                     + _fourstep_pass_flops(h, float(d) * w, factors=fh)
                     + _fourstep_pass_flops(d, float(h) * w, factors=fd))
    if variant == "compensated":
        tw *= 2
        flops *= 2
    sram_rw = 3 * 3 * total
    high_water = 2 * bb * int(d * h * w * elem_bytes) + tw
    return _mk_stage("fused_fft3d", a, flops=flops,
                     dram_in=total + tw, dram_out=total,
                     sram_read=sram_rw, sram_write=sram_rw,
                     sram_high_water=high_water, grid_steps=grid_steps)


def _rfft_fused2d_stage(a: Arch, *, h: int, w: int, batch: int,
                        inverse: bool, block_batch: int,
                        elem_bytes: int) -> TraceStage:
    """The fused real-input 2-D kernel
    (:mod:`repro_torch.kernels.rfft2d_fused`): ONE stage moving a real plane on
    one side and a half spectrum on the other — ~half the complex fused
    kernel's DRAM traffic per image — with the half-width tile as the
    VMEM working set (which is what lets the 1024x1024 fp32 case fit the
    16 MiB budget the complex kernel busts).  Both passes are four-step
    DFT matmuls; FLOPs follow the same 8*n*(n1+n2) accounting as
    :func:`_fft_pass_stage`'s four_step arm.
    """
    from repro_torch.kernels.rfft2d_fused import fourstep_factors
    wh = w // 2 + 1
    half = elem_bytes // 2
    real_plane = float(batch) * h * w * half        # the real input/output
    spec_plane = float(batch) * h * wh * elem_bytes  # the half spectrum
    bb = max(1, min(block_batch, batch))
    grid_steps = math.ceil(batch / bb)
    tw = fourstep_table_bytes(w, elem_bytes=elem_bytes) \
        + fourstep_table_bytes(h, elem_bytes=elem_bytes)
    n1w, n2w = fourstep_factors(w)
    n1h, n2h = fourstep_factors(h)
    flops = batch * ((h / 2) * (8.0 * w * (n1w + n2w) + 6.0 * w)  # row pairs
                     + 10.0 * h * wh                              # untangle
                     + wh * (8.0 * h * (n1h + n2h) + 6.0 * h))    # columns
    # each pass streams its tile through SRAM ~3x (matmul in/out + twiddle
    # round), the untangle adds one half-spectrum round-trip
    row_tile = float(batch) * (h // 2) * w * elem_bytes
    sram_rw = 3 * row_tile + 3 * spec_plane + spec_plane
    # working set: the half-width column tile ping-pong (its (w/2+1) * h
    # spectrum is the widest live value) plus the four-step tables
    high_water = 2 * bb * h * wh * elem_bytes + tw
    name = "fused_irfft2d" if inverse else "fused_rfft2d"
    dram_in = (spec_plane if inverse else real_plane) + tw
    dram_out = real_plane if inverse else spec_plane
    return _mk_stage(name, a, flops=flops, dram_in=dram_in,
                     dram_out=dram_out, sram_read=sram_rw,
                     sram_write=sram_rw, sram_high_water=high_water,
                     grid_steps=grid_steps)


def _fftconv_fused_stage(a: Arch, *, m: int, rows: int,
                         elem_bytes: int) -> TraceStage:
    """The fused spectral-convolution kernel
    (:mod:`repro_torch.kernels.fftconv_fused`, conv-kind plans with
    ``algo="fused"``): ONE stage moving one real plane in, the packed
    filter pair (E, F) in, and one real plane out — the product spectrum never
    exists outside VMEM, versus the unfused path's six-plane traffic
    (real in / spectrum out / spectrum + filter in / product out / product
    in / real out; see :func:`_conv_stages`).  ``rows`` is the number of
    convolved signals resident per grid step (the wrapper's row axis —
    e.g. the SSM channel count); the byte accounting mirrors the kernel's
    real operand buffers exactly so the benchmark's model-vs-counted
    traffic ratio is 1.0 by construction."""
    hm = m // 2
    half = elem_bytes // 2
    real_plane = float(rows) * m * half
    # the packed-domain filter operands E and F: two complex length-m/2
    # vectors per row (untangle, pointwise multiply and pre-tangle all
    # folded in — see fftconv_fused.pack_filter)
    ef_bytes = 2.0 * rows * hm * elem_bytes
    # both passes run at the packed half length: forward + inverse
    # length-m/2 four-step tables only
    tw = 2 * fourstep_table_bytes(hm, elem_bytes=elem_bytes)
    flops = (2.0 * _fourstep_pass_flops(hm, float(rows))  # fwd + inv passes
             + 14.0 * rows * hm                  # E*Z + F*conj(rev Z)
             + 2.0 * rows * hm)                  # 2/m output scale
    packed = float(rows) * hm * elem_bytes               # the complex rows
    # each four-step pass streams its (equal-byte) complex tile through
    # SRAM ~3x; the packed-domain multiply-add adds one spectrum round
    sram_rw = 2 * 3 * packed + 3 * packed
    # working set: ping-pong of the packed complex rows plus the staged
    # packed filter pair and both table sets
    high_water = 2 * rows * hm * elem_bytes + int(ef_bytes) + tw
    return _mk_stage("fused_fftconv", a, flops=flops,
                     dram_in=real_plane + ef_bytes + tw,
                     dram_out=real_plane,
                     sram_read=sram_rw, sram_write=sram_rw,
                     sram_high_water=high_water, grid_steps=1)


def _conv_stages(plan, a: Arch, *, batch: int,
                 elem_bytes: int) -> List[TraceStage]:
    """conv-kind plans (fused rfft -> multiply -> irfft).  ``algo="fused"``
    traces to ONE VMEM-resident stage; ``algo="unfused"`` traces the
    registry-composed baseline — forward packed rfft, a pointwise multiply
    with its own spectrum round-trip, and the Hermitian-extended inverse —
    whose summed DRAM bytes are the six-plane traffic the fused kernel
    deletes."""
    m = plan.n
    if plan.algo == "fused":
        return [_fftconv_fused_stage(a, m=m, rows=batch,
                                     elem_bytes=elem_bytes)]
    hm = m // 2
    spec = float(batch) * (hm + 1) * elem_bytes
    kw = dict(radix=plan.radix, block_batch=plan.block_batch,
              elem_bytes=elem_bytes)
    return [
        _fft_pass_stage("conv_rfft_inner", a, n=m // 2, rows=batch,
                        algo="auto", **kw),
        _untangle_stage("conv_rfft_untangle", a, n=m, rows=batch,
                        elem_bytes=elem_bytes),
        # pointwise multiply: product + filter spectra in, product out
        _mk_stage("conv_pointwise_mul", a, flops=6.0 * batch * (hm + 1),
                  dram_in=2 * spec, dram_out=spec,
                  sram_read=2 * spec, sram_write=spec,
                  sram_high_water=3 * (hm + 1) * elem_bytes),
        _fft_pass_stage("conv_irfft_inner", a, n=m, rows=batch,
                        algo="auto", **kw),
        _untangle_stage("conv_irfft_extend", a, n=m, rows=batch,
                        elem_bytes=elem_bytes),
    ]


def predict_cost(plan, *, arch="wormhole_n300", batch: int = 1) -> float:
    """Model cost for autotune ranking: predicted seconds, or +inf when the
    working set busts the arch's SRAM budget (an unrunnable plan must never
    outrank a runnable one)."""
    t = trace_plan(plan, arch=arch, batch=batch)
    return t.seconds if t.fits else float("inf")


# ---------------------------------------------------------------------------
# Distributed pencil schedules (multi-chip)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistTrace:
    """A multi-chip pencil-FFT schedule walked stage by stage: per-shard
    local plan stages (through :func:`trace_plan`) interleaved with the
    inter-chip exchange legs (priced by :func:`repro_torch.tt.noc.
    all_to_all_s`
    on the arch's ethernet/ICI hop table).  Per-device accounting: stage
    seconds are wall time (every chip runs its shard in parallel), and
    ``exchange_wire_bytes`` is what one device puts on the wire."""
    arch: str
    shape: Tuple[int, ...]
    devices: int
    kind: str                        # "pfft2" | "prfft2"
    method: str                      # compression wire format of the exchange
    backend: str
    elem_bytes: int
    batch: int
    stages: Tuple[TraceStage, ...]
    sram_budget: int

    @property
    def seconds(self) -> float:
        return sum(s.seconds for s in self.stages)

    @property
    def flops(self) -> float:
        return sum(s.flops for s in self.stages)

    @property
    def dram_bytes(self) -> float:
        return sum(s.dram_bytes for s in self.stages)

    @property
    def energy_j(self) -> float:
        return sum(s.energy_j for s in self.stages)

    @property
    def exchange_wire_bytes(self) -> float:
        """Bytes one device ships across chips, all exchange legs summed."""
        return sum(s.noc_bytes for s in self.stages
                   if s.name.startswith("exchange"))

    @property
    def exchange_seconds(self) -> float:
        return sum(s.seconds for s in self.stages
                   if s.name.startswith("exchange"))

    @property
    def sram_high_water(self) -> int:
        return max((s.sram_high_water for s in self.stages), default=0)

    @property
    def fits(self) -> bool:
        return self.sram_high_water <= self.sram_budget

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": list(self.shape),
            "devices": self.devices, "kind": self.kind,
            "method": self.method, "backend": self.backend,
            "elem_bytes": self.elem_bytes, "batch": self.batch,
            "seconds": self.seconds, "flops": self.flops,
            "dram_bytes": self.dram_bytes, "energy_j": self.energy_j,
            "exchange_wire_bytes": self.exchange_wire_bytes,
            "exchange_seconds": self.exchange_seconds,
            "sram_high_water": self.sram_high_water,
            "sram_budget": self.sram_budget, "fits": self.fits,
            "stages": [s.to_dict() for s in self.stages],
        }


def _exchange_stage(name: str, a: Arch, *, payload_bytes: float,
                    devices: int) -> TraceStage:
    """One inter-chip all_to_all leg.  ``payload_bytes`` is the per-device
    payload already in its wire format, so it is priced method="none" here
    (no double compression discount)."""
    x = ttnoc.all_to_all_s(float(payload_bytes), devices, a, multichip=True)
    e_link = a.energy_per_link_byte_j or a.energy_per_noc_byte_j
    energy = x["wire_bytes"] * e_link + a.idle_power_w * x["seconds"]
    return TraceStage(name=name, seconds=x["seconds"],
                      noc_bytes=x["wire_bytes"], energy_j=energy,
                      bound="link")


def trace_dist(shape, *, devices: int, arch="wormhole_n300",
               real: bool = False, method: str = "none",
               dtype="float32", backend: str = "torch",
               transposed_output: bool = True, batch: int = 1) -> DistTrace:
    """Trace one :func:`repro_torch.dist.pencil.pfft2` (``real=False``) or
    :func:`~repro_torch.dist.pencil.prfft2` (``real=True``) schedule end-to-end
    on ``devices`` chips of ``arch``.

    Local passes resolve through the plan registry — the *same* entries
    the pencil functions execute (rfft-kind rows for ``real=True``) — and
    are traced per shard with :func:`trace_plan`; the exchange legs take
    their per-device payload from
    :func:`repro_torch.dist.pencil.exchange_bytes` (so model and wire log can
    never drift) and their time from the multi-chip hop table.  The
    headline query: ``trace_dist(.., real=True)`` predicts half the
    exchange wire bytes of the complex schedule.
    """
    from repro_torch.core import plan as plan_lib
    from repro_torch.dist.compression import torch_dtype
    from repro_torch.dist.pencil import exchange_bytes

    a = get_arch(arch)
    h, w = (int(d) for d in shape)
    devices = int(devices)
    cols_total = w // 2 if real else w          # pencils after the exchange
    assert h % devices == 0 and cols_total % devices == 0, \
        (shape, devices, real)
    elem = 2 * torch_dtype(dtype).itemsize
    kind = "prfft2" if real else "pfft2"
    stages: List[TraceStage] = []

    row_plan = plan_lib.get_plan((w,), dtype=dtype, backend=backend,
                                 kind="rfft" if real else "c2c")
    rt = trace_plan(row_plan, arch=a, batch=batch * h // devices)
    stages += [dataclasses.replace(s, name=f"rows/{s.name}")
               for s in rt.stages]

    payload = batch * exchange_bytes(h, w, devices, real=real, method=method,
                                     dtype=dtype)
    stages.append(_exchange_stage("exchange_a2a", a, payload_bytes=payload,
                                  devices=devices))

    cols = batch * cols_total // devices
    col_plan = plan_lib.get_plan((h,), dtype=dtype, backend=backend)
    ct = trace_plan(col_plan, arch=a, batch=cols)
    stages += [dataclasses.replace(s, name=f"cols/{s.name}")
               for s in ct.stages]

    if real:
        # the local O(H) Hermitian untangle of the packed DC/Nyquist column
        stages.append(_untangle_stage("unpack_nyquist", a, n=2 * h,
                                      rows=batch, elem_bytes=elem))
    if not transposed_output:
        stages.append(_exchange_stage("exchange_a2a_out", a,
                                      payload_bytes=payload,
                                      devices=devices))

    return DistTrace(arch=a.name, shape=(h, w), devices=devices, kind=kind,
                     method=method, backend=backend, elem_bytes=elem,
                     batch=batch, stages=tuple(stages),
                     sram_budget=a.sram_budget)
