"""Tensix backend pipeline: unpacker -> math -> packer as a timeline.

A Tensix core splits one kernel across dedicated backend units — the
unpacker pulls operand tiles from L1 into source registers, the matrix/
vector (FPU/SFPU) unit computes, the packer writes result tiles back to
L1, and the NoC movers stream tiles between L1, DRAM and other cores
(the unit decomposition of tt-sim's ``pe/tensix/backends/``:
unpacker / matrix / vector / packer / mover).  Units run concurrently,
hand tiles through circular buffers, and double-buffering lets tile
``t+1`` be unpacked while tile ``t`` is in the math unit: the pipeline's
steady-state rate is set by its *slowest* unit, which is exactly how the
Tensix "decouple movement from compute" story turns into numbers.

This module is the purely-architectural piece: given per-unit
seconds-per-tile, produce the pipeline timeline.  :mod:`repro_torch.tt.trace`
derives the per-unit costs from an FFT plan's byte/flop counts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

#: Unit order along the pipeline: NoC/DRAM reader, L1 unpacker, FPU/SFPU
#: math, L1 packer, NoC/DRAM writer.
STAGES: Tuple[str, ...] = ("reader", "unpacker", "math", "packer", "writer")

#: Tensix operand granularity: one 32x32 tile.
TILE_DIM = 32
TILE_ELEMS = TILE_DIM * TILE_DIM


@dataclasses.dataclass(frozen=True)
class PipelineTimeline:
    """Timeline of one kernel through the five-unit pipeline."""
    n_tiles: int
    per_tile_s: Dict[str, float]     # seconds each unit spends per tile
    cb_depth: int                    # circular-buffer depth (2 = double buffer)
    fill_s: float                    # time for the first tile to drain through
    steady_tile_s: float             # issue interval once the pipe is full
    total_s: float
    bottleneck: str                  # unit that sets the steady-state rate
    occupancy: Dict[str, float]      # per-unit busy fraction of total_s

    @property
    def movement_bound(self) -> bool:
        """True when a data-movement unit (not math) sets the rate."""
        return self.bottleneck != "math"


def pipeline_timeline(per_tile_s: Dict[str, float], n_tiles: int, *,
                      cb_depth: int = 2) -> PipelineTimeline:
    """Schedule ``n_tiles`` tiles through the unit pipeline.

    With ``cb_depth >= 2`` the circular buffers decouple the units:
    after a fill of one full traversal, tiles complete every
    ``max(unit)`` seconds.  With ``cb_depth == 1`` (no double buffering)
    each tile must fully drain before the next is admitted, so the whole
    pipeline serialises to ``n_tiles * sum(units)`` — the degenerate
    schedule the paper's un-overlapped first designs correspond to.
    """
    assert n_tiles >= 1 and cb_depth >= 1
    per = {s: float(per_tile_s.get(s, 0.0)) for s in STAGES}
    fill = sum(per.values())
    slowest = max(per, key=per.get)
    if cb_depth == 1:
        steady = fill
        total = n_tiles * fill
    else:
        steady = per[slowest]
        total = fill + (n_tiles - 1) * steady
    occupancy = {s: (n_tiles * v) / total if total > 0 else 0.0
                 for s, v in per.items()}
    return PipelineTimeline(n_tiles=n_tiles, per_tile_s=per,
                            cb_depth=cb_depth, fill_s=fill,
                            steady_tile_s=steady, total_s=total,
                            bottleneck=slowest, occupancy=occupancy)


def stage_costs(*, flops: float, dram_in: float, dram_out: float,
                sram_read: float, sram_write: float, arch) -> Dict[str, float]:
    """Aggregate per-unit seconds for one kernel on a Tensix-like device.

    DRAM traffic is shared device-wide (reader/writer = mover units on the
    DRAM-adjacent cores); unpack/pack bandwidth and FLOP/s scale with the
    number of cores the kernel spreads over.
    """
    l1_bw = arch.l1_bw * arch.cores
    return {
        "reader": dram_in / arch.dram_bw if arch.dram_bw else 0.0,
        "unpacker": sram_read / l1_bw if l1_bw else 0.0,
        "math": flops / arch.peak_flops_f32 if arch.peak_flops_f32 else 0.0,
        "packer": sram_write / l1_bw if l1_bw else 0.0,
        "writer": dram_out / arch.dram_bw if arch.dram_bw else 0.0,
    }


def kernel_timeline(*, flops: float, dram_in: float, dram_out: float,
                    sram_read: float, sram_write: float, arch,
                    elem_bytes: int = 4, cb_depth: int = 2) -> PipelineTimeline:
    """Timeline for one kernel: split its aggregate unit costs over the
    32x32-tile stream the units actually hand around."""
    tile_bytes = TILE_ELEMS * elem_bytes
    moved = max(dram_in + dram_out, sram_read + sram_write, tile_bytes)
    n_tiles = max(1, int(moved // tile_bytes))
    total = stage_costs(flops=flops, dram_in=dram_in, dram_out=dram_out,
                        sram_read=sram_read, sram_write=sram_write, arch=arch)
    per_tile = {s: v / n_tiles for s, v in total.items()}
    return pipeline_timeline(per_tile, n_tiles, cb_depth=cb_depth)
