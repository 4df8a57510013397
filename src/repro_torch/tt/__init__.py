"""repro_torch.tt — analytical Wormhole/Tensix data-movement & energy model
(counterpart of :mod:`repro.tt`).

The paper's central claim is about *data movement and energy*, not raw
speed: the Tensix architecture decouples movement from compute, and the
Wormhole n300 draws ~8x less power and ~2.8x less energy than a 24-core
Xeon on the 2-D FFT (§6).  This package turns that claim — and the §5
data-movement bottlenecks — into testable model queries:

- :mod:`~repro_torch.tt.arch`    parameterised hardware tables (Wormhole
                                n300, Grayskull e150, TPU v5e, Xeon 8160)
                                with peak FLOP/s, DRAM/NoC bandwidths,
                                power and pJ/op energy terms, plus the
                                paper's published §6 measurement anchors.
- :mod:`~repro_torch.tt.tensix`  the five-unit unpacker -> math -> packer
                                backend pipeline as a timeline with
                                circular-buffer double-buffering.
- :mod:`~repro_torch.tt.noc`     tile-granular NoC transfer /
                                global-transpose / all_to_all model
                                (compressed collectives reuse
                                :func:`repro_torch.dist.compression.
                                wire_bytes`).
- :mod:`~repro_torch.tt.trace`   walk a port :class:`FFTPlan` into a
                                stage-level trace: per-stage bytes,
                                seconds, SRAM high-water mark vs budget,
                                energy integral.
- :mod:`~repro_torch.tt.report`  markdown/JSON emitters reproducing the
                                paper's Wormhole-vs-Xeon table
                                (``python -m repro_torch.tt.report``).

Consumer: the plan autotuner's ``prune="model"`` mode
(:func:`repro_torch.core.plan.get_plan`) ranks candidates with
:func:`repro_torch.tt.trace.predict_cost` before measuring only the top-k.
Every number the model gives is a prediction for the arch it names (the
reference's tables); no arch describes the card the port runs on.
"""
from . import arch, noc, report, tensix, trace
from .arch import Arch, ARCHS, chip_grid, get_arch, register_arch, hw_table
from .tensix import PipelineTimeline, pipeline_timeline
from .trace import (DistTrace, PlanTrace, TraceStage, plan_elem_bytes,
                    predict_cost, trace_dist, trace_plan)

__all__ = [
    "arch", "noc", "report", "tensix", "trace",
    "Arch", "ARCHS", "chip_grid", "get_arch", "register_arch", "hw_table",
    "PipelineTimeline", "pipeline_timeline",
    "DistTrace", "PlanTrace", "TraceStage", "plan_elem_bytes",
    "trace_plan", "trace_dist", "predict_cost",
]
