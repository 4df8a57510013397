"""Config registry: ``--arch <id>`` resolves here (counterpart of
:mod:`repro.configs`; the port keeps its own copies of the configs, with
the reference's backend names mapped: ``"pallas"`` is ``"cuda"``).

Each assigned architecture carries its own shape set (the assignment table);
``shapes_for(arch)`` returns the runnable cells and ``SKIPPED_CELLS`` records
the skipped ones with reasons (DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig

from . import (fnet_demo, h2o_danube_18b, hubert_xlarge, internvl2_76b,
               nemotron4_340b, phi35_moe, qwen15_4b, qwen3_moe_235b,
               ssm_demo, starcoder2_15b, xlstm_350m, zamba2_27b)

REGISTRY: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (qwen3_moe_235b, phi35_moe, internvl2_76b, h2o_danube_18b,
              nemotron4_340b, qwen15_4b, starcoder2_15b, zamba2_27b,
              hubert_xlarge, xlstm_350m, fnet_demo, ssm_demo)
}

ASSIGNED = [
    "qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b", "internvl2-76b",
    "h2o-danube-1.8b", "nemotron-4-340b", "qwen1.5-4b", "starcoder2-15b",
    "zamba2-2.7b", "hubert-xlarge", "xlstm-350m",
]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    shape: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# archs whose mixer is sub-quadratic (SSM / hybrid / sliding-window):
# these run long_500k; pure full-attention archs skip it.
SUBQUADRATIC = {"zamba2-2.7b", "xlstm-350m", "h2o-danube-1.8b"}
ENCODER_ONLY = {"hubert-xlarge"}

SKIPPED_CELLS: List[Tuple[str, str, str]] = []   # (arch, shape, reason)
for _a in ASSIGNED:
    if _a in ENCODER_ONLY:
        SKIPPED_CELLS.append((_a, "decode_32k", "encoder-only: no decode step"))
        SKIPPED_CELLS.append((_a, "long_500k", "encoder-only: no decode step"))
    elif _a not in SUBQUADRATIC:
        SKIPPED_CELLS.append((_a, "long_500k",
                              "pure full-attention arch: 524k dense KV cache "
                              "out of scope per assignment"))


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def shapes_for(arch: str) -> List[ShapeCell]:
    skipped = {s for a, s, _ in SKIPPED_CELLS if a == arch}
    return [c for n, c in SHAPES.items() if n not in skipped]


def all_cells(include_skipped: bool = False):
    """Every (arch, shape) cell; skipped ones only if requested."""
    out = []
    for a in ASSIGNED:
        skipped = {s for aa, s, _ in SKIPPED_CELLS if aa == a}
        for n, c in SHAPES.items():
            if n in skipped and not include_skipped:
                continue
            out.append((a, c))
    return out
