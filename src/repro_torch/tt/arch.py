"""Parameterised hardware tables for the data-movement/energy model.

Counterpart of :mod:`repro.tt.arch`, copied entry for entry.  One
:class:`Arch` record per machine the model reasons about: the paper's
Wormhole n300 and its Xeon Platinum 8160 baseline (§6), the earlier
Grayskull e150 ("Accelerating stencils on the Tenstorrent Grayskull",
Brown & Barton 2024), and the TPU v5e of the reference's roofline.  These
are the model's inputs, not facts about the card the port runs on: no
entry describes an H100, and a prediction is always labelled with the
arch it models.

Three kinds of numbers live here, kept deliberately separate:

- **rate parameters** (peak FLOP/s, DRAM/NoC/L1 bandwidths, launch
  overhead) feed the analytic time model in :mod:`repro_torch.tt.trace`;
- **energy coefficients** (pJ per flop / DRAM byte / NoC byte / SRAM
  byte, plus idle power) feed its energy integral;
- **published anchors** (``published``) are the paper's §6 *measured*
  figures — 2-D FFT wall time and device power under load — which
  :mod:`repro_torch.tt.report` uses to reproduce the Wormhole-vs-Xeon table
  exactly (~8x power, ~2.8x energy) without trusting the optimistic
  analytic rates.

Rates are aggregate per device (bytes/s, FLOP/s); ``l1_bw`` is per core.
Custom entries register via :func:`register_arch` (see README,
"Modelling the Wormhole").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

KIB = 1024
MIB = 1024 * 1024


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    kind: str                       # "tensix" | "tpu" | "cpu"
    cores: int                      # Tensix cores / TensorCores / CPU cores
    clock_hz: float
    peak_flops_f32: float           # aggregate device FLOP/s
    peak_flops_bf16: float
    dram_bw: float                  # aggregate device DRAM bytes/s
    noc_bw: float                   # per-link on-chip NoC bytes/s
    link_bw: float                  # off-chip interconnect bytes/s (ICI/PCIe/UPI)
    l1_bytes: int                   # per-core scratch: Tensix L1 / TPU VMEM / CPU L2
    l1_bw: float                    # per-core scratch bandwidth bytes/s
    dram_bytes: int                 # device memory capacity
    power_w: float                  # measured device power under FFT load
    idle_power_w: float
    launch_overhead_s: float        # per-kernel dispatch cost
    noc_latency_s: float            # per-hop NoC latency
    energy_per_flop_j: float
    energy_per_dram_byte_j: float
    energy_per_noc_byte_j: float
    energy_per_sram_byte_j: float
    noc_grid: Tuple[int, int] = (1, 1)   # physical core grid the NoC routes over
    # -- multi-chip interconnect (the dist.pencil exchange fabric) ----------
    # Wormhole chips talk over 100 Gb/s ethernet links (16 per chip on the
    # n300 generation); TPUs over ICI; CPUs over UPI.  ``eth_bw`` is the
    # per-link rate, ``eth_links`` how many a collective can stripe across,
    # ``eth_latency_s`` the per-hop cost on the chip grid
    # (:func:`chip_grid` / :data:`MULTICHIP_GRIDS`).  Zero falls back to
    # the single-link ``link_bw`` / ``noc_latency_s`` numbers.
    eth_bw: float = 0.0                  # per ethernet/ICI link bytes/s
    eth_links: int = 1                   # parallel links per chip
    eth_latency_s: float = 0.0           # per chip-to-chip hop
    energy_per_link_byte_j: float = 0.0  # serdes energy; 0 -> NoC coefficient
    published: dict = dataclasses.field(default_factory=dict)

    @property
    def sram_budget(self) -> int:
        """Scratch budget one kernel working set is checked against.

        TPU Pallas kernels stage the whole block in one core's VMEM, so the
        budget is per-core; a Tensix/CPU kernel spreads its working set over
        every core's L1/L2.
        """
        if self.kind == "tpu":
            return self.l1_bytes
        return self.l1_bytes * self.cores

    def peak_flops(self, dtype: str = "float32") -> float:
        return self.peak_flops_bf16 if "bf16" in dtype or "bfloat16" in dtype \
            else self.peak_flops_f32


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------
# Wormhole n300: two Wormhole ASICs, 64 usable Tensix cores each @ ~1 GHz,
# 1.5 MB L1 per core, 24 GB GDDR6 at 576 GB/s aggregate, 32 B/cycle NoC
# links.  The `published` block is the paper's §6 measurement: the n300 is
# ~2.8x *slower* than the Xeon on the 2-D FFT but draws ~8x less power, so
# it spends ~2.8x less energy.
WORMHOLE_N300 = Arch(
    name="wormhole_n300", kind="tensix", cores=128, clock_hz=1.0e9,
    peak_flops_f32=8.2e12, peak_flops_bf16=131e12,
    dram_bw=576e9, noc_bw=32e9, link_bw=32e9,
    l1_bytes=int(1.5 * MIB), l1_bw=64e9, dram_bytes=int(24e9),
    power_w=20.0, idle_power_w=12.0,
    launch_overhead_s=5e-6, noc_latency_s=9e-9,
    energy_per_flop_j=1.2e-12, energy_per_dram_byte_j=15e-12,
    energy_per_noc_byte_j=1.5e-12, energy_per_sram_byte_j=0.4e-12,
    noc_grid=(8, 16),
    eth_bw=12.5e9, eth_links=16, eth_latency_s=1.0e-6,
    energy_per_link_byte_j=30e-12,
    published={
        "workload": "fft2d_f32",
        "source": "paper §6 (Wormhole n300 measured)",
        "time_ms": {256: 0.31, 512: 1.36, 1024: 5.9},
        "power_w": 20.0,
    },
)

# Grayskull e150: 120 Tensix @ 1.2 GHz, 1 MB L1, 8 GB LPDDR4 at 118 GB/s —
# the generation the stencil paper (Brown & Barton 2024) characterised.
GRAYSKULL_E150 = Arch(
    name="grayskull_e150", kind="tensix", cores=120, clock_hz=1.2e9,
    peak_flops_f32=3.5e12, peak_flops_bf16=55e12,
    dram_bw=118.4e9, noc_bw=38.4e9, link_bw=16e9,
    l1_bytes=1 * MIB, l1_bw=51e9, dram_bytes=int(8e9),
    power_w=75.0, idle_power_w=35.0,
    launch_overhead_s=6e-6, noc_latency_s=9e-9,
    energy_per_flop_j=1.6e-12, energy_per_dram_byte_j=22e-12,
    energy_per_noc_byte_j=1.8e-12, energy_per_sram_byte_j=0.5e-12,
    noc_grid=(10, 12),
    eth_bw=16e9, eth_links=1, eth_latency_s=2.0e-6,   # PCIe only, no eth mesh
    energy_per_link_byte_j=35e-12,
)

# TPU v5e: the numbers the reference's roofline hardcoded —
# 197 TFLOP/s bf16 (98.5 f32), 819 GB/s HBM, ~50 GB/s/link ICI, 16 GB HBM,
# 215 W — plus the ~16 MiB per-core VMEM budget the fused 2-D kernel's tile
# working set is checked against (ROADMAP: 1024x1024 footprint question).
TPU_V5E = Arch(
    name="tpu_v5e", kind="tpu", cores=1, clock_hz=0.94e9,
    peak_flops_f32=98.5e12, peak_flops_bf16=197e12,
    dram_bw=819e9, noc_bw=819e9, link_bw=50e9,
    l1_bytes=16 * MIB, l1_bw=3e12, dram_bytes=int(16e9),
    power_w=215.0, idle_power_w=60.0,
    launch_overhead_s=3e-6, noc_latency_s=1e-9,
    energy_per_flop_j=0.45e-12, energy_per_dram_byte_j=7e-12,
    energy_per_noc_byte_j=2e-12, energy_per_sram_byte_j=0.15e-12,
    eth_bw=50e9, eth_links=4, eth_latency_s=1.0e-6,   # ICI 2-D torus
    energy_per_link_byte_j=10e-12,
)

# Xeon Platinum 8160: the paper's CPU baseline — 24 cores @ 2.1 GHz base,
# AVX-512 (2x FMA/core), 6-channel DDR4-2666 (~128 GB/s), 1 MB L2/core.
# `published` holds the paper's measured FFTW wall time and package power.
XEON_8160 = Arch(
    name="xeon_8160", kind="cpu", cores=24, clock_hz=2.1e9,
    peak_flops_f32=3.2e12, peak_flops_bf16=3.2e12,
    dram_bw=128e9, noc_bw=96e9, link_bw=20.8e9,
    l1_bytes=1 * MIB, l1_bw=100e9, dram_bytes=int(192e9),
    power_w=160.0, idle_power_w=55.0,
    launch_overhead_s=0.5e-6, noc_latency_s=40e-9,
    energy_per_flop_j=20e-12, energy_per_dram_byte_j=25e-12,
    energy_per_noc_byte_j=4e-12, energy_per_sram_byte_j=1.5e-12,
    noc_grid=(4, 6),
    eth_bw=20.8e9, eth_links=3, eth_latency_s=0.5e-6,  # UPI
    energy_per_link_byte_j=20e-12,
    published={
        "workload": "fft2d_f32",
        "source": "paper §6 (24-core Xeon Platinum, FFTW)",
        "time_ms": {256: 0.11, 512: 0.48, 1024: 2.1},
        "power_w": 160.0,
    },
)


ARCHS: Dict[str, Arch] = {a.name: a for a in
                          (WORMHOLE_N300, GRAYSKULL_E150, TPU_V5E, XEON_8160)}

_ALIASES = {
    "wormhole": "wormhole_n300", "n300": "wormhole_n300",
    "grayskull": "grayskull_e150", "e150": "grayskull_e150",
    "tpu": "tpu_v5e", "v5e": "tpu_v5e",
    "xeon": "xeon_8160", "cpu": "xeon_8160",
}


def get_arch(name) -> Arch:
    """Look up an entry by name or alias; Arch instances pass through."""
    if isinstance(name, Arch):
        return name
    key = _ALIASES.get(str(name).lower(), str(name).lower())
    try:
        return ARCHS[key]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)} "
                       f"(aliases: {sorted(_ALIASES)})") from None


def register_arch(arch: Arch, *aliases: str) -> Arch:
    """Add a custom entry (and optional aliases) to the table."""
    ARCHS[arch.name] = arch
    for a in aliases:
        _ALIASES[a.lower()] = arch.name
    return arch


# ---------------------------------------------------------------------------
# Multi-chip hop table
# ---------------------------------------------------------------------------
# How `devices` chips are wired for the dist.pencil exchanges: the canonical
# near-square meshes (an n300 board is 2 chips; a TT "nebula" rack 2x4; a
# galaxy 4x8; TPU ICI slices are 2-D tori).  :func:`chip_grid` answers for
# any count, falling back to the most-square factorisation, and
# :func:`repro_torch.tt.noc.eth_hops` turns the grid into a mean hop count.

MULTICHIP_GRIDS: Dict[int, Tuple[int, int]] = {
    1: (1, 1), 2: (1, 2), 4: (2, 2), 8: (2, 4),
    16: (4, 4), 32: (4, 8), 64: (8, 8),
}


def chip_grid(devices: int) -> Tuple[int, int]:
    """The (rows, cols) chip mesh `devices` chips are arranged in."""
    devices = int(devices)
    assert devices >= 1, devices
    if devices in MULTICHIP_GRIDS:
        return MULTICHIP_GRIDS[devices]
    r = int(devices ** 0.5)
    while devices % r:
        r -= 1
    return (r, devices // r)


def hw_table(name="tpu_v5e") -> dict:
    """The reference roofline's ``HW`` dict shape, for any arch.

    Kept as the single bridge so the roofline keeps its public key names
    while the numbers live here.
    """
    a = get_arch(name)
    return {
        "peak_flops_bf16": a.peak_flops_bf16,
        "peak_flops_f32": a.peak_flops_f32,
        "hbm_bw": a.dram_bw,
        "ici_bw": a.link_bw,
        "hbm_per_chip": float(a.dram_bytes),
        "chip_power_w": a.power_w,
    }
