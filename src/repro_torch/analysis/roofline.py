"""Roofline model: three terms per (arch x shape x mesh) from a dry-run
record (counterpart of :mod:`repro.analysis.roofline`).

    compute term    = HLO_FLOPs / (chips x peak FLOP/s)
    memory term     = HLO_bytes / (chips x HBM bw)
    collective term = collective_bytes / (chips x link bw)

The numerators are a record's per-device counts (``loop_aware.flops``,
``traffic_bytes``, ``collective_total``: the reference's field names, so
the two packages' records read the same), so the terms are per chip.
Hardware numbers come from the port's copy of the reference's multi-arch
tables (:mod:`repro_torch.tt.arch`: Wormhole n300, Grayskull e150, TPU
v5e, Xeon 8160) and from :data:`H100_SXM`, the card the port runs on; the
module-level ``HW`` dict is the TPU v5e entry, as in the reference — pass
``arch=`` to :func:`fft2d_roofline` / :func:`roofline_terms` for any other
machine.

MODEL_FLOPS = 6*N_active*tokens (train) / 2*N_active*tokens (inference);
the ratio MODEL_FLOPS / HLO_FLOPs exposes remat/dispatch waste.  The
``fraction`` column is ideal_time / max(term)s, the share of roofline the
program could reach if perfectly overlapped.
"""
from __future__ import annotations

import glob
import json
import math
import os
from typing import List, Optional

from repro_torch.tt import arch as tt_arch

# One H100 SXM, NVIDIA's data sheet (SXM part, dense rates without
# sparsity, at its 700 W limit): 67 TFLOP/s fp32 outside the tensor cores,
# 989 TFLOP/s bf16, 80 GB of HBM3 at 3.35 TB/s, NVLink 900 GB/s to the
# other cards of the host, 450 GB/s each way.  The card the port is
# measured on reads "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi
# --query-gpu=name,power.limit --format=csv,noheader); a card set below
# 700 W runs slower than these peaks.
H100_SXM = {
    "peak_flops_bf16": 989e12,
    "peak_flops_f32": 67e12,
    "hbm_bw": 3.35e12,
    "ici_bw": 450e9,
    "hbm_per_chip": 80e9,
    "chip_power_w": 700.0,
}
_OWN = {"h100_sxm": H100_SXM, "h100": H100_SXM}


def hw_table(arch: str = "tpu_v5e") -> dict:
    """The roofline's hardware dict for ``arch``: :data:`H100_SXM`, or any
    :mod:`repro_torch.tt.arch` entry or alias."""
    own = _OWN.get(str(arch).lower())
    return dict(own) if own is not None else tt_arch.hw_table(arch)


HW = hw_table("tpu_v5e")


def fft2d_traffic_bytes(h: int, w: int, *, elem_bytes: int = 8,
                        fused: bool = False) -> float:
    """Modelled HBM traffic of one (h, w) split-complex 2-D FFT.

    One "plane" is the full split-complex image (re+im), h*w*elem_bytes with
    elem_bytes=8 for float32 re+im.  The row-column path streams the plane
    through HBM three times (row pass, global transpose, column pass, each
    read and written) plus the second output transpose: 8 plane
    traversals.  A fused kernel reads and writes the plane once: 2
    traversals, a 4x traffic reduction.  Per-stage butterfly traffic stays
    on chip in both and is not counted.
    """
    plane = float(h) * float(w) * float(elem_bytes)
    if fused:
        return 2.0 * plane                       # one HBM read + one write
    return 8.0 * plane                           # rows r/w, T r/w, cols r/w, T r/w


def fft2d_roofline(h: int, w: int, *, elem_bytes: int = 8,
                   fused: bool = False, flops: Optional[float] = None,
                   arch: str = "tpu_v5e") -> dict:
    """Roofline terms for the 2-D FFT under the traffic model above, on any
    entry of :func:`hw_table` (default the reference's v5e)."""
    hw = hw_table(arch)
    n = h * w
    if flops is None:
        flops = 5.0 * n * math.log2(n)           # canonical 5 N log2 N
    traffic = fft2d_traffic_bytes(h, w, elem_bytes=elem_bytes, fused=fused)
    compute_s = flops / hw["peak_flops_f32"]
    memory_s = traffic / hw["hbm_bw"]
    step_s = max(compute_s, memory_s)
    return {
        "arch": arch,
        "flops": flops,
        "traffic_bytes": traffic,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "step_s": step_s,
        "dominant": "memory_s" if memory_s >= compute_s else "compute_s",
        "energy_j": step_s * hw["chip_power_w"],
    }


def roofline_terms(rec: dict, *, arch: str = "tpu_v5e") -> Optional[dict]:
    """The three terms of a dry-run record and what they imply; None when
    the record has no loop-aware counts."""
    la = rec.get("loop_aware") or {}
    if "flops" not in la:
        return None
    hw = hw_table(arch)
    chips = rec["devices"] if rec["mesh"] == "2x16x16" else 256
    # per-device numbers from the per-device module
    peak = (hw["peak_flops_bf16"] if rec.get("dtype") == "bfloat16"
            else hw["peak_flops_f32"])
    compute_s = la["flops"] / peak
    memory_s = la["traffic_bytes"] / hw["hbm_bw"]
    collective_s = la["collective_total"] / hw["ici_bw"]
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)

    tokens = (rec["global_batch"] * rec["seq_len"]
              if rec["kind"] in ("train", "prefill") else rec["global_batch"])
    mult = 6 if rec["kind"] == "train" else 2
    model_flops = mult * rec["n_active"] * tokens
    hlo_total = la["flops"] * chips
    ideal_s = model_flops / (chips * peak)
    if rec["kind"] == "decode":
        # decode is bandwidth-bound by construction: every active param is
        # read once a token, so the memory roofline is the honest ideal
        pbytes = 2 if rec.get("dtype") == "bfloat16" else 4
        ideal_mem = rec["n_active"] * pbytes / (chips * hw["hbm_bw"])
        ideal_s = max(ideal_s, ideal_mem)
    step_s = max(terms.values())
    return dict(
        terms,
        dominant=dominant,
        model_flops=model_flops,
        hlo_flops_total=hlo_total,
        useful_ratio=model_flops / hlo_total if hlo_total else 0.0,
        ideal_s=ideal_s,
        step_s=step_s,
        fraction=ideal_s / step_s if step_s else 0.0,
        chips=chips,
        energy_j=step_s * chips * hw["chip_power_w"],
    )


def load_records(save_dir: str = "runs/dryrun", mesh: str = "16x16",
                 include_variants: bool = False) -> List[dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(save_dir, mesh, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if rec.get("tag") and not include_variants:
            continue                      # variants are compared apart
        out.append(rec)
    return out


def markdown_table(save_dir: str = "runs/dryrun", mesh: str = "16x16",
                   arch: str = "tpu_v5e") -> str:
    rows = ["| arch | shape | compute (s) | memory (s) | collective (s) | "
            "dominant | useful ratio | roofline frac | note |",
            "|---|---|---|---|---|---|---|---|---|"]
    for rec in load_records(save_dir, mesh):
        t = roofline_terms(rec, arch=arch)
        if t is None:
            rows.append(f"| {rec['arch']} | {rec['shape']} | - | - | - | "
                        f"parse-error | - | - | |")
            continue
        note = _note(rec, t)
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {t['compute_s']:.3e} | "
            f"{t['memory_s']:.3e} | {t['collective_s']:.3e} | "
            f"{t['dominant'].replace('_s','')} | {t['useful_ratio']:.2f} | "
            f"{t['fraction']:.3f} | {note} |")
    return "\n".join(rows)


def _note(rec: dict, t: dict) -> str:
    if t["dominant"] == "collective_s":
        return "shrink/overlap collectives"
    if t["dominant"] == "memory_s":
        if rec["kind"] == "decode":
            return "decode is HBM-bound by nature (weights+cache read/token)"
        return "fuse/cast to cut HBM traffic"
    if t["useful_ratio"] < 0.5:
        return "recompute/dispatch overhead dominates HLO flops"
    return "near compute roofline"


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--save-dir", default="runs/dryrun")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--arch", default="tpu_v5e",
                    help="h100_sxm or any repro_torch.tt.arch entry "
                         "(wormhole_n300, xeon_8160, ...)")
    args = ap.parse_args(argv)
    print(markdown_table(args.save_dir, args.mesh, args.arch))


if __name__ == "__main__":
    main()
