"""Compare dry-run records, a baseline and its variants (counterpart of
:mod:`repro.analysis.compare`).

    python -m repro_torch.analysis.compare runs/dryrun/16x16/A.json \
        runs/dryrun/16x16/B.json [--arch h100_sxm]
"""
from __future__ import annotations

import json
import sys

from .roofline import HW, hw_table


def row(path: str, hw: dict = HW) -> dict:
    """One record's three terms and its temporaries, on ``hw`` (the
    reference's TPU v5e by default)."""
    with open(path) as f:
        rec = json.load(f)
    la = rec["loop_aware"]
    peak = (hw["peak_flops_bf16"] if rec.get("dtype") == "bfloat16"
            else hw["peak_flops_f32"])
    return {
        "name": path.split("/")[-1].replace(".json", ""),
        "compute_s": la["flops"] / peak,
        "memory_s": la["traffic_bytes"] / hw["hbm_bw"],
        "collective_s": la["collective_total"] / hw["ici_bw"],
        "temp_gb": rec.get("memory", {}).get("temp_size_in_bytes", 0) / 2**30,
    }


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    hw = HW
    if "--arch" in argv:
        i = argv.index("--arch")
        hw = hw_table(argv[i + 1])
        del argv[i:i + 2]
    rows = [row(p, hw) for p in argv]
    base = rows[0]
    print(f"{'variant':44s} {'compute':>9s} {'memory':>9s} {'coll':>9s} "
          f"{'step*':>9s} {'temp GB':>8s}")
    for r in rows:
        step = max(r["compute_s"], r["memory_s"], r["collective_s"])
        base_step = max(base["compute_s"], base["memory_s"],
                        base["collective_s"])
        print(f"{r['name']:44s} {r['compute_s']:9.2f} {r['memory_s']:9.2f} "
              f"{r['collective_s']:9.2f} {step:9.2f} {r['temp_gb']:8.1f}"
              + (f"  ({base_step/step:.2f}x)" if r is not rows[0] else ""))


if __name__ == "__main__":
    main()
