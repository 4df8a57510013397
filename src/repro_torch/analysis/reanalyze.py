"""Count the stored op logs of dry-run records again and refresh the
``loop_aware`` block of each record (counterpart of
:mod:`repro.analysis.reanalyze`, which re-parses stored HLO): a change to
:mod:`repro_torch.analysis.opcount`'s conventions does not need the
cells traced again.

    python -m repro_torch.analysis.reanalyze [--save-dir runs/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from .opcount import count_log


def read_log(path: str):
    """The op log beside a record (``<record>.ops.jsonl.gz``), entry by
    entry."""
    with gzip.open(path, "rt") as f:
        for line in f:
            if line.strip():
                yield json.loads(line)


def reanalyze(save_dir: str = "runs/dryrun") -> int:
    n = 0
    for jf in sorted(glob.glob(os.path.join(save_dir, "*", "*.json"))):
        lf = jf[:-len(".json")] + ".ops.jsonl.gz"
        if not os.path.exists(lf):
            continue
        cost = count_log(read_log(lf))
        with open(jf) as f:
            rec = json.load(f)
        rec["loop_aware"] = cost.loop_aware()
        with open(jf, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--save-dir", default="runs/dryrun")
    args = ap.parse_args(argv)
    print(f"reanalyzed {reanalyze(args.save_dir)} records")


if __name__ == "__main__":
    main()
