"""Time the spectral server of one checkout of the port on the card, to
compare two commits within one call.

    python3 tools/serve_ab.py <tree>

``<tree>/src/repro_torch`` is imported and the serving kernels are built
into ``<tree>/build``.  The buckets and the closed loop's mix are
``chip_smoke.py``'s ``serve_path`` (16 1024^2 complex, real and
inverse-real images a dispatch, 4 2^20-point transforms; 96 requests, 32
outstanding, 1000^2 ones padded up).  After one loop that is thrown away,
each of ``LOOPS`` loops runs on a fresh, pre-warmed, threaded server.
Prints one JSON line: the tree, the card's nvidia-smi name and power
limit, and for each loop requests/s, p50/p99 latency, the wall, and each
bucket's mean service time (staged to drained) and occupancy.  Unpack the
parent into a directory that .gitignore lists and alternate the trees,
one process each:

    mkdir -p build/ab_parent
    git archive <parent> src/repro_torch | tar -x -C build/ab_parent
    for t in build/ab_parent . . build/ab_parent; do
        python3 tools/serve_ab.py $t; done
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = sys.argv[1]
sys.path.insert(0, ROOT + "/src")
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.serve.spectral import (BucketConfig, MixItem,  # noqa: E402
                                        SpectralServer, closed_loop)

LOOPS = 3
SOURCES = ("fft2d_gemm", "rfft2d_fused", "fft_fourstep")


def one_loop(buckets, mix, requests, seed):
    with SpectralServer(buckets, unmatched="pad_up", device="cuda") as srv:
        result = srv.result
        srv.result = lambda rid, timeout=None: result(
            rid, timeout=CS.SERVE_WAIT_S if timeout is None else timeout)
        s = closed_loop(srv, mix, requests=requests,
                        concurrency=CS.SERVE_CONCURRENCY, seed=seed,
                        rid_prefix="ab")
        snap = srv.snapshot()
    if snap["totals"]["fallback_served"] or srv.degraded_buckets:
        raise RuntimeError(f"the server fell back: {srv.degraded_buckets}")
    return {"requests_per_s": s["achieved_qps"], "p50_ms": s["p50_ms"],
            "p99_ms": s["p99_ms"], "wall_s": s["wall_s"],
            "service_mean_ms": {
                lbl: sec["latency"]["service"]["mean_ms"]
                for lbl, sec in snap["buckets"].items()
                if sec["counters"]["completed"]},
            "occupancy_mean": {
                lbl: sec["gauges"]["batch_occupancy"]["mean"]
                for lbl, sec in snap["buckets"].items()
                if sec["counters"]["completed"]}}


def main():
    if not torch.cuda.is_available():
        print("serve_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    _build.build_all(SOURCES)
    buckets = [BucketConfig(s, kind=k, inverse=i, max_batch=b)
               for s, k, i, b in CS.SERVE_BUCKETS]
    mix = [MixItem(s, k, inverse=i, weight=w) for s, k, i, w in CS.SERVE_MIX]
    one_loop(buckets, mix, CS.SERVE_CONCURRENCY, CS.SERVE_SEED)
    loops = [one_loop(buckets, mix, CS.SERVE_REQUESTS, CS.SERVE_SEED + i)
             for i in range(LOOPS)]
    print(json.dumps({"tree": ROOT, "nvidia_smi": smi, "loops": loops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
