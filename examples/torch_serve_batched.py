"""Batched spectral serving on the PyTorch port (counterpart of
``examples/serve_batched.py``): a ragged fft2/rfft2 request mix through
the continuous-batching :class:`repro_torch.serve.spectral.SpectralServer`
(shape-bucket scheduling, pipelined host<->device execution, pre-warmed
plans), finishing with the per-bucket latency snapshot.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cuda|cpu]
"""
import argparse
import json

from repro_torch.serve.spectral import (BucketConfig, MixItem,
                                        SpectralServer, closed_loop)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--pad-up", action="store_true",
                    help="admit off-bucket shapes by zero-padding up")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    buckets = [
        BucketConfig((64, 64), kind="c2c"),
        BucketConfig((64, 64), kind="rfft"),
        BucketConfig((128, 128), kind="c2c"),
    ]
    # a ragged mix: two bucket shapes, complex and real transforms; with
    # --pad-up a 48x48 archetype rides the 64x64 bucket (padded_up counter)
    mix = [MixItem((64, 64), "c2c"), MixItem((64, 64), "rfft"),
           MixItem((128, 128), "c2c", weight=0.5)]
    if args.pad_up:
        mix.append(MixItem((48, 48), "c2c", weight=0.5))

    with SpectralServer(buckets, device=args.device,
                        unmatched="pad_up" if args.pad_up else "reject"
                        ) as srv:
        rep = srv.prewarm_report
        print(f"[serve] pre-warm: {len(rep.entries)} buckets in "
              f"{rep.total_s:.2f}s (wisdom entries: {rep.wisdom_entries})")
        for e in rep.entries:
            print(f"[serve]   {e.label}: backend={e.backend} "
                  f"algo={e.algo} max_batch={e.max_batch} "
                  f"compile={e.compile_s:.2f}s"
                  + (f" DEGRADED ({e.reason})" if e.degraded else ""))

        res = closed_loop(srv, mix, requests=args.requests,
                          concurrency=args.concurrency, seed=0)
        print(f"[serve] {res['completed']}/{args.requests} completed in "
              f"{res['wall_s']:.2f}s ({res['achieved_qps']:.1f} req/s), "
              f"p50={res['p50_ms']:.1f}ms p99={res['p99_ms']:.1f}ms")

        snap = srv.snapshot()
        for lbl in sorted(snap["buckets"]):
            b = snap["buckets"][lbl]
            c, e2e = b["counters"], b["latency"]["e2e"]
            if not c["admitted"]:
                continue
            print(f"[serve] {lbl}: admitted={c['admitted']} "
                  f"completed={c['completed']} padded_up={c['padded_up']} "
                  f"fallback={c['fallback_served']} "
                  f"batches={c['batches']} "
                  f"occupancy={b['gauges']['batch_occupancy']['mean']:.2f} "
                  f"e2e p50={e2e['p50_ms']:.1f}ms p99={e2e['p99_ms']:.1f}ms")
        print("[serve] totals:", json.dumps(snap["totals"], sort_keys=True))
    return {"completed": res["completed"], "totals": snap["totals"],
            "degraded": [e.label for e in rep.entries if e.degraded]}


if __name__ == "__main__":
    main()
