"""Serving driver (counterpart of :mod:`repro.launch.serve`): spectral
transforms through the continuous-batching spectral server.

``python -m repro_torch.launch.serve --workload spectral --buckets
64x64,128x128`` stands up a :class:`repro_torch.serve.spectral.
SpectralServer` over the named shape buckets (c2c + rfft per 2-D shape) on
``--device`` (default ``cuda``) and drives a closed-loop ragged mix through
it, printing throughput, tail latency and the per-bucket snapshot.

``--workload lm`` (LM decode through the slot-based engine) needs the model
stack, ROADMAP 'Modules to port' item 14, and raises until it is ported.
"""
from __future__ import annotations

import argparse


def _parse_buckets(spec: str):
    shapes = []
    for part in spec.split(","):
        dims = tuple(int(d) for d in part.lower().split("x"))
        if len(dims) not in (1, 2):
            raise SystemExit(f"--buckets wants NxM or N entries, got {part}")
        shapes.append(dims)
    return shapes


def _spectral_main(args) -> None:
    from repro_torch.serve.spectral import (BucketConfig, MixItem,
                                            SpectralServer, closed_loop,
                                            open_loop)

    shapes = _parse_buckets(args.buckets)
    buckets = [BucketConfig(s, kind=k) for s in shapes
               for k in ("c2c", "rfft") if len(s) == 2 or k == "c2c"]
    mix = [MixItem(b.shape, b.kind, inverse=b.inverse) for b in buckets]
    with SpectralServer(buckets, unmatched=args.unmatched,
                        device=args.device) as srv:
        rep = srv.prewarm_report
        print(f"[serve] spectral: {len(buckets)} buckets pre-warmed in "
              f"{rep.total_s:.2f}s"
              + (f", degraded: {rep.degraded}" if rep.degraded else ""))
        if args.qps > 0:
            res = open_loop(srv, mix, qps=args.qps,
                            duration_s=args.duration, seed=0)
        else:
            res = closed_loop(srv, mix, requests=args.requests,
                              concurrency=args.batch_size, seed=0)
        print(f"[serve] {res['completed']} completed "
              f"({res['achieved_qps']:.1f} req/s), "
              f"p50={res['p50_ms']:.1f}ms p99={res['p99_ms']:.1f}ms, "
              f"rejected={res['rejected']} timed_out={res['timed_out']}")
        snap = srv.snapshot()
        for lbl in sorted(snap["buckets"]):
            c = snap["buckets"][lbl]["counters"]
            if c["admitted"]:
                print(f"[serve]   {lbl}: admitted={c['admitted']} "
                      f"completed={c['completed']} "
                      f"fallback={c['fallback_served']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("lm", "spectral"), default="lm")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--buckets", default="64x64,128x128",
                    help="spectral: comma-separated bucket shapes (NxM)")
    ap.add_argument("--unmatched", choices=("reject", "pad_up"),
                    default="reject")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="spectral: >0 switches to open-loop at this rate")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="spectral: open-loop duration (seconds)")
    ap.add_argument("--device", default="cuda",
                    help="spectral: the serving device")
    args = ap.parse_args(argv)

    if args.workload == "spectral":
        _spectral_main(args)
        return
    raise NotImplementedError("--workload lm needs the model stack and the "
                              "decode engine: ROADMAP 'Modules to port' "
                              "item 14")


if __name__ == "__main__":
    main()
