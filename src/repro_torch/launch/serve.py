"""Serving launcher (counterpart of :mod:`repro.launch.serve`): LM decode
through the slot-based engine, or spectral transforms through the
continuous-batching spectral server, on ``--device`` (default ``cuda``).

``python -m repro_torch.launch.serve --arch h2o-danube-1.8b`` serves the
full-width model (random weights from a seed, made on the card) with
synthetic prompts: 8 requests, batch 4, 16 new tokens each; ``--reduced``
serves its tiny same-family config.

``python -m repro_torch.launch.serve --workload spectral --buckets
64x64,128x128`` stands up a :class:`repro_torch.serve.spectral.
SpectralServer` over the named shape buckets (c2c + rfft per 2-D shape)
and drives a closed-loop ragged mix through it, printing throughput, tail
latency and the per-bucket snapshot.
"""
from __future__ import annotations

import argparse
import time


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


def _lm_main(args) -> dict:
    import numpy as np
    import torch
    import repro_torch
    import repro_torch.configs as C
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = C.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = repro_torch.device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init_params(gen, cfg, device=dev)
    eng = Engine(cfg, ServeConfig(batch_size=args.batch_size,
                                  max_len=args.max_len,
                                  temperature=args.temperature,
                                  device=args.device), params)
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12))
             .astype(np.int32)) for i in range(args.requests)]
    t0 = time.time()
    out = eng.run(reqs, max_new=args.max_new)
    dt = time.time() - t0
    total = sum(len(v) for v in out.values())
    print(f"[serve] {len(out)} requests, {total} tokens in {dt:.1f}s "
          f"({total/dt:.1f} tok/s) on {dev}")
    for rid in sorted(out)[:4]:
        print(f"[serve] req {rid}: {out[rid][:12]}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("lm", "spectral"), default="lm")
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--buckets", default="64x64,128x128",
                    help="spectral: comma-separated bucket shapes (NxM)")
    ap.add_argument("--unmatched", choices=("reject", "pad_up"),
                    default="reject")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="spectral: >0 switches to open-loop at this rate")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="spectral: open-loop duration (seconds)")
    ap.add_argument("--device", default="cuda",
                    help="the serving device")
    args = ap.parse_args(argv)

    if args.workload == "spectral":
        _spectral_main(args)
        return None
    return _lm_main(args)


if __name__ == "__main__":
    main()
