"""End-to-end training launcher (counterpart of :mod:`repro.launch.train`).

``python -m repro_torch.launch.train --arch h2o-danube-1.8b --reduced
--steps 200 --device cpu`` trains a reduced config on the CPU; without
``--device`` it runs on the card.  Features: deterministic data, the train
step with AdamW (warmup-cosine, clipping), async atomic checkpoints every
``--ckpt-every`` steps, automatic resume from the latest checkpoint, the
bf16 gradient-compression flag, microbatch accumulation.  It prints the
loss, grad norm and lr, tokens/sec after the first step, and the kernel
launches of the run.

``--mesh single|multi`` builds the production mesh (16x16 or 2x16x16
ranks) over the process group the launcher is started in (one process a
rank, ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` set, as
``torchrun`` does, or a group already initialised by the caller) and runs
the step on DTensors, as the reference's launcher runs its jitted step on
sharded arrays: params laid out by ``sharding.param_shardings``, the
optimizer state by ``opt_shardings``, each batch by ``batch_shardings``,
under ``actsharding.activation_spec(mesh, data_axes(mesh), "model")``.
Every rank builds the same params and batches from the seed and keeps its
block of them; checkpoints hold each rank's shards.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def _production_mesh(args, dev):
    """The production mesh over the process group (initialised here from
    the environment unless the caller did)."""
    import torch.distributed as dist
    from . import mesh as mesh_lib
    ranks = 512 if args.mesh == "multi" else 256
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(
                f"--mesh {args.mesh} needs a process group of {ranks} ranks: "
                "start one process a rank with RANK, WORLD_SIZE, MASTER_ADDR "
                "and MASTER_PORT set (torchrun does)")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return mesh_lib.make_production_mesh(multi_pod=args.mesh == "multi",
                                         device=dev.type)


def _value(t):
    """A metric as a plain tensor (a DTensor's full value)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--fft-backend", choices=["torch", "cuda"], default=None,
                    help="override the config's fft_backend (fft_conv plans "
                         "+ fourier_mix) for A/B runs")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", choices=["none", "bf16"], default="none")
    ap.add_argument("--ckpt-dir", default="runs/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="the training device")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True): an op "
                         "with no deterministic implementation raises")
    args = ap.parse_args(argv)

    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import contextlib

    import torch
    import repro_torch
    import repro_torch.configs as C
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import actsharding
    from repro_torch.models import model as M
    from . import mesh as mesh_lib
    from . import sharding as sh
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.train_step import init_opt_state, make_train_step

    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    dev = repro_torch.device(args.device)
    cfg = C.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.fft_backend is not None:
        cfg = dataclasses.replace(cfg, fft_backend=args.fft_backend)
    mesh = _production_mesh(args, dev) if args.mesh != "none" else None
    dcfg = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch)
    data = SyntheticLM(dcfg, cfg, device=dev)
    ocfg = opt_lib.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                               total_steps=args.steps)
    compress = None if args.compress == "none" else args.compress
    step_fn = make_train_step(cfg, ocfg, microbatches=args.microbatches,
                              compress=compress)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = M.init_params(gen, cfg, device=dev)
    opt_state = init_opt_state(cfg, ocfg, params, compress=compress)
    print(f"[train] {cfg.name}: {M.param_count(params)/1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.global_batch} x {args.seq_len} "
          f"on {dev}")

    ctx = contextlib.nullcontext
    shardings = None
    if mesh is not None:
        pshard = sh.param_shardings(cfg, mesh, params)
        params = sh.lay_out(params, pshard)
        opt_state = init_opt_state(cfg, ocfg, params, compress=compress)
        shardings = (pshard, sh.opt_shardings(cfg, mesh, opt_state, params))
        opt_state = sh.lay_out(opt_state, shardings[1])
        bshard = sh.batch_shardings(cfg, mesh, data.batch_at(0))
        print(f"[train] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
              "the step on DTensors")

        def ctx():
            return actsharding.activation_spec(
                mesh, mesh_lib.data_axes(mesh), "model")

    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        (params, opt_state), extra = mgr.restore(latest, (params, opt_state),
                                                 shardings=shardings)
        start = int(extra.get("data_step", latest))
        print(f"[train] resumed from step {latest}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ops.reset_launches()
    t0 = time.time()
    t_steady = None                        # set after the first step
    for step in range(start, args.steps):
        batch = data.batch_at(step)
        if mesh is not None:
            batch = sh.lay_out(batch, bshard)
        with ctx():
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            m = {k: float(_value(v)) for k, v in metrics.items()}
            print(f"[train] step {step:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                  f"({dt:.1f}s)", flush=True)
        if t_steady is None:
            sync()
            t_steady = time.time()         # first-step costs excluded
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            mgr.save_async(step, (params, opt_state),
                           extra={"data_step": step + 1})
    sync()
    steady_steps = args.steps - start - 1
    if steady_steps > 0:
        secs = time.time() - t_steady
        tokens_per_s = steady_steps * args.global_batch * args.seq_len / secs
        print(f"[train] tokens/sec {tokens_per_s:.0f} "
              f"(fft_backend={cfg.fft_backend}, steady steps {steady_steps}, "
              f"{secs / steady_steps * 1e3:.1f} ms/step)", flush=True)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    print(f"[train] kernel launches {json.dumps(launches)}")
    if dev.type == "cuda":
        print(f"[train] peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    mgr.wait()
    mgr.save(args.steps, (params, opt_state),
             extra={"data_step": args.steps})
    print("[train] done")


if __name__ == "__main__":
    main()
