"""Pipeline-parallel train-step variant for the multi-pod mesh
(counterpart of :mod:`repro.launch.pp_variant`).

Instead of FSDP-gathering every layer's weights across the whole machine
a microbatch, the depth is split one stage a ``pod`` rank (GPipe over
``pod``, :func:`repro_torch.dist.pipeline.pipelined_apply`).  Each stage's
blocks are laid out by ``param_shardings`` with ``pod`` stripped from
their specs, over the (data, model) sub-mesh of the rank's pod, so no
weight crosses pods; only microbatch activations do (the ring shift),
plus the usual intra-pod TP/DP collectives.  The loss is the
reference's: embed, the pipeline (each layer under
``actsharding.constrain`` and checkpointed), final norm, unembed and a
full ``log_softmax``; AdamW moments are bf16.

    python -m repro_torch.launch.pp_variant --arch nemotron-4-340b \\
        [--microbatches 8]

``main`` counts one step as rank 0 of a fake 512-rank group
(:mod:`repro_torch.launch.dryrun`'s machinery) and writes the reference's
record.  The step also runs on real groups (gloo ranks on the CPU, the
host-staged backend on one card).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch


def _strip_pod(ax):
    axes = ax if isinstance(ax, tuple) else (ax,)
    kept = tuple(a for a in axes if a not in (None, "pod"))
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def stage_blocks(params, stage: int, n_stages: int):
    """``params`` with only stage ``stage``'s layers of the stacked
    ``blocks`` (the first dim split in ``n_stages`` runs)."""
    from repro_torch.models import model as M
    first = M.tree_leaves(params["blocks"])[0]
    per = first.shape[0] // n_stages
    return dict(params, blocks=M.tree_map(
        lambda t: t[stage * per:(stage + 1) * per], params["blocks"]))


@dataclasses.dataclass
class PPStep:
    """A built pipeline step: ``__call__(params, opt_state, batch)`` ->
    (params, state, metrics); ``loss_and_grads(params, batch)``; the
    shardings lay out this rank's stage (``lay_out``)."""
    cfg: object
    ocfg: object
    mesh: object                 # (pod, data, model)
    sub: object                  # this pod's (data, model)
    n_microbatches: int
    stage: int
    n_stages: int
    pshard: dict
    bshard: dict

    def lay_out(self, params, batch=None):
        """The full param tree (every stage's blocks, on every rank) as
        this rank's stage laid out on the sub-mesh, its bf16 AdamW state,
        and ``batch`` laid out over ``data``."""
        from repro_torch.train.train_step import init_opt_state
        from .sharding import lay_out
        params = lay_out(stage_blocks(params, self.stage, self.n_stages),
                         self.pshard)
        opt = init_opt_state(self.cfg, self.ocfg, params)
        return params, opt, (lay_out(batch, self.bshard)
                             if batch is not None else None)

    def _stage_fn(self, w, x):
        """One stage's layers on a microbatch: ``x`` this rank's local
        rows (batch over data, whole over model), ``w`` the stage's
        blocks."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.utils.checkpoint import checkpoint
        from repro_torch.models import actsharding
        from repro_torch.models import model as M
        cfg, sub = self.cfg, self.sub
        rows = [Shard(0), Replicate()]
        xd = DTensor.from_local(x, sub, rows, run_check=False)
        b, s = xd.shape[:2]
        pos = actsharding.replicate_like(torch.arange(
            s, dtype=torch.int32, device=x.device).expand(b, s), xd)

        def body(x, lp):
            # pin (data, sequence over model) on the residual each layer
            x = actsharding.constrain(x)
            for j, blk in enumerate(cfg.block_pattern):
                x, _ = M._block_apply(lp[f"b{j}"], None, blk, x, cfg, pos)
            return x
        n = M.tree_leaves(w)[0].shape[0]
        for r in range(n):
            xd = checkpoint(body, xd, M._index(w, r), use_reentrant=False)
        return actsharding.constrain(xd).redistribute(sub, rows).to_local()

    def loss(self, params, batch):
        """The reference's pipeline loss on this rank's stage (under the
        sub-mesh's activation spec, which :meth:`loss_and_grads`
        installs)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.dist.pipeline import pipelined_apply
        from repro_torch.models import layers
        cfg, sub = self.cfg, self.sub
        rows = [Shard(0), Replicate()]
        x = layers.embed(params["embed"], batch["tokens"], cfg)
        x = x.redistribute(sub, rows).to_local()
        y = pipelined_apply(self.mesh, "pod", self._stage_fn,
                            params["blocks"], x, self.n_microbatches)
        y = DTensor.from_local(y, sub, rows, run_check=False)
        y = layers.norm_apply(params["final_norm"], y, cfg)
        logits = layers.unembed(params["embed"], y, cfg)
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, batch["labels"][..., None].long())[..., 0]
        return -ll.mean()

    def loss_and_grads(self, params, batch):
        from repro_torch.models import actsharding
        from repro_torch.models import model as M
        from repro_torch.train.train_step import _like
        paths = [p for p, _ in M.tree_flatten_with_paths(params)]
        with torch.enable_grad(), actsharding.activation_spec(
                self.sub, ("data",), "model"):
            live = M.tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            loss = self.loss(live, batch)
            leaves = M.tree_leaves(live)
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
            by_path = {path: torch.zeros_like(p) if g is None else
                       _like(g, p) for path, p, g in zip(paths, leaves, got)}
        return loss.detach(), M.tree_map_with_path(
            lambda path, _: by_path[path], params)

    def grad_norm(self, grads):
        """The whole model's gradient norm: the embedding and final norm
        once, every stage's blocks summed over ``pod``."""
        import torch.distributed as dist
        from repro_torch.models import model as M

        def sq(tree):
            total = sum(torch.sum(torch.square(g.float()))
                        for g in M.tree_leaves(tree))
            return total.full_tensor() if hasattr(total, "full_tensor") \
                else total
        blocks = sq(grads["blocks"]).clone()
        dist.all_reduce(blocks, group=self.mesh.get_group("pod"))
        rest = sq({k: v for k, v in grads.items() if k != "blocks"})
        return torch.sqrt(blocks + rest)

    def apply_grads(self, params, opt_state, loss, grads):
        """AdamW on this rank's stage, clipped by the whole model's norm:
        (params, state, metrics)."""
        from repro_torch.models import model as M
        from repro_torch.train import optimizer as opt_lib
        gnorm = self.grad_norm(grads)
        if self.ocfg.clip_norm is not None:
            scale = torch.clamp(self.ocfg.clip_norm
                                / torch.clamp(gnorm, min=1e-9), max=1.0)
            grads = M.tree_map(lambda g: g * scale.to(g.dtype), grads)
        new_p, new_o, metrics = opt_lib.adamw_update(
            dataclasses.replace(self.ocfg, clip_norm=None), grads,
            opt_state, params)
        return new_p, new_o, dict(metrics, grad_norm=gnorm, loss=loss)

    def __call__(self, params, opt_state, batch):
        return self.apply_grads(params, opt_state,
                                *self.loss_and_grads(params, batch))


def pp_config(arch: str, cfg=None):
    """``arch``'s config (or ``cfg``) in float32, the reference's
    override (its compiler failed on this pipeline's bf16 all-reduces;
    kept so the two records compare)."""
    import repro_torch.configs as C
    return dataclasses.replace(cfg or C.get_config(arch), dtype="float32")


def build_pp_train_step(arch: str, seq_len: int, global_batch: int,
                        n_microbatches: int, mesh=None, *, cfg=None,
                        ocfg=None, device="cuda") -> PPStep:
    """The pipeline step of ``arch`` on ``mesh`` (default the 2x16x16
    production mesh over the initialised group): one stage a ``pod``
    rank.  ``cfg`` replaces the registry config (a reduced one), ``ocfg``
    the bf16-moment AdamW."""
    from repro_torch.data.pipeline import make_batch_specs
    from repro_torch.train import optimizer as opt_lib
    from . import mesh as mesh_lib
    from . import sharding as sh
    from .dryrun import abstract_params
    cfg = pp_config(arch, cfg)
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=True, device=device)
    n_stages = mesh_lib.axis_sizes(mesh)["pod"]
    if cfg.repeat % n_stages:
        raise ValueError(f"{cfg.name}: {cfg.repeat} layers do not split "
                         f"into {n_stages} stages")
    sub = mesh["data", "model"]
    ap = abstract_params(cfg)
    # the tp2d rules on the whole mesh, pod stripped: it carries the
    # stage, not data parallelism
    base = sh.param_shardings(cfg, mesh, ap)
    pshard = sh.tree_map(lambda s: sh.NamedSharding(
        sub, tuple(_strip_pod(a) for a in s.spec)), base)
    bspec = make_batch_specs(cfg, seq_len, global_batch)
    bshard = sh.tree_map(lambda leaf: sh.NamedSharding(sub, sh._fit(
        ["data"] + [None] * (len(leaf.shape) - 1), leaf.shape, sub)), bspec)
    ocfg = ocfg or opt_lib.AdamWConfig(moments_dtype="bfloat16")
    return PPStep(cfg, ocfg, mesh, sub, n_microbatches,
                  mesh.get_local_rank("pod"), n_stages, pshard, bshard)


def sequential_loss(cfg, params, batch):
    """The same loss on one process: every layer in order (each
    checkpointed), final norm, unembed, full ``log_softmax``; the value a
    pipeline step is held to."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import layers
    from repro_torch.models import model as M
    x = layers.embed(params["embed"], batch["tokens"], cfg)
    b, s = x.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

    def body(x, lp):
        for j, blk in enumerate(cfg.block_pattern):
            x, _ = M._block_apply(lp[f"b{j}"], None, blk, x, cfg, pos)
        return x
    for r in range(cfg.repeat):
        x = checkpoint(body, x, M._index(params["blocks"], r),
                       use_reentrant=False)
    x = layers.norm_apply(params["final_norm"], x, cfg)
    logp = torch.log_softmax(layers.unembed(params["embed"], x, cfg).float(),
                             dim=-1)
    return -logp.gather(-1, batch["labels"][..., None].long())[..., 0].mean()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="nemotron-4-340b")
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--out", default="runs/dryrun/pp_variant")
    ap.add_argument("--hw", default="tpu_v5e",
                    help="the roofline's hardware table (tpu_v5e, the "
                         "reference's; h100_sxm; any tt.arch entry)")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's .reduced() (a CPU-sized run)")
    args = ap.parse_args(argv)

    import repro_torch.configs as C
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.analysis.roofline import hw_table
    from .dryrun import (abstract_params, count_call, fake_group,
                         materialize, write_record)
    from repro_torch.data.pipeline import make_batch_specs
    from repro_torch.train.train_step import abstract_opt_state
    from . import mesh as mesh_lib
    from .sharding import NamedSharding

    torch.set_num_threads(1)
    cfg = C.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    with fake_group(512):
        mesh = mesh_lib.make_production_mesh(multi_pod=True, device="cpu")
        step = build_pp_train_step(args.arch, args.seq_len,
                                   args.global_batch, args.microbatches,
                                   mesh, cfg=cfg)
        aparams = stage_blocks(abstract_params(step.cfg), step.stage,
                               step.n_stages)
        aopt = abstract_opt_state(step.cfg, step.ocfg, aparams)
        oshard = {"step": NamedSharding(step.sub, ()), "m": step.pshard,
                  "v": step.pshard}
        bspec = make_batch_specs(step.cfg, args.seq_len, args.global_batch)
        with FakeTensorMode(allow_non_fake_inputs=True):
            fargs = materialize((aparams, aopt, bspec),
                                (step.pshard, oshard, step.bshard))
            cost, ops, memory, secs = count_call(step, fargs)
    hw = hw_table(args.hw)
    rec = {
        "variant": f"pp_{args.arch}", "microbatches": args.microbatches,
        "devices": 512, "hw": args.hw, "trace_s": round(secs, 2),
        "flops": cost.flops, "traffic_bytes": cost.traffic,
        "collective_bytes": dict(cost.collectives),
        "collective_total": cost.collective_total,
        "compute_s": cost.flops / hw["peak_flops_bf16"],
        "memory_s": cost.traffic / hw["hbm_bw"],
        "collective_s": cost.collective_total / hw["ici_bw"],
        "temp_bytes": memory["temp_size_in_bytes"],
        "peak_bytes": memory["peak_bytes"],
    }
    write_record(rec, ops, os.path.join(args.out, f"{args.arch}.json"))
    print(f"[pp] {args.arch}: compute {rec['compute_s']:.2f}s "
          f"memory {rec['memory_s']:.2f}s collective "
          f"{rec['collective_s']:.2f}s temp "
          f"{rec['temp_bytes'] / 2**30:.1f} GiB", flush=True)
    return rec


if __name__ == "__main__":
    main()
