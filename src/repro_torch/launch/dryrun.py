"""Dry-run of one (arch x shape x mesh) cell at production scale
(counterpart of :mod:`repro.launch.dryrun`).

The reference compiles each cell for 256 or 512 emulated XLA devices and
parses the optimized HLO.  Here a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg.FakeStore``: collectives
move nothing) carries the production mesh, and the cell runs once, as
rank 0, under ``FakeTensorMode`` (nothing is allocated), counted by
:class:`repro_torch.analysis.opcount.OpCount` and
``torch.distributed._tools.mem_tracker.MemTracker``.  The record keeps
the reference's fields, so :mod:`repro_torch.analysis.roofline` and
``compare`` read it: ``loop_aware`` (flops, op-boundary traffic and
collective bytes a rank), ``collectives`` (by kind, ``count``,
``total``), ``cost`` (the same counts) and ``memory`` (``MemTracker``'s
peak a rank in place of XLA's argument / output / temp sizes).  Beside
the JSON the op log is written as gzip JSON lines (``.ops.jsonl.gz``),
which :mod:`repro_torch.analysis.reanalyze` counts again.

Train cells run ``make_train_step``; prefill and decode cells run
``serve.engine.prefill_fn`` / ``decode_fn`` with the caches laid out by
``cache_shardings``, under ``sharding.serve_spec``: the batch pinned over
the data axes when it divides them, else (``long_500k``, B = 1) no batch
pin, the reference's rule, and the caches' slots split over the data
axes, each rank attending over its own.

    python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b \\
        --shape train_4k [--mesh single|multi|both] [--save-dir runs/dryrun]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import os
import time

import torch


def abstract_params(cfg):
    """The param tree of ``cfg`` as meta tensors (made under
    ``FakeTensorMode``: no allocation at any width)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import model as M
    with FakeTensorMode():
        p = M.init_params(torch.Generator(), cfg, device="cpu")
    return M.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), p)


def abstract_cache(cfg, batch: int, seq_len: int):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import model as M
    with FakeTensorMode():
        c = M.init_cache(cfg, batch, seq_len, torch.bfloat16, device="cpu")
    return M.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), c)


def build_cell(arch: str, shape_name: str, mesh, *, overrides=None,
               microbatches=None, reduced: bool = False):
    """(fn, abstract_args, shardings, meta) for one cell: the args as
    meta tensors, the shardings a tree of ``NamedSharding`` beside them.

    overrides: ModelConfig field replacements (hillclimb variants);
    microbatches: grad-accumulation override for train cells; reduced:
    the config's ``.reduced()`` (a CPU-sized cell)."""
    import repro_torch.configs as C
    from repro_torch.data.pipeline import make_batch_specs
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import (abstract_opt_state,
                                              make_train_step)
    from . import sharding as sh

    cfg = C.get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = C.SHAPES[shape_name]
    ap = abstract_params(cfg)
    pshard = sh.param_shardings(cfg, mesh, ap)
    meta = {
        "arch": arch, "shape": shape_name, "kind": cell.kind,
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "n_params": M.param_count(ap),
        "n_active": M.active_param_count(cfg, ap),
        "profile": sh.profile_for(cfg),
        "dtype": cfg.dtype,
    }
    if reduced:
        meta["reduced"] = True

    if cell.kind == "train":
        # memory ladder for the 100B+ configs: bf16 optimizer moments and
        # 4-way microbatch accumulation (the reference's)
        big = meta["n_params"] > 5e10
        moments = "bfloat16" if big else "float32"
        micro = microbatches if microbatches else (4 if big else 1)
        meta["microbatches"] = micro
        ocfg = opt_lib.AdamWConfig(moments_dtype=moments)
        ao = abstract_opt_state(cfg, ocfg, ap)
        oshard = sh.opt_shardings(cfg, mesh, ao, ap)
        bspec = make_batch_specs(cfg, cell.seq_len, cell.global_batch)
        bshard = sh.batch_shardings(cfg, mesh, bspec)
        fn = make_train_step(cfg, ocfg, microbatches=micro)
        return fn, (ap, ao, bspec), (pshard, oshard, bshard), meta

    b = cell.global_batch
    acache = abstract_cache(cfg, b, cell.seq_len)
    cshard = sh.cache_shardings(cfg, mesh, acache, b)
    if cell.kind == "prefill":
        bspec = make_batch_specs(cfg, cell.seq_len, b)
        bspec.pop("labels")
        bshard = sh.batch_shardings(cfg, mesh, bspec)
        return (E.prefill_fn(cfg), (ap, bspec, acache),
                (pshard, bshard, cshard), meta)

    # decode: one new token against a seq_len-deep bf16 cache
    toks = torch.empty((b,), dtype=torch.int32, device="meta")
    pos = torch.empty((b,), dtype=torch.int32, device="meta")
    tshard = sh.batch_shardings(cfg, mesh, toks)
    return (E.decode_fn(cfg), (ap, toks, acache, pos),
            (pshard, tshard, cshard, tshard), meta)


def materialize(abstract, shardings, device="cpu"):
    """Each meta leaf of ``abstract`` as a DTensor laid out by its
    ``NamedSharding``, its local block an uninitialised tensor on
    ``device``, the mesh's (under ``FakeTensorMode``: fake, no
    allocation)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import model as M
    from .sharding import shard_slices

    def one(leaf, sh):
        shape = tuple(leaf.shape)
        pl = sh.placements
        local = tuple(len(range(*s.indices(n))) for s, n in
                      zip(shard_slices(shape, sh.mesh, pl), shape))
        t = torch.zeros(local, dtype=leaf.dtype, device=device)
        return DTensor.from_local(t, sh.mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape,
                                                     device="meta").stride())
    return M.tree_map(one, abstract, shardings)


def local_tensors(tree) -> list:
    from repro_torch.models import model as M
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in M.tree_leaves(tree)]


def count_call(fn, args, *, ctx=contextlib.nullcontext):
    """``fn(*args)`` once under ``OpCount(log=True)`` and ``MemTracker``
    (the args already fake): (cost, op log, memory dict, seconds)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch.analysis.opcount import OpCount
    arg_bytes = sum(t.untyped_storage().nbytes()
                    for t in local_tensors(args))
    oc = OpCount(log=True)
    mt = MemTracker()
    mt.track_external(*local_tensors(args))
    t0 = time.time()
    with oc, mt, ctx():
        fn(*args)
    secs = time.time() - t0
    peak = sum(v.get("Total", 0) for v in
               mt.get_tracker_snapshot("peak").values())
    memory = {"peak_bytes": int(peak), "argument_size_in_bytes":
              int(arg_bytes), "temp_size_in_bytes": int(max(0, peak -
                                                           arg_bytes))}
    return oc.cost, oc.ops, memory, secs


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks (this process rank 0), or
    the group already initialised when it has that size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is initialised, the cell needs {world}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def write_record(rec: dict, ops: list, path: str) -> None:
    """The record as JSON at ``path`` and its op log beside it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    with gzip.open(path[:-len(".json")] + ".ops.jsonl.gz", "wt") as f:
        for e in ops:
            f.write(json.dumps(e) + "\n")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             save_dir: str = "runs/dryrun", verbose: bool = True,
             overrides=None, microbatches=None, tag: str = "",
             mesh_shape=None, reduced: bool = False) -> dict:
    """Count one cell (see the module docstring) and write its record to
    ``save_dir/<mesh>/<arch>__<shape>.json``.  ``mesh_shape`` ((data,
    model) sizes) replaces the production mesh, over a fake group of its
    size (or the caller's group of that size)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import actsharding
    from . import mesh as mesh_lib
    from . import sharding

    if mesh_shape is not None:
        dims, axes = tuple(mesh_shape), ("data", "model")
    elif multi_pod:
        dims, axes = (2, 16, 16), ("pod", "data", "model")
    else:
        dims, axes = (16, 16), ("data", "model")
    mesh_name = "x".join(str(d) for d in dims)
    world = 1
    for d in dims:
        world *= d
    torch.set_num_threads(1)
    with fake_group(world):
        mesh = mesh_lib.make_mesh(dims, axes, device="cpu")
        fn, abstract, shardings, meta = build_cell(
            arch, shape_name, mesh, overrides=overrides,
            microbatches=microbatches, reduced=reduced)
        meta["mesh"] = mesh_name
        if tag:
            meta["tag"] = tag
            shape_name = f"{shape_name}__{tag}"
        meta["devices"] = world
        if meta["kind"] == "train":
            def spec():
                return actsharding.activation_spec(
                    mesh, mesh_lib.data_axes(mesh), "model")
        else:
            # decode with an unshardable batch: no batch pinning (the
            # cache's sequence sharding governs), as the reference
            @contextlib.contextmanager
            def spec():
                with sharding.serve_spec(mesh, meta["global_batch"]), \
                        torch.no_grad():
                    yield
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = materialize(abstract, shardings)
            cost, ops, memory, secs = count_call(fn, args, ctx=spec)

    rec = dict(meta, trace_s=round(secs, 2))
    rec["memory"] = memory
    rec["cost"] = {"flops": cost.flops, "bytes accessed": cost.traffic,
                   "collective bytes": cost.collective_total}
    rec["collectives"] = cost.collective_record()
    rec["loop_aware"] = cost.loop_aware()
    out = os.path.join(save_dir, mesh_name, f"{arch}__{shape_name}.json")
    write_record(rec, ops, out)
    if verbose:
        print(f"[dryrun] {mesh_name} {arch} {shape_name}: traced "
              f"{secs:.1f}s flops/dev {cost.flops:.3e} traffic/dev "
              f"{cost.traffic / 2**30:.2f} GiB coll "
              f"{cost.collective_total / 2**30:.2f} GiB peak "
              f"{memory['peak_bytes'] / 2**30:.2f} GiB -> {out}", flush=True)
    return rec


def parse_overrides(pairs) -> dict:
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="every runnable (arch x shape) cell")
    ap.add_argument("--save-dir", default="runs/dryrun")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="ModelConfig overrides for hillclimb variants")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--tag", default="", help="variant tag for the artifact")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's .reduced() (a CPU-sized cell)")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.set)

    import repro_torch.configs as C
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = C.all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, C.SHAPES[args.shape])]

    failures = []
    for arch, cell in cells:
        for mp in meshes:
            try:
                run_cell(arch, cell.shape, multi_pod=mp,
                         save_dir=args.save_dir,
                         overrides=overrides or None,
                         microbatches=args.microbatches, tag=args.tag,
                         reduced=args.reduced)
            except Exception as ex:
                failures.append((arch, cell.shape, mp, repr(ex)[:200]))
                print(f"[dryrun] FAIL {arch} {cell.shape} multi={mp}: {ex}",
                      flush=True)
    skipped = C.SKIPPED_CELLS
    print(f"[dryrun] done; {len(failures)} failures, "
          f"{len(skipped)} cells skipped by design")
    for s in skipped:
        print(f"[dryrun] skipped: {s}")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
