"""Rank functions of the training tests' 4-rank gloo group
(``test_torch_checkpoint.py``).  A module of its own, importing torch and
the port only, so the spawned ranks do not import JAX."""
import torch

from repro_torch.train.checkpoint import CheckpointManager


def elastic(d):
    """Save a (4,)-mesh ``Shard(0)`` leaf, a replicated DTensor and a plain
    scalar; restore onto a (2, 2) mesh with ``(None, "a")``."""
    import torch.distributed as dist
    from repro_torch.dist import make_mesh
    from repro_torch.launch.sharding import NamedSharding
    mgr = CheckpointManager(d, keep=2)
    full = torch.arange(32.0).reshape(8, 4)
    mesh = make_mesh((4,), ("data",), device="cpu")
    w = NamedSharding(mesh, ("data", None)).distribute(full)
    rep = NamedSharding(mesh, ()).distribute(torch.arange(3.0))
    mgr.save(1, {"w": w, "rep": rep,
                 "step": torch.tensor(1, dtype=torch.int32)})
    mesh2 = make_mesh((2, 2), ("a", "b"), device="cpu")
    got, _ = mgr.restore(1, {"w": torch.zeros(8, 4), "rep": torch.zeros(3),
                             "step": torch.tensor(0, dtype=torch.int32)},
                         shardings={"w": NamedSharding(mesh2, (None, "a")),
                                    "rep": None, "step": None})
    return {"full": got["w"].full_tensor().numpy(),
            "local": got["w"].to_local().numpy(),
            "placements": repr(got["w"].placements),
            "coord": mesh2.get_coordinate(), "step": int(got["step"]),
            "rep": got["rep"].numpy(), "rank": dist.get_rank()}


def constrain():
    """``actsharding.constrain`` on DTensors: batch over data, the
    sequence over model when it divides; spec-to-placement rules."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.dist import make_mesh
    from repro_torch.launch.sharding import placements
    from repro_torch.models import actsharding
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    full = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    x = distribute_tensor(full, mesh, [Replicate(), Replicate()])
    plain = torch.ones(2, 3)
    out = {}
    with actsharding.activation_spec(mesh, ("data",), "model"):
        y = actsharding.constrain(x)
        odd = actsharding.constrain(distribute_tensor(
            full[:, :7], mesh, [Replicate(), Replicate()]))
        out["plain_passes"] = actsharding.constrain(plain) is plain
        out["tree"] = repr(actsharding.constrain_tree({"x": x})["x"]
                           .placements)
    out["outside"] = actsharding.constrain(x) is x
    out["seq"] = repr(y.placements)
    out["odd"] = repr(odd.placements)
    out["values"] = bool(torch.equal(y.full_tensor(), full))
    out["pod_data"] = repr(placements(((("data", "model")), None), mesh))
    try:
        placements((("model", "data"),), mesh)
        out["order"] = None
    except ValueError as e:
        out["order"] = str(e)
    return out


def _sharded(arch, params_np, ocfg_kw, use_fft_conv):
    """The (2, 2) ("data", "model") mesh, the config, its AdamW config and
    the params laid out by ``param_shardings``, the opt state by
    ``opt_shardings``."""
    import dataclasses
    import repro_torch.configs as C
    from repro_torch.dist import make_mesh
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import init_opt_state
    torch.set_num_threads(1)
    cfg = dataclasses.replace(C.get_config(arch).reduced(),
                              use_fft_conv=use_fft_conv)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    ocfg = opt_lib.AdamWConfig(**ocfg_kw)
    params = M.params_from_numpy(params_np, cfg, device="cpu")
    params = sh.lay_out(params, sh.param_shardings(cfg, mesh, params))
    opt = init_opt_state(cfg, ocfg, params)
    opt = sh.lay_out(opt, sh.opt_shardings(cfg, mesh, opt, params))
    return cfg, mesh, ocfg, params, opt


def _full(tree):
    """Every leaf's full value as numpy (a collective on every rank)."""
    from repro_torch.models import model as M
    return M.tree_map(lambda t: (t.full_tensor() if hasattr(
        t, "full_tensor") else t).detach().numpy(), tree)


def sharded_step(arch, params_np, batch_np, ocfg_kw, use_fft_conv, steps=1):
    """``steps`` of ``make_train_step`` on DTensors under the activation
    spec, after the step-0 loss and grads; returns the loss, grad norm
    and grads of step 0, the metrics of each step and the final params,
    full, with the placements of the params and their new values."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.models import actsharding
    from repro_torch.models import model as M
    from repro_torch.train import train_step as ts
    cfg, mesh, ocfg, params, opt = _sharded(arch, params_np, ocfg_kw,
                                            use_fft_conv)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    batch = sh.lay_out(batch, sh.batch_shardings(cfg, mesh, batch))
    step = ts.make_train_step(cfg, ocfg)
    metrics = []
    with actsharding.activation_spec(mesh, mesh_lib.data_axes(mesh),
                                     "model"):
        loss, _, grads = ts._grads_of(cfg, params, batch)
        before = M.tree_map(lambda t: repr(t.placements), params)
        for _ in range(steps):
            params, opt, m = step(params, opt, batch)
            metrics.append({k: float(_full(v)) for k, v in m.items()})
    return {"loss": float(_full(loss)), "grads": _full(grads),
            "metrics": metrics, "params": _full(params),
            "placements": before,
            "after": M.tree_map(lambda t: repr(t.placements), params),
            "opt": M.tree_map(lambda t: repr(t.placements), opt)}


def sharded_resume(arch, params_np, batches_np, ocfg_kw, d):
    """Two sharded steps straight, and one step, a save, a restore (with
    the shardings) into fresh state and one more step: both final params,
    full."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.models import actsharding
    from repro_torch.train import train_step as ts
    out = []
    for resume in (False, True):
        cfg, mesh, ocfg, params, opt = _sharded(arch, params_np, ocfg_kw,
                                                False)
        shardings = (sh.param_shardings(cfg, mesh, params),
                     sh.opt_shardings(cfg, mesh, opt, params))
        step = ts.make_train_step(cfg, ocfg)
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in batches_np]
        bshard = sh.batch_shardings(cfg, mesh, batches[0])
        mgr = CheckpointManager(d, keep=2)
        for i, b in enumerate(batches):
            with actsharding.activation_spec(
                    mesh, mesh_lib.data_axes(mesh), "model"):
                params, opt, _ = step(params, opt, sh.lay_out(b, bshard))
            if resume and i == 0:
                mgr.save(1, (params, opt))
                _, _, _, fresh_p, fresh_o = _sharded(arch, params_np,
                                                     ocfg_kw, False)
                (params, opt), _ = mgr.restore(1, (fresh_p, fresh_o),
                                               shardings=shardings)
        out.append(_full(params))
    return out


def host_staged_collectives():
    """Every collective of ``dist.hoststaged.HostStaged`` on this rank,
    and a DTensor step through it: (name, result) pairs as numpy."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.dist import make_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.arange(4.0) + 10 * rank
    out = {"backend": dist.get_backend()}
    t = x.clone()
    dist.all_reduce(t)
    out["all_reduce"] = t.numpy()
    g = torch.empty(4 * world)
    dist.all_gather_into_tensor(g, x)
    out["all_gather_into_tensor"] = g.numpy()
    lst = [torch.empty(4) for _ in range(world)]
    dist.all_gather(lst, x)
    out["all_gather"] = torch.cat(lst).numpy()
    r = torch.empty(1)
    dist.reduce_scatter_tensor(r, x)
    out["reduce_scatter_tensor"] = r.numpy()
    a = torch.empty(4)
    dist.all_to_all_single(a, x)
    out["all_to_all_single"] = a.numpy()
    b = x.clone()
    dist.broadcast(b, src=1)
    out["broadcast"] = b.numpy()
    s = torch.empty(1)
    dist.scatter(s, list(torch.arange(4.0).chunk(4)) if rank == 0 else None,
                 src=0)
    out["scatter"] = s.numpy()
    out["funcol_all_gather"] = funcol.all_gather_tensor(
        x, 0, dist.group.WORLD).numpy()
    dist.barrier()
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    d = DTensor.from_local(x, mesh, [Shard(0), Partial()])
    out["dtensor"] = d.redistribute(mesh, [Replicate(), Replicate()]) \
        .to_local().numpy()
    # the bytes it moved by kind, against opcount's count of the same
    # calls; a ring shift over its send and receive
    from repro_torch.analysis.opcount import OpCount
    from repro_torch.dist import hoststaged
    from repro_torch.dist._compat import sendrecv
    ring = make_mesh((world,), ("ring",), device="cpu")
    before = dict(hoststaged.SPENT["bytes"])
    with OpCount() as oc:
        DTensor.from_local(x, mesh, [Shard(0), Partial()]).redistribute(
            mesh, [Shard(0), Shard(0)]).full_tensor()
        out["sendrecv"] = sendrecv(x, ring, "ring", dst=(rank + 1) % world,
                                   src=(rank - 1) % world).numpy()
    out["moved"] = {k: hoststaged.SPENT["bytes"][k] - before[k]
                    for k in before}
    out["counted"] = dict(oc.cost.collectives)
    return out


def pp_step(arch, params_np, batch_np, n_micro):
    """``launch.pp_variant``'s step of ``arch`` (``.reduced()``) on a
    (pod 2, data 1, model 2) mesh: this rank's stage, its loss and the full
    value of its grads (every leaf of its stage's tree), and the step's
    grad norm."""
    import torch.distributed as dist
    import repro_torch.configs as C
    from repro_torch.dist import make_mesh
    from repro_torch.launch.pp_variant import build_pp_train_step
    from repro_torch.models import model as M
    torch.set_num_threads(1)
    cfg = C.get_config(arch).reduced()
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), device="cpu")
    b, s = batch_np["tokens"].shape
    step = build_pp_train_step(arch, s, b, n_micro, mesh, cfg=cfg)
    params = M.params_from_numpy(params_np, step.cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    params, opt, batch = step.lay_out(params, batch)
    loss, grads = step.loss_and_grads(params, batch)
    _, _, metrics = step(params, opt, batch)
    return {"rank": dist.get_rank(), "stage": step.stage,
            "loss": float(_full(loss)), "grads": _full(grads),
            "grad_norm": float(_full(metrics["grad_norm"])),
            "step_loss": float(_full(metrics["loss"]))}


def counted_step(arch, params_np, batch_np, ocfg_kw, fake=False):
    """One sharded ``make_train_step`` of ``arch`` (``.reduced()``) on the
    (2, 2) mesh of the initialised group, under
    ``analysis.opcount.OpCount``: the collective record (bytes by kind,
    count, total) this rank counted.  ``fake=True`` runs it under
    ``FakeTensorMode`` (a fake group's dry run)."""
    import contextlib
    from torch._subclasses.fake_tensor import FakeTensorMode
    import repro_torch.configs as C
    from repro_torch.analysis.opcount import OpCount
    from repro_torch.dist import make_mesh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.models import actsharding
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts
    torch.set_num_threads(1)
    cfg = C.get_config(arch).reduced()
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    ocfg = opt_lib.AdamWConfig(**ocfg_kw)
    with (FakeTensorMode(allow_non_fake_inputs=True) if fake
          else contextlib.nullcontext()):
        params = M.params_from_numpy(params_np, cfg, device="cpu")
        params = sh.lay_out(params, sh.param_shardings(cfg, mesh, params))
        opt = ts.init_opt_state(cfg, ocfg, params)
        opt = sh.lay_out(opt, sh.opt_shardings(cfg, mesh, opt, params))
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        batch = sh.lay_out(batch, sh.batch_shardings(cfg, mesh, batch))
        with actsharding.activation_spec(mesh, mesh_lib.data_axes(mesh),
                                         "model"), OpCount() as oc:
            ts.make_train_step(cfg, ocfg)(params, opt, batch)
    return oc.cost.collective_record()
