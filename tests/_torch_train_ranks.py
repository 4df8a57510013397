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
