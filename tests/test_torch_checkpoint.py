"""The port's checkpoint manager (``repro_torch.train.checkpoint``) on the
CPU: the reference's cases (roundtrip, latest-k retention, async save, no
partial checkpoint), checkpoints read across packages in both directions
(float32/int32 trees: the reference's ``CheckpointManager.restore`` reads
the port's files and the port reads the reference's), a bf16-moment
roundtrip, and over 4 gloo ranks (``dist.local.LocalGroup``) a DTensor
leaf saved from a (4,) mesh as ``Shard(0)``, its shards' offsets, the
reference reading that checkpoint whole, and the elastic restore onto a
(2, 2) mesh with ``(None, "a")``.  The same group holds
``actsharding.constrain`` to its placements on DTensor activations (the
rank functions are in ``_torch_train_ranks.py``)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as RManager
from repro_torch.dist.local import LocalGroup
from repro_torch.models import model as TM
from repro_torch.train.checkpoint import CheckpointManager

import _torch_train_ranks as ranks


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "nested": {"b": np.arange(5, dtype=np.float32),
                       "step": np.asarray(3, np.int32)}}


def _tree(seed=0):
    return TM.tree_map(torch.from_numpy, _np_tree(seed))


def _zeros(tree):
    return TM.tree_map(torch.zeros_like, tree)


def _equal(a, b):
    la, lb = TM.tree_leaves(a), TM.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    mgr.save(7, tree, extra={"data_step": 8})
    got, extra = mgr.restore(7, _zeros(tree))
    assert extra["data_step"] == 8
    _equal(got, tree)


def test_latest_k_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_async_save_overlaps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    saved = tree["w"].clone()
    mgr.save_async(5, tree, extra={"data_step": 6})
    tree["w"].add_(1.0)                  # the snapshot was taken at the call
    mgr.wait()
    got, extra = mgr.restore(5, _zeros(tree))
    assert extra["data_step"] == 6
    assert torch.equal(got["w"], saved)


def test_no_partial_checkpoint_on_crash(tmp_path):
    """tmp dirs never count as checkpoints."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp0"))
    assert mgr.all_steps() == []


def test_reference_reads_port_checkpoint(tmp_path):
    tree = _tree(1)
    pair = (tree, {"step": torch.tensor(4, dtype=torch.int32),
                   "m": {"w": torch.ones(8, 16)}})
    CheckpointManager(str(tmp_path)).save(3, pair, extra={"data_step": 4})
    target = jax.tree.map(jnp.zeros_like,
                          jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                       pair))
    got, extra = RManager(str(tmp_path)).restore(3, target)
    assert extra == {"data_step": 4}
    for a, b in zip(jax.tree.leaves(got), TM.tree_leaves(pair)):
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_port_reads_reference_checkpoint(tmp_path):
    ref = jax.tree.map(jnp.asarray, _np_tree(2))
    RManager(str(tmp_path)).save(11, ({"p": ref}, [ref["w"]]),
                                 extra={"data_step": 12})
    tree = _tree(2)
    got, extra = CheckpointManager(str(tmp_path)).restore(
        11, _zeros(({"p": tree}, [tree["w"]])))
    assert extra == {"data_step": 12}
    _equal(got, ({"p": tree}, [tree["w"]]))


def test_manifest_paths_are_the_references(tmp_path):
    tree = ({"blocks": {"b0": {"attn": {"wq": torch.ones(2, 2)}}}},
            {"step": torch.tensor(1, dtype=torch.int32)})
    CheckpointManager(str(tmp_path / "t")).save(1, tree)
    RManager(str(tmp_path / "r")).save(
        1, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree))
    read = lambda d: json.load(open(d / "step_00000001"  # noqa: E731
                                    / "manifest.host0.json"))
    assert read(tmp_path / "t") == read(tmp_path / "r")
    assert "0/blocks/b0/attn/wq" in read(tmp_path / "t")["leaves"]


def test_bf16_moments_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"m": torch.from_numpy(rng.standard_normal((16, 8))
                                  .astype(np.float32)).bfloat16(),
            "v": torch.tensor([1e-30, 3e38, -0.0, 1.5]).bfloat16(),
            "p": torch.ones(3)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, tree)
    meta = json.load(open(tmp_path / "step_00000002" / "manifest.host0.json"))
    assert meta["leaves"]["m"]["dtype"] == "bfloat16"
    got, _ = mgr.restore(2, _zeros(tree))
    _equal(got, tree)


# -- DTensor shards over 4 gloo ranks -----------------------------------------


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    with LocalGroup(4) as group:
        return d, group.run(ranks.elastic, str(d)), group.run(ranks.constrain)


@pytest.fixture
def elastic(group_runs):
    return group_runs[:2]


def test_dtensor_shards_and_offsets(elastic):
    d, _ = elastic
    step = d / "step_00000001"
    for r in range(4):
        with np.load(step / f"w.host{r}.npz") as z:
            assert z.files == ["shard_0", "index_0"]
            np.testing.assert_array_equal(z["index_0"],
                                          [[2 * r, 2 * r + 2], [0, 4]])
            np.testing.assert_array_equal(
                z["shard_0"], np.arange(32.0).reshape(8, 4)[2 * r:2 * r + 2])
    # a replicated DTensor is written once; a plain tensor by every rank
    assert [np.load(step / f"rep.host{r}.npz").files for r in range(4)] == \
        [["shard_0", "index_0"], [], [], []]
    assert all(np.load(step / f"step.host{r}.npz").files ==
               ["shard_0", "index_0"] for r in range(4))


def test_reference_reads_dtensor_checkpoint(elastic):
    d, _ = elastic
    got, _ = RManager(str(d)).restore(
        1, {"w": jnp.zeros((8, 4)), "rep": jnp.zeros(3),
            "step": jnp.zeros((), jnp.int32)})
    np.testing.assert_array_equal(np.asarray(got["w"]),
                                  np.arange(32.0).reshape(8, 4))
    assert int(got["step"]) == 1


def test_elastic_restore_onto_another_mesh(elastic):
    _, outs = elastic
    want = np.arange(32.0).reshape(8, 4)
    for out in outs:
        np.testing.assert_array_equal(out["full"], want)
        a = out["coord"][0]                      # "a" splits dim 1 in two
        np.testing.assert_array_equal(out["local"],
                                      want[:, 2 * a:2 * a + 2])
        assert out["placements"] == "(Shard(dim=1), Replicate())"
        assert out["step"] == 1
        np.testing.assert_array_equal(out["rep"], np.arange(3.0))


def test_constrain_redistributes_dtensor_activations(group_runs):
    for out in group_runs[2]:
        assert out["seq"] == "(Shard(dim=0), Shard(dim=1))"
        assert out["odd"] == "(Shard(dim=0), Replicate())"   # 7 % 2 != 0
        assert out["tree"] == out["seq"]
        assert out["plain_passes"] and out["outside"] and out["values"]
        assert out["pod_data"] == "(Shard(dim=0), Shard(dim=0))"
        assert "mesh order" in out["order"]
