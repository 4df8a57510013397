"""The port's sharding rules and meshes (``repro_torch.launch.sharding``,
``.mesh``) against the reference's, on the CPU.

Every leaf of every registry config's full-size param tree (shapes from
the reference's ``abstract_params``), under both profiles, on the
production meshes (16, 16) and (2, 16, 16), gets the reference's spec.
The meshes are stand-ins with ``shape`` and ``axis_names``, which is all
``_param_spec``, ``_fit`` and ``data_axes`` read; for the functions that
build ``NamedSharding``s the reference's is swapped for one that returns
its spec.  Then ``_fit``'s degradation, the batch, cache, optimizer and
replicated rules, ``make_batch_specs``, and ``make_mesh``'s refusals."""
import types

import jax
import pytest
import torch

import repro.configs as RC
from repro.data import pipeline as r_pipeline
from repro.launch import mesh as r_mesh
from repro.launch import sharding as r_sh
from repro.models import model as RM
import repro_torch.configs as TC
from repro_torch.data import pipeline as t_pipeline
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_sh
from repro_torch.models import model as TM

ARCHS = sorted(RC.REGISTRY)


def _mesh(shape, axes):
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=tuple(axes))


MESHES = {"single": _mesh((16, 16), ("data", "model")),
          "multi": _mesh((2, 16, 16), ("pod", "data", "model"))}


def _keys(path):
    return [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]


@pytest.fixture(autouse=True)
def spec_only(monkeypatch):
    """The reference's NamedSharding needs a real mesh: return the spec."""
    monkeypatch.setattr(r_sh, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    tree = RM.abstract_params(rcfg)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    for mesh in MESHES.values():
        for profile in ("tp2d", "fsdp"):
            for path, leaf in leaves:
                keys = _keys(path)
                want = r_sh._param_spec(keys, leaf.shape, rcfg, mesh, profile)
                got = t_sh._param_spec(keys, leaf.shape, tcfg, mesh, profile)
                assert got == tuple(want), (arch, profile, keys)
        got = t_sh.param_shardings(tcfg, mesh, tree)
        want = r_sh.param_shardings(rcfg, mesh, tree)
        flat = dict(TM.tree_flatten_with_paths(got))
        for path, spec in jax.tree_util.tree_flatten_with_path(want)[0]:
            assert flat[tuple(_keys(path))].spec == tuple(spec)


def test_fit_degrades():
    mesh = MESHES["multi"]
    for spec, shape in [(("model", ("pod", "data")), (32000, 2560)),
                        (("model", ("pod", "data")), (32000, 80)),
                        ((("pod", "data", "model"), None), (1024, 3)),
                        ((("pod", "data", "model"), None), (512, 3)),
                        ((None, "model", "data"), (4, 20, 17)),
                        (("data",), (8,))]:
        assert t_sh._fit(spec, shape, mesh) == \
            tuple(r_sh._fit(spec, shape, mesh)), (spec, shape)
    assert t_mesh.data_axes(mesh) == r_mesh.data_axes(mesh) == \
        ("pod", "data")
    assert t_mesh.data_axes(MESHES["single"]) == ("data",)
    assert t_mesh.model_axis(mesh) == "model"


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "hubert-xlarge",
                                  "zamba2-2.7b", "xlstm-350m"])
@pytest.mark.parametrize("batch", [1, 32, 128])
def test_batch_cache_and_opt_specs_match_reference(arch, batch):
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    for mesh in MESHES.values():
        rspecs = r_pipeline.make_batch_specs(rcfg, 4096, batch)
        tspecs = t_pipeline.make_batch_specs(tcfg, 4096, batch)
        want = r_sh.batch_shardings(rcfg, mesh, rspecs)
        got = t_sh.batch_shardings(tcfg, mesh, tspecs)
        assert {k: v.spec for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
        cache = jax.eval_shape(lambda: RM.init_cache(rcfg, batch, 64))
        want = r_sh.cache_shardings(rcfg, mesh, cache, batch)
        got = dict(TM.tree_flatten_with_paths(
            t_sh.cache_shardings(tcfg, mesh, cache, batch)))
        for path, spec in jax.tree_util.tree_flatten_with_path(want)[0]:
            assert got[tuple(_keys(path))].spec == tuple(spec), path
    params = RM.abstract_params(rcfg.reduced())
    opt = {"step": 0, "m": params, "v": params}
    mesh = MESHES["single"]
    got = t_sh.opt_shardings(tcfg.reduced(), mesh, opt, params)
    want = r_sh.opt_shardings(rcfg.reduced(), mesh, opt, params)
    assert got["step"].spec == tuple(want["step"]) == ()
    assert TM.tree_map(lambda s: s.spec, got["m"]) == \
        jax.tree.map(tuple, want["m"], is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    rep = t_sh.replicated(mesh, {"a": torch.ones(2), "b": (torch.ones(3),)})
    assert [s.spec for s in TM.tree_leaves(rep)] == [(), ()]


def test_make_mesh_refuses_without_a_matching_group():
    with pytest.raises(RuntimeError, match="initialised process group"):
        t_mesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        t_mesh.make_mesh((2, 2), ("a", "b"), device="cpu")
