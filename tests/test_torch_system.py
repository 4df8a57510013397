"""End to end on the CPU: the port of ``tests/test_system.py`` (train the
reduced FNet-style model until its loss drops, checkpoint mid-run,
resume, and continue to within 1e-6 of the straight run), and
``python -m repro_torch.launch.train`` run, then resumed from its
mid-run checkpoint to the same final checkpoint, and its ``--mesh``
refusals and sharded step."""
import datetime
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as C
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import init_opt_state, make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops run faster on one intra-op thread, and the suite's
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fnet_technique_end_to_end(tmp_path):
    cfg = C.get_config("fnet_demo").reduced()
    assert cfg.block_pattern == ("fourier_mlp",)       # FFT token mixing
    data = SyntheticLM(DataConfig(seq_len=32, global_batch=8, seed=0), cfg,
                       device="cpu")
    ocfg = opt_lib.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=80)

    def fresh():
        params = M.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
        return params, init_opt_state(cfg, ocfg, params)

    params, state = fresh()
    step = make_train_step(cfg, ocfg)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    losses = []
    for i in range(40):
        params, state, metrics = step(params, state, data.batch_at(i))
        losses.append(float(metrics["loss"]))
        if i == 19:
            mgr.save(19, (params, state), extra={"data_step": 20})
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])

    # crash + resume from step 19: the continuation is the same
    (params2, state2), extra = mgr.restore(19, fresh())
    for i in range(int(extra["data_step"]), 40):
        params2, state2, _ = step(params2, state2, data.batch_at(i))
    for a, b in zip(M.tree_leaves(params), M.tree_leaves(params2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def _launch(ckpt_dir):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--arch", "fnet_demo", "--steps", "6",
         "--ckpt-every", "3", "--seq-len", "32", "--log-every", "1",
         "--ckpt-dir", str(ckpt_dir)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_launch_train_runs_and_resumes(tmp_path):
    first = _launch(tmp_path / "a")
    assert "[train] step     5 loss" in first and "tokens/sec" in first
    mgr = CheckpointManager(str(tmp_path / "a"))
    assert mgr.all_steps() == [3, 6]
    # a crash after step 3: only its checkpoint is left
    shutil.copytree(tmp_path / "a" / "step_00000003",
                    tmp_path / "b" / "step_00000003")
    second = _launch(tmp_path / "b")
    assert "resumed from step 3" in second
    assert "step     3 loss" not in second and "step     4 loss" in second
    cfg = C.get_config("fnet_demo").reduced()
    params = M.init_params(torch.Generator().manual_seed(1), cfg,
                           device="cpu")
    target = (params, init_opt_state(cfg, opt_lib.AdamWConfig(), params))
    a, extra = mgr.restore(6, target)
    b, _ = CheckpointManager(str(tmp_path / "b")).restore(6, target)
    assert extra == {"data_step": 6}
    assert int(a[1]["step"]) == 6
    for x, y in zip(M.tree_leaves(a), M.tree_leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)


def test_launch_train_mesh_refusals(tmp_path, monkeypatch, capsys):
    argv = ["--device", "cpu", "--reduced", "--arch", "fnet_demo",
            "--steps", "1", "--ckpt-dir", str(tmp_path / "c")]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="256 ranks"):
        launch_train.main(argv + ["--mesh", "single"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="needs 512 ranks"):
            launch_train.main(argv + ["--mesh", "multi"])
        # a group of the mesh's size runs the sharded step on DTensors
        monkeypatch.setattr(
            mesh_lib, "make_production_mesh",
            lambda **kw: mesh_lib.make_mesh((1, 1), ("data", "model"),
                                            device="cpu"))
        capsys.readouterr()
        launch_train.main(argv + ["--mesh", "single"])
        out = capsys.readouterr().out
        assert "mesh {'data': 1, 'model': 1}, the step on DTensors" in out
        assert "[train] step     0" in out and "[train] done" in out
    finally:
        dist.destroy_process_group()
