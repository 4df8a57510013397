"""The sharded train step over DTensor (ROADMAP §1 item 14c) on the CPU.

- Op coverage: every registry config ``.reduced()`` takes one sharded
  loss, backward and AdamW step on a (2, 2) ("data", "model") mesh of a
  fake 4-rank process group in this process (no spawn: the fake group's
  collectives move no data, so only the step's ops and layouts are
  checked here), and ``python -m repro_torch.launch.train --mesh single``
  runs over a fake 256-rank group.
- Parity: one spawned 4-rank gloo group (``dist.local.LocalGroup``, rank
  functions in ``_torch_train_ranks.py``, no JAX there) runs a sharded
  step of ``h2o-danube-1.8b``, ``ssm_demo`` (a tied head) and
  ``phi3.5-moe-42b-a6.6b`` (8 experts, top 2: the experts on each rank's
  E/``model`` slice, the embedding and CE head vocab-parallel) (``.reduced()``), held to
  the reference's unsharded ``make_train_step`` under ``jax.jit`` on the
  same params and batch within ``test_torch_train.py``'s train-step
  bound, 1e-5: a sharded step computes what the unsharded one does.  ``ssm_demo`` goes against
  the reference with the direct conv (ROADMAP §3 F6) and with the FFT
  conv (on its plain version) against the port's own unsharded step.
- The same group counts one phi3.5-moe step's collectives with
  ``analysis.opcount``: each rank's bytes by kind equal, byte for byte,
  what ``opcount`` counts for rank 0 of a fake (2, 2) group under
  ``FakeTensorMode`` (a dry run's counts are a real run's).
- A sharded run saves, resumes and equals the straight run.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import repro.configs as RC
from repro.models import model as RM
from repro.train import optimizer as r_opt
from repro.train import train_step as r_step
import repro_torch.configs as TC
from repro_torch.dist.local import LocalGroup
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.launch import train as launch_train
from repro_torch.models import actsharding
from repro_torch.models import model as TM
from repro_torch.train import optimizer as t_opt
from repro_torch.train.train_step import init_opt_state, make_train_step

import _torch_train_ranks as ranks

TOL_STEP = 1e-5         # test_torch_train.py's bound (loss, grad norm, params)
# eps 1e-4 as in test_torch_train.py: the update stays Lipschitz in the
# gradient, so noise-level gradient elements move params by noise
OCFG = dict(lr=3e-3, warmup_steps=2, total_steps=10, eps=1e-4)
B, S = 4, 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_group():
    """A fake process group of ``world`` ranks, this process rank 0."""
    def start(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)) \
            .astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)) \
            .astype(np.int32)
    return batch


# -- op coverage on a fake group -----------------------------------------------

@pytest.mark.parametrize("arch", sorted(TC.REGISTRY))
def test_every_config_takes_a_sharded_step(arch, fake_group):
    fake_group(4)
    cfg = TC.get_config(arch).reduced()
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    ocfg = t_opt.AdamWConfig(**OCFG)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    params = sh.lay_out(params, sh.param_shardings(cfg, mesh, params))
    opt = init_opt_state(cfg, ocfg, params)
    opt = sh.lay_out(opt, sh.opt_shardings(cfg, mesh, opt, params))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    batch = sh.lay_out(batch, sh.batch_shardings(cfg, mesh, batch))
    with actsharding.activation_spec(mesh, mesh_lib.data_axes(mesh),
                                     "model"):
        new_p, new_o, metrics = make_train_step(cfg, ocfg)(params, opt,
                                                           batch)
    for got, old in zip(TM.tree_leaves(new_p), TM.tree_leaves(params)):
        assert got.placements == old.placements
        assert got.to_local().shape == old.to_local().shape
    assert sorted(new_o) == sorted(opt)
    assert set(metrics) >= {"loss", "grad_norm", "lr"}


def test_sharded_step_with_bf16_compression(fake_group):
    """compress="bf16" (the error-feedback residual) on DTensors: the
    residual takes its params' placements."""
    fake_group(4)
    cfg = TC.get_config("h2o-danube-1.8b").reduced()
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    ocfg = t_opt.AdamWConfig(**OCFG)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    params = sh.lay_out(params, sh.param_shardings(cfg, mesh, params))
    opt = init_opt_state(cfg, ocfg, params, compress="bf16")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    batch = sh.lay_out(batch, sh.batch_shardings(cfg, mesh, batch))
    with actsharding.activation_spec(mesh, mesh_lib.data_axes(mesh),
                                     "model"):
        _, new_o, _ = make_train_step(cfg, ocfg, compress="bf16")(
            params, opt, batch)
    for r, p in zip(TM.tree_leaves(new_o["ef_residual"]),
                    TM.tree_leaves(params)):
        assert r.dtype == torch.bfloat16 and r.placements == p.placements


def test_launch_train_mesh_single_on_256_fake_ranks(fake_group, tmp_path,
                                                    capsys):
    fake_group(256)
    launch_train.main(["--mesh", "single", "--reduced", "--device", "cpu",
                       "--steps", "1", "--seq-len", "32",
                       "--ckpt-dir", str(tmp_path / "c")])
    out = capsys.readouterr().out
    assert "mesh {'data': 16, 'model': 16}" in out
    assert "[train] done" in out


# -- parity over 4 gloo ranks --------------------------------------------------

def _ref_setup(arch, use_fft_conv=False):
    rcfg = dataclasses.replace(RC.get_config(arch).reduced(),
                               use_fft_conv=use_fft_conv)
    rp = RM.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, jax.tree.map(np.asarray, rp)


PARITY = [("h2o-danube-1.8b", False), ("ssm_demo", False),
          ("ssm_demo", True), ("phi3.5-moe-42b-a6.6b", False)]
COUNTED = "phi3.5-moe-42b-a6.6b"      # the collective-count cross-check


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    """Every rank job of this file in one spawned group: a step of each
    parity case (rank 0's results) and the resume check."""
    d = tmp_path_factory.mktemp("sharded_resume")
    jobs = {}
    with LocalGroup(4) as group:
        for arch, fft in PARITY:
            _, pnp = _ref_setup(arch)
            cfg = TC.get_config(arch).reduced()
            jobs[(arch, fft)] = group.run(ranks.sharded_step, arch, pnp,
                                          _batch(cfg), OCFG, fft)[0]
        _, pnp = _ref_setup(COUNTED)
        jobs["counted"] = group.run(ranks.counted_step, COUNTED, pnp,
                                    _batch(TC.get_config(COUNTED).reduced()),
                                    OCFG)
        _, pnp = _ref_setup("fnet_demo")
        cfg = TC.get_config("fnet_demo").reduced()
        jobs["resume"] = group.run(
            ranks.sharded_resume, "fnet_demo", pnp,
            [_batch(cfg, 1), _batch(cfg, 2)], OCFG, str(d))[0]
    return jobs


def _close(got, ref, what, tol=TOL_STEP):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    bound = tol * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    assert err <= bound, f"{what}: {err} > {bound}"


def _trees_close(got, ref, what):
    got_flat = TM.tree_flatten_with_paths(got)
    ref_flat = TM.tree_flatten_with_paths(ref)
    assert [p for p, _ in got_flat] == [p for p, _ in ref_flat], what
    for (path, g), (_, r) in zip(got_flat, ref_flat):
        _close(g, r, f"{what} {'/'.join(path)}")


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "ssm_demo",
                                  "phi3.5-moe-42b-a6.6b"])
def test_sharded_step_matches_the_reference(arch, group_runs):
    rcfg, pnp = _ref_setup(arch)
    rocfg = r_opt.AdamWConfig(**OCFG)
    rs = r_step.init_opt_state(rcfg, rocfg, pnp)
    batch = _batch(TC.get_config(arch).reduced())
    rp, _, rm = jax.jit(r_step.make_train_step(rcfg, rocfg))(
        jax.tree.map(jax.numpy.asarray, pnp), rs, batch)
    got = group_runs[(arch, False)]
    for k in ("loss", "grad_norm", "lr"):
        _close(got["metrics"][0][k], rm[k], k)
    _close(got["loss"], rm["loss"], "step-0 loss")
    _trees_close(got["params"], jax.tree.map(np.asarray, rp), "params")


def test_sharded_fft_conv_step_matches_the_unsharded_port(group_runs):
    """ssm_demo with its conv through fft_conv (on the conv's plain
    version here) against the port's own unsharded step."""
    arch = "ssm_demo"
    _, pnp = _ref_setup(arch)
    cfg = dataclasses.replace(TC.get_config(arch).reduced(),
                              use_fft_conv=True)
    ocfg = t_opt.AdamWConfig(**OCFG)
    params = TM.params_from_numpy(pnp, cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    new_p, _, metrics = make_train_step(cfg, ocfg)(
        params, init_opt_state(cfg, ocfg, params), batch)
    got = group_runs[(arch, True)]
    for k in ("loss", "grad_norm", "lr"):
        _close(got["metrics"][0][k], float(metrics[k]), k)
    _trees_close(got["params"], TM.tree_map(lambda t: t.numpy(), new_p),
                 "params")


def test_sharded_layouts_follow_the_rules(group_runs):
    """Params keep their param_shardings placements through the step, and
    the optimizer moments take the same."""
    got = group_runs[("h2o-danube-1.8b", False)]
    assert got["after"] == got["placements"]
    assert got["opt"]["m"] == got["placements"]
    assert got["opt"]["v"] == got["placements"]
    wq = got["placements"]["blocks"]["b0"]["attn"]["wq"]
    assert "Shard(dim=1)" in wq and "Shard(dim=2)" in wq   # (R, d, H*D)


def test_fake_group_counts_the_collectives_of_real_ranks(group_runs,
                                                         fake_group):
    """``analysis.opcount`` on a fake (2, 2) group under FakeTensorMode
    (a dry run: nothing moves, nothing is allocated) counts, byte for
    byte and kind by kind, the collectives each of the 4 gloo ranks
    counted on the same sharded step."""
    fake_group(4)
    _, pnp = _ref_setup(COUNTED)
    want = ranks.counted_step(COUNTED, pnp,
                              _batch(TC.get_config(COUNTED).reduced()),
                              OCFG, fake=True)
    assert want["total"] > 0 and want["count"] > 0
    for got in group_runs["counted"]:
        assert got == want


def test_sharded_run_resumes_to_the_straight_run(group_runs):
    straight, resumed = group_runs["resume"]
    _trees_close(resumed, straight, "resumed params")


def test_kernel_wrappers_refuse_dtensors(fake_group):
    """A DTensor's data_ptr is not its shard's data: every CUDA wrapper's
    operand check refuses one, naming local_map, before it looks at the
    device."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.core import SplitComplex
    from repro_torch.kernels import _build
    fake_group(4)
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")

    def dt(shape, dtype=torch.float32):
        return DTensor.from_local(torch.zeros(shape, dtype=dtype), mesh,
                                  [Shard(0), Replicate()], run_check=False)
    x = dt((4, 8))
    for operand in (x, SplitComplex(x, dt((4, 8)))):
        with pytest.raises(TypeError, match="local_map"):
            _build.check_operands(operand, 2, _build.FFT_DTYPES)
    with pytest.raises(TypeError, match="local_map"):
        _build.check_decode_operands(dt((2, 4, 8)), dt((2, 6, 2, 8)),
                                     dt((2, 6, 2, 8)),
                                     dt((2, 6), torch.int32),
                                     dt((2,), torch.int32))
