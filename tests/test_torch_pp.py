"""The pipeline-parallel train step (``repro_torch.launch.pp_variant``,
ROADMAP §1 item 15c) on 4 spawned gloo ranks, mesh (pod 2, data 1, model
2): ``h2o-danube-1.8b`` ``.reduced()`` (2 layers, one a stage), a batch
of 4 x 32 tokens in 4 microbatches.  Each rank's loss and the grads of
its stage (its layer, the embedding and the final norm) are held within
1e-5 of the reference's value-and-grad of the same loss (embed, every
layer through ``_block_apply``, final norm, unembed, full
``log_softmax``) computed layer by layer on one device, and the step's
grad norm (every stage's blocks summed over ``pod``) to the reference's
global norm."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as RC
from repro.models import layers as RL
from repro.models import model as RM
import repro_torch.configs as TC
from repro_torch.dist.local import LocalGroup
from repro_torch.models import model as TM

import _torch_train_ranks as ranks

ARCH = "h2o-danube-1.8b"
B, S, MICRO = 4, 32, 4
TOL = 1e-5


def _batch(cfg):
    rng = np.random.default_rng(3)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _ref_loss(cfg):
    """The pipeline loss on one device, layer by layer (float32, as the
    pipeline variant's config)."""
    def loss(p, batch):
        x = RL.embed(p["embed"], batch["tokens"], cfg)
        pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
        for r in range(cfg.repeat):
            lp = jax.tree.map(lambda t: t[r], p["blocks"])
            for j, blk in enumerate(cfg.block_pattern):
                x, _ = RM._block_apply(lp[f"b{j}"], None, blk, x, cfg, pos)
        x = RL.norm_apply(p["final_norm"], x, cfg)
        logp = jax.nn.log_softmax(
            RL.unembed(p["embed"], x, cfg).astype(jnp.float32), -1)
        return -jnp.take_along_axis(logp, batch["labels"][..., None],
                                    -1)[..., 0].mean()
    return loss


@pytest.fixture(scope="module")
def runs():
    rcfg = RC.get_config(ARCH).reduced()
    rp = jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(0),
                                                 rcfg))
    batch = _batch(TC.get_config(ARCH).reduced())
    with LocalGroup(4) as group:
        got = group.run(ranks.pp_step, ARCH, rp, batch, MICRO)
    loss, grads = jax.jit(jax.value_and_grad(_ref_loss(rcfg)))(
        jax.tree.map(jnp.asarray, rp), batch)
    return got, float(loss), jax.tree.map(np.asarray, grads)


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    bound = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: {err} > {bound}"


def test_pipeline_loss_matches_the_sequential_reference(runs):
    got, loss, _ = runs
    for r in got:
        _close(r["loss"], loss, f"rank {r['rank']} loss")
        _close(r["step_loss"], loss, f"rank {r['rank']} step loss")


def test_each_stage_grads_match_the_reference(runs):
    got, _, grads = runs
    assert sorted(r["stage"] for r in got) == [0, 0, 1, 1]
    for r in got:
        s = r["stage"]
        want = dict(grads, blocks=jax.tree.map(lambda t: t[s:s + 1],
                                               grads["blocks"]))
        got_flat = TM.tree_flatten_with_paths(r["grads"])
        want_flat = TM.tree_flatten_with_paths(want)
        assert [p for p, _ in got_flat] == [p for p, _ in want_flat]
        for (path, g), (_, w) in zip(got_flat, want_flat):
            _close(g, w, f"rank {r['rank']} {'/'.join(path)}")


def test_grad_norm_covers_every_stage(runs):
    got, _, grads = runs
    norm = float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                             for g in jax.tree.leaves(grads))))
    for r in got:
        _close(r["grad_norm"], norm, f"rank {r['rank']} grad norm")
