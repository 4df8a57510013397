"""Shared set-up of the model parity tests (``test_torch_models.py``,
``test_torch_models_decode.py``, ``test_torch_loss.py``,
``test_torch_train.py``): each registry config ``reduced()`` with the
reference's weights carried across, seeded inputs, the logits tolerance,
1e-4 of max(1, max|ref|), and the training tolerances with their leaf
and tree comparisons."""
import dataclasses
import functools

import jax
import numpy as np
import torch

import repro.configs as RC
from repro.models import model as RM
import repro_torch.configs as TC
from repro_torch.models import model as TM

B, S, STEPS = 2, 32, 8
TOL = 1e-4
TOL_LOSS = 1e-5         # training parity: the loss, relative
TOL_GRAD = 1e-4         # each gradient leaf, of max(1, max|ref|)
# tests/test_train.py's config
SMALL = dict(name="t", family="dense", d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab_size=128, block_pattern=("attn_mlp",), repeat=2,
             head_dim=16, attn_chunk=16, vocab_pad_multiple=32)
ARCHS = sorted(RC.REGISTRY)


def _close(got, ref, what):
    ref = np.asarray(ref, np.float64)
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(got - ref).max())
    bound = TOL * max(1.0, float(np.abs(ref).max()))
    assert err <= bound, f"{what}: {err} > {bound}"


def _caches_close(got, ref, what):
    ref_leaves = jax.tree.leaves(ref)
    got_leaves = TM.tree_leaves(got)
    assert len(got_leaves) == len(ref_leaves), what
    for i, (g, r) in enumerate(zip(got_leaves, ref_leaves)):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape, (what, i)
        if r.dtype == np.int32:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=f"{what} {i}")
        else:
            _close(g, r, f"{what} leaf {i}")


@functools.lru_cache(maxsize=None)
def _setup(arch):
    rcfg = RC.get_config(arch).reduced()
    tcfg = TC.get_config(arch).reduced()
    rp = RM.init_params(jax.random.PRNGKey(0), rcfg)
    # the reference's model as its decode and direct conv define it (F6)
    rcfg = dataclasses.replace(rcfg, use_fft_conv=False)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, rp), tcfg,
                              device="cpu")
    rng = np.random.default_rng(1)
    inputs = {"tokens": rng.integers(0, rcfg.vocab_size, (B, S))
              .astype(np.int32)}
    if rcfg.input_mode == "embeddings":
        inputs = {"embeds": rng.standard_normal((B, S, rcfg.d_model))
                  .astype(np.float32)}
    steps = rng.integers(0, rcfg.vocab_size, (STEPS, B)).astype(np.int32)
    return rcfg, tcfg, rp, tp, inputs, steps


def _torch_inputs(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def _leaf_close(got, ref, what, tol=TOL_GRAD):
    ref = np.asarray(ref, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    bound = tol * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    assert err <= bound, f"{what}: {err} > {bound}"


def _tree_close(got, ref, what, tol=TOL_GRAD):
    ref_flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_flat = TM.tree_flatten_with_paths(got)
    assert len(got_flat) == len(ref_flat), what
    for (path, g), (rpath, r) in zip(got_flat, ref_flat):
        assert "/".join(path) == "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in rpath)
        _leaf_close(g, r, f"{what} {'/'.join(path)}", tol)
