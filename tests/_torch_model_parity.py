"""Shared set-up of the model parity tests (``test_torch_models.py``,
``test_torch_models_decode.py``): each registry config ``reduced()`` with
the reference's weights carried across, seeded inputs, and the logits
tolerance, 1e-4 of max(1, max|ref|)."""
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
