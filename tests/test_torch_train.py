"""The port's training half (``repro_torch.train``) against the
reference's, on the CPU.

- ``adamw_update`` and ``warmup_cosine`` against the reference's, fp32
  and bf16 moments, with and without clipping.
- Three steps of ``make_train_step`` against the reference's on
  ``tests/test_train.py``'s config, for microbatches 1 and 4 and
  ``compress="bf16"``.
- ``tests/test_train.py``'s own checks on the port: the loss falls, the
  microbatch equivalence, the schedule, clipping, bf16 moments.
- FFT tables first cast in inference mode serve a later backward (F10).

``test_torch_loss.py`` holds ``loss_fn`` and its gradients for every
registry config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.models import model as RM
from repro.models.config import ModelConfig as RConfig
from repro.train import optimizer as r_opt
from repro.train import train_step as r_step
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.train import optimizer as t_opt
from repro_torch.train.train_step import (abstract_opt_state, init_opt_state,
                                          make_train_step)

from _torch_model_parity import SMALL, _leaf_close, _tree_close

CFG, RCFG = TConfig(**SMALL), RConfig(**SMALL)


# -- optimizer -----------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops run faster on one intra-op thread, and the suite's
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "nested": {"b": rng.standard_normal(5).astype(np.float32),
                       "u": rng.standard_normal((3, 4, 2)).astype(np.float32)}}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [None, 1.0, 1e-3])
def test_adamw_update_matches_reference(moments, clip):
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=10, clip_norm=clip,
              moments_dtype=moments)
    rcfg, tcfg = r_opt.AdamWConfig(**kw), t_opt.AdamWConfig(**kw)
    rp = jax.tree.map(jnp.asarray, _opt_tree(0))
    tp = TM.tree_map(torch.from_numpy, _opt_tree(0))
    rs, ts = r_opt.adamw_init(rcfg, rp), t_opt.adamw_init(tcfg, tp)
    assert TM.tree_leaves(ts["m"])[0].dtype == getattr(torch, moments)
    for i in range(4):
        g = _opt_tree(10 + i)
        rp, rs, rm = r_opt.adamw_update(rcfg, jax.tree.map(jnp.asarray, g),
                                        rs, rp)
        tp, ts, tm = t_opt.adamw_update(tcfg, TM.tree_map(torch.from_numpy,
                                                          g), ts, tp)
        _tree_close(tp, rp, f"params {i}", 1e-6)
        for k in ("m", "v"):
            _tree_close(TM.tree_map(lambda t: t.float(), ts[k]),
                        jax.tree.map(lambda a: a.astype(jnp.float32), rs[k]),
                        f"{k} {i}", 1e-6)
        assert int(ts["step"]) == int(rs["step"])
        for k in ("grad_norm", "lr"):
            _leaf_close(tm[k], rm[k], k, 1e-6)


def test_warmup_cosine_matches_reference():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-3, warmup_steps=0, total_steps=1),
               dict(lr=2.0, warmup_steps=5, total_steps=5,
                    min_lr_ratio=0.3)):
        rcfg, tcfg = r_opt.AdamWConfig(**kw), t_opt.AdamWConfig(**kw)
        for step in (0, 1, 4, 5, 10, 50, 99, 100, 150):
            want = float(r_opt.warmup_cosine(rcfg, jnp.asarray(step)))
            got = t_opt.warmup_cosine(tcfg, torch.tensor(step,
                                                         dtype=torch.int32))
            assert abs(float(got) - want) <= 1e-7 * max(1.0, abs(want))
            assert float(t_opt.warmup_cosine(tcfg, step)) == float(got)


# -- train step ----------------------------------------------------------------


@pytest.mark.parametrize("microbatches,compress",
                         [(1, None), (4, None), (1, "bf16"), (4, "bf16")])
def test_train_step_matches_reference(microbatches, compress):
    # eps 1e-4 keeps the update Lipschitz in the gradient: at 1e-8 an
    # element whose gradient is fp32 noise (~1e-8, of sums of ~1e-2
    # terms) moves by a share of lr set by its rounding, in both packages
    ocfg_kw = dict(lr=3e-3, warmup_steps=2, total_steps=10, eps=1e-4)
    rocfg, tocfg = r_opt.AdamWConfig(**ocfg_kw), t_opt.AdamWConfig(**ocfg_kw)
    rp = RM.init_params(jax.random.PRNGKey(0), RCFG)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, rp), CFG,
                              device="cpu")
    rs = r_step.init_opt_state(RCFG, rocfg, rp, compress=compress)
    ts = init_opt_state(CFG, tocfg, tp, compress=compress)
    rfn = jax.jit(r_step.make_train_step(RCFG, rocfg,
                                         microbatches=microbatches,
                                         compress=compress))
    tfn = make_train_step(CFG, tocfg, microbatches=microbatches,
                          compress=compress)
    rdata = RSyntheticLM(RDataConfig(seq_len=32, global_batch=8, seed=2),
                         RCFG)
    tdata = SyntheticLM(DataConfig(seq_len=32, global_batch=8, seed=2), CFG,
                        device="cpu")
    for i in range(3):
        rp, rs, rm = rfn(rp, rs, rdata.batch_at(i))
        tp, ts, tm = tfn(tp, ts, tdata.batch_at(i))
        for k in ("loss", "grad_norm", "lr"):
            _leaf_close(tm[k], rm[k], f"step {i} {k}", 1e-5)
    # bf16 compression: a gradient element within fp32 noise of a bf16
    # rounding boundary rounds either way, a relative step of 2^-8 in that
    # element's update (at most one such step a train step)
    _tree_close(tp, rp, "params",
                1e-5 if compress is None else 3 * tocfg.lr * 2 ** -8)
    assert sorted(ts) == sorted(rs)
    if compress:
        # the residual is the rounding error itself, so it does not carry
        # over element for element; its dtype, shapes and size do
        for g, r in zip(TM.tree_leaves(ts["ef_residual"]),
                        jax.tree.leaves(rs["ef_residual"])):
            assert g.dtype == torch.bfloat16 and tuple(g.shape) == r.shape
            ratio = float(g.double().norm()) / max(
                float(np.linalg.norm(np.asarray(r, np.float64))), 1e-30)
            assert 0.5 <= ratio <= 2.0, ratio


def test_bf16_compression_keeps_the_rounding_error():
    """One compressed step from a zero residual: the residual is exactly
    bf16(g - bf16(g)) of the step's (clip-free) gradient."""
    from repro_torch.train.train_step import _grads_of
    ocfg = t_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)
    params = TM.init_params(torch.Generator().manual_seed(2), CFG,
                            device="cpu")
    batch = SyntheticLM(DataConfig(seq_len=32, global_batch=4), CFG,
                        device="cpu").batch_at(1)
    _, state, _ = make_train_step(CFG, ocfg, compress="bf16")(
        params, init_opt_state(CFG, ocfg, params, compress="bf16"), batch)
    _, _, grads = _grads_of(CFG, params, batch)
    for g, r in zip(TM.tree_leaves(grads),
                    TM.tree_leaves(state["ef_residual"])):
        want = (g - g.to(torch.bfloat16).float()).to(torch.bfloat16)
        assert torch.equal(r, want)


def test_train_step_leaves_its_inputs():
    ocfg = t_opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    params = TM.init_params(torch.Generator().manual_seed(0), CFG,
                            device="cpu")
    state = init_opt_state(CFG, ocfg, params)
    before = TM.tree_map(torch.clone, (params, state))
    batch = SyntheticLM(DataConfig(seq_len=32, global_batch=4), CFG,
                        device="cpu").batch_at(0)
    p2, s2, _ = make_train_step(CFG, ocfg)(params, state, batch)
    for a, b in zip(TM.tree_leaves((params, state)), TM.tree_leaves(before)):
        assert torch.equal(a, b) and not a.requires_grad
    assert any(not torch.equal(a, b) for a, b in
               zip(TM.tree_leaves(p2), TM.tree_leaves(params)))
    meta = abstract_opt_state(CFG, ocfg, params, compress="bf16")
    assert sorted(meta) == ["ef_residual", "m", "step", "v"]
    assert all(t.device.type == "meta" for t in TM.tree_leaves(meta))
    assert TM.tree_map(lambda t: (tuple(t.shape), t.dtype), meta["m"]) == \
        TM.tree_map(lambda t: (tuple(t.shape), t.dtype), s2["m"])


# -- tests/test_train.py on the port -------------------------------------------


def test_loss_decreases():
    data = SyntheticLM(DataConfig(seq_len=32, global_batch=8, seed=3), CFG,
                       device="cpu")
    ocfg = t_opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    params = TM.init_params(torch.Generator().manual_seed(0), CFG,
                            device="cpu")
    state = init_opt_state(CFG, ocfg, params)
    step = make_train_step(CFG, ocfg)
    losses = []
    for i in range(60):
        params, state, metrics = step(params, state, data.batch_at(i))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_microbatch_equivalence():
    """Accumulated grads over 4 microbatches == one big batch's update."""
    batch = SyntheticLM(DataConfig(seq_len=32, global_batch=8, seed=1), CFG,
                        device="cpu").batch_at(0)
    ocfg = t_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                             clip_norm=None)
    params = TM.init_params(torch.Generator().manual_seed(0), CFG,
                            device="cpu")
    p1, _, _ = make_train_step(CFG, ocfg, microbatches=1)(
        params, init_opt_state(CFG, ocfg, params), batch)
    p4, _, _ = make_train_step(CFG, ocfg, microbatches=4)(
        params, init_opt_state(CFG, ocfg, params), batch)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(TM.tree_leaves(p1), TM.tree_leaves(p4)))
    assert diff < 5e-5, diff


def test_warmup_cosine_schedule():
    ocfg = t_opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_ratio=0.1)
    lr0 = float(t_opt.warmup_cosine(ocfg, torch.tensor(1)))
    lr_w = float(t_opt.warmup_cosine(ocfg, torch.tensor(10)))
    lr_end = float(t_opt.warmup_cosine(ocfg, torch.tensor(100)))
    assert lr0 < 0.2 and abs(lr_w - 1.0) < 1e-5 and abs(lr_end - 0.1) < 1e-3


def test_grad_clipping():
    ocfg = t_opt.AdamWConfig(clip_norm=1e-6)
    params = {"w": torch.ones((4, 4))}
    state = t_opt.adamw_init(ocfg, params)
    grads = {"w": torch.full((4, 4), 100.0)}
    newp, _, metrics = t_opt.adamw_update(ocfg, grads, state, params)
    assert float(metrics["grad_norm"]) > 100.0       # reported pre-clip
    assert float((newp["w"] - params["w"]).abs().max()) < ocfg.lr * 2


def test_bf16_moments_halve_memory():
    ocfg = t_opt.AdamWConfig(moments_dtype="bfloat16")
    params = {"w": torch.ones((128, 128))}
    st = t_opt.adamw_init(ocfg, params)
    assert st["m"]["w"].dtype == torch.bfloat16
    newp, st2, _ = t_opt.adamw_update(ocfg, {"w": torch.ones((128, 128))},
                                      st, params)
    assert st2["v"]["w"].dtype == torch.bfloat16
    assert bool(torch.isfinite(newp["w"]).all())


def test_fft_tables_cached_in_inference_mode_serve_training():
    """ROADMAP §3 F10: a table first cast under ``torch.inference_mode``
    (a served prefill) and then read by a training step's FFT is saved
    for backward; an inference tensor there raises.  The conv's plain
    twin differentiates through the same tables."""
    from repro_torch.core import fft1d, fft_conv
    from repro_torch.core import twiddle as tw
    tw.clear_table_cache()
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 3, 60))
                         .astype(np.float32))
    k = torch.from_numpy(np.random.default_rng(8).standard_normal((3, 4))
                         .astype(np.float32))
    with torch.inference_mode():
        want = fft1d.rfft(x)
        fft_conv(x, k, backend="cuda")
    xg, kg = x.clone().requires_grad_(True), k.clone().requires_grad_(True)
    got = fft1d.rfft(xg)
    assert torch.equal(got.re.detach(), want.re)
    g, = torch.autograd.grad(got.re.sum() + got.im.sum(), xg)
    gx, gk = torch.autograd.grad(fft_conv(xg, kg, backend="cuda").square()
                                 .sum(), (xg, kg))
    assert all(bool(torch.isfinite(t).all()) for t in (g, gx, gk))
