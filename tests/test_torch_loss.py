"""The port's loss (``repro_torch.models.model.loss_fn``) and its
gradients against the reference's, on the CPU.

``loss_fn`` and every gradient leaf for each registry config
``reduced()`` at B 2, S 32, with the reference's ``init_params`` weights
(``params_from_numpy``) and seeded numpy tokens and labels, against
``jax.value_and_grad(loss_fn)``: the loss within 1e-5 relative, each leaf
within 1e-4 of max(1, max|ref|).  ``ssm_demo`` runs the direct conv on
both sides (ROADMAP §3 F6), and once more with the port's FFT conv
(``fftconv_fused``'s plain version and its VJP).  The batch's seed is 5:
at seed 4 one mLSTM denominator of ``xlstm-350m`` sits within 2e-7
(relative) of its exp(-m) floor, a kink of the gradient, and the two
packages' fp32 forwards (each ~1e-5 from float64) fall on its two sides;
neither gradient is then the other's.  Then an explicit mask and a length
the loss chunk does not divide, and the SSD scan past an exp overflow
(F9).  ``test_torch_train.py`` holds the optimizer and the train step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as RM
from repro.models.config import ModelConfig as RConfig
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig as TConfig

from _torch_model_parity import (ARCHS, B, S, SMALL, TOL_LOSS,
                                 _leaf_close, _setup, _tree_close)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops run faster on one intra-op thread, and the suite's
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rcfg, seed=5):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    if rcfg.input_mode == "embeddings":
        return {"embeds": rng.standard_normal((B, S, rcfg.d_model))
                .astype(np.float32), "labels": labels}
    return {"tokens": rng.integers(0, rcfg.vocab_size, (B, S))
            .astype(np.int32), "labels": labels}


def _port_loss_grads(tp, tcfg, batch):
    live = TM.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss, metrics = TM.loss_fn(live, tcfg,
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    leaves = TM.tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)])
    paths = [p for p, _ in TM.tree_flatten_with_paths(live)]
    by_path = dict(zip(paths, it))
    return loss, metrics, TM.tree_map_with_path(lambda p, _: by_path[p], tp)


def _check_loss_grads(arch, tcfg):
    rcfg, _, rp, tp, _, _ = _setup(arch)
    batch = _batch(rcfg)
    ref_fn = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, b), has_aux=True))
    (r_loss, r_metrics), r_grads = ref_fn(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _port_loss_grads(tp, tcfg, batch)
    rel = abs(float(loss.detach()) - float(r_loss)) / abs(float(r_loss))
    assert rel <= TOL_LOSS, f"{arch} loss {float(loss)} vs {float(r_loss)}"
    for k in ("ce", "aux"):
        _leaf_close(metrics[k], r_metrics[k], f"{arch} {k}")
    _tree_close(grads, r_grads, f"{arch} grad")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    _, tcfg, _, _, _, _ = _setup(arch)
    _check_loss_grads(arch, dataclasses.replace(tcfg, use_fft_conv=False))


def test_ssm_demo_grads_through_the_fft_conv():
    _, tcfg, _, _, _, _ = _setup("ssm_demo")
    assert tcfg.use_fft_conv and tcfg.fft_backend == "cuda"
    _check_loss_grads("ssm_demo", tcfg)


def test_loss_masks_and_odd_lengths():
    """An explicit mask, and a sequence the loss chunk does not divide
    (one chunk of the whole sequence), against the reference."""
    cfg, rcfg = TConfig(**SMALL), RConfig(**SMALL)
    rp = RM.init_params(jax.random.PRNGKey(1), rcfg)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, rp), cfg,
                              device="cpu")
    rng = np.random.default_rng(5)
    for s in (24, 512 + 8):
        toks = rng.integers(0, 128, (2, s)).astype(np.int32)
        labels = rng.integers(0, 128, (2, s)).astype(np.int32)
        mask = (rng.random((2, s)) < 0.7).astype(np.float32)
        batch = {"tokens": toks, "labels": labels, "mask": mask}
        r_loss, _ = RM.loss_fn(rp, rcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        with torch.no_grad():
            loss, _ = TM.loss_fn(tp, cfg, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
        assert abs(float(loss) - float(r_loss)) <= TOL_LOSS * float(r_loss)


def test_ssd_grads_finite_past_exp_overflow():
    """ROADMAP §3 F9: at ``ssm_demo``'s chunk of 64, seg_t - seg_u above
    the diagonal passes 88 and exp overflows.  The reference masks after
    the exp, so its backward multiplies inf by 0 and every gradient is
    NaN; the port masks before it.  Forward equal to the reference's, and
    the gradients against autograd through the step-by-step recurrence in
    float64."""
    from repro.models import ssm as r_ssm
    from repro_torch.models import ssm as t_ssm
    cfg = dataclasses.replace(TConfig(**SMALL), ssm_chunk=64)
    rcfg = dataclasses.replace(RConfig(**SMALL), ssm_chunk=64)
    rng = np.random.default_rng(6)
    b, s, h, p, n = 1, 128, 2, 4, 4
    ins = [rng.standard_normal((b, s, h, p)),
           rng.uniform(0.1, 0.2, (b, s, h)),
           np.array([-1.0, -16.0]),
           rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n)),
           np.ones(h)]
    ins = [a.astype(np.float32) for a in ins]
    cot = rng.standard_normal((b, s, h, p)).astype(np.float32)

    def ref_loss(x, dt, bi, ci):
        y, _ = r_ssm._ssd_chunked(x, dt, jnp.asarray(ins[2]), bi, ci,
                                  jnp.asarray(ins[5]), rcfg)
        return jnp.sum(y * cot), y

    (_, r_y), r_g = jax.value_and_grad(ref_loss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        *(jnp.asarray(ins[i]) for i in (0, 1, 3, 4)))
    assert not all(np.isfinite(np.asarray(g)).all() for g in r_g)

    t = [torch.from_numpy(a).requires_grad_(i in (0, 1, 3, 4))
         for i, a in enumerate(ins)]
    y, _ = t_ssm._ssd_chunked(*t, cfg)
    _leaf_close(y, r_y, "ssd forward", 1e-5)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                              [t[i] for i in (0, 1, 3, 4)])

    d = [torch.from_numpy(a).double().requires_grad_(i in (0, 1, 3, 4))
         for i, a in enumerate(ins)]
    x, dt, a, bi, ci, dskip = d
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    ys = []
    for step in range(s):
        decay = torch.exp(dt[:, step] * a)                  # (B, H)
        state = decay[..., None, None] * state + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, step], x[:, step], bi[:, step])
        ys.append(torch.einsum("bhpn,bn->bhp", state, ci[:, step])
                  + dskip[:, None] * x[:, step])
    want = torch.autograd.grad(
        (torch.stack(ys, 1) * torch.from_numpy(cot).double()).sum(),
        [x, dt, bi, ci])
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g.double() - w).abs().max()) <= 1e-4 * max(
            1.0, float(w.abs().max()))
