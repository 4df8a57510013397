"""The port's flash attention (``repro_torch.models.flash``: the chunked
forward and its hand-written backward) against the reference's custom-VJP
``repro.models.flash.flash_attention``, on the CPU.

Every case of ``tests/test_flash.py`` (windows, causal and non-causal,
chunks 8/16/40/64, MHA, padded KV) plus queries that see no key at all:
the same seeded numpy q, k, v and cotangent through both, the output and
dq/dk/dv (``jax.grad`` of sum(sin(out)) against ``torch.autograd``) within
2e-5 absolute, the reference's own bound.  Then the port's dense check:
gradients under ``torch.utils.checkpoint`` equal the plain ones."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models.flash import flash_attention as r_flash
from repro_torch.models.flash import flash_attention as t_flash

TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops run faster on one intra-op thread, and the suite's
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(B=2, S=40, H=4, KV=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return q, k, v, pos


def _both(q, k, v, qp, kp, chunk, window, causal):
    """(out, dq, dk, dv) of sum(sin(flash)) from each package."""
    def loss_r(q, k, v):
        out = r_flash(q, k, v, jnp.asarray(qp), jnp.asarray(kp), chunk,
                      window, causal)
        return jnp.sum(jnp.sin(out)), out

    (_, r_out), r_g = jax.value_and_grad(loss_r, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    t_out = t_flash(tq, tk, tv, torch.from_numpy(qp), torch.from_numpy(kp),
                    chunk, window, causal)
    t_g = torch.autograd.grad(torch.sin(t_out).sum(), (tq, tk, tv))
    return (np.asarray(r_out), *map(np.asarray, r_g)), \
        (t_out.detach().numpy(), *(g.numpy() for g in t_g))


def _check(ref, got):
    for name, r, g in zip(("out", "dq", "dk", "dv"), ref, got):
        assert g.shape == r.shape, name
        err = float(np.abs(g - r).max())
        assert err < TOL, f"{name}: {err}"


@pytest.mark.parametrize("window,causal", [(None, True), (16, True),
                                           (None, False)])
@pytest.mark.parametrize("chunk", [8, 16, 40, 64])
def test_forward_and_grads_match_reference(window, causal, chunk):
    q, k, v, pos = _setup()
    _check(*_both(q, k, v, pos, pos, chunk, window, causal))


@pytest.mark.parametrize("window,causal", [(None, True), (12, True),
                                           (None, False)])
def test_gradients_match_reference(window, causal):
    q, k, v, pos = _setup(seed=3)
    _check(*_both(q, k, v, pos, pos, 16, window, causal))


def test_mha_no_grouping():
    q, k, v, pos = _setup(H=4, KV=4, seed=5)
    _check(*_both(q, k, v, pos, pos, 16, None, True))


def test_padding_positions_masked():
    q, k, v, pos = _setup(seed=7)
    kp = pos.copy()
    kp[:, -8:] = -1                       # pad tail KV positions
    _check(*_both(q, k, v, pos, kp, 16, None, False))


@pytest.mark.parametrize("chunk", [8, 16])
def test_queries_with_no_visible_key(chunk):
    """Keys start at position 8 under a causal mask, so queries 0-7 see
    nothing: both packages give the NEG_INF rows' arithmetic (p = 1 over
    every masked score), forward and backward."""
    q, k, v, pos = _setup(seed=11)
    _check(*_both(q, k, v, pos, pos + 8, chunk, None, True))


def test_checkpoint_composes():
    q, k, v, pos = _setup(seed=9)
    tp = torch.from_numpy(pos)

    def grads(remat):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                      for a in (q, k, v))
        fn = lambda *a: t_flash(*a, tp, tp, 16, None, True)  # noqa: E731
        out = checkpoint(fn, tq, tk, tv, use_reentrant=False) if remat \
            else fn(tq, tk, tv)
        return [out.detach()] + list(torch.autograd.grad(out.sum(),
                                                         (tq, tk, tv)))

    for a, b in zip(grads(True), grads(False)):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)
