"""Rank functions of the sharded serving tests' 4-rank gloo group
(``test_torch_sharded_serve.py``).  A module of its own, importing torch
and the port only, so the spawned ranks do not import JAX."""
import contextlib

import numpy as np
import torch

MESH = ((2, 2), ("data", "model"))


def _full(t):
    """A leaf's full value as numpy (a collective on every rank)."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t) \
        .detach().numpy()


def _laid_out(arch, params_np, batch, max_len, mesh):
    """The reduced config, its params laid out by ``param_shardings`` and
    a zero fp32 cache of ``batch`` rows laid out by ``cache_shardings``."""
    import repro_torch.configs as C
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as M
    cfg = C.get_config(arch).reduced()
    params = M.params_from_numpy(params_np, cfg, device="cpu")
    params = sh.lay_out(params, sh.param_shardings(cfg, mesh, params))
    cache = M.init_cache(cfg, batch, max_len, torch.float32, device="cpu")
    cache = sh.lay_out(cache, sh.cache_shardings(cfg, mesh, cache, batch))
    return cfg, params, cache


def _rows(cfg, mesh, t):
    from repro_torch.launch import sharding as sh
    return sh.lay_out(t, sh.batch_shardings(cfg, mesh, t))


def serve(arch, params_np, prompt_np, steps_np, max_len):
    """Prefill ``prompt_np`` (B, S) (or embeddings (B, S, d)) into a cache
    laid out by ``cache_shardings`` on the (2, 2) mesh, then one decode
    step a column of ``steps_np`` (B, T) at positions S, S + 1, ...,
    under ``sharding.serve_spec`` (batch split, or the slots split when B
    does not divide the data ranks).  Returns every step's logits and the
    final caches, full, with the caches' placements."""
    from repro_torch.dist import make_mesh
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E
    torch.set_num_threads(1)
    mesh = make_mesh(*MESH, device="cpu")
    b, s = prompt_np.shape[:2]
    cfg, params, cache = _laid_out(arch, params_np, b, max_len, mesh)
    key = "embeds" if prompt_np.ndim == 3 else "tokens"
    batch = {key: _rows(cfg, mesh, torch.from_numpy(prompt_np))}
    logits = []
    with sh.serve_spec(mesh, b), torch.no_grad():
        lg, cache = E.prefill_fn(cfg)(params, batch, cache)
        logits.append(_full(lg))
        for t in range(steps_np.shape[1]):
            tok = _rows(cfg, mesh, torch.from_numpy(steps_np[:, t]))
            pos = _rows(cfg, mesh, torch.full((b,), s + t, dtype=torch.int32))
            lg, cache = E.decode_fn(cfg)(params, tok, cache, pos)
            logits.append(_full(lg))
    return {"logits": logits, "cache": M.tree_map(_full, cache),
            "placements": M.tree_map(lambda t: repr(t.placements), cache)}


def attend(q_np, k_np, v_np, kv_pos_np, q_pos_np, window):
    """``layers.attend_cache`` on a cache laid out sequence-parallel (the
    slots over ``data``, the KV heads over ``model``) under the slot spec:
    the output, full."""
    import dataclasses
    import repro_torch.configs as C
    from repro_torch.dist import make_mesh
    from repro_torch.launch import sharding as sh
    from repro_torch.models import layers
    torch.set_num_threads(1)
    mesh = make_mesh(*MESH, device="cpu")
    cfg = dataclasses.replace(C.get_config("h2o-danube-1.8b").reduced(),
                              sliding_window=window)
    kv = sh.NamedSharding(mesh, (None, "data", "model", None))
    k, v = (kv.distribute(torch.from_numpy(a)) for a in (k_np, v_np))
    kv_pos = sh.NamedSharding(mesh, (None, "data")).distribute(
        torch.from_numpy(kv_pos_np))
    q = sh.NamedSharding(mesh, (None, "model", None)).distribute(
        torch.from_numpy(q_np))
    q_pos = sh.NamedSharding(mesh, (None,)).distribute(
        torch.from_numpy(q_pos_np))
    with sh.serve_spec(mesh, q_np.shape[0]), torch.no_grad():
        out = layers.attend_cache(q, k, v, kv_pos, q_pos, cfg)
    return _full(out)


def counted_decode(arch, params_np, prompt_np, token_np, max_len,
                   fake=False):
    """One decode step of ``arch`` (``.reduced()``) after a prefill of
    ``prompt_np``, on the (2, 2) mesh of the initialised group, the step
    alone under ``analysis.opcount.OpCount``: the collective record this
    rank counted.  ``fake=True`` runs it under ``FakeTensorMode`` (a fake
    group's dry run)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.analysis.opcount import OpCount
    from repro_torch.dist import make_mesh
    from repro_torch.launch import sharding as sh
    from repro_torch.serve import engine as E
    torch.set_num_threads(1)
    mesh = make_mesh(*MESH, device="cpu")
    b, s = prompt_np.shape
    with (FakeTensorMode(allow_non_fake_inputs=True) if fake
          else contextlib.nullcontext()):
        cfg, params, cache = _laid_out(arch, params_np, b, max_len, mesh)
        batch = {"tokens": _rows(cfg, mesh, torch.from_numpy(prompt_np))}
        tok = _rows(cfg, mesh, torch.from_numpy(token_np))
        pos = _rows(cfg, mesh, torch.full((b,), s, dtype=torch.int32))
        with sh.serve_spec(mesh, b), torch.no_grad():
            _, cache = E.prefill_fn(cfg)(params, batch, cache)
            with OpCount() as oc:
                E.decode_fn(cfg)(params, tok, cache, pos)
    return oc.cost.collective_record()

