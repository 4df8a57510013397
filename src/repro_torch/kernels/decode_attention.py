"""One-token GQA flash-decode attention against a KV cache: the CUDA kernel
and its plain PyTorch version.

Replaces ``repro/kernels/decode_attention.py::_decode_kernel``.  q is
(B, H, D); the caches are (B, S, KV, D) in float32 or bfloat16 with query
head h reading KV head ``h // (H // KV)``; ``kv_pos`` (B, S) int32 holds
each slot's token position (-1 for an empty slot, ring caches wrap) and
``q_pos`` (B,) the query's.  A slot is visible when
``0 <= pos <= q_pos`` (and ``pos > q_pos - window`` with a window).
Masked scores are the finite :data:`NEG_INF`, so a row with no visible
slot gets the mean of V, as the dense reference does.

The TPU kernel carries its online softmax across a sequential chunk grid;
``csrc/decode_attention.cu`` splits the cache across blocks instead
(flash-decoding) and merges the splits' partial softmax states in a second
launch.  A split holds up to ``chunk`` slots, fewer when the heads' scores
would overflow the block's shared memory, so ``chunk`` moves only the
order of fp32 sums.  What bounds it: bytes (the caches, read once in their
storage dtype).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.fft1d import assert_full_fp32
from . import _build

NEG_INF = -1e30
# scores one block keeps in shared memory: heads (padded to 4) x slots
SCORE_FLOATS = 8192


def decode_attention_plain(q, k_cache, v_cache, kv_pos, q_pos, *,
                           window=None):
    """The dense formula of the reference's oracle: fp32 scores of the
    1/sqrt(D)-scaled q, masked softmax, fp32 product with V, cast to
    ``q.dtype``."""
    b, h, d = q.shape
    kvh = k_cache.shape[2]
    if q.is_cuda:
        assert_full_fp32()
    qg = q.float().reshape(b, kvh, h // kvh, d) / math.sqrt(d)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float())
    mask = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window is not None:
        mask &= kv_pos > (q_pos[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def split_length(s: int, chunk: int, group: int) -> int:
    """Cache slots a block reduces: ``chunk``, at most the cache, and few
    enough that the group's scores fit :data:`SCORE_FLOATS`."""
    g4 = -(-group // 4) * 4
    return max(1, min(chunk, s, SCORE_FLOATS // g4))


_ARGS = [_build.P] * 9 + [_build.L] + [_build.I] * 10 + [_build.P]


def decode_attention_cuda(q, k_cache, v_cache, kv_pos, q_pos, *,
                          window=None, chunk: int = 512):
    """Launch the split and merge kernels on CUDA operands; returns
    (B, H, D) in ``q.dtype``."""
    _build.check_decode_operands(q, k_cache, v_cache, kv_pos, q_pos)
    b, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    group = h // kvh
    split = split_length(s, chunk, group)
    nsplit = -(-s // split)
    dev = q.device
    m = torch.empty((b, kvh, nsplit, group), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, kvh, nsplit, group, d), dtype=torch.float32,
                      device=dev)
    out = torch.empty_like(q)
    vec = d % 4 == 0 and all(t.data_ptr() % 16 == 0
                             for t in (k_cache, v_cache))
    # a window beyond int32 masks as the nearest int32 does
    win = 0 if window is None else min(max(int(window), -2**31), 2**31 - 1)
    bf16 = torch.bfloat16
    fn = _build.function("decode_attention", "decode_attention", _ARGS)
    ptrs = [q, k_cache, v_cache, kv_pos, q_pos, m, l, acc, out]
    _build.launch(fn, [t.data_ptr() for t in ptrs] + [
        b, s, h, kvh, d, split, win, int(window is not None),
        int(q.dtype == bf16), int(k_cache.dtype == bf16), int(vec)],
        "decode_attention", dev)
    return out
