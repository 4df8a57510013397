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
(flash-decoding), carries the same online softmax from tile to tile within
a split, and merges the splits' partial softmax states in a second launch.
The split length follows from the grid (:func:`split_length`), so
``chunk``, the reference's sequential tile, only has to divide S.  Tiles
and splits with no visible slot are not read.  For bf16 q and caches with
D a multiple of 16 (up to 128) and up to 16 query heads a KV head, both
products run on the tensor cores; other dtypes and shapes take the
CUDA-core route (:func:`route`).  What bounds it: bytes (the visible
slots' K and V, read once in their storage dtype).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.fft1d import assert_full_fp32
from . import _build

NEG_INF = -1e30
BLOCKS = 1024       # split blocks a launch aims for: about 8 an SM of 132
TILE = 64           # slots a split is a multiple of (the tiles it skips)
MAX_SPLIT = 16384   # slots a split: one visibility bit each in shared memory
MMA_MAX_D = 128     # the tensor-core route's largest head dim ...
MMA_MAX_GROUP = 16  # ... and query heads a KV head (two n-tiles of 8)
MERGE_WEIGHTS = 8192  # most splits x heads a KV head the merge weighs


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


def split_length(s: int, b: int, kv: int, group: int) -> int:
    """Cache slots a block reduces: enough splits a (row, KV head) that the
    launch has about :data:`BLOCKS` blocks (no more than the merge's
    :data:`MERGE_WEIGHTS` over the group), each a multiple of :data:`TILE`
    slots (or the whole cache), at most :data:`MAX_SPLIT`."""
    want = min(-(-BLOCKS // max(1, b * kv)), max(1, MERGE_WEIGHTS // group))
    per = -(-s // want)
    split = -(-per // TILE) * TILE
    return max(1, min(split, s, MAX_SPLIT))


def route(q_dtype, kv_dtype, d: int, group: int) -> str:
    """``"mma"`` (the tensor cores) for bf16 q and caches with D a multiple
    of 16 up to :data:`MMA_MAX_D` and at most :data:`MMA_MAX_GROUP` query
    heads a KV head; else ``"cores"`` (fp32 CUDA cores)."""
    bf16 = torch.bfloat16
    if q_dtype == bf16 and kv_dtype == bf16 and d % 16 == 0 \
            and d <= MMA_MAX_D and group <= MMA_MAX_GROUP:
        return "mma"
    return "cores"


_ARGS = [_build.P] * 11 + [_build.L] + [_build.I] * 12 + [_build.P]


def decode_attention_cuda(q, k_cache, v_cache, kv_pos, q_pos, *,
                          window=None, chunk: int = 512):
    """Launch the split and merge kernels on CUDA operands, on the route
    :func:`route` picks; returns (B, H, D) in ``q.dtype``.  ``chunk`` is
    the reference's tile and does not move the card's split."""
    _build.check_decode_operands(q, k_cache, v_cache, kv_pos, q_pos)
    b, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    group = h // kvh
    split = split_length(s, b, kvh, group)
    mma = route(q.dtype, k_cache.dtype, d, group) == "mma"
    if mma:            # 16-byte copies and fragment loads
        q, k_cache, v_cache = (t if t.data_ptr() % 16 == 0 else t.clone()
                               for t in (q, k_cache, v_cache))
    nsplit = -(-s // split)
    dev = q.device
    m = torch.empty((b, kvh, nsplit, group), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, kvh, nsplit, group, d), dtype=torch.float32,
                      device=dev)
    mean_sum = torch.empty((b, kvh, d), dtype=torch.float32, device=dev)
    mean_cnt = torch.empty((b, kvh), dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    vec = d % 4 == 0 and all(t.data_ptr() % 16 == 0
                             for t in (k_cache, v_cache))
    # a window beyond int32 masks as the nearest int32 does
    win = 0 if window is None else min(max(int(window), -2**31), 2**31 - 1)
    bf16 = torch.bfloat16
    fn = _build.function("decode_attention", "decode_attention", _ARGS)
    ptrs = [q, k_cache, v_cache, kv_pos, q_pos, m, l, acc, mean_sum,
            mean_cnt, out]
    _build.launch(fn, [t.data_ptr() for t in ptrs] + [
        b, s, h, kvh, d, split, win, int(window is not None),
        int(q.dtype == bf16), int(k_cache.dtype == bf16), int(vec),
        int(mma), _build.sm_count(dev)],
        "decode_attention", dev)
    return out
