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
and splits with no visible slot are not read.  For bf16 (or float16) q
and caches of one dtype with D a multiple of 16 (up to 128) and up to 16
query heads a KV head, both products run on the tensor cores; other
dtypes and shapes take the CUDA-core route (:func:`route`).  What bounds
it: bytes (the visible slots' K and V, read once in their storage dtype).

A cache whose slots are split over ranks (sequence-parallel serving) runs
in two steps.  :func:`decode_attention_partial_cuda` runs the same split
launch over the rank's slots and merges its splits into the rank's
partial state instead of the output: the running max ``m`` and sum ``l``
(B, KV, G) and the unnormalised ``acc`` (B, KV, G, D), with ``l = 0`` and
``m = NEG_INF`` for a (row, KV head) that sees no slot of this rank, and
``vsum`` (B, KV, D), the sum of V over the rank's slots for exactly those
rows (zero elsewhere).  Only these cross ranks.
:func:`decode_attention_merge_cuda` merges the ranks' gathered partials
with the merge launch's arithmetic, the ranks in place of the splits; a
row that sees no slot on any rank gets the mean of V over all slots,
``sum(vsum) / S``, as the dense reference's uniform softmax gives it.
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


def decode_attention_partial_plain(q, k_cache, v_cache, kv_pos, q_pos, *,
                                   window=None):
    """The partial state of :func:`decode_attention_plain` over the given
    slots (the module docstring): (m, l, acc, vsum), fp32."""
    b, h, d = q.shape
    kvh = k_cache.shape[2]
    if q.is_cuda:
        assert_full_fp32()
    qg = q.float().reshape(b, kvh, h // kvh, d) / math.sqrt(d)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float())
    mask = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window is not None:
        mask &= kv_pos > (q_pos[:, None] - window)
    seen = mask.any(dim=1)                                   # (B,)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask[:, None, None, :], torch.exp(s - m[..., None]), 0.0)
    v32 = v_cache.float()
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgc,bckd->bkgd", p, v32)
    vsum = torch.where(seen[:, None, None], 0.0, v32.sum(dim=1))
    m = torch.where(seen[:, None, None], m, NEG_INF)
    return m, l, acc, vsum


def decode_attention_merge_plain(m, l, acc, vsum, slots: int, dtype):
    """The output (B, H, D) in ``dtype`` of R ranks' gathered partials:
    m, l (R, B, KV, G), acc (R, B, KV, G, D), vsum (R, B, KV, D) over
    ``slots`` slots in all."""
    r, b, kvh, g = m.shape
    live = l > 0
    mx = torch.where(live, m, NEG_INF).amax(dim=0)
    w = torch.where(live, torch.exp(m - mx), 0.0)            # (R,B,KV,G)
    tot = (w * l).sum(dim=0)
    out = (w[..., None] * acc).sum(dim=0) / torch.clamp(tot, min=1e-30)[
        ..., None]
    mean = (vsum.sum(dim=0) / slots)[:, :, None, :]
    out = torch.where(live.any(dim=0)[..., None], out, mean)
    return out.reshape(b, kvh * g, -1).to(dtype)


def partial_size(b: int, kv: int, group: int, d: int) -> int:
    """Floats of a rank's packed partial state: m, l, acc, vsum."""
    return b * kv * (2 * group + group * d + d)


def unpack_partial(flat, b: int, kv: int, group: int, d: int):
    """(m, l, acc, vsum) as views of the packed ``flat`` (..., n): any
    leading dims (a rank axis) kept."""
    lead = flat.shape[:-1]
    n = b * kv * group
    cuts = [n, n, n * d, b * kv * d]
    m, l, acc, vsum = torch.split(flat, cuts, dim=-1)
    return (m.reshape(*lead, b, kv, group), l.reshape(*lead, b, kv, group),
            acc.reshape(*lead, b, kv, group, d),
            vsum.reshape(*lead, b, kv, d))


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
    """``"mma"`` (the tensor cores, ``mma.sync`` in bf16 or float16 with
    fp32 accumulation) for q and caches both bf16 or both float16 with D a
    multiple of 16 up to :data:`MMA_MAX_D` and at most
    :data:`MMA_MAX_GROUP` query heads a KV head; else ``"cores"`` (fp32
    CUDA cores)."""
    if q_dtype == kv_dtype and q_dtype in (torch.bfloat16, torch.float16) \
            and d % 16 == 0 and d <= MMA_MAX_D and group <= MMA_MAX_GROUP:
        return "mma"
    return "cores"


# the storage codes of the C entry points: 0 fp32, 1 bf16, 2 float16
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_ARGS = [_build.P] * 11 + [_build.L] + [_build.I] * 13 + [_build.P]
_ARGS_MERGE = [_build.P] * 5 + [_build.L] + [_build.I] * 6 + [_build.P]


def _launch_split(q, k_cache, v_cache, kv_pos, q_pos, window, partial):
    """The split launch and the merge over its splits: into ``out`` (B,
    H, D) in q's dtype, or with ``partial`` into the rank's partial state
    (m, l, acc) and the mean-of-V scratch (vsum)."""
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
    mean_cnt = torch.empty((b, kvh), dtype=torch.int32, device=dev)
    if partial:        # one buffer: m, l, acc, then vsum (the mean scratch)
        out = unpack_partial(torch.empty(partial_size(b, kvh, group, d),
                                         dtype=torch.float32, device=dev),
                             b, kvh, group, d)
        dst, mean_sum = out[0], out[3]
    else:
        mean_sum = torch.empty((b, kvh, d), dtype=torch.float32, device=dev)
        out = torch.empty_like(q)
        dst = out
    vec = d % 4 == 0 and all(t.data_ptr() % 16 == 0
                             for t in (k_cache, v_cache))
    # a window beyond int32 masks as the nearest int32 does
    win = 0 if window is None else min(max(int(window), -2**31), 2**31 - 1)
    fn = _build.function("decode_attention", "decode_attention", _ARGS)
    ptrs = [q, k_cache, v_cache, kv_pos, q_pos, m, l, acc, mean_sum,
            mean_cnt, dst]
    _build.launch(fn, [t.data_ptr() for t in ptrs] + [
        b, s, h, kvh, d, split, win, int(window is not None),
        _CODES[q.dtype], _CODES[k_cache.dtype], int(vec), int(mma),
        _build.sm_count(dev), int(partial)], "decode_attention", dev)
    return out


def decode_attention_cuda(q, k_cache, v_cache, kv_pos, q_pos, *,
                          window=None, chunk: int = 512):
    """Launch the split and merge kernels on CUDA operands, on the route
    :func:`route` picks; returns (B, H, D) in ``q.dtype``.  ``chunk`` is
    the reference's tile and does not move the card's split."""
    return _launch_split(q, k_cache, v_cache, kv_pos, q_pos, window, False)


def decode_attention_partial_cuda(q, k_cache, v_cache, kv_pos, q_pos, *,
                                  window=None):
    """The rank's partial state (m, l, acc, vsum) over its slots (the
    module docstring), on the card: the split launch, then the merge over
    its splits writing the state in place of the output."""
    return _launch_split(q, k_cache, v_cache, kv_pos, q_pos, window, True)


def decode_attention_merge_cuda(m, l, acc, vsum, slots: int, dtype):
    """The merge launch over R ranks' gathered partials (m, l (R, B, KV,
    G), acc (R, B, KV, G, D), vsum (R, B, KV, D), fp32 on one card):
    (B, H, D) in ``dtype``."""
    _build.check_merge_operands(m, l, acc, vsum)
    r, b, kvh, g = m.shape
    d = acc.shape[-1]
    if dtype not in _CODES:
        raise TypeError(f"the merge stores float32, bfloat16 or float16, "
                        f"got {dtype}")
    # the ranks as the splits of a (row, KV head): (B, KV, R, G[, D])
    m, l = (t.permute(1, 2, 0, 3).contiguous() for t in (m, l))
    acc = acc.permute(1, 2, 0, 3, 4).contiguous()
    vsum = vsum.contiguous()
    out = torch.empty((b, kvh * g, d), dtype=dtype, device=m.device)
    fn = _build.function("decode_attention", "decode_attention_merge",
                         _ARGS_MERGE)
    _build.launch(fn, [t.data_ptr() for t in (m, l, acc, vsum, out)] + [
        b, kvh * g, kvh, d, r, int(slots), _CODES[dtype]],
        "decode_attention", m.device)
    return out
