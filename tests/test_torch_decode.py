"""One-token GQA flash-decode on the CPU: ``ops.decode_attention`` (on CPU
tensors, the decode kernel's plain version) against the reference's
``ops.decode_attention`` (the Pallas decode kernel in interpret mode) and
its dense oracle ``ref.decode_attention_ref``, on the same seeded numpy
inputs: the reference test's shapes, partial fills, a sliding window, a
ring cache filled by the reference's ``models/cache.kv_update``, per-row
query positions, a row with no visible slot, a group of 12 at D = 80,
bf16 caches and chunk invariance.

Tolerances: 2e-5 absolute in fp32, the reference test's own
(``tests/test_decode_kernel.py``); in bf16 2^-7 of max (one bf16 ulp at
the top of the range: both round the same fp32 sums)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.models import cache as ref_cache
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as DA

ATOL = 2e-5
TOL_BF16 = 2.0 ** -7


def _setup(b, s, h, kvh, d, seed=0, fill=None):
    """Seeded numpy q, K, V and a cache filled to ``fill`` slots."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    fill = s if fill is None else fill
    kv_pos = np.where(np.arange(s) < fill, np.arange(s), -1)
    kv_pos = np.broadcast_to(kv_pos, (b, s)).astype(np.int32).copy()
    q_pos = np.full((b,), fill - 1, np.int32)
    return q, k, v, kv_pos, q_pos


def _port(args, dtype=torch.float32, **kw):
    q, k, v, kv_pos, q_pos = args
    out = ops.decode_attention(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), torch.from_numpy(kv_pos),
        torch.from_numpy(q_pos), **kw)
    assert out.dtype == dtype
    return out.float().numpy()


def _ref(args, dtype=jnp.float32, oracle=False, **kw):
    q, k, v, kv_pos, q_pos = (jnp.asarray(a) for a in args)
    q, k, v = q.astype(dtype), k.astype(dtype), v.astype(dtype)
    if oracle:
        kw.pop("chunk", None)
        out = ref_oracle.decode_attention_ref(q, k, v, kv_pos, q_pos, **kw)
    else:
        out = ref_ops.decode_attention(q, k, v, kv_pos, q_pos, **kw)
    return np.asarray(out.astype(jnp.float32))


def _check(args, **kw):
    got = _port(args, **kw)
    np.testing.assert_allclose(got, _ref(args, **kw), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _ref(args, oracle=True, **kw),
                               atol=ATOL, rtol=0)
    return got


@pytest.mark.parametrize("b,s,h,kvh,d", [
    (2, 128, 4, 2, 16),
    (3, 512, 8, 8, 32),       # MHA, the reference's batch padding path
    (8, 1024, 8, 2, 64),      # GQA 4x
    (2, 256, 12, 1, 80),      # a group of 12 at D = 80 (starcoder2's
    (2, 128, 24, 2, 80),      # group, h2o-danube's head dim)
])
def test_matches_reference(b, s, h, kvh, d):
    _check(_setup(b, s, h, kvh, d), chunk=128)


def test_partial_cache_fill():
    """Empty slots (pos = -1) are masked out."""
    _check(_setup(2, 256, 4, 2, 16, fill=100), chunk=64)


def test_sliding_window():
    _check(_setup(2, 256, 4, 2, 16, seed=3), window=64, chunk=64)


def test_per_row_query_positions():
    """Rows of different lengths: each row's q_pos and its own empty
    slots."""
    q, k, v, kv_pos, q_pos = _setup(3, 256, 8, 2, 32, seed=4)
    for row, n in enumerate((256, 37, 130)):
        kv_pos[row, n:] = -1
        q_pos[row] = n - 1
    _check((q, k, v, kv_pos, q_pos), chunk=64)


def test_ring_cache_wraps():
    """A sliding-window ring of 16 slots filled token by token by the
    reference's ``kv_update``: rows of 37 and 20 tokens wrap mid-array,
    a row of 9 leaves slots empty; window = ring size, as the configs'
    sliding-window caches use it, and a narrower one."""
    slots, kvh, d, h = 16, 2, 16, 8
    rng = np.random.default_rng(5)
    ks, vs, ps = [], [], []
    for n in (37, 9, 20):
        c = {"k": jnp.zeros((1, slots, kvh, d)),
             "v": jnp.zeros((1, slots, kvh, d)),
             "pos": jnp.full((1, slots), -1, jnp.int32)}
        for t in range(n):
            c, _, _, _ = ref_cache.kv_update(
                c, jnp.asarray(rng.standard_normal((1, kvh, d)), jnp.float32),
                jnp.asarray(rng.standard_normal((1, kvh, d)), jnp.float32),
                jnp.asarray([t], jnp.int32))
        ks.append(np.asarray(c["k"]))
        vs.append(np.asarray(c["v"]))
        ps.append(np.asarray(c["pos"]))
    kv_pos = np.concatenate(ps)
    assert kv_pos[0, 37 % slots] == 37 - slots    # the oldest, mid-array
    assert kv_pos[0, 37 % slots - 1] == 36
    assert (kv_pos[1, 9:] == -1).all()
    q = rng.standard_normal((3, h, d)).astype(np.float32)
    q_pos = np.array([36, 8, 19], np.int32)
    args = (q, np.concatenate(ks), np.concatenate(vs), kv_pos, q_pos)
    _check(args, window=slots, chunk=8)
    _check(args, window=5, chunk=16)


def test_row_with_no_visible_slot_is_mean_of_v():
    """A row whose slots are all empty scores -1e30 everywhere, so its
    softmax is uniform: the mean of V over its slots, not NaN."""
    q, k, v, kv_pos, q_pos = _setup(2, 256, 12, 1, 80, seed=6)
    kv_pos[1] = -1
    got = _check((q, k, v, kv_pos, q_pos), chunk=64)
    mean = v[1, :, 0].astype(np.float64).mean(axis=0)
    np.testing.assert_allclose(got[1], np.broadcast_to(mean, (12, 80)),
                               atol=ATOL, rtol=0)


def test_bf16_cache():
    """bf16 q and caches cast from the same values on both sides."""
    args = _setup(2, 256, 12, 1, 80, seed=7, fill=200)
    got = _port(args, dtype=torch.bfloat16, chunk=64)
    for want in (_ref(args, dtype=jnp.bfloat16, chunk=64),
                 _ref(args, dtype=jnp.bfloat16, oracle=True)):
        assert np.abs(got - want).max() <= TOL_BF16 * np.abs(want).max()


def test_chunk_invariance():
    """The result does not depend on the chunking (nor, on the card, on
    the split count that follows from it)."""
    args = _setup(2, 512, 4, 4, 32, seed=7)
    a = _port(args, chunk=512)
    b = _port(args, chunk=64)
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    np.testing.assert_allclose(b, _ref(args, chunk=64), atol=ATOL, rtol=0)


def test_chunk_must_divide_cache_length():
    """Both sides refuse a cache length that min(chunk, S) does not
    divide."""
    args = _setup(2, 192, 4, 2, 16)
    with pytest.raises(ValueError, match="must divide"):
        _port(args, chunk=128)
    with pytest.raises(AssertionError):
        _ref(args, chunk=128)
    _check(args, chunk=64)                    # 64 divides 192


def test_empty_batch():
    out = ops.decode_attention(torch.zeros(0, 4, 16),
                               torch.zeros(0, 64, 2, 16),
                               torch.zeros(0, 64, 2, 16),
                               torch.zeros(0, 64, dtype=torch.int32),
                               torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 4, 16)


# (B, S, H, KV, D) of the card's two decode cells (chip_smoke.py)
STARCODER2 = (16, 32768, 48, 4, 128)
DANUBE = (128, 4096, 32, 8, 80)


@pytest.mark.parametrize("cell,split,nsplit", [(STARCODER2, 2048, 16),
                                               (DANUBE, 4096, 1)])
def test_split_length_fills_the_card_at_both_cells(cell, split, nsplit):
    """The split follows the grid, not the chunk: about BLOCKS = 1024
    blocks (eight an SM of 132) at both cells, and (m, l, acc) partials
    of 6.3 MB at starcoder2-15b, a quarter of the 512-slot splits'."""
    b, s, h, kv, d = cell
    assert DA.split_length(s, b, kv, h // kv) == split
    assert -(-s // split) == nsplit
    assert b * kv * nsplit == DA.BLOCKS == 1024
    assert split % DA.TILE == 0
    if cell == STARCODER2:
        assert b * kv * nsplit * (h // kv) * d * 4 == 16 * 4 * 16 * 12 * 128 * 4


def test_split_length_rule():
    """Enough splits for BLOCKS blocks, each a multiple of TILE slots or
    the whole cache, at most MAX_SPLIT, and no more splits than the merge
    weighs (MERGE_WEIGHTS over the group)."""
    assert DA.split_length(100, 2, 2, 4) == 64          # 256 splits wanted
    assert DA.split_length(40, 1, 1, 1) == 40           # shorter than a tile
    assert DA.split_length(1 << 22, 1024, 1, 1) == DA.MAX_SPLIT
    assert DA.split_length(1 << 20, 1, 1, 64) == (1 << 20) // 128
    for s, b, kv, g in [(32768, 16, 4, 12), (4096, 128, 8, 4), (512, 2, 1, 40),
                        (1 << 20, 1, 1, 64), (100, 3, 8, 1)]:
        split = DA.split_length(s, b, kv, g)
        n = -(-s // split)
        assert split == s or split % DA.TILE == 0
        assert 1 <= split <= DA.MAX_SPLIT
        assert n * g <= DA.MERGE_WEIGHTS
        assert b * kv * n <= max(DA.BLOCKS, b * kv)


@pytest.mark.parametrize("q_dtype,kv_dtype,d,group,want", [
    (torch.bfloat16, torch.bfloat16, 128, 12, "mma"),     # starcoder2-15b
    (torch.bfloat16, torch.bfloat16, 80, 4, "mma"),       # h2o-danube-1.8b
    (torch.bfloat16, torch.bfloat16, 16, 16, "mma"),
    (torch.bfloat16, torch.bfloat16, 18, 1, "cores"),     # D % 16
    (torch.bfloat16, torch.bfloat16, 144, 4, "cores"),    # D > 128
    (torch.bfloat16, torch.bfloat16, 8, 40, "cores"),     # group > 16
    (torch.float32, torch.float32, 128, 12, "cores"),
    (torch.float32, torch.bfloat16, 80, 4, "cores"),      # mixed
    (torch.bfloat16, torch.float32, 80, 4, "cores"),
    (torch.float16, torch.float16, 80, 4, "mma"),
    (torch.float16, torch.bfloat16, 80, 4, "cores"),      # mixed halves
    (torch.float16, torch.float32, 128, 12, "cores"),
])
def test_route_from_dtype_and_shape(q_dtype, kv_dtype, d, group, want):
    """q and caches both bf16 or both float16, D a multiple of 16 up to 128
    and at most 16 heads a KV head take the tensor cores; the rest the CUDA
    cores, chosen before any launch."""
    assert DA.route(q_dtype, kv_dtype, d, group) == want


@pytest.mark.parametrize("dtype,cell", [(torch.bfloat16, (2, 256, 24, 2, 80)),
                                        (torch.float32, (2, 256, 24, 2, 80)),
                                        (torch.bfloat16, (3, 100, 8, 8, 18))])
def test_wrapper_launches_the_planned_split(monkeypatch, dtype, cell):
    """One call: the eleven pointers, the shape, the split of
    split_length, the window, the dtypes' codes, the route flag, a merge
    helper block an SM and the partial flag off."""
    calls = []
    monkeypatch.setattr(_build, "check_decode_operands", lambda *a: None)
    monkeypatch.setattr(_build, "function", lambda *a: a)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "launch", lambda fn, args, what, dev:
                        calls.append((fn, args, what)))
    b, s, h, kvh, d = cell
    q, k, v, kv_pos, q_pos = (torch.from_numpy(a) for a in
                              _setup(b, s, h, kvh, d))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    DA.decode_attention_cuda(q, k, v, kv_pos, q_pos, window=64, chunk=64)
    (fn, args, what), = calls
    assert fn == ("decode_attention", "decode_attention", DA._ARGS)
    assert what == "decode_attention" and len(args) == len(DA._ARGS) - 1
    split = DA.split_length(s, b, kvh, h // kvh)
    assert args[:5] == [t.data_ptr() for t in (q, k, v, kv_pos, q_pos)]
    assert args[11:18] == [b, s, h, kvh, d, split, 64]
    code = DA._CODES[dtype]
    mma = DA.route(dtype, dtype, d, h // kvh) == "mma"
    assert args[18:] == [1, code, code, int(d % 4 == 0), int(mma), 132, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_partial_and_merge_launch_with_their_argument_types(monkeypatch,
                                                            dtype):
    """The sequence-parallel route's two calls: the split launch with the
    partial flag set and the fp32 buffer of m, l, acc and vsum as its
    output, then the cross-rank merge with one argument for each of its
    ctypes types (the ranks' partials, the shape, the ranks, the slots,
    the output's storage code)."""
    calls = []
    monkeypatch.setattr(_build, "check_decode_operands", lambda *a: None)
    monkeypatch.setattr(_build, "check_merge_operands", lambda *a: None)
    monkeypatch.setattr(_build, "function", lambda *a: a)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "launch", lambda fn, args, what, dev:
                        calls.append((fn, args, what)))
    b, s, h, kvh, d = 2, 256, 8, 2, 16
    q, k, v, kv_pos, q_pos = (torch.from_numpy(a) for a in
                              _setup(b, s, h, kvh, d))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    m, l, acc, vsum = DA.decode_attention_partial_cuda(q, k, v, kv_pos,
                                                       q_pos)
    (fn, args, _), = calls
    assert fn == ("decode_attention", "decode_attention", DA._ARGS)
    assert len(args) == len(DA._ARGS) - 1 and args[-1] == 1
    assert args[10] == m.data_ptr() and args[8] == vsum.data_ptr()
    assert (m.shape, acc.shape, vsum.shape) == ((b, kvh, h // kvh),
                                               (b, kvh, h // kvh, d),
                                               (b, kvh, d))
    calls.clear()
    parts = [torch.stack([t] * 3) for t in (m, l, acc, vsum)]
    out = DA.decode_attention_merge_cuda(*parts, 3 * s, dtype)
    (fn, args, _), = calls
    assert fn == ("decode_attention", "decode_attention_merge",
                  DA._ARGS_MERGE)
    assert len(args) == len(DA._ARGS_MERGE) - 1
    assert args[5:] == [b, h, kvh, d, 3, 3 * s, DA._CODES[dtype]]
    assert out.shape == (b, h, d) and out.dtype == dtype


def test_decode_operand_dtypes_refused():
    """What the CUDA kernel does not take raises before any pointer is
    passed: int64 positions, float64 caches (float16 caches pass the dtype
    check and are refused only for lying on the CPU)."""
    q, k, v, kv_pos, q_pos = (torch.from_numpy(a) for a in
                              _setup(1, 64, 4, 2, 16))
    with pytest.raises(TypeError, match="int32"):
        _build.check_decode_operands(q, k, v, kv_pos.long(), q_pos)
    with pytest.raises(TypeError, match="float16"):
        _build.check_decode_operands(q, k.double(), v.double(), kv_pos,
                                     q_pos)
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_decode_operands(q, k.half(), v.half(), kv_pos, q_pos)
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_decode_operands(q, k, v, kv_pos, q_pos)
