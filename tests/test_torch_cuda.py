"""The CUDA kernels against their plain versions on the card.  Marked
``cuda``: these skip (with the reason) where CUDA is absent.  Run them on
a GPU machine with ``PYTHONPATH=src python -m pytest -m cuda tests/``."""
import numpy as np
import pytest
import torch

from repro_torch.core import (SplitComplex, fft2, fft3, from_numpy, irfft2,
                              rfft, irfft, rfft2, fft_conv)
import repro_torch.configs as C
from repro_torch.kernels import ops
from repro_torch.kernels import (fft2d_gemm, fft_fourstep, fft_stockham,
                                 rfft2d_fused, fftconv_fused, fft3d_fused,
                                 fft2d_fused, fft_stage, decode_attention)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return "cuda"


def _rand(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(got, ref):
    d = max((got.re - ref.re).abs().max().item(),
            (got.im - ref.im).abs().max().item())
    return d / max(ref.re.abs().max().item(), ref.im.abs().max().item())


@pytest.mark.parametrize("launch,plain,shape,tol", [
    (fft2d_gemm.fft2d_gemm_cuda, fft2d_gemm.fft2d_gemm_plain, (2, 8, 4), 1e-5),
    (fft2d_gemm.fft2d_gemm_cuda, fft2d_gemm.fft2d_gemm_plain, (3, 512, 256),
     1e-5),
    (fft_fourstep.fft_fourstep_cuda, fft_fourstep.fft_fourstep_plain,
     (3, 8192), 5e-5),
    # the four-step kernel's routes: the smallest default split (16, 32),
    # one launch up to 2^14, two from 2^15, an unequal split (512, 1024),
    # a batch no row block divides
    (fft_fourstep.fft_fourstep_cuda, fft_fourstep.fft_fourstep_plain,
     (3, 512), 5e-5),
    (fft_fourstep.fft_fourstep_cuda, fft_fourstep.fft_fourstep_plain,
     (3, 1 << 14), 5e-5),
    (fft_fourstep.fft_fourstep_cuda, fft_fourstep.fft_fourstep_plain,
     (3, 1 << 15), 5e-5),
    (fft_fourstep.fft_fourstep_cuda, fft_fourstep.fft_fourstep_plain,
     (2, 1 << 19), 5e-5),
    (fft_fourstep.fft_fourstep_cuda, fft_fourstep.fft_fourstep_plain,
     (3, 1 << 20), 5e-5),
    (fft_stockham.fft_stockham_cuda, fft_stockham.fft_stockham_plain,
     (3, 2048), 5e-5),
    (fft_stockham.fft_stockham_cuda, fft_stockham.fft_stockham_plain,
     (3, 2), 5e-5),
    # the radix-4 kernel's routes: one launch to 2^14 (n = 8, a batch no
    # row tile divides), two from 2^15 (odd log2 n: the tail in launch B)
    (fft_stockham.fft_stockham_cuda, fft_stockham.fft_stockham_plain,
     (5, 8), 5e-5),
    (fft_stockham.fft_stockham_cuda, fft_stockham.fft_stockham_plain,
     (7, 512), 5e-5),
    (fft_stockham.fft_stockham_cuda, fft_stockham.fft_stockham_plain,
     (3, 1 << 14), 5e-5),
    (fft_stockham.fft_stockham_cuda, fft_stockham.fft_stockham_plain,
     (3, 1 << 15), 5e-5),
    (fft_stockham.fft_stockham_cuda, fft_stockham.fft_stockham_plain,
     (2, 1 << 17), 5e-5),
    (fft_stockham.fft_stockham_cuda, fft_stockham.fft_stockham_plain,
     (2, 1 << 18), 5e-5),
    (fft_stockham.fft_stockham_r2_cuda, fft_stockham.fft_stockham_r2_plain,
     (3, 2), 5e-5),
    (fft_stockham.fft_stockham_r2_cuda, fft_stockham.fft_stockham_r2_plain,
     (5, 8), 5e-5),
    (fft_stockham.fft_stockham_r2_cuda, fft_stockham.fft_stockham_r2_plain,
     (3, 4096), 5e-5),
    # the radix-2 kernel's routes: one launch to 2^14, two from 2^15, an
    # odd log2 n (2^17), a batch no row tile divides (7 rows, 16 a tile)
    (fft_stockham.fft_stockham_r2_cuda, fft_stockham.fft_stockham_r2_plain,
     (3, 1 << 13), 5e-5),
    (fft_stockham.fft_stockham_r2_cuda, fft_stockham.fft_stockham_r2_plain,
     (3, 1 << 14), 5e-5),
    (fft_stockham.fft_stockham_r2_cuda, fft_stockham.fft_stockham_r2_plain,
     (3, 1 << 15), 5e-5),
    (fft_stockham.fft_stockham_r2_cuda, fft_stockham.fft_stockham_r2_plain,
     (2, 1 << 17), 5e-5),
    (fft_stockham.fft_stockham_r2_cuda, fft_stockham.fft_stockham_r2_plain,
     (7, 512), 5e-5),
    (fft3d_fused.fft3d_fused_cuda, fft3d_fused.fft3d_fused_plain,
     (1, 4, 8, 16), 1e-5),
    (fft3d_fused.fft3d_fused_cuda, fft3d_fused.fft3d_fused_plain,
     (2, 2, 4, 256), 1e-5),
    (fft3d_fused.fft3d_fused_cuda, fft3d_fused.fft3d_fused_plain,
     (1, 256, 4, 4), 1e-5),
    (fft3d_fused.fft3d_fused_cuda, fft3d_fused.fft3d_fused_plain,
     (1, 64, 256, 512), 1e-5),
    (fft2d_fused.fft2d_fused_cuda, fft2d_fused.fft2d_fused_plain,
     (2, 8, 16), 1e-5),
    (fft2d_fused.fft2d_fused_cuda, fft2d_fused.fft2d_fused_plain,
     (3, 2, 4096), 1e-5),
    (fft2d_fused.fft2d_fused_cuda, fft2d_fused.fft2d_fused_plain,
     (1, 1024, 512), 1e-5),
    (fft_stage.fft_staged_cuda, fft_stage.fft_staged_plain, (3, 1), 5e-5),
    (fft_stage.fft_staged_cuda, fft_stage.fft_staged_plain, (5, 8), 5e-5),
    (fft_stage.fft_staged_cuda, fft_stage.fft_staged_plain, (3, 2048), 5e-5),
    (fft_stage.fft_staged_cuda, fft_stage.fft_staged_plain, (2, 16384),
     5e-5),
    # stage 0 through 32x32 tiles from 2^10 points on
    (fft_stage.fft_staged_cuda, fft_stage.fft_staged_plain, (2, 1 << 16),
     5e-5)])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_plain_on_card(card, launch, plain, shape, tol,
                                      inverse):
    x = from_numpy(_rand(shape), device=card)
    got = launch(x, inverse=inverse)
    torch.cuda.synchronize()
    assert _rel(got, plain(x, inverse=inverse)) <= tol


def _real(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _rel_real(got, ref):
    return (got - ref).abs().max().item() / ref.abs().max().item()


# w = 2, 4, 8, 16, 1024 give half widths c = 2, 3, 5, 9, 513: the column
# pass at widths that are no power of two, whole images a tile or C
# columns with a ragged last tile (2048- and 4096-point columns too)
@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 8, 4), (2, 4, 8),
                                   (2, 2, 16), (3, 256, 512),
                                   (2, 512, 1024), (2, 512, 64),
                                   (3, 2048, 256), (1, 4096, 8)])
def test_rfft2d_kernels_match_plain_on_card(card, shape):
    x = torch.from_numpy(_real(shape)).float().to(card)
    got = rfft2d_fused.rfft2d_fused_cuda(x)
    torch.cuda.synchronize()
    assert _rel(got, rfft2d_fused.rfft2d_fused_plain(x)) <= 1e-5
    b, h, w = shape
    xf = from_numpy(_rand((b, h, w // 2 + 1), seed=1), device=card)
    back = rfft2d_fused.irfft2d_fused_cuda(xf)
    torch.cuda.synchronize()
    assert _rel_real(back, rfft2d_fused.irfft2d_fused_plain(xf)) <= 1e-5


def test_real_input_entry_points_on_card(card):
    """rfft2/irfft2 (fused kernels, an s= truncation that leaves a complex
    Nyquist bin) and rfft/irfft (inner four-step and radix-2 Stockham)
    through the registry against float64 numpy."""
    z = _real((2, 64, 128), seed=5)
    x = torch.from_numpy(z).float().to(card)
    xf = rfft2(x, backend="cuda")
    ref = np.fft.rfft2(z)
    zz = xf.re.double().cpu().numpy() + 1j * xf.im.double().cpu().numpy()
    assert np.abs(zz - ref).max() <= 1e-5 * np.abs(ref).max()
    back = irfft2(xf, backend="cuda").double().cpu().numpy()
    assert np.abs(back - z).max() <= 1e-4 * np.abs(z).max()
    cut = irfft2(xf, s=(64, 64), backend="cuda").double().cpu().numpy()
    want = np.fft.irfft2(ref, s=(64, 64))
    assert np.abs(cut - want).max() <= 1e-5 * np.abs(want).max()
    for n, algo in [(2048, "auto"), (256, "stockham2")]:
        z1 = _real((3, n), seed=n)
        x1 = torch.from_numpy(z1).float().to(card)
        y = rfft(x1, algo=algo, backend="cuda")
        ref1 = np.fft.rfft(z1)
        zz1 = y.re.double().cpu().numpy() + 1j * y.im.double().cpu().numpy()
        assert np.abs(zz1 - ref1).max() <= 5e-5 * np.abs(ref1).max()
        b1 = irfft(y, algo=algo, backend="cuda").double().cpu().numpy()
        assert np.abs(b1 - z1).max() <= 1e-4 * np.abs(z1).max()


def test_wrappers_count_launches_on_card(card):
    ops.reset_launches()
    ops.fft2d_gemm(from_numpy(_rand((1, 64, 64)), device=card))
    ops.fft_fourstep(from_numpy(_rand((1, 1024)), device=card))
    ops.fft_stockham(from_numpy(_rand((1, 1024)), device=card))
    ops.fft_stockham(from_numpy(_rand((1, 1024)), device=card), radix=2)
    xf = ops.rfft2d_fused(torch.from_numpy(_real((1, 8, 8))).float()
                          .to(card))
    ops.irfft2d_fused(xf)
    ops.fftconv_fused(torch.from_numpy(_real((2, 3, 64))).float().to(card),
                      from_numpy(_rand((3, 33)), device=card))
    ops.fft3d_fused(from_numpy(_rand((1, 8, 8, 8)), device=card))
    ops.fft2d_fused(from_numpy(_rand((1, 64, 64)), device=card))
    ops.fft_staged(from_numpy(_rand((1, 1024)), device=card))
    ops.decode_attention(*_decode_operands((1, 64, 4, 2, 16), card))
    assert ops.LAUNCHES == {"fft_stockham": 1, "fft_stockham_r2": 1,
                            "fft_fourstep": 1, "fft2d_gemm": 1,
                            "rfft2d_fused": 1, "irfft2d_fused": 1,
                            "fftconv_fused": 1, "fft3d_fused": 1,
                            "fft2d_fused": 1, "fft_staged": 1,
                            "decode_attention": 1, "decode_merge": 0}


def _decode_operands(shape, card, dtype=torch.float32, seed=0):
    """q, caches and a ring-style position plane: per-row query positions,
    the ring wrapped mid-array, a part-filled row and, with three rows or
    more, a row with no slot."""
    b, s, h, kvh, d = shape
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, h, d))).to(card, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kvh, d)))
            .to(card, dtype) for _ in range(2))
    q_pos = rng.integers(s // 2, 3 * s, b)
    slot = np.arange(s)
    kv_pos = q_pos[:, None] - (q_pos[:, None] - slot) % s
    kv_pos[0, s // 3:] = -1
    if b > 2:
        kv_pos[-1] = -1
    return (q, k, v, torch.from_numpy(kv_pos).to(card, torch.int32),
            torch.from_numpy(q_pos).to(card, torch.int32))


# the reference test's shapes, a group of 12 at D = 80, D not a multiple of
# 4, a group of 40, windows; fp32 at the reference's 2e-5 absolute, bf16
# at 2^-7 of max|plain|, float16 at 2^-10
@pytest.mark.parametrize("shape,window,chunk", [
    ((2, 128, 4, 2, 16), None, 128), ((3, 512, 8, 8, 32), None, 128),
    ((8, 1024, 8, 2, 64), None, 128), ((3, 256, 12, 1, 80), 100, 64),
    ((3, 100, 8, 8, 18), None, 512), ((3, 512, 40, 1, 8), 300, 512),
    ((4, 4096, 32, 8, 80), 4096, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_decode_kernel_matches_plain_on_card(card, shape, window, chunk,
                                             dtype):
    ops_ = _decode_operands(shape, card, dtype)
    got = decode_attention.decode_attention_cuda(*ops_, window=window,
                                                 chunk=chunk)
    torch.cuda.synchronize()
    want = decode_attention.decode_attention_plain(*ops_, window=window)
    assert got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 2e-5
    else:
        bound = 2.0 ** (-7 if dtype == torch.bfloat16 else -10)
        assert err <= bound * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_decode_partial_and_merge_match_plain_on_card(card, dtype):
    """The sequence-parallel route on one card: the partials of four slot
    quarters (one with no visible slot for any row, one row with none
    anywhere), merged, against the plain partials and merge and the whole
    kernel, within the whole kernel's bound of its dtype."""
    q, k, v, kv_pos, q_pos = _decode_operands((4, 4096, 32, 8, 80), card,
                                              dtype, seed=5)
    kv_pos[:, 1024:2048] = -1
    parts, plain = [], []
    for i in range(4):
        sl = slice(i * 1024, (i + 1) * 1024)
        args = (q, k[:, sl].contiguous(), v[:, sl].contiguous(),
                kv_pos[:, sl].contiguous(), q_pos)
        parts.append(decode_attention.decode_attention_partial_cuda(
            *args, window=4096))
        plain.append(decode_attention.decode_attention_partial_plain(
            *args, window=4096))
    stack = [torch.stack([p[j] for p in parts]) for j in range(4)]
    got = decode_attention.decode_attention_merge_cuda(*stack, 4096, dtype)
    want = decode_attention.decode_attention_merge_plain(
        *(torch.stack([p[j] for p in plain]) for j in range(4)), 4096, dtype)
    whole = decode_attention.decode_attention_plain(q, k, v, kv_pos, q_pos,
                                                    window=4096)
    torch.cuda.synchronize()
    bound = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7,
             torch.float16: 2.0 ** -10}[dtype]
    scale = 1.0 if dtype == torch.float32 else \
        whole.float().abs().max().item()
    for ref in (want, whole):
        assert (got.float() - ref.float()).abs().max().item() <= \
            bound * scale


def test_decode_chunk_invariance_on_card(card):
    ops_ = _decode_operands((4, 4096, 32, 8, 80), card, seed=3)
    a = ops.decode_attention(*ops_, window=4096, chunk=512)
    b = ops.decode_attention(*ops_, window=4096, chunk=64)
    assert (a - b).abs().max().item() <= 2e-5


@pytest.mark.parametrize("inverse", [False, True])
def test_fft2_row_col_on_card(card, inverse):
    """algo="row_col": two Stockham kernel passes with the swap between,
    against float64 numpy and the GEMM kernel at the paper's size."""
    z = _rand((2, 1024, 1024), seed=3)
    x = from_numpy(z, device=card)
    got = fft2(x, inverse=inverse, algo="row_col", backend="cuda")
    ref = np.fft.ifft2(z) if inverse else np.fft.fft2(z)
    zz = got.re.double().cpu().numpy() + 1j * got.im.double().cpu().numpy()
    assert np.abs(zz - ref).max() <= 1e-5 * np.abs(ref).max()
    assert _rel(got, fft2d_gemm.fft2d_gemm_cuda(x, inverse=inverse)) <= 1e-5


# m = 8 and 1024 run the one-pass shared-memory kernel (odd row counts,
# several rows a block, a ragged last block); m = 32768 the multi-launch
# schedule; shared and per-batch banks
@pytest.mark.parametrize("m", [8, 1024, 32768])
@pytest.mark.parametrize("klead", [(3,), (2, 3)])
def test_fftconv_kernel_matches_plain_on_card(card, m, klead):
    x = torch.from_numpy(_real((2, 3, m), seed=m)).float().to(card)
    kf = from_numpy(_rand(klead + (m // 2 + 1,), seed=1), device=card)
    ef = fftconv_fused.pack_filter(kf, m, torch.float32)
    got = fftconv_fused.fftconv_fused_cuda(x, ef)
    torch.cuda.synchronize()
    assert _rel_real(got, fftconv_fused.fftconv_fused_plain(x, ef)) <= 1e-5


def test_fftconv_gradient_on_card(card):
    """The autograd.Function: the fused forward and the plain twin's
    backward against the unfused torch backend."""
    z = _real((2, 4, 300), seed=6)
    kz = _real((4, 33), seed=7)

    def grads(backend):
        x = torch.from_numpy(z).float().to(card).requires_grad_(True)
        k = torch.from_numpy(kz).float().to(card).requires_grad_(True)
        loss = (fft_conv(x, k, backend=backend) ** 2).sum()
        return torch.autograd.grad(loss, (x, k))

    for got, want in zip(grads("cuda"), grads("torch")):
        assert _rel_real(got, want) <= 1e-4


def _bf16(z, card):
    return SplitComplex(torch.from_numpy(z.real).to(card, torch.bfloat16),
                        torch.from_numpy(z.imag).to(card, torch.bfloat16))


# the bf16 modes against the plain versions' definition of them: the two
# round the same fp32 sums to bf16, so they agree to a rounding tie, one
# bf16 ulp at the top of the range (2^-7 of max)
@pytest.mark.parametrize("launch,plain,shape", [
    (fft2d_gemm.fft2d_gemm_cuda, fft2d_gemm.fft2d_gemm_plain, (2, 8, 4)),
    (fft2d_gemm.fft2d_gemm_cuda, fft2d_gemm.fft2d_gemm_plain, (2, 512, 1024)),
    (fft3d_fused.fft3d_fused_cuda, fft3d_fused.fft3d_fused_plain,
     (1, 32, 32, 32)),
    (fft3d_fused.fft3d_fused_cuda, fft3d_fused.fft3d_fused_plain,
     (1, 4, 256, 512))])
@pytest.mark.parametrize("variant", ["plain", "compensated"])
@pytest.mark.parametrize("inverse", [False, True])
def test_bf16_kernels_match_plain_on_card(card, launch, plain, shape,
                                          variant, inverse):
    x = _bf16(_rand(shape, seed=2), card)
    got = launch(x, inverse=inverse, variant=variant)
    torch.cuda.synchronize()
    assert got.re.dtype == torch.bfloat16
    ref = plain(x, inverse=inverse, variant=variant)
    assert _rel(SplitComplex(got.re.float(), got.im.float()),
                SplitComplex(ref.re.float(), ref.im.float())) <= 2.0 ** -7


@pytest.mark.parametrize("shape", [(2, 8, 16, 32), (1, 256, 128, 8)])
def test_fft3_entry_points_on_card(card, shape):
    """fft3 through the registry (the fused kernel), its row_col baseline
    (three Stockham passes) and the bf16 compensated plan, against float64
    numpy."""
    z = _rand(shape, seed=9)
    x = from_numpy(z, device=card)
    want = np.fft.fftn(z, axes=(-3, -2, -1))
    for algo in ("auto", "row_col"):
        y = fft3(x, algo=algo, backend="cuda")
        zz = y.re.double().cpu().numpy() + 1j * y.im.double().cpu().numpy()
        assert np.abs(zz - want).max() <= 1e-5 * np.abs(want).max()
        back = fft3(y, inverse=True, algo=algo, backend="cuda")
        bb = back.re.double().cpu().numpy() + \
            1j * back.im.double().cpu().numpy()
        assert np.abs(bb - z).max() <= 1e-4 * np.abs(z).max()
    yb = fft3(_bf16(z, card), backend="cuda")
    zb = yb.re.double().cpu().numpy() + 1j * yb.im.double().cpu().numpy()
    assert np.linalg.norm(zb - want) / np.linalg.norm(want) <= 5e-3


def test_fft2_fused_stockham_on_card(card):
    z = _rand((2, 1024, 1024), seed=4)
    y = fft2(from_numpy(z, device=card), algo="fused_stockham",
             backend="cuda")
    zz = y.re.double().cpu().numpy() + 1j * y.im.double().cpu().numpy()
    want = np.fft.fft2(z)
    assert np.abs(zz - want).max() <= 1e-5 * np.abs(want).max()


# the 2-D and 3-D kernels' routes (kernels/axis_fft.py): one plane launch at
# h*w = 2^14 (and 128^2 single-buffered), rows then columns at 2^15, C = 8
# at h = 2048, C = 4 at h = 4096, whole images where w < C; 3-D on the
# plane route and D (d = 2, a D pass over h*w = 4 columns) and on three
# launches
_ROUTES_2D = [(2, 128, 128), (1, 256, 128), (3, 2048, 32), (1, 4096, 16),
              (2, 4096, 8), (5, 16, 1024)]
_ROUTES_3D = [((1, 128, 128, 128), None), ((2, 2, 4, 256), None),
              ((1, 256, 2, 2), None), ((1, 32, 64, 256), None),
              ((1, 128, 128, 128), False), ((2, 2, 4, 256), False)]


@pytest.mark.parametrize("shape", _ROUTES_2D)
@pytest.mark.parametrize("inverse", [False, True])
def test_fft2d_routes_match_plain_on_card(card, shape, inverse):
    x = from_numpy(_rand(shape, seed=11), device=card)
    got = fft2d_gemm.fft2d_gemm_cuda(x, inverse=inverse)
    torch.cuda.synchronize()
    assert _rel(got, fft2d_gemm.fft2d_gemm_plain(x, inverse=inverse)) <= 1e-5


@pytest.mark.parametrize("shape,planes", _ROUTES_3D)
@pytest.mark.parametrize("inverse", [False, True])
def test_fft3d_routes_match_plain_on_card(card, shape, planes, inverse):
    x = from_numpy(_rand(shape, seed=12), device=card)
    got = fft3d_fused._fft3d_cuda(x, inverse=inverse, planes=planes)
    torch.cuda.synchronize()
    assert _rel(got, fft3d_fused.fft3d_fused_plain(x, inverse=inverse)) <= \
        1e-5


@pytest.mark.parametrize("shape,planes", [((2, 128, 128), None),
                                          ((1, 256, 128), None),
                                          ((1, 64, 128, 128), None),
                                          ((1, 64, 128, 128), False)])
def test_bf16_compensated_routes_on_card(card, shape, planes):
    """bf16 compensated on every route: within one bf16 ulp at the top of
    the plain version and 5e-3 of float64 numpy (relative norm)."""
    z = _rand(shape, seed=13)
    x = _bf16(z, card)
    if len(shape) == 3:
        got = fft2d_gemm.fft2d_gemm_cuda(x, variant="compensated")
        ref = fft2d_gemm.fft2d_gemm_plain(x, variant="compensated")
        want = np.fft.fft2(z)
    else:
        got = fft3d_fused._fft3d_cuda(x, variant="compensated", planes=planes)
        ref = fft3d_fused.fft3d_fused_plain(x, variant="compensated")
        want = np.fft.fftn(z, axes=(-3, -2, -1))
    torch.cuda.synchronize()
    assert got.re.dtype == torch.bfloat16
    assert _rel(SplitComplex(got.re.float(), got.im.float()),
                SplitComplex(ref.re.float(), ref.im.float())) <= 2.0 ** -7
    zz = got.re.double().cpu().numpy() + 1j * got.im.double().cpu().numpy()
    assert np.linalg.norm(zz - want) / np.linalg.norm(want) <= 5e-3


def test_fft2d_reads_an_unaligned_view_on_card(card):
    """Planes at an offset that is no multiple of 16 bytes are copied before
    the 16-byte cp.async chunks read them."""
    z = _rand((3, 64, 256), seed=14)
    x = from_numpy(z, device=card)
    view = SplitComplex(x.re.flatten()[1:].narrow(0, 0, 2 * 64 * 256)
                        .view(2, 64, 256), x.im[1:])
    assert view.re.data_ptr() % 16 != 0
    got = fft2d_gemm.fft2d_gemm_cuda(view)
    torch.cuda.synchronize()
    assert _rel(got, fft2d_gemm.fft2d_gemm_plain(view)) <= 1e-5


# -- the long-axis routes and bf16 planes ---------------------------------

@pytest.mark.parametrize("shape", [(2, 2, 8192), (2, 8192, 4),
                                   (1, 2, 16384)])
def test_long_axes_entry_points_on_card(card, shape):
    """fft2/ifft2 (the fused route and the fused_stockham oracle),
    rfft2/irfft2 with an axis past 4096: within 1e-5 of max|X| of numpy."""
    z = _rand(shape, 5)
    x = from_numpy(z, device=card)
    zr = np.random.default_rng(6).standard_normal(shape)
    xr = torch.from_numpy(zr).to(card, torch.float32)

    def err(got, want):
        g = got.re.double().cpu().numpy() + 1j * got.im.double().cpu().numpy() \
            if isinstance(got, SplitComplex) else got.double().cpu().numpy()
        return np.abs(g - want).max() / np.abs(want).max()
    for algo in ("auto", "fused_stockham"):
        assert err(fft2(x, algo=algo, backend="cuda"), np.fft.fft2(z)) <= 1e-5
        assert err(fft2(x, inverse=True, algo=algo, backend="cuda"),
                   np.fft.ifft2(z)) <= 1e-5
    f = rfft2(xr, backend="cuda")
    assert err(f, np.fft.rfft2(zr)) <= 1e-5
    assert err(irfft2(f, s=shape[1:], backend="cuda"), zr) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 2, 2, 8192), (1, 8192, 2, 4)])
def test_long_axes_fft3_on_card(card, shape):
    z = _rand(shape, 7)
    got = fft3(from_numpy(z, device=card), backend="cuda")
    g = got.re.double().cpu().numpy() + 1j * got.im.double().cpu().numpy()
    want = np.fft.fftn(z, axes=(-3, -2, -1))
    assert np.linalg.norm(g - want) / np.linalg.norm(want) <= 1e-6


@pytest.mark.parametrize("shape,n1", [((1, 1 << 21), None), ((3, 4096), 2),
                                      ((3, 1 << 15), 2),
                                      ((3, 1 << 14), 1 << 14)])
def test_fourstep_factors_on_card(card, shape, n1):
    """The four-step kernel's factors past 1024 (the axis route): within
    5e-5 of max|X| of numpy and of the plain version."""
    x = from_numpy(_rand(shape, 8), device=card)
    got = ops.fft_fourstep(x, n1=n1)
    assert _rel(got, fft_fourstep.fft_fourstep_plain(x, n1=n1)) <= 5e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 6e-2),
                                       (torch.float16, 1e-3)])
@pytest.mark.parametrize("radix", [2, 4])
def test_stockham_r2_per_stage_on_card(card, radix, dtype, tol):
    """Both radices past 2^24 (three fused launches, no longer a launch a
    stage), forward and inverse, against float64 numpy of the input as
    rounded to its dtype: within 5e-5 of max|X| in fp32, 6e-2 in bf16,
    1e-3 in float16."""
    z = _rand((1, 1 << 25), 9)
    x = SplitComplex(*(torch.from_numpy(p).to(card, dtype)
                       for p in (z.real, z.imag)))
    z = x.re.double().cpu().numpy() + 1j * x.im.double().cpu().numpy()
    kern = (fft_stockham.fft_stockham_r2_cuda if radix == 2
            else fft_stockham.fft_stockham_cuda)
    for inverse in (False, True):
        got = kern(x, inverse=inverse)
        assert got.re.dtype == dtype
        g = got.re.double().cpu().numpy() + 1j * got.im.double().cpu().numpy()
        want = np.fft.ifft(z) if inverse else np.fft.fft(z)
        assert np.abs(g - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 6e-2),
                                       (torch.float16, 1e-3)])
@pytest.mark.parametrize("shape", [(1, 2, 1 << 25), (1, 1 << 25, 4)])
def test_stockham2d_three_launches_on_card(card, shape, dtype, tol):
    """The fused Stockham 2-D kernel with an axis of 2^25, on rows and on
    the columns of 4-wide images (the 1-D kernel's three launches along
    it), forward and inverse, against float64 numpy of the input as
    rounded to its dtype: within 1e-5 of max|X| in fp32, 6e-2 in bf16,
    1e-3 in float16.  The float16 input is scaled by 1/8: the spectrum of
    2^27 unit normals reaches ~7e4, past float16's largest value, 65504."""
    z = _rand(shape, 13) * (0.125 if dtype == torch.float16 else 1.0)
    x = SplitComplex(*(torch.from_numpy(p).to(card, dtype)
                       for p in (z.real, z.imag)))
    z = x.re.double().cpu().numpy() + 1j * x.im.double().cpu().numpy()
    assert "split_mid" in [r for r, _ in fft2d_fused.plan(*shape)]
    for inverse in (False, True):
        got = fft2d_fused.fft2d_fused_cuda(x, inverse=inverse)
        assert got.re.dtype == dtype
        g = got.re.double().cpu().numpy() + 1j * got.im.double().cpu().numpy()
        want = np.fft.ifft2(z) if inverse else np.fft.fft2(z)
        assert np.abs(g - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("name,shape", [
    ("fft_stockham", (4, 256)), ("fft_stockham_r2", (4, 256)),
    ("fft_fourstep", (4, 256)), ("fft_staged", (4, 256)),
    ("fft2d_fused", (2, 64, 64)), ("rfft2d_fused", (2, 64, 64)),
    ("irfft2d_fused", (2, 64, 64)), ("fftconv_fused", (2, 3, 64))])
def test_bf16_planes_on_card(card, name, shape):
    """bf16 in, bf16 out; against float64 numpy of the bf16-rounded input
    within 6e-2 of max|X| and within the plain version's own error plus
    2^-7."""
    rng = np.random.default_rng(10)

    def f64(y):
        if isinstance(y, SplitComplex):
            return f64(y.re) + 1j * f64(y.im)
        return y.double().cpu().numpy()
    if name in ("rfft2d_fused", "fftconv_fused"):
        x = torch.from_numpy(rng.standard_normal(shape)).to(card).bfloat16()
    elif name == "irfft2d_fused":
        b, h, w = shape
        z = _rand((b, h, w // 2 + 1), 11)
        x = SplitComplex(*(torch.from_numpy(p).to(card).bfloat16()
                           for p in (z.real, z.imag)))
    else:
        z = _rand(shape, 12)
        x = SplitComplex(*(torch.from_numpy(p).to(card).bfloat16()
                           for p in (z.real, z.imag)))
    kern = {"fft_stockham": (fft_stockham.fft_stockham_cuda,
                             fft_stockham.fft_stockham_plain, np.fft.fft),
            "fft_stockham_r2": (fft_stockham.fft_stockham_r2_cuda,
                                fft_stockham.fft_stockham_r2_plain,
                                np.fft.fft),
            "fft_fourstep": (fft_fourstep.fft_fourstep_cuda,
                             fft_fourstep.fft_fourstep_plain, np.fft.fft),
            "fft_staged": (fft_stage.fft_staged_cuda,
                           fft_stage.fft_staged_plain, np.fft.fft),
            "fft2d_fused": (fft2d_fused.fft2d_fused_cuda,
                            fft2d_fused.fft2d_fused_plain, np.fft.fft2),
            "rfft2d_fused": (rfft2d_fused.rfft2d_fused_cuda,
                             rfft2d_fused.rfft2d_fused_plain, np.fft.rfft2),
            "irfft2d_fused": (rfft2d_fused.irfft2d_fused_cuda,
                              rfft2d_fused.irfft2d_fused_plain,
                              lambda a: np.fft.irfft2(a, s=shape[1:]))}
    if name == "fftconv_fused":
        m = shape[-1]
        kz = _rand((shape[1], m // 2 + 1), 13)
        kz[:, 0], kz[:, -1] = kz[:, 0].real, kz[:, -1].real
        ef = fftconv_fused.pack_filter(from_numpy(kz, device=card), m,
                                       torch.bfloat16)
        launch = lambda t: fftconv_fused.fftconv_fused_cuda(t, ef)  # noqa
        plain = lambda t: fftconv_fused.fftconv_fused_plain(t, ef)  # noqa
        want = np.fft.irfft(np.fft.rfft(f64(x)) * kz, m)
    else:
        launch, plain, ref = kern[name]
        want = ref(f64(x))
    got = launch(x)
    assert (got.re if isinstance(got, SplitComplex) else got).dtype == \
        torch.bfloat16
    scale = np.abs(want).max()
    k_err = np.abs(f64(got) - want).max() / scale
    p_err = np.abs(f64(plain(x)) - want).max() / scale
    assert k_err <= 6e-2 and k_err <= p_err + 2.0 ** -7


@pytest.mark.parametrize("name,shape", [
    ("fft_stockham", (4, 256)), ("fft_stockham_r2", (4, 256)),
    ("fft_fourstep", (4, 256)), ("fft_staged", (4, 256)),
    ("fft2d_fused", (2, 64, 64)), ("fft2d_gemm", (2, 64, 64)),
    ("fft3d_fused", (1, 4, 8, 16)), ("rfft2d_fused", (2, 64, 64)),
    ("irfft2d_fused", (2, 64, 64)), ("fftconv_fused", (2, 3, 64))])
def test_float16_planes_on_card(card, name, shape):
    """float16 in, float16 out (F11); against float64 numpy of the
    float16-rounded input within 1e-3 of max|X| (the staged FFT, which
    rounds every stage to float16 as the reference does, excepted) and
    within the plain version's own error plus 2^-10."""
    rng = np.random.default_rng(16)
    f16 = torch.float16

    def f64(y):
        if isinstance(y, SplitComplex):
            return f64(y.re) + 1j * f64(y.im)
        return y.double().cpu().numpy()

    def planes(z):
        return SplitComplex(*(torch.from_numpy(p).to(card, f16)
                              for p in (z.real, z.imag)))
    if name in ("rfft2d_fused", "fftconv_fused"):
        x = torch.from_numpy(rng.standard_normal(shape)).to(card, f16)
    elif name == "irfft2d_fused":
        b, h, w = shape
        x = planes(_rand((b, h, w // 2 + 1), 17))
    else:
        x = planes(_rand(shape, 18))
    kern = {"fft_stockham": (fft_stockham.fft_stockham_cuda,
                             fft_stockham.fft_stockham_plain, np.fft.fft),
            "fft_stockham_r2": (fft_stockham.fft_stockham_r2_cuda,
                                fft_stockham.fft_stockham_r2_plain,
                                np.fft.fft),
            "fft_fourstep": (fft_fourstep.fft_fourstep_cuda,
                             fft_fourstep.fft_fourstep_plain, np.fft.fft),
            "fft_staged": (fft_stage.fft_staged_cuda,
                           fft_stage.fft_staged_plain, np.fft.fft),
            "fft2d_fused": (fft2d_fused.fft2d_fused_cuda,
                            fft2d_fused.fft2d_fused_plain, np.fft.fft2),
            "fft2d_gemm": (
                lambda t: fft2d_gemm.fft2d_gemm_cuda(t, variant="compensated"),
                lambda t: fft2d_gemm.fft2d_gemm_plain(
                    t, variant="compensated"), np.fft.fft2),
            "fft3d_fused": (
                lambda t: fft3d_fused.fft3d_fused_cuda(
                    t, variant="compensated"),
                lambda t: fft3d_fused.fft3d_fused_plain(
                    t, variant="compensated"),
                lambda a: np.fft.fftn(a, axes=(1, 2, 3))),
            "rfft2d_fused": (rfft2d_fused.rfft2d_fused_cuda,
                             rfft2d_fused.rfft2d_fused_plain, np.fft.rfft2),
            "irfft2d_fused": (rfft2d_fused.irfft2d_fused_cuda,
                              rfft2d_fused.irfft2d_fused_plain,
                              lambda a: np.fft.irfft2(a, s=shape[1:]))}
    if name == "fftconv_fused":
        m = shape[-1]
        kz = _rand((shape[1], m // 2 + 1), 19)
        kz[:, 0], kz[:, -1] = kz[:, 0].real, kz[:, -1].real
        ef = fftconv_fused.pack_filter(from_numpy(kz, device=card), m, f16)
        launch = lambda t: fftconv_fused.fftconv_fused_cuda(t, ef)  # noqa
        plain = lambda t: fftconv_fused.fftconv_fused_plain(t, ef)  # noqa
        want = np.fft.irfft(np.fft.rfft(f64(x)) * kz, m)
    else:
        launch, plain, ref = kern[name]
        want = ref(f64(x))
    got = launch(x)
    assert (got.re if isinstance(got, SplitComplex) else got).dtype == f16
    scale = np.abs(want).max()
    k_err = np.abs(f64(got) - want).max() / scale
    p_err = np.abs(f64(plain(x)) - want).max() / scale
    assert k_err <= p_err + 2.0 ** -10
    assert name == "fft_staged" or k_err <= 1e-3


def test_plain_float16_on_the_gemm_chain_raises_on_card(card):
    """No plan resolves to it (ROADMAP §2e): the plain variant's
    tensor-core route in float16 against its plain version, within 2^-10
    of max|plain| (its roundings are the plain version's), 2-D and 3-D,
    both directions."""
    for shape, launch, plain in (
            ((2, 64, 128), fft2d_gemm.fft2d_gemm_cuda,
             fft2d_gemm.fft2d_gemm_plain),
            ((1, 8, 16, 32), fft3d_fused.fft3d_fused_cuda,
             fft3d_fused.fft3d_fused_plain)):
        z = _rand(shape, 23)
        x = SplitComplex(*(torch.from_numpy(p).to(card, torch.float16)
                           for p in (z.real, z.imag)))
        for inverse in (False, True):
            got = launch(x, inverse=inverse, variant="plain")
            want = plain(x, inverse=inverse, variant="plain")
            assert got.re.dtype == torch.float16
            assert _rel(got, want) <= 2.0 ** -10


def test_guarded_fallback_stays_on_the_card(card):
    """A launch fault on a cuda plan falls back to the torch twin on the
    card, and the result agrees with the kernel's within the 2-D bound."""
    from repro_torch import resilience
    from repro_torch.core import plan as P
    from repro_torch.resilience import faults
    resilience.reset()
    P.clear_plan_cache()
    x = from_numpy(_rand((4, 64, 64), seed=11), device=card)
    pl = P.get_plan((64, 64), backend="cuda")
    want = pl(x)
    with faults.inject("plan.execute", "error"):
        got = pl(x)
    assert got.re.device.type == "cuda" and got.im.device.type == "cuda"
    assert _rel(got, want) <= 1e-5
    key = P._plan_key((64, 64), torch.float32, False, "cuda", "c2c")
    assert resilience.executor.stats(key)["fallbacks"] == 1
    resilience.reset()


def test_kernel_failure_on_the_card_raises(card, monkeypatch):
    """A kernel wrapper that fails with an error that is not an injected
    fault (a build failure, here) raises through the guarded executor, the
    tuning warm and the server's pre-warm: nothing falls back to the torch
    twin on the card, and no breaker opens."""
    from repro_torch import resilience
    from repro_torch.core import plan as P
    from repro_torch.serve.spectral import BucketConfig, SpectralServer

    def broken(*args, **kwargs):
        raise RuntimeError("nvcc failed to build fft2d_gemm")

    resilience.reset()
    P.clear_plan_cache()
    monkeypatch.setattr(fft2d_gemm, "fft2d_gemm_cuda", broken)
    x = from_numpy(_rand((2, 64, 64), seed=13), device=card)
    pl = P.get_plan((64, 64), backend="cuda")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        pl(x)
    key = P._plan_key((64, 64), torch.float32, False, "cuda", "c2c")
    assert resilience.executor.stats(key)["fallbacks"] == 0
    assert resilience.policy.breaker(key) is None
    P.clear_plan_cache()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        P.warm([(64, 64)], tune=True, tune_batch=2, device=card)
    P.clear_plan_cache()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        SpectralServer([BucketConfig((64, 64), max_batch=2)], device=card)
    resilience.reset()
    P.clear_plan_cache()


def test_tune_measures_on_the_card(card):
    from repro_torch.core import plan as P
    P.clear_plan_cache()
    pl = P.get_plan((64, 64), backend="cuda", tune=True, tune_batch=2,
                    device=card)
    times = [v for k, v in pl.tune_report.items()
             if k not in ("n_candidates", "n_measured", "winner")]
    assert pl.tuned and len(times) == pl.tune_report["n_candidates"]
    assert all(isinstance(t, float) and t > 0 for t in times)
    P.clear_plan_cache()


def test_spectral_server_on_the_card(card):
    """A threaded server on the card: staged on a side stream, dispatched
    on a compute stream, every spectrum against float64 numpy, and the
    kernels counted."""
    from repro_torch.serve.spectral import BucketConfig, SpectralServer
    rng = np.random.default_rng(12)
    ops.reset_launches()
    buckets = [BucketConfig((64, 64), max_batch=4),
               BucketConfig((64, 64), kind="rfft", max_batch=4)]
    want = {}
    with SpectralServer(buckets, unmatched="pad_up", device=card) as srv:
        for i in range(12):
            if i % 2:
                x = rng.standard_normal((64, 64)).astype(np.float32)
                srv.submit(i, x, kind="rfft")
                want[i] = np.fft.rfft2(x.astype(np.float64))
            else:
                z = _rand((60, 64), seed=i)
                srv.submit(i, z.astype(np.complex64))
                pad = np.zeros((64, 64), np.complex128)
                pad[:60] = z.astype(np.complex64)
                want[i] = np.fft.fft2(pad)
        assert srv.drain(timeout_s=120)
        for i, w in want.items():
            rec = srv.result(i, timeout=60)
            got = rec.value.re.astype(np.float64) + 1j * rec.value.im
            assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max()
        assert srv.snapshot()["totals"]["fallback_served"] == 0
    assert ops.LAUNCHES["fft2d_gemm"] > 0 and ops.LAUNCHES["rfft2d_fused"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_finite_check_on_the_card(card, dtype):
    """The guard's scan sees a NaN or an infinity anywhere in either plane
    on the card, and passes the largest finite values."""
    from repro_torch.resilience import guards
    y = from_numpy(_rand((2, 64, 64), seed=14), device=card, dtype=dtype)
    assert guards.finite_check(y)
    for bad in (float("nan"), float("inf"), float("-inf")):
        for plane in (0, 1):
            for at in (0, 4097, y.re.numel() - 1):
                p = [y.re.clone(), y.im.clone()]
                p[plane].view(-1)[at] = bad
                assert not guards.finite_check(SplitComplex(*p))
    big = torch.full((4096,), torch.finfo(dtype).max, device=card,
                     dtype=dtype)
    assert guards.finite_check(SplitComplex(big, -big))


def _model_run(cfg, params, toks, dev):
    """Bulk prefill of 16 tokens, then 4 decode steps; the last-position
    logits of each, stacked."""
    from repro_torch.models import model as M
    with torch.inference_mode():
        t = toks.to(dev)
        lg, cache = M.prefill(params, cfg, tokens=t,
                              cache=M.init_cache(cfg, 2, 24, device=dev))
        out = [lg[:, -1]]
        for i in range(4):
            lg, cache = M.decode_step(
                params, cfg, t[:, i], cache,
                torch.full((2,), 16 + i, dtype=torch.int32, device=dev))
            out.append(lg)
        return torch.stack(out).float().cpu()


@pytest.mark.parametrize("arch", sorted(C.REGISTRY))
def test_model_serving_path_on_the_card(card, arch):
    """Every registry config reduced: prefill and decode on the card (each
    attention layer of a step on the decode kernel, ssm_demo's conv on the
    fused conv kernel) agree with the same on the CPU within 1e-4 of
    max(1, max|logits|)."""
    from repro_torch.models import model as M
    cfg = C.get_config(arch).reduced()
    host = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = M.tree_map(lambda t: t.to(card), host)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)))
    ops.reset_launches()
    got = _model_run(cfg, params, toks, card)
    attn = sum(b in ("attn_mlp", "attn_moe", "shared_attn")
               for b in cfg.block_pattern) * cfg.repeat
    assert ops.LAUNCHES["decode_attention"] == 4 * attn
    if cfg.use_fft_conv:
        assert ops.LAUNCHES["fftconv_fused"] >= cfg.repeat
    want = _model_run(cfg, host, toks, "cpu")
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.abs().max().item()), err
