// One-token GQA flash-decode attention over a position-masked KV cache:
// q (B, H, D), K and V (B, S, KV, D) in fp32, bf16 or float16, kv_pos
// (B, S) int32 (-1 = empty slot), q_pos (B,) int32; out (B, H, D) in q's
// dtype.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::_decode_kernel.
// The TPU kernel walks the cache's chunks in order on one core and carries
// the online-softmax state (m, l, acc) in VMEM from one grid step to the
// next.  Blocks on the card run in parallel and carry nothing, so the cache
// is cut into splits (flash-decoding): block (split, KV head, batch row)
// reduces its split to a partial (m, l, acc) for the `group` query heads of
// its KV head, carrying the same online softmax from tile to tile (each
// tile rescales the running state by exp(m_old - m_new)), and a second
// launch merges the splits with the same rescaling.  The host picks the
// split length so that a launch has about 1024 blocks
// (kernels/decode_attention.py::split_length).
//
// Bound on the card: bytes.  Each visible (batch row, slot) moves
// 2 * KV * D cache elements and takes 4 * H * D flops: 12 flops a byte at
// starcoder2-15b (H 48, KV 4, D 128, bf16) and 4 at h2o-danube-1.8b (H 32,
// KV 8, D 80), far below the tensor cores' 295.  On fp32 CUDA cores those
// flops, with a shared-memory read for every few FMAs, held the kernel to
// 12-31 % of the bytes' bound; so for bf16 q and caches the products run on
// the tensor cores, and the kernel's work is to keep the bytes flowing:
//
//   skip     a block first turns its split's positions into one visibility
//            bit a slot (a word a 32-slot tile, __ballot_sync).  A tile with
//            no visible slot is never copied: where the split has a visible
//            slot, exp(-1e30 - m) is exactly 0, so the skipped slots'
//            weights are 0 and -1e30 never raises m.  A split with no
//            visible slot copies nothing and leaves the marker l = 0; where
//            every split of a (row, KV head) carries it, the merge computes
//            the mean of V over all S slots itself, as the dense reference
//            gives a row with no visible slot.
//   copy     (tensor cores) each of the block's NW warps walks its own
//            tiles (tile i of the split goes to warp i mod NW) through a
//            ring of NS shared-memory stages: the next tile's K and V are
//            in flight (cp.async, 16 bytes a lane, bf16 as stored) while
//            the warp computes the current one.  Rows are skewed by 16
//            bytes (pitch D + 8 elements), so the 8 rows an ldmatrix reads
//            fall on 32 distinct banks for every D that is a multiple of 16.
//   scores   S^T = K q^T with mma.sync m16n8k16 bf16 -> fp32: slots as M
//            (16 a fragment, two a tile), the group's query heads as N (8 an
//            n-tile, zero-padded), D as the reduction.  The group's q
//            fragments are loaded once a block and stay in registers.
//   softmax  the tile's max per head (three shuffles), the running state
//            rescaled, p = exp(s - m) rounded to bf16 and written, in the
//            accumulator's layout, to the warp's P buffer.
//   P.V      O^T = V^T P^T: D as M (ldmatrix.trans of the V tile), heads as
//            N (ldmatrix.trans of P), slots as the reduction.
//   combine  the NW warps' states are merged in shared memory, with the
//            same rescaling, into the split's partial.
// wgmma is not used: its 64-row tiles do not fit 4-12 heads.  float16 q
// and caches take the same route with mma.sync's f16 form, p rounded to
// float16.
//
// Rounding points against the reference (which scales q by 1/sqrt(D) in
// fp32 before its fp32 dot, and multiplies fp32 p by fp32 V):
//   - q enters the MMA as the bf16 input; 1/sqrt(D) multiplies the fp32
//     scores (the reference rounds q / sqrt(D) to fp32 first);
//   - p enters the P.V MMA in bf16 (FlashAttention's rounding point), and l
//     sums the same rounded p, so the output stays a convex combination of
//     V rows: the error is about 2^-9 of the output's own size, inside the
//     bf16 bound of 2^-7 of max|out| (PERF.md; no P_hi + P_lo split);
//   - the fp32 sums run in the MMA's order and the warps' merge order.
//
// A cache split over ranks (sequence-parallel serving) runs the split
// launch over the rank's slots and then the merge in its partial mode:
// instead of the output it writes the rank's (m, l, acc) a (row, KV head)
// (acc not divided by l; the marker m = -1e30, l = 0, acc = 0 where no
// slot of the rank is visible) and keeps the mean-of-V scratch as the sum
// of V over the rank's slots for those rows (zero elsewhere).  The ranks'
// partials, gathered, go through the merge again in its cross-rank mode
// (decode_attention_merge): the ranks are the splits, and a row that sees
// no slot on any rank takes the mean of V from the ranks' sums over the
// S slots of all ranks, since no rank can read another's V.
//
// fp32 or mixed dtypes, D not a multiple of 16, D > 128 and groups of more
// than 16 heads take the CUDA-core route (decode_core), chosen by the host
// from the dtypes and shapes before the launch: K and V tiles of 64 slots
// upcast to fp32 in shared memory, a thread a slot and four query heads for
// the scores, a warp a head for the online-softmax update, a thread a quad
// of D, four heads and every TS-th slot of the tile for P.V.  It skips tiles
// and splits as above (64-slot tiles).  It scales q by 1/sqrt(D) in fp32
// before the dot, as the reference does; everything accumulates in fp32.
#include <cuda_runtime.h>

#include <type_traits>

#include "bf16.cuh"
#include "f16.cuh"
#include "mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;
constexpr unsigned FULL = 0xFFFFFFFFu;

typedef unsigned short bf16;   // also the raw 16 bits of either half type
typedef cg::f16 f16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return cg::bf16_to_f32(x); }
__device__ __forceinline__ float to_f32(f16 x) { return cg::widen_f16(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = cg::f32_to_bf16(x);
}
__device__ __forceinline__ void store(f16* p, float x) {
  *p = cg::narrow_f16(x);
}

// a half of the tensor-core route (raw bits) from fp32 and back
template <bool F16>
__device__ __forceinline__ unsigned short to_half(float x) {
  return F16 ? cg::f32_to_f16(x) : cg::f32_to_bf16(x);
}
template <bool F16>
__device__ __forceinline__ float from_half(unsigned short h) {
  return F16 ? cg::f16_to_f32(h) : cg::bf16_to_f32(h);
}

__device__ __forceinline__ bool visible(long long p, long long qp,
                                        int window, int has_window) {
  return p >= 0 && p <= qp && (!has_window || p > qp - window);
}

// the warp-collective instructions (mma.cuh)
using cg::cp16;
using cg::cp_commit;
using cg::cp_wait;
using cg::ldsm4;
using cg::mma;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The split's visibility words (bit i of word w: slot 32w + i of the split)
// by the block's warps, VB words a warp at a time so that their position
// loads are in flight together; returns whether any slot is visible.
// `flag` is a shared int the caller has zeroed before a barrier.
constexpr int VB = 8;
__device__ __forceinline__ bool visibility(unsigned* vis, int* flag,
                                           const int* __restrict__ pos,
                                           int len, long long qp, int window,
                                           int has_window) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = (len + 31) >> 5, warps = blockDim.x >> 5;
  for (int w0 = warp; w0 < words; w0 += warps * VB) {
    int p[VB];
#pragma unroll
    for (int j = 0; j < VB; ++j) {
      const int i = ((w0 + j * warps) << 5) + lane;
      p[j] = i < len ? pos[i] : -1;
    }
#pragma unroll
    for (int j = 0; j < VB; ++j) {
      const unsigned m = __ballot_sync(FULL, visible(p[j], qp, window,
                                                     has_window));
      const int w = w0 + j * warps;
      if (lane == 0 && w < words) {
        vis[w] = m;
        if (m) *flag = 1;
      }
    }
  }
  __syncthreads();
  return *flag != 0;
}

// split 0 of each (row, KV head) clears the merge's mean-of-V scratch
__device__ __forceinline__ void clear_mean(float* mean_sum, int* mean_cnt,
                                           long long bk, int D) {
  for (int d = threadIdx.x; d < D; d += blockDim.x) mean_sum[bk * D + d] = 0.f;
  if (threadIdx.x == 0) mean_cnt[bk] = 0;
}

// -- the tensor-core route (bf16 or, F16, float16 q and caches, D = 16 * KS
// -- <= 128, a group of up to 8 * NTL heads) --------------------------------

constexpr int NW = 4;     // warps a block
constexpr int TW = 32;    // slots a warp's tile: one visibility word

constexpr int NS = 3;     // stages of a warp's ring: two tiles in flight

// shared memory, in bytes: the visibility words and flag, the warps' rings,
// the warps' P buffers
__host__ __device__ constexpr int vis_bytes(int split) {
  return ((split + 31) / 32 * 4 + 4 + 15) / 16 * 16;
}
__host__ __device__ constexpr int mma_pitch(int d) { return d + 8; }
__host__ __device__ constexpr int p_pitch(int ntl) {
  return ntl == 1 ? 8 : ntl * 8 + 8;
}
__host__ __device__ constexpr long long ring_bytes(int d) {
  return (long long)NW * NS * 2 * TW * mma_pitch(d) * 2;
}
__host__ __device__ constexpr long long mma_smem(int d, int ntl, int split) {
  return vis_bytes(split) + ring_bytes(d) + (long long)NW * TW * p_pitch(ntl) * 2;
}

template <int KS, int NTL, bool F16>
__global__ void __launch_bounds__(NW * 32)
decode_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const int* __restrict__ kv_pos,
           const int* __restrict__ q_pos, float* __restrict__ m_part,
           float* __restrict__ l_part, float* __restrict__ acc_part,
           float* __restrict__ mean_sum, int* __restrict__ mean_cnt, int S,
           int H, int KV, int split, int nsplit, int window, int has_window) {
  constexpr int D = 16 * KS, P = mma_pitch(D), PP = p_pitch(NTL), G = 8 * NTL;
  extern __shared__ float smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const int group = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long blk = blockIdx.x;
  const int c = (int)(blk % nsplit);
  const long long bk = blk / nsplit;          // b * KV + kvh
  const int kvh = (int)(bk % KV);
  const long long b = bk / KV;
  const int s0 = c * split;
  const int len = S - s0 < split ? S - s0 : split;
  const int words = (len + 31) >> 5;
  const long long qp = q_pos[b];
  const long long part = (bk * nsplit + c) * group;
  unsigned* vis = reinterpret_cast<unsigned*>(base);
  int* flag = reinterpret_cast<int*>(vis + words);
  bf16* ring = reinterpret_cast<bf16*>(base + vis_bytes(split));
  bf16* pw = ring + (long long)NW * NS * 2 * TW * P + warp * TW * PP;
  bf16* mine = ring + (long long)warp * NS * 2 * TW * P;

  if (c == 0) clear_mean(mean_sum, mean_cnt, bk, D);
  if (tid == 0) *flag = 0;
  __syncthreads();
  if (!visibility(vis, flag, kv_pos + b * S + s0, len, qp, window,
                  has_window)) {
    if (tid < group) {                 // the marker: nothing visible here
      m_part[part + tid] = NEG_INF;
      l_part[part + tid] = 0.f;
    }
    return;
  }

  // q fragments (the B operand, heads as N): head nt*8 + lane/4, elements
  // 2*(lane%4), +1 and +8, +9 of each 16 of D; heads past the group zero
  unsigned qf[KS][NTL][2];
  const bf16* qb = q + (b * H + (long long)kvh * group) * D;
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    const int hh = nt * 8 + (lane >> 2);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const unsigned* src = reinterpret_cast<const unsigned*>(
          qb + (long long)hh * D + ks * 16 + 2 * (lane & 3));
      qf[ks][nt][0] = hh < group ? src[0] : 0u;
      qf[ks][nt][1] = hh < group ? src[4] : 0u;
    }
  }

  // the warp's state for heads nt*8 + 2*(lane%4) + e: running max, its
  // lanes' share of l, and acc (O^T fragments: d md*16 + lane/4 (+8))
  float m_r[NTL][2], l_r[NTL][2], acc[KS][NTL][4];
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m_r[nt][e] = NEG_INF;
      l_r[nt][e] = 0.f;
    }
#pragma unroll
  for (int md = 0; md < KS; ++md)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[md][nt][i] = 0.f;

  const long long row0 = ((b * S + s0) * KV + kvh) * D;
  const long long stride = (long long)KV * D;   // one slot to the next
  const float scale = 1.f / sqrtf((float)D);

  // the warp's next tile with a visible slot from word w on
  auto next = [&](int w) {
    while (w < words && vis[w] == 0u) w += NW;
    return w;
  };
  // start the copy of tile w's K and V rows into stage st; rows past the
  // split zero
  auto load = [&](int w, int st) {
    bf16* kt = mine + st * 2 * TW * P;
    bf16* vt = kt + TW * P;
    constexpr int CH = D / 8;                   // 16-byte chunks a row
#pragma unroll 4
    for (int i = lane; i < TW * CH; i += 32) {
      const int r = i / CH, ch = i - r * CH;
      const int t = (w << 5) + r;
      const long long g = t < len ? row0 + t * stride + ch * 8 : 0;
      const int have = t < len ? 16 : 0;
      cp16(kt + r * P + ch * 8, k + g, have);
      cp16(vt + r * P + ch * 8, v + g, have);
    }
  };
  auto compute = [&](int w, int st) {
    const bf16* kt = mine + st * 2 * TW * P;
    const bf16* vt = kt + TW * P;
    const unsigned bits = vis[w];
    // scores, slots mf*16 + lane/4 (+8) of heads nt*8 + 2*(lane%4) (+1)
    float sc[2][NTL][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf) {
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[mf][nt][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned a[4];
        ldsm4<false>(a, kt + (mf * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                            ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt)
          mma<F16>(sc[mf][nt], a, qf[ks][nt][0], qf[ks][nt][1]);
      }
    }
    float mx[NTL][2];
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) mx[nt][0] = mx[nt][1] = NEG_INF;
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = mf * 16 + (lane >> 2) + (i >> 1) * 8;
          const float s = (bits >> t) & 1u ? sc[mf][nt][i] * scale : NEG_INF;
          sc[mf][nt][i] = s;
          mx[nt][i & 1] = fmaxf(mx[nt][i & 1], s);
        }
    // the tile's max over the 8 lanes of a head's column, then rescale
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = mx[nt][e];
        x = fmaxf(x, __shfl_xor_sync(FULL, x, 4));
        x = fmaxf(x, __shfl_xor_sync(FULL, x, 8));
        x = fmaxf(x, __shfl_xor_sync(FULL, x, 16));
        const float mn = fmaxf(m_r[nt][e], x);
        const float alpha = expf(m_r[nt][e] - mn);
        m_r[nt][e] = mn;
        l_r[nt][e] *= alpha;
#pragma unroll
        for (int md = 0; md < KS; ++md) {
          acc[md][nt][e] *= alpha;
          acc[md][nt][e + 2] *= alpha;
        }
      }
    // p in the half type to the warp's P buffer, [slot][head]
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = mf * 16 + (lane >> 2) + hf * 8;
          const bf16 p0 = to_half<F16>(expf(sc[mf][nt][2 * hf] - m_r[nt][0]));
          const bf16 p1 =
              to_half<F16>(expf(sc[mf][nt][2 * hf + 1] - m_r[nt][1]));
          l_r[nt][0] += from_half<F16>(p0);
          l_r[nt][1] += from_half<F16>(p1);
          *reinterpret_cast<unsigned*>(pw + t * PP + nt * 8 + 2 * (lane & 3)) =
              (unsigned)p0 | ((unsigned)p1 << 16);
        }
    __syncwarp();
    // P^T fragments: register 2*kk + j holds slots kk*16 + j*8 + 2*(lane%4)
    // (+1) of head nt*8 + lane/4
    unsigned pb[NTL][4];
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) ldsm4<true>(pb[nt], pw + lane * PP + nt * 8);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int md = 0; md < KS; ++md) {
        unsigned a[4];
        const int j = lane >> 3;
        ldsm4<true>(a, vt + (kk * 16 + (j >> 1) * 8 + (lane & 7)) * P +
                           md * 16 + (j & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt)
          mma<F16>(acc[md][nt], a, pb[nt][2 * kk], pb[nt][2 * kk + 1]);
      }
  };

  // the ring: NS - 1 tiles in flight ahead of the one computed
  int ahead = next(warp), work = ahead, st_ahead = 0, st_work = 0;
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (ahead < words) {
      load(ahead, st_ahead);
      ahead = next(ahead + NW);
    }
    cp_commit();
    st_ahead = st_ahead + 1 == NS ? 0 : st_ahead + 1;
  }
  while (work < words) {
    if (ahead < words) {
      load(ahead, st_ahead);
      ahead = next(ahead + NW);
    }
    cp_commit();
    st_ahead = st_ahead + 1 == NS ? 0 : st_ahead + 1;
    cp_wait<NS - 1>();
    __syncwarp();
    compute(work, st_work);
    __syncwarp();               // the stage and P buffer may be overwritten
    work = next(work + NW);
    st_work = st_work + 1 == NS ? 0 : st_work + 1;
  }
  cp_wait<0>();

  // l over the 8 lanes of a head's column
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = l_r[nt][e];
      x += __shfl_xor_sync(FULL, x, 4);
      x += __shfl_xor_sync(FULL, x, 8);
      x += __shfl_xor_sync(FULL, x, 16);
      l_r[nt][e] = x;
    }

  // merge the warps' states over the rings: fm, fl (NW, G), facc (NW, G, D)
  __syncthreads();
  float* fm = reinterpret_cast<float*>(ring);
  float* fl = fm + NW * G;
  float* facc = fl + NW * G;
  if (lane < 4)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int hh = nt * 8 + 2 * lane + e;
        fm[warp * G + hh] = m_r[nt][e];
        fl[warp * G + hh] = l_r[nt][e];
      }
#pragma unroll
  for (int md = 0; md < KS; ++md)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = md * 16 + (lane >> 2) + (i >> 1) * 8;
        const int hh = nt * 8 + 2 * (lane & 3) + (i & 1);
        facc[(warp * G + hh) * D + d] = acc[md][nt][i];
      }
  __syncthreads();
  for (int i = tid; i < group * D; i += NW * 32) {
    const int g = i / D, d = i - g * D;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, fm[w * G + g]);
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      o += expf(fm[w * G + g] - mm) * facc[(w * G + g) * D + d];
    acc_part[(part + g) * D + d] = o;
  }
  if (tid < group) {
    float mm = NEG_INF;
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, fm[w * G + tid]);
    float l = 0.f;
    for (int w = 0; w < NW; ++w) l += expf(fm[w * G + tid] - mm) * fl[w * G + tid];
    m_part[part + tid] = mm;
    l_part[part + tid] = l;
  }
}

// -- the CUDA-core route ---------------------------------------------------

constexpr int NT = 256;       // threads a block
constexpr int T = 64;         // cache slots a tile: two visibility words

// four consecutive elements (16-byte fp32 or 8-byte bf16 / float16 load)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(cg::bf16_to_f32((bf16)(u.x & 0xFFFFu)),
                     cg::bf16_to_f32((bf16)(u.x >> 16)),
                     cg::bf16_to_f32((bf16)(u.y & 0xFFFFu)),
                     cg::bf16_to_f32((bf16)(u.y >> 16)));
}
__device__ __forceinline__ float4 load4(const f16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(cg::f16_to_f32((bf16)(u.x & 0xFFFFu)),
                     cg::f16_to_f32((bf16)(u.x >> 16)),
                     cg::f16_to_f32((bf16)(u.y & 0xFFFFu)),
                     cg::f16_to_f32((bf16)(u.y >> 16)));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float p, float4 v, float4 a) {
  return make_float4(fmaf(p, v.x, a.x), fmaf(p, v.y, a.y),
                     fmaf(p, v.z, a.z), fmaf(p, v.w, a.w));
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// the shapes of a block's shared memory, all counts in floats
struct Layout {
  int g4, d, d4, dp, nq, ngb, ts;
  long long qs, kt, red, sc, ms, ls, al, vis, floats;
};

__host__ __device__ inline Layout layout(int group, int d, int split) {
  Layout y;
  y.g4 = (group + 3) / 4 * 4;
  y.d = d;
  y.d4 = (d + 3) / 4 * 4;
  y.nq = y.d4 / 4;
  y.dp = (y.nq % 2 == 0) ? y.d4 + 4 : y.d4;  // odd quads a row: no conflicts
  y.ngb = y.g4 / 4;
  int ts = NT / (y.nq * y.ngb);
  y.ts = ts < 1 ? 1 : (ts > T ? T : ts);
  y.qs = 0;
  y.kt = y.qs + (long long)y.g4 * y.d4;
  y.red = y.kt + (long long)T * y.dp;
  y.sc = y.red + (long long)y.ts * y.g4 * y.d4;
  y.ms = y.sc + (long long)y.g4 * T;
  y.ls = y.ms + y.g4;
  y.al = y.ls + y.g4;
  y.vis = y.al + y.g4;
  y.floats = y.vis + (split + 31) / 32 + 1;
  return y;
}

// rows [0, rows) of a tile: row t is D elements at base + t * stride; rows
// past the end and the pad of D are zeros
template <class KT>
__device__ void load_tile(float* kt, const KT* __restrict__ base,
                          long long stride, int rows, const Layout& y,
                          bool vec) {
  for (int i = threadIdx.x; i < T * y.nq; i += NT) {
    const int t = i / y.nq, c = (i - t * y.nq) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < rows) {
      const KT* p = base + t * stride + c;
      if (vec) {
        v = load4(p);
      } else {
        if (c < y.d) v.x = to_f32(p[0]);
        if (c + 1 < y.d) v.y = to_f32(p[1]);
        if (c + 2 < y.d) v.z = to_f32(p[2]);
        if (c + 3 < y.d) v.w = to_f32(p[3]);
      }
    }
    *reinterpret_cast<float4*>(kt + (long long)t * y.dp + c) = v;
  }
}

// grid: one block per (split, KV head, batch row), split fastest
template <class KT, class QT>
__global__ void __launch_bounds__(NT)
decode_core(const QT* __restrict__ q, const KT* __restrict__ k,
            const KT* __restrict__ v, const int* __restrict__ kv_pos,
            const int* __restrict__ q_pos, float* __restrict__ m_part,
            float* __restrict__ l_part, float* __restrict__ acc_part,
            float* __restrict__ mean_sum, int* __restrict__ mean_cnt, int S,
            int H, int KV, int D, int split, int nsplit, int window,
            int has_window, int vec) {
  extern __shared__ float smem[];
  const int group = H / KV;
  const Layout y = layout(group, D, split);
  float* qs = smem + y.qs;
  float* kt = smem + y.kt;
  float* red = smem + y.red;
  float* sc = smem + y.sc;
  float* ms = smem + y.ms;
  float* ls = smem + y.ls;
  float* al = smem + y.al;
  unsigned* vis = reinterpret_cast<unsigned*>(smem + y.vis);
  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  const int c = (int)(blk % nsplit);
  const long long bk = blk / nsplit;          // b * KV + kvh
  const int kvh = (int)(bk % KV);
  const long long b = bk / KV;
  const int s0 = c * split;
  const int len = S - s0 < split ? S - s0 : split;
  const int words = (len + 31) >> 5;
  int* flag = reinterpret_cast<int*>(vis + words);
  const long long qp = q_pos[b];
  const long long part = (bk * nsplit + c) * group;
  const float root = sqrtf((float)D);

  if (c == 0) clear_mean(mean_sum, mean_cnt, bk, D);
  if (tid == 0) *flag = 0;
  __syncthreads();
  if (!visibility(vis, flag, kv_pos + b * S + s0, len, qp, window,
                  has_window)) {
    if (tid < group) {                 // the marker: nothing visible here
      m_part[part + tid] = NEG_INF;
      l_part[part + tid] = 0.f;
    }
    return;
  }

  // q of the group's heads, scaled, zero-padded to (g4, d4); red zeroed;
  // the running (m, l) and the tile's rescale factor
  const QT* qb = q + (b * H + (long long)kvh * group) * D;
  for (int i = tid; i < y.g4 * y.d4; i += NT) {
    const int g = i / y.d4, d = i - g * y.d4;
    qs[i] = (g < group && d < D) ? to_f32(qb[(long long)g * D + d]) / root
                                 : 0.f;
  }
  for (long long i = tid; i < (long long)y.ts * y.g4 * y.d4; i += NT)
    red[i] = 0.f;
  for (int g = tid; g < y.g4; g += NT) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
    al[g] = 1.f;
  }

  const long long stride = (long long)KV * D;  // one slot to the next
  const long long row0 = ((b * S + s0) * KV + kvh) * D;
  const int warp = tid / 32, lane = tid % 32;
  const int items = y.nq * y.ngb * y.ts;
  for (int t0 = 0; t0 < len; t0 += T) {
    const unsigned w0 = vis[t0 >> 5];
    const unsigned w1 = (t0 >> 5) + 1 < words ? vis[(t0 >> 5) + 1] : 0u;
    if ((w0 | w1) == 0u) continue;   // no visible slot: not read
    const int rows = len - t0 < T ? len - t0 : T;
    // 1. scores of the tile; masked (and past the split) -1e30
    __syncthreads();                 // the previous tile is consumed
    load_tile(kt, k + row0 + t0 * stride, stride, rows, y, vec != 0);
    __syncthreads();
    for (int j = tid; j < y.ngb * T; j += NT) {
      const int t = j % T, gb = j / T;
      const float* kr = kt + (long long)t * y.dp;
      const float* q0 = qs + (long long)gb * 4 * y.d4;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int e = 0; e < y.d4; e += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + e);
        a0 = dot4(*reinterpret_cast<const float4*>(q0 + e), kk, a0);
        a1 = dot4(*reinterpret_cast<const float4*>(q0 + y.d4 + e), kk, a1);
        a2 = dot4(*reinterpret_cast<const float4*>(q0 + 2 * y.d4 + e), kk, a2);
        a3 = dot4(*reinterpret_cast<const float4*>(q0 + 3 * y.d4 + e), kk, a3);
      }
      const bool ok = ((t < 32 ? w0 >> t : w1 >> (t - 32)) & 1u) != 0u;
      const float a[4] = {a0, a1, a2, a3};
      for (int i = 0; i < 4; ++i)
        sc[(long long)(gb * 4 + i) * T + t] = ok ? a[i] : NEG_INF;
    }
    __syncthreads();
    // 2. online softmax, one warp a head: the tile's max, the rescale of
    // the running state, p = exp(s - m) in place
    for (int g = warp; g < group; g += NT / 32) {
      float* row = sc + (long long)g * T;
      const float tm = warp_max(fmaxf(row[lane], row[lane + 32]));
      const float mn = fmaxf(ms[g], tm);
      const float e0 = expf(row[lane] - mn), e1 = expf(row[lane + 32] - mn);
      row[lane] = e0;
      row[lane + 32] = e1;
      const float l = warp_sum(e0 + e1);
      if (lane == 0) {
        const float alpha = expf(ms[g] - mn);
        al[g] = alpha;
        ls[g] = ls[g] * alpha + l;
        ms[g] = mn;
      }
    }
    // 3. p @ V, each slice rescaled first
    __syncthreads();
    load_tile(kt, v + row0 + t0 * stride, stride, rows, y, vec != 0);
    __syncthreads();
    for (int j = tid; j < items; j += NT) {
      const int e = (j % y.nq) * 4;
      const int r = j / y.nq;
      const int gb = r % y.ngb, ts = r / y.ngb;
      float* acc = red + ((long long)ts * y.g4 + gb * 4) * y.d4 + e;
      float4 a[4];
      for (int i = 0; i < 4; ++i)
        a[i] = scale4(*reinterpret_cast<float4*>(acc + (long long)i * y.d4),
                      al[gb * 4 + i]);
      for (int t = ts; t < rows; t += y.ts) {
        const float4 vv = *reinterpret_cast<const float4*>(
            kt + (long long)t * y.dp + e);
        for (int i = 0; i < 4; ++i) {
          const int g = gb * 4 + i;
          const float p = g < group ? sc[(long long)g * T + t] : 0.f;
          a[i] = axpy4(p, vv, a[i]);
        }
      }
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(acc + (long long)i * y.d4) = a[i];
    }
  }
  __syncthreads();

  // the split's partials: (m, l) and acc summed over the slices
  for (int i = tid; i < group * D; i += NT) {
    const int g = i / D, d = i - g * D;
    float o = 0.f;
    for (int ts = 0; ts < y.ts; ++ts)
      o += red[((long long)ts * y.g4 + g) * y.d4 + d];
    acc_part[(part + g) * D + d] = o;
  }
  if (tid < group) {
    m_part[part + tid] = ms[tid];
    l_part[part + tid] = ls[tid];
  }
}

// -- the merge ---------------------------------------------------------------

// The merge's modes: the output from the splits (MERGE_OUT), the rank's
// partial state from its splits (MERGE_PARTIAL: `out` is the fp32 buffer
// of the module comment's (m, l, acc) a (row, KV head), in that order,
// then vsum, which is mean_sum), the output from the ranks' gathered
// partials (MERGE_RANKS: the ranks as the splits, no helpers, the empty
// rows' mean from vsums (R, B, KV, D) over the S slots of all ranks).
constexpr int MERGE_OUT = 0, MERGE_PARTIAL = 1, MERGE_RANKS = 2;

constexpr int NM = 256;              // threads a merge block
constexpr int MERGE_WEIGHTS = 8192;  // most nsplit * group weights (the host's)
constexpr int MS = 16;               // slot slices of a row's mean of V
constexpr int LW = 4096;             // (row, KV head) pairs a helper lists at once

// 16 bytes of V, as loaded, added to s as floats
__device__ __forceinline__ void add16(float* s, uint4 u, float) {
  s[0] += __uint_as_float(u.x); s[1] += __uint_as_float(u.y);
  s[2] += __uint_as_float(u.z); s[3] += __uint_as_float(u.w);
}
__device__ __forceinline__ void add16(float* s, uint4 u, bf16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[2 * i] += cg::bf16_to_f32((bf16)(w[i] & 0xFFFFu));
    s[2 * i + 1] += cg::bf16_to_f32((bf16)(w[i] >> 16));
  }
}
__device__ __forceinline__ void add16(float* s, uint4 u, f16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[2 * i] += cg::f16_to_f32((bf16)(w[i] & 0xFFFFu));
    s[2 * i + 1] += cg::f16_to_f32((bf16)(w[i] >> 16));
  }
}

// whether every split of (row, KV head) bk carries the marker l = 0
__device__ __forceinline__ bool no_visible(const float* __restrict__ l_part,
                                           long long bk, int nsplit,
                                           int group) {
  for (int c = 0; c < nsplit; ++c)
    if (l_part[(bk * nsplit + c) * group] > 0.f) return false;
  return true;
}

// Slice `sl` of MS of the mean of V over the S slots of (row, KV head) bk,
// by the whole block: lane r of R sums slots r, r + R, ... of the slice, a
// 16-byte chunk of D (vec) or one element (D <= NM) a lane; the slice's
// sums are added to mean_sum[bk] atomically, and the block that adds the
// last slice writes the mean to every head of the group (in the partial
// mode the sums stay in mean_sum, the rank's vsum).
template <class KT, class QT>
__device__ void mean_slice(const KT* __restrict__ v, QT* __restrict__ out,
                           float* mean_sum, int* mean_cnt, float* part,
                           int* last, long long bk, int sl, int S, int H,
                           int KV, int D, int vec, int mode) {
  const int group = H / KV, tid = threadIdx.x;
  const long long b = bk / KV;
  const int kvh = (int)(bk % KV);
  const int t0 = (int)((long long)S * sl / MS);
  const int t1 = (int)((long long)S * (sl + 1) / MS);
  const long long stride = (long long)KV * D;
  const KT* vb = v + (b * S * KV + kvh) * D;
  constexpr int E = 16 / sizeof(KT);            // elements a chunk
  const int ch = vec ? D / E : D, w = vec ? E : 1, R = NM / ch;
  const int r = tid / ch, c = tid - r * ch;
  float sum[E];
#pragma unroll
  for (int e = 0; e < E; ++e) sum[e] = 0.f;
  if (r < R) {
    if (vec) {
      const KT* p = vb + c * E;
#pragma unroll 4
      for (int t = t0 + r; t < t1; t += R)
        add16(sum, *reinterpret_cast<const uint4*>(p + t * stride), KT());
    } else {
#pragma unroll 4
      for (int t = t0 + r; t < t1; t += R) sum[0] += to_f32(vb[t * stride + c]);
    }
    for (int e = 0; e < w; ++e) part[r * D + c * w + e] = sum[e];
  }
  __syncthreads();
  for (int d = tid; d < D; d += NM) {
    float o = 0.f;
    for (int j = 0; j < R; ++j) o += part[j * D + d];
    atomicAdd(mean_sum + bk * D + d, o);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(mean_cnt + bk, 1) == MS - 1;
  __syncthreads();
  if (*last && mode == MERGE_OUT) {
    __threadfence();
    const volatile float* m = mean_sum + bk * D;
    QT* ob = out + (b * H + (long long)kvh * group) * D;
    for (int i = tid; i < group * D; i += NM) store(ob + i, m[i % D] / (float)S);
  }
  __syncthreads();
}

// grid: (batch row, KV head) x `oblocks` blocks of NM outputs, then
// `helpers` blocks.  Over the splits without the marker: out = sum_c a_c
// acc_c / max(sum_c a_c l_c, 1e-30), a_c = exp(m_c - max_c m_c), the
// weights a_c / l (zero for a marker) in shared memory.  A (row, KV head)
// whose every split carries the marker has no visible slot: its output is
// the mean of V over the S slots, which the helpers compute in MS slices a
// row, spread over the card (a block alone would stream the row's V at a
// fraction of the card's rate).  Shared memory: the (nsplit, group)
// weights and (mx, 1/l) a head; a helper's list of empty (row, KV head)
// pairs and a slice's (R, D) partial sums.
template <class KT, class QT>
__global__ void __launch_bounds__(NM)
decode_merge(const float* __restrict__ m_part, const float* __restrict__ l_part,
             const float* __restrict__ acc_part, const KT* __restrict__ v,
             QT* __restrict__ out, float* mean_sum, int* mean_cnt, int S,
             int H, int KV, int D, int nsplit, long long rows, int oblocks,
             int vec, int mode, const float* __restrict__ vsums) {
  extern __shared__ float smem[];
  const int group = H / KV, tid = threadIdx.x;
  // MERGE_PARTIAL: this (row, KV head)'s m, l and acc in the fp32 buffer
  float* pm = reinterpret_cast<float*>(out);
  float* pl = pm + rows * group;
  float* pacc = pl + rows * group;
  const long long normal = rows * oblocks;
  if (blockIdx.x >= normal) {          // a helper: slices of empty rows
    // every helper lists the (row, KV head) pairs with no visible slot, LW
    // at a time, in order (ballots), then takes slices hb, hb + hs, ...
    int* list = reinterpret_cast<int*>(smem);
    int* wc = list + LW;
    int* total = wc + NM / 32;
    int* last = total + 1;
    float* part = reinterpret_cast<float*>(last + 1);
    const int hb = (int)(blockIdx.x - normal), hs = (int)(gridDim.x - normal);
    const int warp = tid >> 5, lane = tid & 31;
    for (long long w0 = 0; w0 < rows; w0 += LW) {
      const int wn = (int)(rows - w0 < LW ? rows - w0 : LW);
      if (tid == 0) *total = 0;
      __syncthreads();
      for (int r0 = 0; r0 < wn; r0 += NM) {
        const int j = r0 + tid;
        const bool e = j < wn && no_visible(l_part, w0 + j, nsplit, group);
        const unsigned m = __ballot_sync(FULL, e);
        if (lane == 0) wc[warp] = __popc(m);
        __syncthreads();
        int at = *total + __popc(m & ((1u << lane) - 1u));
        for (int k = 0; k < warp; ++k) at += wc[k];
        if (e) list[at] = j;
        __syncthreads();
        if (tid == 0)
          for (int k = 0; k < NM / 32; ++k) *total += wc[k];
        __syncthreads();
      }
      const long long items = (long long)*total * MS;
      for (long long it = hb; it < items; it += hs)
        mean_slice<KT, QT>(v, out, mean_sum, mean_cnt, part, last,
                           w0 + list[it / MS], (int)(it % MS), S, H, KV, D,
                           vec, mode);
      __syncthreads();
    }
    return;
  }
  const long long bk = blockIdx.x / oblocks;   // b * KV + kvh
  const int i = (int)(blockIdx.x % oblocks) * NM + tid;
  const long long b = bk / KV;
  const int kvh = (int)(bk % KV);
  const long long base = bk * nsplit * group;  // split 0 of (b, kvh)
  const int ws = nsplit * group;
  float* wt = smem;
  float* mx = smem + ws;
  float* il = mx + group;
  int* any = reinterpret_cast<int*>(il + group);
  if (tid == 0) *any = 0;
  for (int j = tid; j < ws; j += NM) wt[j] = m_part[base + j];
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int g = warp; g < group; g += NM / 32) {   // a warp a head
    float m = NEG_INF, l = 0.f;
    for (int c = lane; c < nsplit; c += 32)
      if (l_part[base + c * group + g] > 0.f) m = fmaxf(m, wt[c * group + g]);
    m = warp_max(m);
    for (int c = lane; c < nsplit; c += 32) {
      const float lc = l_part[base + c * group + g];
      if (lc > 0.f) l += expf(wt[c * group + g] - m) * lc;
    }
    l = warp_sum(l);
    if (lane == 0) {
      mx[g] = m;
      il[g] = mode == MERGE_PARTIAL ? 1.f : 1.f / fmaxf(l, 1e-30f);
      if (l > 0.f) *any = 1;
      if (mode == MERGE_PARTIAL && blockIdx.x % oblocks == 0) {
        pm[bk * group + g] = l > 0.f ? m : NEG_INF;
        pl[bk * group + g] = l;
      }
    }
  }
  __syncthreads();
  if (!*any) {
    if (mode == MERGE_PARTIAL && i < group * D)   // the marker's acc
      pacc[bk * group * D + i] = 0.f;
    if (mode != MERGE_RANKS || i >= group * D) return;
    // no rank sees a slot: the mean of V from the ranks' sums
    const int d = i % D;
    float o = 0.f;
    for (int c = 0; c < nsplit; ++c) o += vsums[((long long)c * rows + bk) * D + d];
    store(out + (b * H + (long long)kvh * group) * D + i, o / (float)S);
    return;                            // else the helpers write the mean
  }
  for (int j = tid; j < ws; j += NM) {
    const int g = j % group;
    wt[j] = l_part[base + j] > 0.f ? expf(wt[j] - mx[g]) * il[g] : 0.f;
  }
  __syncthreads();
  if (i >= group * D) return;
  const int g = i / D, d = i - g * D;
  const float* a = acc_part + (base + g) * D + d;
  float o = 0.f;
#pragma unroll 8
  for (int c = 0; c < nsplit; ++c) {   // a marker's acc is never written
    const float w = wt[c * group + g], x = a[(long long)c * group * D];
    o = w != 0.f ? fmaf(w, x, o) : o;
  }
  if (mode == MERGE_PARTIAL)
    pacc[bk * group * D + i] = o;
  else
    store(out + (b * H + (long long)kvh * group) * D + i, o);
}

template <int KS, int NTL, bool F16>
int launch_mma(const void* q, const void* k, const void* v, const int* kv_pos,
               const int* q_pos, float* m_part, float* l_part,
               float* acc_part, float* mean_sum, int* mean_cnt,
               long long blocks, int S, int H, int KV, int split, int nsplit,
               int window, int has_window, cudaStream_t s) {
  const long long smem = mma_smem(16 * KS, NTL, split);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      decode_mma<KS, NTL, F16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  decode_mma<KS, NTL, F16><<<(unsigned)blocks, NW * 32, (size_t)smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, kv_pos, q_pos, m_part,
      l_part, acc_part, mean_sum, mean_cnt, S, H, KV, split, nsplit, window,
      has_window);
  return (int)cudaGetLastError();
}

template <int NTL, bool F16>
int pick_mma(int ks, const void* q, const void* k, const void* v,
             const int* kv_pos, const int* q_pos, float* m_part,
             float* l_part, float* acc_part, float* mean_sum, int* mean_cnt,
             long long blocks, int S, int H, int KV, int split, int nsplit,
             int window, int has_window, cudaStream_t s) {
#define DECODE_MMA(KS)                                                       \
  case KS:                                                                   \
    return launch_mma<KS, NTL, F16>(q, k, v, kv_pos, q_pos, m_part, l_part,  \
                               acc_part, mean_sum, mean_cnt, blocks, S, H,   \
                               KV, split, nsplit, window, has_window, s);
  switch (ks) {
    DECODE_MMA(1) DECODE_MMA(2) DECODE_MMA(3) DECODE_MMA(4)
    DECODE_MMA(5) DECODE_MMA(6) DECODE_MMA(7) DECODE_MMA(8)
  }
#undef DECODE_MMA
  return (int)cudaErrorInvalidValue;
}

template <class KT, class QT>
int run(const void* q, const void* k, const void* v, const int* kv_pos,
        const int* q_pos, float* m_part, float* l_part, float* acc_part,
        float* mean_sum, int* mean_cnt, void* out, long long B, int S, int H,
        int KV, int D, int split, int window, int has_window, int vec,
        int use_mma, int helpers, int mode, cudaStream_t s) {
  constexpr bool F16 = std::is_same<KT, f16>::value;
  constexpr bool HALVES = std::is_same<KT, QT>::value && sizeof(KT) == 2;
  const int nsplit = (S + split - 1) / split;
  const long long blocks = B * KV * nsplit;
  const int group = H / KV;
  int e = 0;
  bool launched = false;
  if constexpr (HALVES) {
    if (use_mma) {
      launched = true;
      e = group <= 8
            ? pick_mma<1, F16>(D / 16, q, k, v, kv_pos, q_pos, m_part,
                               l_part, acc_part, mean_sum, mean_cnt, blocks,
                               S, H, KV, split, nsplit, window, has_window, s)
            : pick_mma<2, F16>(D / 16, q, k, v, kv_pos, q_pos, m_part,
                               l_part, acc_part, mean_sum, mean_cnt, blocks,
                               S, H, KV, split, nsplit, window, has_window, s);
    }
  } else if (use_mma) {
    return (int)cudaErrorInvalidValue;
  }
  if (!launched) {
    const Layout y = layout(group, D, split);
    const long long smem = y.floats * 4;
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    e = (int)cudaFuncSetAttribute(decode_core<KT, QT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
    if (e != cudaSuccess) return e;
    decode_core<KT, QT><<<(unsigned)blocks, NT, (size_t)smem, s>>>(
        (const QT*)q, (const KT*)k, (const KT*)v, kv_pos, q_pos, m_part,
        l_part, acc_part, mean_sum, mean_cnt, S, H, KV, D, split, nsplit,
        window, has_window, vec);
    e = (int)cudaGetLastError();
  }
  if (e != cudaSuccess) return e;
  // the merge: vector reads of V where D is whole 16-byte chunks of a
  // 16-byte aligned cache
  const int chunk = 16 / (int)sizeof(KT);
  const int mvec = D % chunk == 0 && ((unsigned long long)v & 15) == 0;
  const long long weights = (long long)nsplit * group + 2 * group + 1;
  const long long slices =
      LW + NM / 32 + 2 + (long long)NM / (mvec ? D / chunk : D) * D;
  const long long msmem = (weights > slices ? weights : slices) * 4;
  if ((long long)nsplit * group > MERGE_WEIGHTS || D > NM || msmem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  e = (int)cudaFuncSetAttribute(decode_merge<KT, QT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)msmem);
  if (e != cudaSuccess) return e;
  const int oblocks = (group * D + NM - 1) / NM;
  decode_merge<KT, QT><<<(unsigned)(B * KV * oblocks + helpers), NM,
                         (size_t)msmem, s>>>(
      m_part, l_part, acc_part, (const KT*)v, (QT*)out, mean_sum, mean_cnt, S,
      H, KV, D, nsplit, B * KV, oblocks, mvec, mode, nullptr);
  return (int)cudaGetLastError();
}

// run<KT, QT> from the storage codes (0 fp32, 1 bf16, 2 float16)
template <class QT>
int pick_q(int kv_code, const void* q, const void* k, const void* v,
           const int* kv_pos, const int* q_pos, float* m_part,
           float* l_part, float* acc_part, float* mean_sum, int* mean_cnt,
           void* out, long long B, int S, int H, int KV, int D, int split,
           int window, int has_window, int vec, int use_mma, int helpers,
           int mode, cudaStream_t s) {
#define DECODE_RUN(KT)                                                       \
  run<KT, QT>(q, k, v, kv_pos, q_pos, m_part, l_part, acc_part, mean_sum,    \
              mean_cnt, out, B, S, H, KV, D, split, window, has_window, vec, \
              use_mma, helpers, mode, s)
  switch (kv_code) {
    case 0: return DECODE_RUN(float);
    case 1: return DECODE_RUN(bf16);
    case 2: return DECODE_RUN(f16);
  }
#undef DECODE_RUN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// m_part, l_part (B, KV, nsplit, H/KV) and acc_part (B, KV, nsplit, H/KV, D)
// are fp32 scratch, nsplit = ceil(S / split), and mean_sum (B, KV, D) fp32
// and mean_cnt (B, KV) int32 the merge's mean-of-V scratch (cleared by the
// split launch); q_code / kv_code the storage of q and out / of the caches
// (0 fp32, 1 bf16, 2 float16); vec: D % 4 == 0 and the caches 16-byte
// aligned (the CUDA-core route's vector loads); use_mma picks the
// tensor-core route, which takes q and caches both bf16 or both float16,
// D a multiple of 16 up to 128, H/KV <= 16 and 16-byte aligned operands
// (else an error); `helpers` the merge's blocks for rows with no visible
// slot (one an SM).  partial: out is the fp32 buffer of the rank's m, l
// (B, KV, H/KV) and acc (B, KV, H/KV, D), followed by mean_sum (vsum).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* kv_pos, const int* q_pos,
                                float* m_part, float* l_part, float* acc_part,
                                float* mean_sum, int* mean_cnt, void* out,
                                long long B, int S, int H, int KV, int D,
                                int split, int window, int has_window,
                                int q_code, int kv_code, int vec, int use_mma,
                                int helpers, int partial, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || split <= 0 ||
      helpers <= 0 || B * KV * ((S + split - 1) / split) >= (1LL << 31) ||
      B * KV * ((H / KV * D + NM - 1) / NM) + helpers >= (1LL << 31) ||
      B * H * (long long)D >= (1LL << 31) || q_code < 0 || q_code > 2 ||
      kv_code < 0 || kv_code > 2)
    return (int)cudaErrorInvalidValue;
  if (use_mma && (q_code != kv_code || q_code == 0 || D % 16 != 0 ||
                  D > 128 || H / KV > 16 ||
                  (((unsigned long long)q | (unsigned long long)k |
                    (unsigned long long)v) & 15)))
    return (int)cudaErrorInvalidValue;
  const int mode = partial ? MERGE_PARTIAL : MERGE_OUT;
#define DECODE_Q(QT)                                                         \
  pick_q<QT>(kv_code, q, k, v, kv_pos, q_pos, m_part, l_part, acc_part,      \
             mean_sum, mean_cnt, out, B, S, H, KV, D, split, window,         \
             has_window, vec, use_mma, helpers, mode, s)
  switch (q_code) {
    case 0: return DECODE_Q(float);
    case 1: return DECODE_Q(bf16);
    default: return DECODE_Q(f16);
  }
#undef DECODE_Q
}

// The merge of R ranks' gathered partials: m, l (B, KV, R, H/KV) and acc
// (B, KV, R, H/KV, D) fp32, the ranks in place of the splits, vsums (R, B,
// KV, D) fp32; out (B, H, D) in out_code's storage (0 fp32, 1 bf16, 2
// float16); S the slots of all ranks.
extern "C" int decode_attention_merge(const float* m, const float* l,
                                      const float* acc, const float* vsums,
                                      void* out, long long B, int H, int KV,
                                      int D, int R, int S, int out_code,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int group = KV > 0 ? H / KV : 0;
  const long long ws = (long long)R * group;
  if (B <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D > NM || R <= 0 ||
      S <= 0 || ws > MERGE_WEIGHTS || out_code < 0 || out_code > 2 ||
      B * KV * ((group * D + NM - 1) / NM) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long msmem = (ws + 2 * group + 1) * 4;
  const int oblocks = (group * D + NM - 1) / NM;
  const unsigned grid = (unsigned)(B * KV * oblocks);
#define DECODE_MERGE(QT)                                                     \
  {                                                                          \
    const cudaError_t e = cudaFuncSetAttribute(                              \
        decode_merge<float, QT>,                                             \
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)msmem);            \
    if (e != cudaSuccess) return (int)e;                                     \
    decode_merge<float, QT><<<grid, NM, (size_t)msmem, s>>>(                 \
        m, l, acc, nullptr, (QT*)out, nullptr, nullptr, S, H, KV, D, R,      \
        B * KV, oblocks, 0, MERGE_RANKS, vsums);                             \
    return (int)cudaGetLastError();                                          \
  }
  switch (out_code) {
    case 0: DECODE_MERGE(float)
    case 1: DECODE_MERGE(bf16)
    default: DECODE_MERGE(f16)
  }
#undef DECODE_MERGE
}
