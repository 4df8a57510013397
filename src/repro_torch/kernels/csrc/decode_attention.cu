// One-token GQA flash-decode attention over a position-masked KV cache:
// q (B, H, D), K and V (B, S, KV, D) in fp32 or bf16, kv_pos (B, S) int32
// (-1 = empty slot), q_pos (B,) int32; out (B, H, D) in q's dtype.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::_decode_kernel.
// The TPU kernel walks the cache's chunks in order on one core and carries
// the online-softmax state (m, l, acc) in VMEM from one grid step to the
// next.  Blocks on the card run in parallel and carry nothing, so the chunks
// become splits (flash-decoding): block (split, KV head, batch row) reduces
// its split of up to L slots to a partial (m, l, acc) for the `group` query
// heads of its KV head, and a second launch merges the splits with the
// reference's rescaling, exp(m_c - M).  One block per (KV head, batch row)
// alone would leave most of the 132 SMs idle (64 blocks at starcoder2-15b's
// B = 16, KV = 4).  Within a split:
//   1. K tiles of T slots are upcast to fp32 in shared memory; a thread
//      takes a slot and four query heads, so each K quad it reads meets four
//      q quads (broadcast reads).  Masked slots score -1e30, never -inf.
//   2. Per head, one warp takes the split's max m and turns the scores into
//      p = exp(s - m) in place, summing l.
//   3. V tiles go through the same buffer; a thread takes a quad of D, four
//      heads and every TS-th slot of the tile, and accumulates p * v into its
//      own slice of shared memory; the slices are summed at the end.
// A split with no visible slot has m = -1e30 and p = 1 on every slot, and
// the merge gives it weight 1 only when every split is so: a row with no
// visible slot gets the mean of V over its slots, as the dense reference.
// q is scaled by 1/sqrt(D) in fp32 before the dot; everything accumulates in
// fp32.  Shapes need not be powers of two: D is padded to a multiple of 4
// (zeros) and the heads to a multiple of 4 (ignored).
//
// Bound on the card: bytes by the roofline.  Each (batch row, slot) moves
// 2 * KV * D cache elements and takes 4 * H * D flops: with bf16 caches 12
// flops a byte at starcoder2-15b (H 48, KV 4, D 128) and 4 at
// h2o-danube-1.8b (H 32, KV 8, D 80), against the fp32 CUDA cores' balance of
// 67 TFLOP/s / 3.35 TB/s = 20.  At 12 the CUDA cores' instruction rate (FMAs plus
// shared-memory reads and conversions) can hold the kernel back before the
// bytes do; tensor cores are later work.
#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

constexpr int NT = 256;       // threads a block
constexpr int T = 64;         // cache slots a tile
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(unsigned short x) {
  return cg::bf16_to_f32(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(unsigned short* p, float x) {
  *p = cg::f32_to_bf16(x);
}

// four consecutive elements (16-byte fp32 or 8-byte bf16 load)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const unsigned short* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(cg::bf16_to_f32((unsigned short)(u.x & 0xFFFFu)),
                     cg::bf16_to_f32((unsigned short)(u.x >> 16)),
                     cg::bf16_to_f32((unsigned short)(u.y & 0xFFFFu)),
                     cg::bf16_to_f32((unsigned short)(u.y >> 16)));
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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// the shapes of a block's shared memory, all counts in floats
struct Layout {
  int g4, d, d4, dp, nq, ngb, ts;
  long long qs, kt, red, sc, ms, ls, floats;
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
  y.ms = y.sc + ((long long)group * split + 3) / 4 * 4;
  y.ls = y.ms + y.g4;
  y.floats = y.ls + y.g4;
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
decode_split(const QT* __restrict__ q, const KT* __restrict__ k,
             const KT* __restrict__ v, const int* __restrict__ kv_pos,
             const int* __restrict__ q_pos, float* __restrict__ m_part,
             float* __restrict__ l_part, float* __restrict__ acc_part,
             int S, int H, int KV, int D, int split, int nsplit, int window,
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
  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  const int c = (int)(blk % nsplit);
  const long long bk = blk / nsplit;          // b * KV + kvh
  const int kvh = (int)(bk % KV);
  const long long b = bk / KV;
  const int s0 = c * split;
  const int len = S - s0 < split ? S - s0 : split;
  const long long qp = q_pos[b];
  const float root = sqrtf((float)D);

  // q of the group's heads, scaled, zero-padded to (g4, d4); red zeroed
  const QT* qb = q + (b * H + (long long)kvh * group) * D;
  for (int i = tid; i < y.g4 * y.d4; i += NT) {
    const int g = i / y.d4, d = i - g * y.d4;
    qs[i] = (g < group && d < D) ? to_f32(qb[(long long)g * D + d]) / root
                                 : 0.f;
  }
  for (long long i = tid; i < (long long)y.ts * y.g4 * y.d4; i += NT)
    red[i] = 0.f;

  const long long stride = (long long)KV * D;  // one slot to the next
  const long long row0 = ((b * S + s0) * KV + kvh) * D;
  const int* pos = kv_pos + b * S + s0;

  // 1. scores
  for (int t0 = 0; t0 < len; t0 += T) {
    const int rows = len - t0 < T ? len - t0 : T;
    __syncthreads();                 // the previous tile is consumed
    load_tile(kt, k + row0 + t0 * stride, stride, rows, y, vec != 0);
    __syncthreads();
    for (int j = tid; j < y.ngb * T; j += NT) {
      const int t = j % T, gb = j / T;
      if (t >= rows) continue;
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
      const long long p = pos[t0 + t];
      const bool ok = p >= 0 && p <= qp && (!has_window || p > qp - window);
      const float a[4] = {a0, a1, a2, a3};
      for (int i = 0; i < 4; ++i) {
        const int g = gb * 4 + i;
        if (g < group) sc[(long long)g * split + t0 + t] = ok ? a[i] : NEG_INF;
      }
    }
  }
  __syncthreads();

  // 2. softmax numerators and the split's (m, l), one warp a head
  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < group; g += NT / 32) {
    float* row = sc + (long long)g * split;
    float m = NEG_INF;
    for (int t = lane; t < len; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < len; t += 32) {
      const float e = expf(row[t] - m);
      row[t] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      ms[g] = m;
      ls[g] = l;
    }
  }

  // 3. p @ V
  const int items = y.nq * y.ngb * y.ts;
  for (int t0 = 0; t0 < len; t0 += T) {
    const int rows = len - t0 < T ? len - t0 : T;
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
        a[i] = *reinterpret_cast<float4*>(acc + (long long)i * y.d4);
      for (int t = ts; t < rows; t += y.ts) {
        const float4 vv = *reinterpret_cast<const float4*>(
            kt + (long long)t * y.dp + e);
        for (int i = 0; i < 4; ++i) {
          const int g = gb * 4 + i;
          const float p = g < group ? sc[(long long)g * split + t0 + t] : 0.f;
          a[i] = axpy4(p, vv, a[i]);
        }
      }
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(acc + (long long)i * y.d4) = a[i];
    }
  }
  __syncthreads();

  // the split's partials: (m, l) and acc summed over the slices
  const long long part = (bk * nsplit + c) * group;
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

// grid: one block per (batch row, query head); out = sum_c a_c acc_c /
// max(sum_c a_c l_c, 1e-30) with a_c = exp(m_c - max_c m_c)
template <class QT>
__global__ void __launch_bounds__(128)
decode_merge(const float* __restrict__ m_part, const float* __restrict__ l_part,
             const float* __restrict__ acc_part, QT* __restrict__ out, int H,
             int KV, int D, int nsplit) {
  const int group = H / KV;
  const long long bh = blockIdx.x;
  const long long b = bh / H;
  const int h = (int)(bh % H);
  const int kvh = h / group, g = h - kvh * group;
  const long long base = (b * KV + kvh) * nsplit;   // split 0 of (b, kvh)
  float mx = NEG_INF;
  for (int c = 0; c < nsplit; ++c)
    mx = fmaxf(mx, m_part[(base + c) * group + g]);
  float l = 0.f;
  for (int c = 0; c < nsplit; ++c) {
    const long long i = (base + c) * group + g;
    l += expf(m_part[i] - mx) * l_part[i];
  }
  const float scale = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
    for (int c = 0; c < nsplit; ++c) {
      const long long i = (base + c) * group + g;
      o += expf(m_part[i] - mx) * acc_part[i * D + d];
    }
    store(out + bh * D + d, o * scale);
  }
}

template <class KT, class QT>
int run(const void* q, const void* k, const void* v, const int* kv_pos,
        const int* q_pos, float* m_part, float* l_part, float* acc_part,
        void* out, long long B, int S, int H, int KV, int D, int split,
        int window, int has_window, int vec, cudaStream_t s) {
  const int nsplit = (S + split - 1) / split;
  const Layout y = layout(H / KV, D, split);
  const long long smem = y.floats * 4;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decode_split<KT, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = B * KV * nsplit;
  decode_split<KT, QT><<<(unsigned)blocks, NT, (size_t)smem, s>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, kv_pos, q_pos, m_part, l_part,
      acc_part, S, H, KV, D, split, nsplit, window, has_window, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_merge<QT><<<(unsigned)(B * H), 128, 0, s>>>(
      m_part, l_part, acc_part, (QT*)out, H, KV, D, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// m_part, l_part (B, KV, nsplit, H/KV) and acc_part (B, KV, nsplit, H/KV, D)
// are fp32 scratch, nsplit = ceil(S / split); q_bf16 / kv_bf16 select bf16
// (else fp32) for q and out / for the caches; vec: D % 4 == 0 and the caches
// 16-byte aligned (vector loads).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* kv_pos, const int* q_pos,
                                float* m_part, float* l_part, float* acc_part,
                                void* out, long long B, int S, int H, int KV,
                                int D, int split, int window, int has_window,
                                int q_bf16, int kv_bf16, int vec,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || split <= 0 ||
      B * KV * ((S + split - 1) / split) >= (1LL << 31) || B * H >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  typedef unsigned short bf16;
  if (kv_bf16 && q_bf16)
    return run<bf16, bf16>(q, k, v, kv_pos, q_pos, m_part, l_part, acc_part,
                           out, B, S, H, KV, D, split, window, has_window, vec, s);
  if (kv_bf16)
    return run<bf16, float>(q, k, v, kv_pos, q_pos, m_part, l_part, acc_part,
                            out, B, S, H, KV, D, split, window, has_window, vec, s);
  if (q_bf16)
    return run<float, bf16>(q, k, v, kv_pos, q_pos, m_part, l_part, acc_part,
                            out, B, S, H, KV, D, split, window, has_window, vec, s);
  return run<float, float>(q, k, v, kv_pos, q_pos, m_part, l_part, acc_part,
                           out, B, S, H, KV, D, split, window, has_window, vec, s);
}
