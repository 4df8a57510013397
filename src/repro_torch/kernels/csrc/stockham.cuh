// The fused Stockham machinery of fft_stockham.cu and fft2d_fused.cu: up to
// four bits of radix-2 or mixed radix-4/2 Stockham stages a pass in
// registers (16 points a thread, the stage loops template recursions so
// that the points stay in registers), passes between shared-memory
// barriers in bank-spreading layouts, twiddles off one table a radix (the
// radix-4 one (3, n/4): w, w^2, w^3, read at (j >> 2s) << 2s for stage s,
// bit for bit row s of the packed (s4, 3, n/4) table), and the stores of a
// rows tile (whole rows, or launch B's columns).  The tile walk, the
// copies and FromShared / ToShared / FromStage are axis_fft.cuh's.
#pragma once
#include "axis_fft.cuh"

namespace {

// i with its bits 4..8 folded into bits 0..4: a permutation of every aligned
// 32 under which the strides of a pass's writes (16 apart at its first
// stage) land on distinct banks
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 31); }

// The work layout of a rows tile: transform t's element i at t*p + swz(i),
// p padded so that 8 rows x 4 points hit 32 banks (pitch())
struct RowsSw {
  int p;
  __device__ __forceinline__ int at(int t, int i) const {
    return t * p + swz(i);
  }
};

// ... of a columns tile: element i of column t at swz(i*C + t)
struct ColsSw {
  int lc;
  __device__ __forceinline__ int at(int t, int i) const {
    return swz((i << lc) + t);
  }
};

// Twiddle W_n^m, m = (q + (p << qb)) << s: p the butterfly's p at stage
// bit s of its length, q the column of a launch A tile (q0 + t; qb = log2
// Q, the column's stages fold the four-step twiddle in), s shifted by
// s0 = l1 in launch B (its bit s is bit s + l1 of the whole).  Radix 4
// reads w^r at m of row r - 1 (rows of `row` = n/4 entries); `sg` is the
// transform's sign (-1 forward).
struct Twiddle {
  const float2* w;
  int q0, qb, s0, row;
  float sg;
  __device__ __forceinline__ int at(int t, int p, int s) const {
    return (q0 + (qb ? t : 0) + (p << qb)) << (s + s0);
  }
  __device__ __forceinline__ float2 operator()(int t, int p, int s) const {
    return w[at(t, p, s)];
  }
};

// Stages S+K .. S+LR-1 of a length-2^LN radix-2 Stockham on the 2^LR
// points u[r] = element base + r * 2^(LN-LR) of transform t, in registers,
// one template instance a stage (so that every index of u is a constant
// and u stays in registers).  Stage S+K pairs register bit LR-1-K (the
// current top bit of the index), so the pair's p (its index >> (S+K)) is
// bits S .. LN-2-K of the first point's index: one twiddle for the 2^K
// pairs that share them.
template <int LR, int LN, int S, int K = 0, class Tw>
__device__ __forceinline__ void r2_stages(float2* u, int base, int t,
                                          const Tw& tw) {
  if constexpr (K < LR) {
    constexpr int HB = LR - 1 - K;
    const int mask = (1 << (LN - 1 - S - K)) - 1;
#pragma unroll
    for (int lo = 0; lo < (1 << HB); ++lo) {
      const int p = ((base + (lo << (LN - LR))) >> S) & mask;
      const float2 w = tw(t, p, S + K);
#pragma unroll
      for (int hi = 0; hi < (1 << K); ++hi) {
        const int a = lo | (hi << (HB + 1)), b = a | (1 << HB);
        const float2 x = u[a], y = u[b];
        u[a] = cadd(x, y);
        u[b] = cmul(csub(x, y), w);
      }
    }
    r2_stages<LR, LN, S, K + 1>(u, base, t, tw);
  }
}

// The same for the mixed radix-4/2 Stockham: a radix-4 stage a step of two
// bits, which takes register bits HB and HB-1 (HB = LR-1-K) as its digit
// r (the quarter x[j + r*n/4]) and computes stockham_stages' butterfly
// (y_r * w^r, the +-i of the transform's sign); the radix-2 tail (stage
// LN-1, twiddle 1) when one bit is left.
template <int LR, int LN, int S, int K = 0, class Tw>
__device__ __forceinline__ void r4_stages(float2* u, int base, int t,
                                          const Tw& tw) {
  if constexpr (K + 1 == LR) {
    static_assert(S + K == LN - 1, "the radix-2 tail is the last stage");
#pragma unroll
    for (int hi = 0; hi < (1 << K); ++hi) {
      const float2 x = u[2 * hi], y = u[2 * hi + 1];
      u[2 * hi] = cadd(x, y);
      u[2 * hi + 1] = csub(x, y);
    }
  } else if constexpr (K < LR) {
    constexpr int HB = LR - 1 - K;
    const int mask = (1 << (LN - 2 - S - K)) - 1;
    const float sg = tw.sg;
#pragma unroll
    for (int lo = 0; lo < (1 << (HB - 1)); ++lo) {
      const int p = ((base + (lo << (LN - LR))) >> S) & mask;
      const int m = tw.at(t, p, S + K);
      const float2 w1 = tw.w[m], w2 = tw.w[m + tw.row],
                   w3 = tw.w[m + 2 * tw.row];
#pragma unroll
      for (int hi = 0; hi < (1 << K); ++hi) {
        const int i0 = lo | (hi << (HB + 1)), st = 1 << (HB - 1);
        const float2 a0 = u[i0], a1 = u[i0 + st], a2 = u[i0 + 2 * st],
                     a3 = u[i0 + 3 * st];
        const float2 e0 = cadd(a0, a2), d0 = csub(a0, a2);
        const float2 e1 = cadd(a1, a3), d1 = csub(a1, a3);
        u[i0] = cadd(e0, e1);
        u[i0 + st] = cmul(make_float2(d0.x - sg * d1.y, d0.y + sg * d1.x), w1);
        u[i0 + 2 * st] = cmul(csub(e0, e1), w2);
        u[i0 + 3 * st] =
            cmul(make_float2(d0.x + sg * d1.y, d0.y - sg * d1.x), w3);
      }
    }
    r4_stages<LR, LN, S, K + 2>(u, base, t, tw);
  }
}

// The register holding output r (element k0 + r * 2^S) after a pass of LR
// bits: a radix-2 stage moves the top register bit to the next bit of r
// (bit reversal); a radix-4 stage the top digit, its two bits in order,
// and the tail the last bit to the top of r.  Plain shifts, so an unrolled
// r folds to a constant.
template <int RX>
__device__ __forceinline__ constexpr int pass_reg(int r, int lr) {
  if (RX == 2) return rev4(r, lr);
  int x = 0;
#pragma unroll
  for (int k = 0; k + 1 < lr; k += 2)
    x |= (((r >> (k + 1)) & 1) << (lr - 1 - k)) | (((r >> k) & 1) << (lr - 2 - k));
  return (lr & 1) ? x | ((r >> (lr - 1)) & 1) : x;
}

// One pass: stages of bits S .. S+LR-1 of the 2^lT transforms of length
// 2^LN read through `in`, radix RX.  Each of the nt threads takes E / 2^LR
// groups q = tid + b*nt; q's low bits pick up to 2^LF transforms, the next
// ones the group's base (its first point, < 2^(LN-LR)), the rest the other
// transforms.  After the stages register pass_reg(r) is element
// (base mod 2^S) + r * 2^S + (base >> S) * 2^(S+LR), which `out` is handed
// in order.
template <int RX, int LR, int LN, int S, int LF, class In, class Tw,
          class Out>
__device__ __forceinline__ void st_pass(const In& in, int lT, int nt,
                                        const Tw& tw, const Out& out) {
  constexpr int R = 1 << LR, B = E / R, LB = LN - LR;
  const int lf = lT < LF ? lT : LF;
  const int tid = threadIdx.x;
  float2 v[E];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = tid + b * nt;
    const int rest = q >> lf;
    const int base = rest & ((1 << LB) - 1);
    const int t = ((rest >> LB) << lf) | (q & ((1 << lf) - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) v[b * R + r] = in(t, base + (r << LB));
    if constexpr (RX == 2)
      r2_stages<LR, LN, S>(v + b * R, base, t, tw);
    else
      r4_stages<LR, LN, S>(v + b * R, base, t, tw);
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = tid + b * nt;
    const int rest = q >> lf;
    const int base = rest & ((1 << LB) - 1);
    const int t = ((rest >> LB) << lf) | (q & ((1 << lf) - 1));
    float2 o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] = v[b * R + pass_reg<RX>(r, LR)];
    out.template put<R>(t, (base & ((1 << S) - 1)) | ((base >> S) << (S + LR)),
                        1 << S, o);
  }
  __syncthreads();
}

// Every stage from bit S on: passes of four bits, the last of LN - S mod 4;
// the first reads through `in`, the others from shared memory laid out by
// `lay`; the last hands its outputs to `last`, the others write to `lay`.
template <int RX, int LN, int S, int LF, class In, class Lay, class Tw,
          class Last>
__device__ __forceinline__ void st_passes(const In& in, float* sr, float* si,
                                          const Lay& lay, int lT, int nt,
                                          const Tw& tw, const Last& last) {
  constexpr int LR = LN - S < 4 ? LN - S : 4;
  if constexpr (S + LR == LN) {
    st_pass<RX, LR, LN, S, LF>(in, lT, nt, tw, last);
  } else {
    st_pass<RX, LR, LN, S, LF>(in, lT, nt, tw, ToShared<Lay>{sr, si, lay});
    st_passes<RX, LN, S + LR, LF>(FromShared<Lay>{sr, si, lay}, sr, si, lay,
                                  lT, nt, tw, last);
  }
}

// launch B's last pass: element m of row R = r0 + t (image R >> l1, column
// R mod 2^l1) to image * 2^(l1 + LN) + m * 2^l1 + column, scaled; rows
// past `outer` skipped
struct ToColumns {
  float* outr;
  float* outi;
  long long r0, outer;
  int l1, ln;
  float scale;
  template <int R>
  __device__ __forceinline__ void put(int t, int k0, int ns, float2* v) const {
    const long long row = r0 + t;
    if (row >= outer) return;
    const long long base =
        ((row >> l1) << (l1 + ln)) + (row & ((1LL << l1) - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long a = base + ((long long)(k0 + r * ns) << l1);
      outr[a] = v[r].x * scale;
      outi[a] = v[r].y * scale;
    }
  }
};

// a rows tile, back in the work layout, to rows of out: 32 lanes store 128
// contiguous bytes
template <int LN>
__device__ __forceinline__ void st_store_rows(const Geo& g, long long k,
                                              const float* wr,
                                              const float* wi,
                                              const RowsSw& lay) {
  float* outr = static_cast<float*>(g.outr);
  float* outi = static_cast<float*>(g.outi);
  const long long base = (k << g.lg) << LN;
  const long long left = (g.outer << LN) - base;
  const int points = 1 << (LN + g.lg);
  const int n = points < left ? points : (int)left;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int a = lay.at(e >> LN, e & ((1 << LN) - 1));
    outr[base + e] = wr[a] * g.scale;
    outi[base + e] = wi[a] * g.scale;
  }
  __syncthreads();
}

}  // namespace
