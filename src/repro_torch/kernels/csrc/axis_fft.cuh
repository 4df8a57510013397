// Radix-16 Stockham FFTs in shared memory and registers, and the axis FFT
// built on them: a length-n complex FFT along the middle axis of a split
// plane viewed as (outer, n, inner), over tiles copied in asynchronously.
//
// The machinery (fft_fourstep.cu's, whose kernels keep it as it was): each
// thread holds E = 16 points across a pass; a radix-2^LR pass reads its
// inputs at stride N/R, twiddles them from the N-entry fp32 table of its
// length (w[e*r]: no __sincosf), runs a radix-2 network in registers and
// writes them back Stockham-ordered, with a barrier on either side; a
// radix-2/4/8 pass comes first when log2 n is no multiple of 4.  Row
// pitches are padded so that 32 lanes hit 32 banks (pitch()).
//
// The axis FFT (fft2d_gemm.cu, fft3d_fused.cu) is bound by bytes: ~5*log2(n)
// flops a point against 16 bytes in and out.  So a launch is one pass over
// device memory, and the host plans the fewest launches
// (kernels/axis_fft.py):
//   rows   inner = 1: a tile holds G whole rows (G*n points, one run);
//   cols   inner > 1: a tile holds C adjacent inner columns of all n rows
//          (C = 8192/n >= 8 for n <= 1024, 16384/n from n = 2048: every
//          row segment a whole 32-byte sector but at n = 4096, where C = 4),
//          or G whole images where inner < C;
//   plane  a tile holds G whole (h, w) images: the W FFT on its rows, then
//          the H FFT on its columns, both in shared memory.
// A block walks tiles blockIdx.x, + gridDim.x, ... (a persistent grid of
// about one block an SM).  Tiles of up to 8192 points (two 64 KB fp32
// buffers a block) OVERLAP: the block copies the next tile into its second
// buffer with cp.async while it transforms the current one.  Tiles of
// 16384 points (cols at n >= 2048, 128^2 planes; 128 KB) hold one buffer
// and do not overlap.  A tile is copied as it lies in memory in chunks of
// up to 16 bytes (rows' chunks swizzled by row so that the first pass reads
// 8 rows x 4 points from 32 banks); the first pass reads it (widening bf16
// or float16) and writes the work layout over it in fp32.  The cols and
// plane routes' last pass stores from registers (its lanes take adjacent
// columns); the rows route's goes back to shared memory and the tile leaves
// row by row, 128 contiguous bytes a warp.  Stores are scaled (the
// inverse's 1/N) and rounded to bf16 or float16 for such planes.  Every
// pass runs in place, so a launch may read and write the same planes.
// Axes longer than one launch holds (n > 4096 in the 2-D and 3-D kernels,
// four-step factors past 1024) split four-step fashion, n = n1 * n2 (*
// n3), one launch a factor, planned on the host (axis_fft.py::plan_split):
//   TWIDDLE  the FFT along n1 of the (outer, n1, n2*inner) view, each point
//            (k1, j2) multiplied at its store by W_M^(k1*j2) (M = n1*n2; a
//            two-level table, W_M^m = hi[m >> s] * lo[m mod 2^s]), in place;
//   REVERSED the FFT along the last factor of the (outer*n1(*n2), n2,
//            inner) view, point k2 of image (o, k1) stored at its
//            digit-reversed place (o, k2*n1 + k1) (with a third factor,
//            (o, k3*n1*n2 + k2*n1 + k1)), so it reads other planes than
//            it writes.
// Images of a view may lie further apart than their points (img_in,
// img_out: the real-input kernels' packed row pairs).
#pragma once
#include <cuda_runtime.h>
#include <type_traits>
#include <utility>
#include "bf16.cuh"
#include "f16.cuh"

namespace {

constexpr int E = 16;            // complex points a thread holds

// how an axis launch stores (the split routes; see Geo)
enum { PLAIN = 0, TWIDDLE = 1, REVERSED = 2 };

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// cos and sin of 2*pi*e/16, e in [0, 8)
__host__ __device__ constexpr float cos16(int e) {
  return e == 0 ? 1.f : e == 1 ? 0.92387953251128674f
       : e == 2 ? 0.70710678118654752f : e == 3 ? 0.38268343236508977f
       : e == 4 ? 0.f : e == 5 ? -0.38268343236508977f
       : e == 6 ? -0.70710678118654752f : -0.92387953251128674f;
}

__host__ __device__ constexpr float sin16(int e) {
  return e == 0 ? 0.f : e == 1 ? 0.38268343236508977f
       : e == 2 ? 0.70710678118654752f : e == 3 ? 0.92387953251128674f
       : e == 4 ? 1.f : e == 5 ? 0.92387953251128674f
       : e == 6 ? 0.70710678118654752f : 0.38268343236508977f;
}

// i < 16 with its low `bits` bits reversed: plain shifts, so an unrolled
// loop index folds to a constant and register arrays stay in registers
__host__ __device__ constexpr int rev4(int i, int bits) {
  return (((i & 1) << 3) | ((i & 2) << 1) | ((i & 4) >> 1) | ((i & 8) >> 3))
         >> (4 - bits);
}

// b * exp(sg * 2*pi*i * e/16), e a compile-time constant after unrolling
__device__ __forceinline__ float2 rot16(float2 b, int e, float sg) {
  if (e == 0) return b;
  if (e == 4) return make_float2(-sg * b.y, sg * b.x);
  const float c = cos16(e), s = sg * sin16(e);
  return make_float2(b.x * c - b.y * s, b.x * s + b.y * c);
}

// in-register DFT of 2^LR points, natural order in and out (radix-2 DIT)
template <int LR>
__device__ __forceinline__ void dft(float2* v, float sg) {
  constexpr int R = 1 << LR;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = rev4(i, LR);
    if (i < j) {
      const float2 t = v[i];
      v[i] = v[j];
      v[j] = t;
    }
  }
#pragma unroll
  for (int len = 2; len <= R; len <<= 1) {
#pragma unroll
    for (int i = 0; i < R; i += len) {
#pragma unroll
      for (int k = 0; k < len / 2; ++k) {
        const float2 a = v[i + k];
        const float2 b = rot16(v[i + k + len / 2], k * (16 / len), sg);
        v[i + k] = cadd(a, b);
        v[i + k + len / 2] = csub(a, b);
      }
    }
  }
}

// dft<LR> with every index a constant expression, one template instance a
// radix-2 stage: dft<LR>'s doubling stage loop is not always unrolled, and
// then v lives in local memory (the axis kernels take this one; the
// four-step kernel keeps dft<LR>, whose code it was tuned with)
template <int LR, int LEN = 2>
__device__ __forceinline__ void dft_stages(float2* v, float sg) {
  constexpr int R = 1 << LR;
  if constexpr (LEN <= R) {
#pragma unroll
    for (int i = 0; i < R; i += LEN) {
#pragma unroll
      for (int k = 0; k < LEN / 2; ++k) {
        const float2 a = v[i + k];
        const float2 b = rot16(v[i + k + LEN / 2], k * (16 / LEN), sg);
        v[i + k] = cadd(a, b);
        v[i + k + LEN / 2] = csub(a, b);
      }
    }
    dft_stages<LR, 2 * LEN>(v, sg);
  }
}

template <int LR>
__device__ __forceinline__ void dft_unrolled(float2* v, float sg) {
  constexpr int R = 1 << LR;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = rev4(i, LR);
    if (i < j) {
      const float2 t = v[i];
      v[i] = v[j];
      v[j] = t;
    }
  }
  dft_stages<LR>(v, sg);
}

// w^1, w^2, w^4, w^8: w^r for r < 16 is the product of the ones its bits
// pick, at most six products deep
struct Powers {
  float2 w[4];
  __device__ __forceinline__ explicit Powers(float2 w1) {
    w[0] = w1;
    w[1] = cmul(w[0], w[0]);
    w[2] = cmul(w[1], w[1]);
    w[3] = cmul(w[2], w[2]);
  }
  // b * w^r, r a compile-time constant after unrolling
  __device__ __forceinline__ float2 times(float2 b, int r) const {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (r & (1 << k)) b = cmul(b, w[k]);
    return b;
  }
};

// W_n^m = hi[m >> s] * lo[m & (2^s - 1)]
struct Levels {
  const float2* lo;
  const float2* hi;
  int s;
  __device__ __forceinline__ float2 operator()(int m) const {
    return cmul(hi[m >> s], lo[m & ((1 << s) - 1)]);
  }
};

// v[r] *= T[k1 = k0 + r*ns, j2] = W_n^(k0*j2) * (W_n^(ns*j2))^r
template <int R>
__device__ __forceinline__ void twiddle_t(const Levels& tw, int k0, int ns,
                                          int j2, float2* v) {
  const Powers p(tw(ns * j2));
  const float2 b = tw(k0 * j2);
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = cmul(v[r], p.times(b, r));
}

// Where element i of transform t sits in shared memory.
// Rows of pitch p: pass B's tile, the one launch's rows (g, k1).
struct Rows {
  int p;
  __device__ __forceinline__ int at(int t, int i) const { return t * p + i; }
};

// Columns: transform t = (g, j2) of rows (g, j1), pitch p; pass A's tile
// [j1][c] is one g of C columns at pitch C.
struct Columns {
  int ln2, block, p;
  __device__ __forceinline__ int at(int t, int i) const {
    return (t >> ln2) * block + (t & ((1 << ln2) - 1)) + i * p;
  }
};

// Where a pass reads element i of transform t: shared memory, or, in the
// first pass, the input planes themselves (no staging copy, no barrier).
template <class Lay>
struct FromShared {
  const float* sr;
  const float* si;
  Lay lay;
  __device__ __forceinline__ float2 operator()(int t, int i) const {
    const int a = lay.at(t, i);
    return make_float2(sr[a], si[a]);
  }
};


// A pass hands each butterfly's R outputs k0 + r*ns (r < R) of transform t
// to one of these: back to shared memory for every pass but the last.
template <class Lay>
struct ToShared {
  float* sr;
  float* si;
  Lay lay;
  template <int R>
  __device__ __forceinline__ void put(int t, int k0, int ns, float2* v) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = lay.at(t, k0 + r * ns);
      sr[a] = v[r].x;
      si[a] = v[r].y;
    }
  }
};

// One radix-2^LR Stockham pass over the 2^lT transforms of length 2^LN read
// through `in`, after passes whose radices multiply to 2^LNS.  Each of the
// nt threads takes E/R butterflies q = tid + b*nt; q's low bits pick up to
// 32 transforms (up to 2^LF where LF >= 0), the next ones the butterfly j,
// the rest the other transforms.  The twiddle of input r of butterfly j is w[e*r],
// e = (j mod 2^LNS) * 2^(LN - LNS - LR).  UR picks dft_unrolled.
template <int LR, int LN, int LNS, int LF = -1, bool UR = false, class In,
          class Out>
__device__ __forceinline__ void pass(const In& in, int lT, int nt,
                                     const float2* w, float sg,
                                     const Out& out) {
  constexpr int R = 1 << LR, B = E / R, LNB = LN - LR, NS = 1 << LNS;
  const int lf = LF >= 0 ? (lT < LF ? lT : LF) : lT < 5 ? lT : 5;
  const int tid = threadIdx.x;
  float2 v[E];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = tid + b * nt;
    const int rest = q >> lf;
    const int j = rest & ((1 << LNB) - 1);
    const int t = ((rest >> LNB) << lf) | (q & ((1 << lf) - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) v[b * R + r] = in(t, j + (r << LNB));
    if (LNS > 0) {
      const int e = (j & (NS - 1)) << (LN - LNS - LR);
#pragma unroll
      for (int r = 1; r < R; ++r) v[b * R + r] = cmul(v[b * R + r], w[e * r]);
    }
    if constexpr (UR)
      dft_unrolled<LR>(v + b * R, sg);
    else
      dft<LR>(v + b * R, sg);
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = tid + b * nt;
    const int rest = q >> lf;
    const int j = rest & ((1 << LNB) - 1);
    const int t = ((rest >> LNB) << lf) | (q & ((1 << lf) - 1));
    const int k0 = ((j >> LNS) << (LNS + LR)) + (j & (NS - 1));
    out.template put<R>(t, k0, NS, v + b * R);
  }
  __syncthreads();
}

// The passes of an FFT of length 2^LN (LN >= 1) from the one after those
// that multiply to 2^LNS: a radix 2^(LN mod 4) pass first when LN is no
// multiple of 4, then radix 16.  The first reads through `in`, the others
// from shared memory laid out by `lay`; the last pass hands its outputs to
// `last`, the others write back to `lay`.  The first pass takes up to 2^LF0
// transforms a warp where LF0 >= 0; UR as in pass.
template <int LN, int LNS, int LF0 = -1, bool UR = false, class In, class Lay,
          class Last>
__device__ __forceinline__ void passes(const In& in, float* sr, float* si,
                                       const Lay& lay, int lT, int nt,
                                       const float2* w, float sg,
                                       const Last& last) {
  constexpr int LR = (LNS == 0 && (LN & 3)) ? (LN & 3) : 4;
  if constexpr (LNS + LR == LN) {
    pass<LR, LN, LNS, LF0, UR>(in, lT, nt, w, sg, last);
  } else {
    pass<LR, LN, LNS, LF0, UR>(in, lT, nt, w, sg,
                               ToShared<Lay>{sr, si, lay});
    passes<LN, LNS + LR, -1, UR>(FromShared<Lay>{sr, si, lay}, sr, si, lay,
                                 lT, nt, w, sg, last);
  }
}

// the same for a length 2^ln known only at run time, 1 <= ln <= 10
template <int LF0 = -1, bool UR = false, class In, class Lay, class Last>
__device__ __forceinline__ void fft_any(int ln, const In& in, float* sr,
                                        float* si, const Lay& lay, int lT,
                                        int nt, const float2* w, float sg,
                                        const Last& last) {
  switch (ln) {
    case 1: passes<1, 0, LF0, UR>(in, sr, si, lay, lT, nt, w, sg, last); break;
    case 2: passes<2, 0, LF0, UR>(in, sr, si, lay, lT, nt, w, sg, last); break;
    case 3: passes<3, 0, LF0, UR>(in, sr, si, lay, lT, nt, w, sg, last); break;
    case 4: passes<4, 0, LF0, UR>(in, sr, si, lay, lT, nt, w, sg, last); break;
    case 5: passes<5, 0, LF0, UR>(in, sr, si, lay, lT, nt, w, sg, last); break;
    case 6: passes<6, 0, LF0, UR>(in, sr, si, lay, lT, nt, w, sg, last); break;
    case 7: passes<7, 0, LF0, UR>(in, sr, si, lay, lT, nt, w, sg, last); break;
    case 8: passes<8, 0, LF0, UR>(in, sr, si, lay, lT, nt, w, sg, last); break;
    case 9: passes<9, 0, LF0, UR>(in, sr, si, lay, lT, nt, w, sg, last); break;
    default: passes<10, 0, LF0, UR>(in, sr, si, lay, lT, nt, w, sg, last); break;
  }
}

// pad a row pitch so that 32 lanes over 2^lt rows (up to 32 of them,
// 32 / rows consecutive points each) hit 32 distinct banks
__host__ __device__ constexpr int pitch(int width, int lt) {
  return width + (lt >= 5 ? 1 : 32 >> lt);
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// cudaFuncSetAttribute once for each kernel, size and device: the largest
// dynamic shared memory already allowed is remembered
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes, int* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 16 && done[dev] >= (int)bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < 16) done[dev] = (int)bytes;
  return e;
}


// the same up to ln = 12
template <int LF0 = -1, bool UR = false, class In, class Lay, class Last>
__device__ __forceinline__ void fft_any12(int ln, const In& in, float* sr,
                                          float* si, const Lay& lay, int lT,
                                          int nt, const float2* w, float sg,
                                          const Last& last) {
  if (ln == 12)
    passes<12, 0, LF0, UR>(in, sr, si, lay, lT, nt, w, sg, last);
  else if (ln == 11)
    passes<11, 0, LF0, UR>(in, sr, si, lay, lT, nt, w, sg, last);
  else
    fft_any<LF0, UR>(ln, in, sr, si, lay, lT, nt, w, sg, last);
}

// -- the axis FFT over tiles ----------------------------------------------

constexpr int AXIS_TILE = 8192;       // points of a double-buffered tile
constexpr int AXIS_TILE_BIG = 16384;  // points of a single-buffered tile
constexpr int AXIS_TILE_MIN = 512;    // points of the smallest tile (a warp)
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may have
static_assert(AXIS_TILE_BIG == 1 << 14, "the launch checks take log2 14");

// `bytes` (4, 8 or 16) copied from device to shared memory with cp.async,
// of which the first `have` are read and the rest zero-filled
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes, int have) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(have));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(have));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(have));
#elif defined(CUDA_EMU)
  std::memcpy(dst, src, have);
  std::memset(static_cast<char*>(dst) + have, 0, bytes - have);
#endif
}

__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// The storage types: float, bf16 (raw unsigned short) and float16
// (cg::f16); the arithmetic is fp32 whatever the storage.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {
  return cg::bf16_to_f32(v);
}
__device__ __forceinline__ float widen(cg::f16 v) { return cg::widen_f16(v); }

template <class T>
__device__ __forceinline__ T narrow(float v) {
  if constexpr (std::is_same_v<T, cg::f16>)
    return cg::narrow_f16(v);
  else if constexpr (sizeof(T) == 2)
    return cg::f32_to_bf16(v);
  else
    return v;
}

// v rounded to the storage type T, kept as a float
template <class T>
__device__ __forceinline__ float round_to(float v) {
  return widen(narrow<T>(v));
}

template <class T>
struct Stored {
  using type = T;
};

// f(Stored<T>{}) for the storage type of `store`: 0 float, 1 bf16, 2 float16
template <class F>
auto by_store(int store, F f) {
  return store == 2   ? f(Stored<cg::f16>{})
         : store == 1 ? f(Stored<unsigned short>{})
                      : f(Stored<float>{});
}

// A tile as copied: rows of 2^lrow elements, transform t = row t, with the
// chunks of 2^lv elements of row t at chunk ^ (t & mask)
struct Swizzled {
  int lrow, lv, mask;
  __device__ __forceinline__ int at(int t, int i) const {
    return ((t << lrow) + i) ^ ((t & mask) << lv);
  }
};

// the first pass's read of the copied tile (fp32 or raw bf16)
template <class T, class Lay>
struct FromStage {
  const T* sr;
  const T* si;
  Lay lay;
  __device__ __forceinline__ float2 operator()(int t, int i) const {
    const int a = lay.at(t, i);
    return make_float2(widen(sr[a]), widen(si[a]));
  }
};

// the plane's W FFT's last pass: back to shared, rounded through the
// storage type T at a sub-fp32 transform's pass boundary
template <class Lay, class T>
struct ToWork {
  float* sr;
  float* si;
  Lay lay;
  template <int R>
  __device__ __forceinline__ void put(int t, int k0, int ns, float2* v) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = lay.at(t, k0 + r * ns);
      sr[a] = round_to<T>(v[r].x);
      si[a] = round_to<T>(v[r].y);
    }
  }
};

// the last pass: element k of transform t = (image o0 + (t >> lc), column
// c0 + (t mod 2^lc)) to (image * img + column) + k * 2^linner, scaled,
// images past `outer` skipped (a ragged last tile)
template <class T>
struct ToGlobal {
  T* outr;
  T* outi;
  long long o0, outer, img, c0;
  int lc, linner;
  float scale;
  template <int R>
  __device__ __forceinline__ void put(int t, int k0, int ns, float2* v) const {
    const long long o = o0 + (t >> lc);
    if (o >= outer) return;
    const long long base = o * img + c0 + (t & ((1 << lc) - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long a = base + ((long long)(k0 + r * ns) << linner);
      outr[a] = narrow<T>(v[r].x * scale);
      outi[a] = narrow<T>(v[r].y * scale);
    }
  }
};

// the last pass of a split's launch (Geo): TWIDDLE stores element k of
// transform t as ToGlobal does, multiplied by W_M^(k * (column >> ljr));
// REVERSED stores it at image o >> (lr1 + lr2), row ((k << lr2 | b) <<
// lr1) | a of that image's rows, where the low bits of o are (a, b), a of
// lr1 bits, img the stride of the split's images
template <class T, int MODE>
struct ToSplit {
  T* outr;
  T* outi;
  long long o0, outer, img, c0;
  int lc, linner;
  float scale;
  Levels tw;
  int ljr, lr1, lr2;
  template <int R>
  __device__ __forceinline__ void put(int t, int k0, int ns, float2* v) const {
    const long long o = o0 + (t >> lc);
    if (o >= outer) return;
    const long long col = c0 + (t & ((1 << lc) - 1));
    long long base = o * img + col;
    int lk = linner;
    if constexpr (MODE == REVERSED) {
      const int lr = lr1 + lr2;
      const long long lo = o & ((1LL << lr) - 1);
      const long long rev = ((lo & ((1LL << lr2) - 1)) << lr1) | (lo >> lr2);
      base = (o >> lr) * img + (rev << linner) + col;
      lk = linner + lr;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float2 x = v[r];
      if constexpr (MODE == TWIDDLE)
        x = cmul(x, tw((int)((long long)(k0 + r * ns) * (col >> ljr))));
      const long long a = base + ((long long)(k0 + r * ns) << lk);
      outr[a] = narrow<T>(x.x * scale);
      outi[a] = narrow<T>(x.y * scale);
    }
  }
};

// One launch: the view (outer, 2^ln, 2^linner) of the planes x -> out and
// its tiling, planned on the host.  A tile holds 2^lc adjacent inner
// columns (lc < linner: of one image) of 2^lg consecutive images (lc ==
// linner), 2^(ln + lc + lg) points; tile k is images (k >> (linner - lc))
// << lg, columns (k mod 2^(linner - lc)) << lc.  A plane launch has ln =
// log2 h, linner = lc = log2 w.  Each of the nbuf buffers holds two work
// planes of wf floats; p is the rows' (plane: the image rows') pitch.
struct Geo {
  const void* xr;
  const void* xi;
  void* outr;
  void* outi;
  const float2* tab;   // W_n^k, k < n (plane: the W axis')
  const float2* tab2;  // plane: the H axis' table
  long long outer, tiles;
  int ln, linner, lc, lg, nbuf, wf, p;
  float sg, scale;
  // the split routes (zero: a plain launch of dense images): the TWIDDLE
  // store's [lo | hi] table and its level shift, log2 of the inner extent
  // whose multiples are j2; the REVERSED store's digit widths (n1, n2)
  const float2* tlo;
  int tls, ljr, lr1, lr2;
  // elements between consecutive images of the input and output views
  long long img_in, img_out;
};


// log2 of the elements a chunk copies: up to 16 bytes of the tile's runs
template <class T>
__device__ __forceinline__ int chunk_log(const Geo& g) {
  const int run = g.lc < g.linner ? g.lc : g.ln + g.lc + g.lg;
  const int most = sizeof(T) == 2 ? 3 : 2;
  return run < most ? run : most;
}

// Issue the copies of tile k into (sr, si), as it lies in memory; rows of
// 2^lrow elements swizzled by `mask` (Swizzled).  Chunks past the last
// image read nothing and are zero-filled.
template <class T>
__device__ __forceinline__ void load_tile(const Geo& g, long long k, T* sr,
                                          T* si, int lv, int lrow,
                                          int mask) {
  const int cpi = g.linner - g.lc;
  const long long o0 = (k >> cpi) << g.lg;
  const long long c0 = (k & ((1LL << cpi) - 1)) << g.lc;
  const long long img = g.img_in ? g.img_in : 1LL << (g.ln + g.linner);
  const T* xr = static_cast<const T*>(g.xr);
  const T* xi = static_cast<const T*>(g.xi);
  const int bytes = (int)sizeof(T) << lv;
  const int chunks = 1 << (g.ln + g.lc + g.lg - lv);
  for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
    const int e = q << lv;
    long long src;
    int have = bytes;
    if (g.lc < g.linner) {  // runs of 2^lc columns, one a row of the image
      src = o0 * img + ((long long)(e >> g.lc) << g.linner) + c0 +
            (e & ((1 << g.lc) - 1));
    } else {                // whole images: one run
      src = o0 * img + e;
      const long long left = g.outer * img - src;
      if (left <= 0) {
        have = 0;
        src = 0;
      } else if (left < (1LL << lv)) {
        have = (int)left * (int)sizeof(T);
      }
    }
    const int s = e ^ (((e >> lrow) & mask) << lv);
    copy_async(sr + s, xr + src, bytes, have);
    copy_async(si + s, xi + src, bytes, have);
  }
}

// Walk the tiles of this block: tile k's copy into buffer b is load(k, b),
// its transform run(k, b).  With two buffers the next tile's copy is in
// flight while the current one is transformed; `run` ends with a barrier
// (every pass does), after which its buffer may be overwritten.
template <class Load, class Run>
__device__ __forceinline__ void walk_tiles(const Geo& g, const Load& load,
                                           const Run& run) {
  long long k = blockIdx.x;
  if (g.nbuf == 2 && k < g.tiles) {
    load(k, 0);
    copy_commit();
  }
  for (int it = 0; k < g.tiles; k += gridDim.x, ++it) {
    const int cur = g.nbuf == 2 ? it & 1 : 0;
    if (g.nbuf == 2) {
      if (k + gridDim.x < g.tiles) load(k + gridDim.x, cur ^ 1);
      copy_commit();
      copy_wait<1>();
    } else {
      load(k, 0);
      copy_commit();
      copy_wait<0>();
    }
    __syncthreads();
    run(k, cur);
  }
}

template <class T>
struct TileCopy {
  const Geo& g;
  float* smem;
  int lv, lrow, mask;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    T* sr = reinterpret_cast<T*>(smem + b * 2 * g.wf);
    load_tile<T>(g, k, sr, sr + (1 << (g.ln + g.lc + g.lg)), lv, lrow,
                 mask);
  }
};

template <class T>
__device__ __forceinline__ ToGlobal<T> to_global(const Geo& g, long long k) {
  const int cpi = g.linner - g.lc;
  return ToGlobal<T>{static_cast<T*>(g.outr), static_cast<T*>(g.outi),
                     (k >> cpi) << g.lg, g.outer, 1LL << (g.ln + g.linner),
                     (k & ((1LL << cpi) - 1)) << g.lc, g.lc, g.linner,
                     g.scale};
}

// a split launch's store (MODE TWIDDLE or REVERSED)
template <class T, int MODE>
__device__ __forceinline__ ToSplit<T, MODE> to_split(const Geo& g,
                                                     long long k) {
  const int cpi = g.linner - g.lc;
  const int lr = MODE == REVERSED ? g.lr1 + g.lr2 : 0;
  return ToSplit<T, MODE>{
      static_cast<T*>(g.outr), static_cast<T*>(g.outi), (k >> cpi) << g.lg,
      g.outer, g.img_out ? g.img_out : 1LL << (g.ln + g.linner + lr),
      (k & ((1LL << cpi) - 1)) << g.lc, g.lc, g.linner, g.scale,
      Levels{g.tlo, g.tlo + (1 << g.tls), g.tls}, g.ljr, g.lr1, g.lr2};
}

// the store of an axis launch of MODE
template <class T, int MODE>
__device__ __forceinline__ auto store_for(const Geo& g, long long k) {
  if constexpr (MODE == PLAIN)
    return to_global<T>(g, k);
  else
    return to_split<T, MODE>(g, k);
}

// A rows tile's transform, back in the work layout (rows of pitch p), to
// device memory: element e of the tile is row e >> ln, point e mod n, so
// each warp stores 128 contiguous bytes (the last pass's lanes take 8 or
// 32 rows at a time, which would scatter its stores over as many rows).
template <class T>
__device__ __forceinline__ void store_rows(const Geo& g, long long k,
                                           const float* wr,
                                           const float* wi) {
  T* outr = static_cast<T*>(g.outr);
  T* outi = static_cast<T*>(g.outi);
  const long long base = (k << g.lg) << g.ln;
  const long long left = (g.outer << g.ln) - base;
  const int points = 1 << (g.ln + g.lg);
  const int n = points < left ? points : (int)left;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int a = (e >> g.ln) * g.p + (e & ((1 << g.ln) - 1));
    outr[base + e] = narrow<T>(wr[a] * g.scale);
    outi[base + e] = narrow<T>(wi[a] * g.scale);
  }
  __syncthreads();
}

// the FFT of one tile of the rows (ROWS) or cols route, stored as MODE
// says (a REVERSED rows tile from registers, its rows' points scattered)
template <int LN, bool ROWS, class T, int MODE>
struct AxisRun {
  const Geo& g;
  float* smem;
  int lv, mask;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    float* wr = smem + b * 2 * g.wf;
    float* wi = wr + g.wf;
    const T* sr = reinterpret_cast<const T*>(wr);
    const T* si = sr + (1 << (LN + g.lc + g.lg));
    const int lT = g.lc + g.lg, nt = blockDim.x;
    if constexpr (ROWS && MODE == REVERSED) {
      const Rows rows{g.p};
      passes<LN, 0, 3, true>(
          FromStage<T, Swizzled>{sr, si, Swizzled{LN, lv, mask}}, wr, wi,
          rows, lT, nt, g.tab, g.sg, to_split<T, MODE>(g, k));
    } else if constexpr (ROWS) {
      const Rows rows{g.p};
      passes<LN, 0, 3, true>(
          FromStage<T, Swizzled>{sr, si, Swizzled{LN, lv, mask}}, wr, wi,
          rows, lT, nt, g.tab, g.sg, ToShared<Rows>{wr, wi, rows});
      store_rows<T>(g, k, wr, wi);
    } else {
      const Columns cols{g.lc, 1 << (LN + g.lc), 1 << g.lc};
      passes<LN, 0, -1, true>(FromStage<T, Columns>{sr, si, cols}, wr, wi,
                              cols, lT, nt, g.tab, g.sg,
                              store_for<T, MODE>(g, k));
    }
  }
};

// The axis FFT of length 2^LN over rows (ROWS, inner = 1) or columns.
template <int LN, bool ROWS, class T, int NT, int MODE>
__global__ void __launch_bounds__(NT, 1)
axis_fft(const __grid_constant__ Geo g) {
  extern __shared__ float smem[];
  const int lv = chunk_log<T>(g);
  const int mask = ROWS && LN - lv >= 3 ? 7 : 0;
  walk_tiles(g, TileCopy<T>{g, smem, lv, LN, mask},
             AxisRun<LN, ROWS, T, MODE>{g, smem, lv, mask});
}

// the FFT of one tile of whole (h, w) images: rows, then columns
template <class T>
struct PlaneRun {
  const Geo& g;
  float* smem;
  int lv, mask;
  __device__ __forceinline__ void operator()(long long k, int b) const {
    float* wr = smem + b * 2 * g.wf;
    float* wi = wr + g.wf;
    const T* sr = reinterpret_cast<const T*>(wr);
    const int lh = g.ln, lw = g.linner, nt = blockDim.x;
    const T* si = sr + (1 << (lh + lw + g.lg));
    const Rows rows{g.p};
    fft_any12<3, true>(
        lw, FromStage<T, Swizzled>{sr, si, Swizzled{lw, lv, mask}}, wr, wi,
        rows, g.lg + lh, nt, g.tab, g.sg,
        ToWork<Rows, T>{wr, wi, rows});
    const Columns cols{lw, g.p << lh, g.p};
    fft_any12<-1, true>(lh, FromShared<Columns>{wr, wi, cols}, wr, wi, cols,
                        g.lg + lw, nt, g.tab2, g.sg, to_global<T>(g, k));
  }
};

// The 2-D FFT of whole (h, w) images, h*w <= 16384.
template <class T>
__global__ void __launch_bounds__(1024, 1)
plane_fft(const __grid_constant__ Geo g) {
  extern __shared__ float smem[];
  const int lv = chunk_log<T>(g);
  const int mask = g.linner - lv >= 3 ? 7 : 0;
  walk_tiles(g, TileCopy<T>{g, smem, lv, g.linner, mask},
             PlaneRun<T>{g, smem, lv, mask});
}

using AxisLaunch = cudaError_t (*)(const Geo&, unsigned, int, size_t,
                                   cudaStream_t);

template <int LN, bool ROWS, class T, int NT, int MODE>
cudaError_t launch_axis(const Geo& g, unsigned blocks, int threads,
                        size_t smem, cudaStream_t st) {
  static int done[16];
  const cudaError_t e =
      allow_smem(axis_fft<LN, ROWS, T, NT, MODE>, smem, done);
  if (e != cudaSuccess) return e;
  axis_fft<LN, ROWS, T, NT, MODE><<<blocks, threads, smem, st>>>(g);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_plane(const Geo& g, unsigned blocks, int threads,
                         size_t smem, cudaStream_t st) {
  static int done[16];
  const cudaError_t e = allow_smem(plane_fft<T>, smem, done);
  if (e != cudaSuccess) return e;
  plane_fft<T><<<blocks, threads, smem, st>>>(g);
  return cudaGetLastError();
}

template <int MODE, bool ROWS, class T, int... L>
AxisLaunch axis_for(int ln, std::integer_sequence<int, L...>) {
  static const AxisLaunch fns[] = {launch_axis<L + 1, ROWS, T, 512, MODE>...};
  return fns[ln - 1];
}

// The kernel of a launch, null for none: rows of 2^1 .. 2^13 points (512
// threads) and 2^14 (1024); columns of 2^1 .. 2^12 (512) and 2^11 ..
// 2^12 (16384-point tiles, 1024), TWIDDLE columns to 2^14 (the four-step
// kernel's factors); no TWIDDLE rows (a split's first factor has columns).
template <class T, int MODE>
AxisLaunch pick_mode(int ln, bool rows, int threads) {
  if (rows) {
    if (MODE == TWIDDLE) return nullptr;
    if (threads > 512) return ln == 14 ? launch_axis<14, true, T, 1024, MODE>
                                       : nullptr;
    return ln <= 13 ? axis_for<MODE, true, T>(
                          ln, std::make_integer_sequence<int, 13>{})
                    : nullptr;
  }
  if (threads > 512) {  // 16384-point column tiles
    switch (ln) {
      case 11: return launch_axis<11, false, T, 1024, MODE>;
      case 12: return launch_axis<12, false, T, 1024, MODE>;
      case 13: return MODE == TWIDDLE ? launch_axis<13, false, T, 1024, MODE>
                                      : nullptr;
      case 14: return MODE == TWIDDLE ? launch_axis<14, false, T, 1024, MODE>
                                      : nullptr;
      default: return nullptr;
    }
  }
  return ln <= 12 ? axis_for<MODE, false, T>(
                        ln, std::make_integer_sequence<int, 12>{})
                  : nullptr;
}

template <class T>
AxisLaunch pick(int ln, bool rows, int threads, int mode) {
  return mode == TWIDDLE    ? pick_mode<T, TWIDDLE>(ln, rows, threads)
         : mode == REVERSED ? pick_mode<T, REVERSED>(ln, rows, threads)
                            : pick_mode<T, PLAIN>(ln, rows, threads);
}

// Floats a work plane of a tile: G rows of pitch p (rows), G images of h
// rows of pitch p (plane) or the tile itself (cols), rounded up to 32.
inline long long work_floats(int ln, int linner, int lc, int lg, bool plane,
                             int* p) {
  long long f;
  if (plane) {
    *p = pitch(1 << linner, lg + ln);
    f = (long long)*p << (lg + ln);
  } else if (linner == 0) {
    *p = pitch(1 << ln, lg);
    f = (long long)*p << lg;
  } else {
    *p = 0;
    f = 1LL << (ln + lc + lg);
  }
  return (f + 31) / 32 * 32;
}

}  // namespace

// One launch of the axis FFT (plane = 0) or of the plane FFT (plane = 1)
// on x -> out (which may be the same planes but for mode REVERSED), fp32,
// raw bf16 (store = 1) or raw float16 (store = 2), with the tiling the host
// planned (kernels/axis_fft.py): log2 of n, of the inner extent, of the columns
// and of the images a tile holds; `tab` the fp32 table W_n^k (plane: the W
// axis'; `tab2` the H axis') of the transform's sign, `scale` applied at
// the store, `blocks` the persistent grid.  `mode` PLAIN, TWIDDLE (`tw` the
// fp32 [lo | hi] table of level shift `tls`, j2 = column >> ljr) or
// REVERSED (digit widths lr1, lr2); img_in / img_out the images' strides
// (0: dense).  Returns cudaErrorInvalidValue for a tiling it does not
// take.  (A template, so that a source that includes this header and never
// calls it instantiates none of the kernels.)
template <int = 0>
cudaError_t axis_fft_launch(const void* xr, const void* xi, void* outr,
                            void* outi, const float* tab,
                            const float* tab2, long long outer, int ln,
                            int linner, int lc, int lg, int plane, int blocks,
                            int inverse, float scale, int store, int mode,
                            const float* tw, int tls, int ljr, int lr1,
                            int lr2, long long img_in, long long img_out,
                            cudaStream_t st) {
  const int lp = ln + lc + lg;
  const long long img = 1LL << (ln + linner);
  if (ln < 1 || ln > 14 || lc < 0 || lg < 0 || lc > linner || linner > 30 ||
      outer <= 0 || blocks <= 0 || lp > 14 || (1 << lp) < AXIS_TILE_MIN ||
      (lc < linner && lg != 0) || (plane && (lc != linner || ln + lc > 14 ||
                                             mode != PLAIN)) ||
      mode < PLAIN || mode > REVERSED ||
      (mode == TWIDDLE && (tw == nullptr || tls < 0 || tls > 20 ||
                           ljr < 0 || ljr > linner)) ||
      (mode == REVERSED && (lr1 < 0 || lr2 < 0 || lr1 + lr2 > 30 ||
                            xr == outr || xi == outi)) ||
      (img_in != 0 && (img_in < img || (lg != 0 && img_in != img))) ||
      (img_out != 0 && (img_out < img || mode == PLAIN)))
    return cudaErrorInvalidValue;
  int p;
  const long long wf = work_floats(ln, linner, lc, lg, plane != 0, &p);
  const int nbuf = (1 << lp) <= AXIS_TILE ? 2 : 1;
  const size_t smem = (size_t)nbuf * 2 * sizeof(float) * wf;
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  const long long per = (outer + (1LL << lg) - 1) >> lg;
  Geo g{xr, xi, outr, outi, (const float2*)tab, (const float2*)tab2, outer,
        per << (linner - lc), ln, linner, lc, lg, nbuf, (int)wf, p,
        inverse ? 1.f : -1.f, scale, (const float2*)tw, tls, ljr, lr1, lr2,
        img_in, img_out};
  const int threads = 1 << (lp - 4);
  const unsigned grid = (unsigned)(g.tiles < blocks ? g.tiles : blocks);
  if (plane)
    return by_store(store, [&](auto t) {
      return launch_plane<typename decltype(t)::type>(g, grid, threads, smem,
                                                      st);
    });
  const bool rows = linner == 0;
  const AxisLaunch fn = by_store(store, [&](auto t) {
    return pick<typename decltype(t)::type>(ln, rows, threads, mode);
  });
  if (fn == nullptr) return cudaErrorInvalidValue;
  return fn(g, grid, threads, smem, st);
}
