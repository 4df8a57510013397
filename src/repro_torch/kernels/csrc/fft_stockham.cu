// Mixed radix-4 / radix-2 Stockham autosort FFT on (batch, n) split fp32,
// bf16 or float16 planes (widened at the load, fp32 in registers and shared
// memory, rounded at the store), n a power of two >= 2, and its pure
// radix-2 twin.
//
// Replaces the Pallas kernels repro/kernels/fft_stockham.py::_stockham_kernel
// (radix=4; stage arithmetic repro_torch/core/fft1d.py::stockham_stages)
// and ::_stockham_kernel_r2 (radix=2; fft1d.py::stockham_radix2_stages).
// The TPU kernel keeps a whole row in VMEM for all stages.
//
// Both radices run the reference's butterflies in its stage order (radix
// 4: radix-4 stages, then a radix-2 tail of twiddle 1 for odd log2 n;
// radix 2: a + b and (a - b) * w), up to four bits of stages a pass in
// registers (16 points a thread) between shared-memory barriers, over
// tiles copied in with cp.async (axis_fft.cuh's tile walk), so a launch is
// one pass over HBM:
//   n <= 2^14  ONE launch: a tile holds G whole rows and runs every stage;
//   above      TWO launches (n <= 2^24).  With n = M * Q, M = 2^l1: stages
//              of bits 0..l1-1 act on the M points {q + r*Q} of each
//              column q of the (M, Q) view, and launch A runs them on tiles
//              of C adjacent columns, writing each point back where its
//              column lies (x -> scratch); the other stages act on each
//              stride-M subset {k + t*M} of their output, and are exactly
//              the length-Q Stockham there, so launch B runs them on rows k
//              of the scratch (G rows a tile) and stores row k's point t at
//              t*M + k of out, C-wide segments.  Radix 2 splits at
//              l1 = ceil(log2 n / 2); radix 4 at an even l1, so that launch
//              A holds whole radix-4 stages (the tail runs in launch B):
//              2 * floor((log2 n + 1) / 4), 12 from 2^22
//              (kernels/fft_stockham.py::split).
//   past 2^24 THREE launches (n <= 2^36).  Launch B's length-Q Stockham
//              splits again, Q = M2 * Q3, M2 = 2^l2: launch 1 is launch A
//              on the (M1, M2*Q3) view (x -> out); launch 2 (ST_MID) runs
//              the stages of bits l1..l1+l2-1 on tiles of C columns of the
//              (M1 images, M2, Q3) view of that, image k1 a launch A of
//              its own (twiddles at bit s + l1), storing point t of
//              (k1, q) at row t*M1 + k1 (out -> scratch); launch 3 is
//              launch B after l1 + l2 bits, on rows of Q3, row k2*M1 + k1's
//              point t stored at t*M1*M2 + k2*M1 + k1 (scratch -> out).
//              Columns of at most 2^11 points (radix 4: 2^10; C >= 8),
//              rows of at most 2^14, radix 4's launches 1 and 2 whole
//              radix-4 stages (kernels/fft_stockham.py::split3; radix 4 at
//              2^35 and 2^36 takes 4096-point columns in launch 1).
//              Launch 1 also reads nearly all of the table (its first
//              stages' twiddles), about as many bytes as the transform.
// Passes start at bit 0 and take four bits each, so a pass boundary is a
// radix-4 stage boundary and a pass is two radix-4 stages (or one, and the
// tail, at its end).  The stages, passes, layouts and twiddles live in
// stockham.cuh, which fft2d_fused.cu shares.
// One table a radix.  Radix 2: W_n^m for m < n/2; stage s's twiddle at
// butterfly j is row s of the packed (stages, n/2) table, which is entry
// (j >> s) << s of row 0 bit for bit (the float64 angles are equal).
// Radix 4: row 0 of the packed (s4, 3, n/4) table, w, w^2 and w^3 as three
// rows of n/4; radix-4 stage s reads entry (j >> 2s) << 2s of each, bit for
// bit row s of the packed table: 25 MB a direction at 2^22 against 277.
// Bound by bytes: 16 a point in and out a launch, ~4.25 flops a point a
// radix-2 bit.  The inverse's 1/n is applied at the last store.
#include "stockham.cuh"

// One launch of the fused kernel x -> out over (outer, 2^ln, 2^linner)
// with the tiling the host planned (kernels/fft_stockham.py::plan):
// ST_ROWS (linner = 0; G = 2^lg rows a tile; every stage), ST_COLS (launch
// A or 1: tiles of 2^lc of the 2^linner columns, stages of bits 0..ln-1 of
// length n = 2^(ln + linner)), ST_TRANSPOSED (launch B or 3: rows of 2^ln,
// stages of bits l1.. of n = 2^(l1 + ln), out[image][m][row mod 2^l1]) or
// ST_MID (launch 2: stages of bits l1..l1+ln-1 of n = 2^(l1+ln+linner) on
// tiles of 2^lc columns or 2^lg whole images of the (outer, 2^ln,
// 2^linner) view, x != out);
// `scale` at the store; `blocks` the persistent grid; raw bf16 planes for
// store = 1, raw float16 for store = 2.  Returns cudaErrorInvalidValue for
// a tiling it does not take.
// Radix 2: `tab` the fp32 W_n^m, m < n/2, of the transform's sign as
// (cos, sin) pairs.
extern "C" int fft_stockham_r2_pass(const void* xr, const void* xi,
                                    void* outr, void* outi,
                                    const float* tab, long long outer, int ln,
                                    int linner, int lc, int lg, int route,
                                    int l1, int blocks, float scale, int store,
                                    void* stream) {
  return stockham_pass<2>(xr, xi, outr, outi, tab, outer, ln, linner,
                                lc, lg, route, l1, 0, blocks, scale, -1.f,
                                store, (cudaStream_t)stream);
}

// Radix 4 (l1 even, so launches A, 1 and 2 hold whole radix-4 stages):
// `tab` the fp32 (3, n/4) table w, w^2, w^3 of the transform's sign
// (`inverse`) as (cos, sin) pairs.
extern "C" int fft_stockham_r4_pass(const void* xr, const void* xi,
                                    void* outr, void* outi,
                                    const float* tab, long long outer, int ln,
                                    int linner, int lc, int lg, int route,
                                    int l1, int blocks, float scale,
                                    int inverse, int store, void* stream) {
  return stockham_pass<4>(xr, xi, outr, outi, tab, outer, ln, linner,
                                lc, lg, route, l1, 0, blocks, scale,
                                inverse ? 1.f : -1.f, store,
                                (cudaStream_t)stream);
}
