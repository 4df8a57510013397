"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version (counterpart of :mod:`repro.kernels`).

fft_stockham — mixed radix-4/2 and pure radix-2 Stockham FFTs, stages
               fused in registers (one launch up to 2^14 points, two up
               to 2^24; radix 4 a launch a stage above)
fft_fourstep — Bailey four-step FFT with shared-memory radix-16 sub-FFTs
               (one launch up to 2^14 points, two above)
fft2d_gemm   — 2-D FFT as shared-memory FFT passes (plain bf16: four-step
               GEMM row and column passes)
axis_fft     — the 2-D and 3-D kernels' launch plan and twiddle tables
rfft2d_fused — real-input 2-D FFT and its inverse (packed row pairs,
               Hermitian untangle, half-width column pass), plus the
               four-step helpers shared with fft2d_gemm
fftconv_fused — one-pass spectral convolution (packed filter pair E/F)
fft3d_fused  — 3-D FFT as shared-memory FFT passes along W, H and D
               (plain bf16: four-step GEMM passes)
fft2d_fused  — fused Stockham 2-D FFT, the ``fused_stockham`` oracle
fft_stage    — the paper's per-stage radix-2 "Initial" FFT (Table 1
               baseline), one launch a butterfly stage, the bit-reverse
               folded into stage 0
decode_attention — one-token GQA flash-decode attention over a
               position-masked KV cache (splits merged in a second launch)
ops          — dispatch wrappers and the per-kernel launch counters
_build       — nvcc build of ``csrc/*.cu`` into ctypes-loaded libraries
"""
