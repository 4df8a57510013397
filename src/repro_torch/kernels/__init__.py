"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version (counterpart of :mod:`repro.kernels`).

fft_stockham — per-stage mixed radix-4/2 and pure radix-2 Stockham FFTs
fft_fourstep — Bailey four-step FFT as two tiled complex GEMMs
fft2d_gemm   — 2-D FFT as four-step GEMM row and column passes
rfft2d_fused — real-input 2-D FFT and its inverse (packed row pairs,
               Hermitian untangle, half-width column pass), plus the
               four-step helpers shared with fft2d_gemm
ops          — dispatch wrappers and the per-kernel launch counters
_build       — nvcc build of ``csrc/*.cu`` into ctypes-loaded libraries
"""
