"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version (counterpart of :mod:`repro.kernels`).

fft_stockham — per-stage radix-4/radix-2 Stockham autosort FFT
fft_fourstep — Bailey four-step FFT as two tiled complex GEMMs
fft2d_gemm   — 2-D FFT as four-step GEMM row and column passes
rfft2d_fused — (this slice) the shared four-step helpers only
ops          — dispatch wrappers and the per-kernel launch counters
_build       — nvcc build of ``csrc/*.cu`` into ctypes-loaded libraries
"""
