"""repro_torch.core — split-complex FFTs in PyTorch (counterpart of
:mod:`repro.core`).

Public API of this slice:
  SplitComplex, from_complex, to_complex, from_real, from_numpy
  fft, ifft, rfft, irfft, fft_axis, fft2, fft3, rfft2, irfft2
  fft_conv, circular_conv, fourier_mix
  plan_fft, plan_ifft, plan_fft2, plan_ifft2, FFTPlan, get_plan
  autotune_count, save_wisdom, load_wisdom, warm, WarmResult
"""
from .complexmath import (SplitComplex, from_complex, to_complex, from_real,
                          from_numpy, add, sub, mul, conj, scale)
from .fft1d import (fft, ifft, rfft, irfft, fft_axis, dft_naive,
                    fft_cooley_tukey, fft_stockham, fft_stockham_radix2,
                    fft_four_step, fft_bluestein, resolve_algo)
from .fft2d import fft2, fft3, rfft2, irfft2
from .fftconv import fft_conv, circular_conv
from .spectral import fourier_mix
from .plan import (FFTPlan, plan_fft, plan_ifft, plan_fft2, plan_ifft2,
                   get_plan, clear_plan_cache, autotune_count,
                   plan_cache_size, save_wisdom, load_wisdom, warm,
                   WarmResult, plan_from_reference)
