"""Split-complex arithmetic on (re, im) pairs of real tensors.

Counterpart of :mod:`repro.core.complexmath`.  Every kernel consumes
separate real and imaginary planes, so the port keeps them split instead of
using ``torch.complex64``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

import repro_torch


class SplitComplex(NamedTuple):
    """A complex tensor stored as two same-shape real tensors."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return tuple(self.re.shape)

    @property
    def dtype(self):
        return self.re.dtype

    @property
    def device(self):
        return self.re.device


def from_numpy(z, *, device="cuda", dtype=torch.float32) -> SplitComplex:
    """Split a numpy (complex or real) array onto ``device``."""
    dev = repro_torch.device(device)
    z = np.asarray(z)
    re = np.ascontiguousarray(z.real)
    im = np.ascontiguousarray(z.imag) if np.iscomplexobj(z) \
        else np.zeros_like(re)
    return SplitComplex(torch.from_numpy(re).to(dev, dtype),
                        torch.from_numpy(im).to(dev, dtype))


def from_complex(z: torch.Tensor) -> SplitComplex:
    """Split a complex tensor (on its own device) into planes."""
    return SplitComplex(z.real.contiguous(), z.imag.contiguous())


def from_real(x: torch.Tensor) -> SplitComplex:
    """A real tensor as split complex with a zero imaginary plane."""
    return SplitComplex(x, torch.zeros_like(x))


def to_complex(z: SplitComplex) -> torch.Tensor:
    return torch.complex(z.re, z.im)


def add(a: SplitComplex, b: SplitComplex) -> SplitComplex:
    return SplitComplex(a.re + b.re, a.im + b.im)


def sub(a: SplitComplex, b: SplitComplex) -> SplitComplex:
    return SplitComplex(a.re - b.re, a.im - b.im)


def mul(a: SplitComplex, b: SplitComplex) -> SplitComplex:
    """4-multiply complex product."""
    return SplitComplex(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def conj(a: SplitComplex) -> SplitComplex:
    return SplitComplex(a.re, -a.im)


def scale(a: SplitComplex, s) -> SplitComplex:
    return SplitComplex(a.re * s, a.im * s)
