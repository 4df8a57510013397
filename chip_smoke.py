#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
kernel against its plain PyTorch version at the main path's shapes, drives
the two main paths through the plan registry and checks them against
float64 numpy:

- complex: ``repro_torch.core.fft2(x, backend="cuda")`` at 1024x1024 fp32,
  its ``algo="row_col"`` Stockham baseline, and the 1-D plans at n = 2^20
  and 2^22;
- real input: ``rfft2``/``irfft2`` on 1024x1024 fp32 images (and an
  ``s=`` truncation), ``rfft``/``irfft`` at n = 2^21 and 2^23, the
  radix-2 Stockham kernel through ``algo="stockham2"``;
- spectral convolution: ``fft_conv`` on the ``ssm_demo`` conv branch
  (x (8, 576, 4096), a (1, 576, 4) filter bank: padded FFT length 8192),
  its gradient, the filter-spectrum cache, ``circular_conv`` on table 11's
  64-row bank at m = 1024, 4096 and 16384 (and a demoted m = 768), and
  ``fourier_mix`` at (8, 4096, 512);
- volumes: ``fft3`` at 256^3 x 2 (a DNS / particle-mesh slab) and
  128^3 x 8 (a PME grid) in fp32, its ``algo="row_col"`` Stockham
  baseline, a demoted (96, 128, 128), and 256^3 x 2 in bf16 (compensated);
- bf16 images: ``fft2`` on 16 1024^2 bf16 images, compensated through the
  registry and plain by explicit variant;
- the paper's Table 1 ladder: ``ops.fft_staged`` (the per-stage "Initial"
  kernel) forward and inverse at Table 1's 8 x 16384 and at 512 x 16384,
  beside the port's other rungs (two- and one-reorder Cooley-Tukey, the
  Stockham kernel, ``fft(algo="auto")`` and the cuda backend's plan);
- decode attention: ``ops.decode_attention`` for one decode step of one
  layer at full width, bf16 caches: starcoder2-15b (16 sequences of up to
  32768 tokens, GQA 48/4, D 128) and h2o-danube-1.8b (128 sequences on its
  4096-slot ring cache, window 4096, GQA 32/8, D 80), and in fp32 against
  float64 numpy;

- serving: a threaded, pre-warmed ``SpectralServer`` on the card with
  buckets for 16 1024^2 complex, real and inverse-real images and 4
  2^20-point transforms, a seeded closed loop of 96 requests (1000^2 ones
  padded up), every spectrum against float64 numpy; one bucket tuned, its
  wisdom saved and loaded back (no second measurement); the same buckets
  behind a ``serve.prewarm`` fault, degraded to their torch twins;
- resilience: the guarded executor at 16 1024^2 images under an output
  fault and a launch fault, the circuit breaker's walk, and the guard's
  cost against the raw execution, there and at every entry-point path's
  main shape (rfft2, fft3, the SSM conv and its gradient, table 11's
  conv banks);
- distributed (``dist_path``): 4 ranks of one process group
  (``repro_torch.dist.local.LocalGroup``: NCCL with a card a rank where
  the host has 4 cards, else gloo on the shared card), the pencil FFTs on
  the 1-D kernels: ``pfft2`` at 8192^2 (chunks, both layouts and the
  roundtrip, the three wire formats, ``verify=True`` under wire faults),
  ``prfft2``/``pirfft2``, the two-hop hierarchy, ``pfft3`` at 512^3 on a
  (2, 2) mesh (every pass four-step), ``pfft1d`` at 2^26, ``pfft2`` at (16, 2^21) (rows on
  ``fft_stockham``), and ``pipelined_apply`` over 4 stages; each block
  against float64 numpy, each compressed wire also against float64 numpy
  with the wire's rounding applied, each exchange's logged bytes against
  ``exchange_bytes``; then one ``pfft2`` at 16384^2 over every card on
  NCCL (``dist_nccl``);
- the cost model (``tt_path``): ``get_plan(tune=True, prune="model")`` on
  the main path's key beside the unpruned tune, ``trace_dist``'s exchange
  bytes against the wire log, and the model's predictions for the main
  path's keys (the reference's wormhole_n300, not this card);

and times every kernel beside its plain version, ``torch.fft`` and its
bound.  Every plan call runs through the guarded executor, and no
earlier phase may have fallen back.  Each phase prints one JSON line; the
last line is the device record.  Exits non-zero, with no device record,
when CUDA is missing, a kernel fails to build or launch, or any check fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TOL_2D = 1e-5           # kernel vs plain, error / max|plain|
TOL_1D = 5e-5
TOL_NUMPY = 1e-5        # fft2 vs float64 numpy, error / max|ref|
TOL_ROUNDTRIP = 1e-4
TOL_3D_NUMPY = 1e-6     # fft3 vs float64 numpy, relative norm (reference)
TOL_BF16_NUMPY = 5e-3   # bf16 compensated vs float64 numpy, relative norm
# bf16 kernel vs plain, error / max|plain|: both round the same fp32 sums
# to bf16, so they differ by rounding ties, one bf16 ulp at the top
TOL_BF16 = 2.0 ** -7

# the main path's shapes: the paper's 1024x1024 complex fp32 images in a
# batch of 16 (and 1), and the 1-D plans on either side of 2^20
MAIN_2D = (16, 1024, 1024)
MAIN_2D_SINGLE = (1, 1024, 1024)
MAIN_FOURSTEP = (4, 1 << 20)
MAIN_STOCKHAM = (2, 1 << 22)
# (kernel, shape) pairs held against the plain version, forward and inverse
CHECKS = [("fft2d_gemm", MAIN_2D), ("fft2d_gemm", (2, 8, 4)),
          ("fft2d_fused", MAIN_2D), ("fft2d_fused", (2, 8, 16)),
          ("fft2d_fused", (1, 64, 32)), ("fft2d_fused", (1, 256, 256)),
          ("fft2d_fused", (3, 2, 4096)), ("fft2d_fused", (1, 4096, 2048)),
          ("fft2d_gemm", (3, 256, 512)), ("fft2d_gemm", (1, 4096, 2048)),
          ("fft_fourstep", (64, 4096)), ("fft_fourstep", MAIN_FOURSTEP),
          ("fft_stockham", MAIN_STOCKHAM), ("fft_stockham", (64, 1024)),
          ("fft_stockham", (3, 2)), ("fft_stockham", (5, 8))]
# the four-step kernel's routes: its smallest default split (16, 32), the
# one-launch boundary 2^14 and the first two-launch size 2^15, an unequal
# split (512, 1024) and a batch that no row block divides
CHECKS += [("fft_fourstep", (3, 512)), ("fft_fourstep", (3, 1 << 14)),
           ("fft_fourstep", (3, 1 << 15)), ("fft_fourstep", (2, 1 << 19)),
           ("fft_fourstep", (3, 1 << 20))]
DEMOTED_2D = (1, 1000, 1000)
C2C_KERNELS = ("fft2d_gemm", "fft_fourstep", "fft_stockham", "fft2d_fused")

# the real-input path's shapes: the paper's 1024x1024 images as real fp32
# (batch 16 and 1), the 1-D rfft whose inner transform is four-step
# (n/2 = 2^20) or Stockham (n/2 = 2^22), and the radix-2 Stockham kernel
# at 2^20 (its plain version's packed float64 host table is 738 MB a
# direction at 2^22)
MAIN_RFFT2 = (16, 1024, 1024)
MAIN_RFFT2_SINGLE = (1, 1024, 1024)
IRFFT2_S = (1024, 512)
MAIN_RFFT_FOURSTEP = (4, 1 << 21)
MAIN_RFFT_STOCKHAM = (2, 1 << 23)
MAIN_R2 = (2, 1 << 20)
CHECKS += [("rfft2d_fused", MAIN_RFFT2), ("rfft2d_fused", (2, 2, 2)),
           ("rfft2d_fused", (3, 8, 4)), ("rfft2d_fused", (2, 4, 8)),
           ("rfft2d_fused", (3, 256, 512)), ("rfft2d_fused", (1, 4096, 2048)),
           ("fft_stockham_r2", MAIN_R2), ("fft_stockham_r2", (3, 2)),
           ("fft_stockham_r2", (5, 8))]
# the radix-2 kernel's routes: one launch up to 2^14 (2^13 the largest with
# two buffers a block, 2^14 with one), two from 2^15, an odd log2 n (2^17:
# 512-point columns, then 256-point rows), a batch that no row tile divides
# (7 rows of 512, 16 a tile); the real-input forward at h != w with a
# ragged last column tile (33 columns in tiles of 16; 129 in tiles of 8,
# 2048-point columns); the inverse's column pass reads those shapes' half
# spectra at their odd pitch
CHECKS += [("fft_stockham_r2", (3, 1 << 13)), ("fft_stockham_r2", (3, 1 << 14)),
           ("fft_stockham_r2", (3, 1 << 15)), ("fft_stockham_r2", (2, 1 << 17)),
           ("fft_stockham_r2", (7, 512)), ("rfft2d_fused", (2, 512, 64)),
           ("rfft2d_fused", (3, 2048, 256))]
# the inner transforms the real-input window runs at shapes of their own:
# irfft's full-length inverse at 2^21 and 2^23 on the radix-4 kernel, and
# rfft2/irfft2(algo="stockham2") at 1024^2 on the radix-2 kernel (rows of
# 512 packed points, 513 columns of 1024, inverse rows of 1024)
CHECKS += [("fft_stockham", MAIN_RFFT_FOURSTEP),
           ("fft_stockham", MAIN_RFFT_STOCKHAM),
           ("fft_stockham_r2", (MAIN_RFFT2[1], MAIN_RFFT2[2] // 2)),
           ("fft_stockham_r2", (MAIN_RFFT2[2] // 2 + 1, MAIN_RFFT2[1])),
           ("fft_stockham_r2", (MAIN_RFFT2[1], MAIN_RFFT2[2]))]
# the radix-4 kernel's routes: one launch up to 2^14, two from 2^15 (an odd
# log2 n at 2^15 and 2^17: the radix-2 tail in launch B), 2^24 the largest
# of two; above, a launch a stage, held against float64 numpy at
# STOCKHAM_STAGES (its plain version's packed float64 host table would be
# 4.8 GB)
CHECKS += [("fft_stockham", (3, 1 << 14)), ("fft_stockham", (3, 1 << 15)),
           ("fft_stockham", (2, 1 << 17)), ("fft_stockham", (2, 1 << 24))]
STOCKHAM_STAGES = (1, 1 << 25)
REAL_KERNELS = ("rfft2d_fused", "irfft2d_fused", "fft_stockham_r2",
                "fft_fourstep", "fft_stockham")
MAIN_SHAPE = {"fft2d_gemm": MAIN_2D, "fft_fourstep": MAIN_FOURSTEP,
              "fft2d_fused": MAIN_2D,
              "fft_stockham": MAIN_STOCKHAM, "rfft2d_fused": MAIN_RFFT2,
              "irfft2d_fused": MAIN_RFFT2, "fft_stockham_r2": MAIN_R2}

# the spectral-convolution path's shapes: the ssm_demo conv branch
# (channels d_inner + 2*ssm_state = 576, filter length ssm_conv = 4,
# sequence 4096 padded to m = 8192, batch 8) and table 11's 64-row bank of
# 129-tap filters at m = 1024, 4096, 16384 (batch 1)
SSM_X = (8, 576, 4096)
SSM_K = (1, 576, 4)
SSM_GRAD_X = (2, 576, 4096)
TABLE11_ROWS, TABLE11_TAPS = 64, 129
TABLE11_M = (1024, 4096, 16384)
DEMOTED_CONV_M = 768
FNET_X = (8, 4096, 512)          # fnet_demo: d_model 512, a 4096 sequence
MAIN_CONV = (8, 576, 8192)       # what fft_conv hands the kernel
TOL_CONV = 1e-5                  # conv kernel vs plain, error / max|plain|
TOL_CONV_NUMPY = 2e-6            # relative norm vs float64 numpy
TOL_GRAD = 1e-4
# (x shape, filter bank lead) held against the plain version: the one-pass
# kernel at every length class it takes (shared banks, odd row counts,
# several rows a block), per-batch banks, and the multi-launch schedule
CONV_CHECKS = [((2, 3, 4), (3,)), ((2, 3, 8), (3,)), ((2, 3, 64), (3,)),
               ((2, 64, 1024), (64,)), (MAIN_CONV, MAIN_CONV[1:2]),
               ((2, 5, 16384), (5,)), ((3, 5, 512), (3, 5)),
               ((2, 3, 4096), (2, 3)), ((1, 3, 32768), (3,)),
               ((2, 2, 1 << 20), (2, 2)), ((1, 2, 1 << 22), (2,))]
# the shapes the conv window hands the kernel: table 11's bank at batch 1
# and the gradient run's padded (2, 576, 8192)
CONV_CHECKS += [((1, TABLE11_ROWS, m), (TABLE11_ROWS,)) for m in TABLE11_M]
CONV_CHECKS += [((SSM_GRAD_X[0],) + MAIN_CONV[1:], MAIN_CONV[1:2])]
# fourier_mix's axis transforms on the four-step kernel: 8*4096 rows of
# 512 (d_model) and 8*512 rows of 4096 (seq)
CHECKS += [("fft_fourstep", (FNET_X[0] * FNET_X[1], FNET_X[2])),
           ("fft_fourstep", (FNET_X[0] * FNET_X[2], FNET_X[1]))]
CONV_KERNELS = ("fftconv_fused", "fft_fourstep")

# the volume path's shapes: the 3-D grids users run on one card, a DNS
# turbulence or particle-mesh slab at 256^3 (batch 2: every axis four-step,
# split (16, 16)) and a PME electrostatics grid at 128^3 (batch 8: every
# axis one dense 128-point DFT); a non-cube with a dense D axis, a (16, 16)
# H axis and an unequal (16, 32) W axis; a shape that demotes
MAIN_3D = (2, 256, 256, 256)
PME_3D = (8, 128, 128, 128)
ODD_3D = (2, 64, 256, 512)
DEMOTED_3D = (1, 96, 128, 128)
CHECKS += [("fft3d_fused", MAIN_3D), ("fft3d_fused", PME_3D),
           ("fft3d_fused", ODD_3D), ("fft3d_fused", (1, 4, 8, 16)),
           ("fft3d_fused", (2, 2, 4, 256)), ("fft3d_fused", (1, 256, 4, 4)),
           ("fft3d_fused", (2, 8, 8, 8)),
           # the rows fft3(algo="row_col") hands the Stockham kernel
           ("fft_stockham", (MAIN_3D[0] * MAIN_3D[1] * MAIN_3D[2],
                             MAIN_3D[3]))]
# the 2-D and 3-D kernels' route boundaries (kernels/axis_fft.py): one
# plane launch at h*w = 2^14, rows then columns at 2^15, columns of C = 4
# at h = 4096 (w = 8), a 128^3 volume on the plane route, a D pass over
# whole images (h*w = 4 < 8 columns), and the PME grid's three-launch route
# ("fft3d_three": W, H, D, the route the plane launch replaces there)
CHECKS += [("fft2d_gemm", (2, 128, 128)), ("fft2d_gemm", (2, 256, 128)),
           ("fft2d_gemm", (2, 4096, 8)), ("fft3d_fused", (1, 128, 128, 128)),
           ("fft3d_fused", (1, 256, 2, 2)), ("fft3d_three", PME_3D),
           ("fft3d_three", (1, 128, 128, 128))]
# (kernel, shape, variant) in bf16: the bf16 window's images and the
# volume window's bf16 slab, and small shapes
BF16_CHECKS = [("fft2d_gemm", MAIN_2D, "compensated"),
               ("fft2d_gemm", MAIN_2D, "plain"),
               ("fft2d_gemm", (2, 8, 4), "compensated"),
               ("fft2d_gemm", (2, 8, 4), "plain"),
               ("fft3d_fused", MAIN_3D, "compensated"),
               ("fft3d_fused", ODD_3D, "compensated"),
               ("fft3d_fused", ODD_3D, "plain"),
               ("fft3d_fused", (1, 4, 8, 16), "plain")]
# bf16 compensated on each route: a plane launch (2-D, and 3-D with D),
# rows and columns (the bf16 window's MAIN_2D), three launches (MAIN_3D)
BF16_CHECKS += [("fft2d_gemm", (2, 128, 128), "compensated"),
                ("fft3d_fused", (1, 128, 128, 128), "compensated"),
                ("fft3d_three", (1, 128, 128, 128), "compensated")]
# the CPU tests' bf16 shapes (tests/test_torch_gemm_bf16.py), both variants
BF16_CHECKS += [(k, shape, v) for k, shape in
                [("fft2d_gemm", (1, 64, 64)), ("fft2d_gemm", (1, 256, 256)),
                 ("fft3d_fused", (1, 32, 32, 32))]
                for v in ("compensated", "plain")]
VOLUME_KERNELS = ("fft3d_fused", "fft_stockham")
MAIN_SHAPE["fft3d_fused"] = MAIN_3D
MAIN_SHAPE["fft3d_three"] = PME_3D

# the Table 1 path's shapes: the paper's 16384-point FFT at the batch of
# benchmarks/table1_fft_variants.py (BATCH, N) and at a batch that loads the
# card (512 rows: 134 MB in and out); the stage kernel against its plain
# version there and at n = 16, 256, 2048, 16384
TABLE1 = (8, 16384)
TABLE1_LOADED = (512, 16384)
CHECKS += [("fft_staged", (4, n)) for n in (16, 256, 2048, 16384)]
CHECKS += [("fft_staged", TABLE1), ("fft_staged", TABLE1_LOADED),
           ("fft_staged", (2, 1 << 16))]
MAIN_SHAPE["fft_staged"] = TABLE1_LOADED
TABLE1_KERNELS = ("fft_staged", "fft_stockham", "fft_fourstep")

# the long-axis routes: 2-D images and 3-D volumes with an axis past 4096
# (kernels/axis_fft.py::plan_split, the fused Stockham kernel's split
# launches, the real-input kernels' split steps), held against float64
# numpy through the entry points and against the plain versions; one timed
# 8192^2 image; the four-step kernel's factors past 1024
# (fft_fourstep.axis_plan) and radix 2 past 2^24 (a launch a stage)
LONG_2D = [(2, 2, 8192), (2, 8192, 4), (1, 2, 16384)]
LONG_3D = [(1, 2, 2, 8192), (1, 8192, 2, 4)]
LONG_TIMED = (1, 8192, 8192)
CHECKS += [(k, shape) for shape in LONG_2D
           for k in ("fft2d_gemm", "fft2d_fused", "rfft2d_fused")]
CHECKS += [("fft3d_fused", shape) for shape in LONG_3D]
# (shape, n1 or None for the plan's split, how it is reached)
FOURSTEP_FACTORS = [((1, 1 << 21), None, "plan"), ((2, 1 << 22), None, "plan"),
                    ((3, 4096), 2, "ops"), ((3, 1 << 15), 2, "ops"),
                    ((3, 1 << 14), 1 << 14, "ops")]
R2_STAGES = (1, 1 << 25)
LONG_KERNELS = ("fft2d_gemm", "fft2d_fused", "rfft2d_fused",
                "irfft2d_fused", "fft3d_fused", "fft_fourstep",
                "fft_stockham_r2")
# bf16 planes on the kernels that took float32 only: each kernel's own
# small shape and its path's main shape, against float64 numpy of the
# bf16-rounded input, within the reference's bf16 bound (6e-2 of max|X|,
# tests/test_kernels.py) and within the plain version's own error (same
# call) plus 2^-7 of max|X|
TOL_BF16_REF = 6e-2
BF16_SLACK = 2.0 ** -7
BF16_F4 = [("fft_stockham", (4, 256)), ("fft_stockham", MAIN_STOCKHAM),
           ("fft_stockham_r2", (4, 256)), ("fft_stockham_r2", MAIN_R2),
           ("fft_fourstep", (4, 256)), ("fft_fourstep", MAIN_FOURSTEP),
           ("fft_staged", (4, 256)), ("fft_staged", TABLE1),
           ("rfft2d_fused", (2, 64, 64)), ("rfft2d_fused", MAIN_RFFT2),
           ("irfft2d_fused", (2, 64, 64)), ("irfft2d_fused", MAIN_RFFT2),
           ("fft2d_fused", (2, 64, 64)), ("fft2d_fused", MAIN_2D),
           ("fftconv_fused", (2, 3, 64)), ("fftconv_fused", MAIN_CONV)]

# the serving path: a SpectralServer on the card with the paper's 1024^2
# images as buckets (complex, real forward, real inverse; 16 a dispatch)
# and the 1-D 2^20 transform (4 a dispatch), driven by a seeded closed loop
# whose mix pads 1000^2 forward requests up to 1024^2
SERVE_BUCKETS = [((1024, 1024), "c2c", False, 16),
                 ((1024, 1024), "rfft", False, 16),
                 ((1024, 1024), "rfft", True, 16),
                 ((1 << 20,), "c2c", False, 4)]
# (shape, kind, inverse, weight) of the closed loop's mix
SERVE_MIX = [((1024, 1024), "c2c", False, 3.0),
             ((1000, 1000), "c2c", False, 1.0),
             ((1024, 1024), "rfft", False, 2.0),
             ((1000, 1000), "rfft", False, 1.0),
             ((1024, 1024), "rfft", True, 2.0),
             ((1 << 20,), "c2c", False, 1.0)]
SERVE_REQUESTS, SERVE_CONCURRENCY, SERVE_SEED = 96, 32, 22
SERVE_WAIT_S = 120.0        # a request's longest wait before the run fails
SERVE_KERNELS = ("fft2d_gemm", "rfft2d_fused", "irfft2d_fused",
                 "fft_fourstep")
TOL_DEGRADED = 1e-6         # degraded vs healthy server, of max|healthy|
# the guarded executor on the card: 16 1024^2 complex fp32 images
RESILIENCE_2D = MAIN_2D
GUARD_STREAM = 10       # back-to-back calls a run in the guard's stream mode

# the decode path's cells, one decode step's attention for one layer at the
# configs' full widths (src/repro/configs/): (B, S, H, KV, D, window, ring)
# - starcoder2-15b decode_32k: 16 sequences of up to 32768 tokens, about
#   what one 80 GB card holds beside 30 GB of bf16 weights (40 layers of
#   2 x 32768 x 4 x 128 bf16 K and V: 2.7 GB a sequence; 1.07 GB a layer);
# - h2o-danube-1.8b decode_32k: 128 sequences on the 4096-slot ring cache of
#   its 4096-token sliding window (models/cache.py kv_init), 1.34 GB a layer
STARCODER2 = (16, 32768, 48, 4, 128, None, False)
DANUBE = (128, 4096, 32, 8, 80, 4096, True)
DECODE_CELLS = {"starcoder2-15b": STARCODER2, "h2o-danube-1.8b": DANUBE}
TOL_DECODE = 2e-5       # fp32 vs float64 numpy, absolute (the reference's)
# (shape (B, S, H, KV, D), window, ring, chunk) held against the plain
# version in fp32 and bf16, each on the route the wrapper picks (bf16 with
# D a multiple of 16: the tensor cores; the rest: the CUDA cores): the
# reference test's shapes, a part-filled ring, a window, a group of 12 at
# D = 80, D not a multiple of 4, a group of 4 at D = 80 with a window (the
# danube cell's shape of work), rows filled to a quarter .. all of 8192
# slots in splits of 64 (whole splits with no visible slot); then the cells
DECODE_CHECKS = [((2, 128, 4, 2, 16), None, False, 128),
                 ((3, 512, 8, 8, 32), None, False, 128),
                 ((8, 1024, 8, 2, 64), None, False, 128),
                 ((3, 256, 4, 2, 16), 64, True, 64),
                 ((3, 256, 12, 1, 80), None, False, 64),
                 ((3, 100, 8, 8, 18), 40, True, 512),
                 ((4, 2048, 16, 4, 80), 300, True, 512),
                 ((4, 8192, 12, 1, 128), None, False, 512)]
DECODE_CHECKS += [(c[:5], c[5], c[6], 512) for c in DECODE_CELLS.values()]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# -- operation and byte counts ------------------------------------------------
#
# The bound is the function's, not the method's: ``batch`` complex FFTs of
# n points (n = H*W for a 2-D image) need 5*n*log2(n) flops each, and each
# input and output point is read or written once, 8 bytes a point.  The
# method's own counts (dense-DFT contractions at 8 flops per complex
# multiply-add, and the twiddle tables it streams) are printed beside it.

def fft_counts(batch: int, n: int):
    """(flops, bytes) that ``batch`` complex fp32 FFTs of n points need."""
    return 5 * batch * n * (n.bit_length() - 1), 16 * batch * n


def rfft_counts(batch: int, h: int, w: int):
    """(flops, bytes) that ``batch`` real fp32 2-D FFTs of h x w points
    need, either direction: 2.5*N*log2(N) flops a transform (half a
    complex FFT), 4 bytes a real point and 8 a half-spectrum bin."""
    n = h * w
    flops = 5 * batch * n * (n.bit_length() - 1) // 2
    return flops, 4 * batch * n + 8 * batch * h * (w // 2 + 1)


def _fourstep_flops(n: int, n1: int) -> int:
    """Method flops of one length-n row: both DFT contractions and the
    twiddle (6 per point), or one dense DFT when n1 = 1."""
    n2 = n // n1
    if n1 == 1:
        return 8 * n * n
    return 8 * n1 * n1 * n2 + 6 * n + 8 * n1 * n2 * n2


def method_fft2d(b, h, w, fac):
    """(method flops, table bytes) of the GEMM 2-D kernel."""
    n1w, n1h = fac(w)[0], fac(h)[0]
    flops = b * (h * _fourstep_flops(w, n1w) + w * _fourstep_flops(h, n1h))
    tables = sum(8 * (n1 * n1 + (n // n1) ** 2 + n)
                 for n, n1 in ((w, n1w), (h, n1h)))
    return flops, tables


def method_fourstep(b, n, n1):
    """(method flops, table bytes) of the four-step kernel: its n1- and
    n2-point FFTs, 5*n*log2(n) flops a row (radix-2 count), and T, 6 a
    point; its one table [w1 | w2 | lo | hi] (n1 + n2 + 2^s + n/2^s
    entries of 8 bytes, s = ceil(log2(n) / 2))."""
    s = n.bit_length() // 2
    flops = b * (5 * n * (n.bit_length() - 1) + 6 * n)
    return flops, 8 * (n1 + n // n1 + (1 << s) + (n >> s))


def fourstep_launches(n: int) -> int:
    """Grid launches of one four-step call: one up to 2^14, two above."""
    return 1 if n <= 1 << 14 else 2


def fourstep_floor_bytes(batch: int, n: int) -> int:
    """Bytes the four-step design moves: the fp32 planes read and written
    once a launch (the second launch through scratch)."""
    return 16 * batch * n * fourstep_launches(n)


def method_rfft2d(b, h, w):
    """(method flops, table bytes) of the real-input 2-D kernels, either
    direction: the shared-memory FFTs (5*n*log2(n) flops, radix-2 count)
    of the h/2 packed rows, the untangle or repack (8 flops a
    half-spectrum bin pair) and the w/2+1 columns; one float2 table an
    axis."""
    c = w // 2 + 1
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    flops = b * ((h // 2) * 5 * w * lw + 8 * (h // 2) * c + c * 5 * h * lh)
    return flops, 8 * (w + h)


def rfft2d_floor_bytes(b, h, w, pitch):
    """Bytes the two-launch real-input kernels move, either direction: the
    real images read (written), the half spectra written to and read from
    the scratch (rows of ``pitch`` bins), and the half spectra written
    (read)."""
    return 4 * b * h * w + 16 * b * h * pitch + 8 * b * h * (w // 2 + 1)


def method_stockham_r2(b, n):
    """(method flops, table bytes) of the radix-2 Stockham kernel: 10
    flops a butterfly, n/2 butterflies a stage, log2(n) stages; one table
    of n/2 float2 entries."""
    ln = n.bit_length() - 1
    return b * ln * (n // 2) * 10, 8 * (n // 2)


def method_stockham(b, n):
    """(method flops, table bytes) of the radix-4 Stockham kernel: 34 flops
    a radix-4 butterfly, n/4 a stage, and the radix-2 tail; one table of
    3 * n/4 float2 entries (w, w^2, w^3)."""
    ln = n.bit_length() - 1
    s4, tail = ln // 2, ln % 2
    flops = b * (s4 * (n // 4) * 34 + tail * (n // 2) * 4)
    return flops, 8 * 3 * max(n // 4, 1)


def conv_counts(batch: int, rows: int, m: int, bank_rows: int):
    """(flops, bytes) of the fused conv on (batch, rows, m) real fp32 with
    a packed filter pair of ``bank_rows`` rows: two FFTs of m/2 points a
    row, 5*(m/2)*log2(m/2) flops each; 4 bytes a real sample in and out,
    16 an E/F bin (four fp32 planes)."""
    hm = m // 2
    flops = 2 * 5 * hm * (hm.bit_length() - 1) * batch * rows
    return flops, 8 * batch * rows * m + 16 * bank_rows * hm


def method_conv(batch, rows, m):
    """(method flops, table bytes) of the one-pass kernel: a row's two
    FFTs as radix-4 stages of m/8 butterflies (34 flops each: three
    complex multiplies, eight complex adds) and, for odd log2(m/2), a
    radix-2 tail of m/4 (4 flops each), and the multiply (16 flops a bin);
    two (3, m/8) float2 tables."""
    hm = m // 2
    ln = hm.bit_length() - 1
    fft = (ln // 2) * (hm // 4) * 34 + (ln & 1) * (hm // 2) * 4
    return batch * rows * (2 * fft + 16 * hm), 2 * 3 * (hm // 4) * 8


def method_axis(b, dims):
    """(method flops, table bytes) of the 2-D and 3-D kernels' shared-memory
    FFTs (fp32 and bf16 compensated): 5*N*log2(N) flops a transform
    (radix-2 count) and one n-entry float2 table an axis."""
    n = 1
    for d in dims:
        n *= d
    return 5 * b * n * (n.bit_length() - 1), 8 * sum(dims)


def method_stockham2d(b, h, w):
    """(method flops, table bytes) of the fused Stockham 2-D kernel: the
    1-D kernel's stages on every row and every column."""
    fw, tw = method_stockham(b * h, w)
    fh, th = method_stockham(b * w, h)
    return fw + fh, tw + th


def staged_launches(n: int) -> int:
    """Grid launches of one staged call: one a stage (stage 0 with the
    bit-reverse), one copy for n = 1."""
    return max(n.bit_length() - 1, 1)


def staged_floor_bytes(batch: int, n: int) -> int:
    """Bytes the per-stage design moves: each launch reads and writes the
    fp32 planes once."""
    return 16 * batch * n * staged_launches(n)


def decode_counts(visible: int, empty_rows: int, b, s, h, kv, d,
                  cache_size: int, q_size: int):
    """(flops, bytes) one decode step's attention needs on this run's
    positions: K and V of each of the ``visible`` (row, slot) pairs and
    4*H*D flops for each; a row with no visible slot (its output is the
    mean of V) V of every slot and 2*H*D flops a slot; both position
    planes, q and the output."""
    flops = 4 * h * d * visible + 2 * h * d * s * empty_rows
    nbytes = (2 * visible + s * empty_rows) * kv * d * cache_size \
        + 4 * b * s + 4 * b + 2 * b * h * d * q_size
    return flops, nbytes


def skipped_shares(mask, split: int, tile: int):
    """(share of (row, tile) pairs, share of (row, split) pairs) with no
    visible slot in the (B, S) visibility ``mask``: what the decode kernel
    never reads (tiles of ``tile`` slots within splits of ``split``)."""
    import torch
    b, s = mask.shape
    pad = -s % split
    m = torch.cat([mask, mask.new_zeros((b, pad))], dim=1) if pad else mask
    m = m.reshape(b, -1, split)
    pad = -split % tile
    if pad:
        m = torch.cat([m, m.new_zeros(m.shape[:2] + (pad,))], dim=2)
    seen = m.reshape(b, m.shape[1], -1, tile).any(dim=3)
    return (1 - seen.float().mean().item(),
            1 - seen.any(dim=2).float().mean().item())


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


# -- helpers ------------------------------------------------------------------

def time_ms(fn, torch, runs=25, warmup=3):
    """Median of ``runs`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def _planes(t):
    """The planes of a split-complex pair, or a real tensor alone."""
    return tuple(t) if isinstance(t, tuple) else (t,)


def errors(got, ref):
    """(max abs error, max abs error / max |ref|) over every plane."""
    d = max((g - r).abs().max().item()
            for g, r in zip(_planes(got), _planes(ref)))
    m = max(r.abs().max().item() for r in _planes(ref))
    return d, d / m


def to_numpy(t):
    """A split-complex pair or a real tensor as a float64/complex128
    array on the host."""
    p = [q.double().cpu().numpy() for q in _planes(t)]
    return p[0] + 1j * p[1] if len(p) == 2 else p[0]


def np_errors(got, ref):
    import numpy as np
    return float(np.abs(to_numpy(got) - ref).max() / np.abs(ref).max())


def np_rel_norm(got, ref):
    import numpy as np
    return float(np.linalg.norm(to_numpy(got) - ref) / np.linalg.norm(ref))


def host_value(v):
    """A served result (a pair of host planes, or one real plane) as a
    float64/complex128 array."""
    import numpy as np
    if isinstance(v, tuple):
        return np.asarray(v[0], np.float64) + 1j * np.asarray(v[1],
                                                             np.float64)
    return np.asarray(v, np.float64)


def serve_reference(payload, kind, inverse, bucket_shape):
    """float64 numpy of what the server computes for one request: the
    payload zero-padded into its bucket's leading corner, then the
    bucket's transform (the inverse real transform takes the half
    spectrum as it is)."""
    import numpy as np
    if kind == "rfft" and inverse:
        return np.fft.irfft2(host_value(payload), s=bucket_shape)
    src = host_value(payload)
    x = np.zeros(bucket_shape, src.dtype)
    x[tuple(slice(0, d) for d in src.shape)] = src
    return np.fft.rfft2(x) if kind == "rfft" else np.fft.fftn(x)


def ptxas_report(log: str) -> dict:
    """{kernel symbol: ptxas resource line} from an nvcc -Xptxas -v log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Used" in line and name is not None:
            out[name] = line.split(":", 1)[1].strip()
    return out


# -- dist_path: the ranks' side ----------------------------------------------
#
# The distributed phase runs 4 ranks of one process group (spawned with
# repro_torch.dist.local.LocalGroup; they import this file as their main
# module and find these functions by name).  The parent writes each global
# input and its float64 numpy reference to .npy files; every rank maps
# them, cuts its block by the reference's PartitionSpec, runs the port's
# transform on the card and measures its own block's error.

DIST_2D = (8192, 8192)            # 512 MB complex fp32, 128 MB a rank
DIST_3D = (512, 512, 512)         # 1 GiB, 256 MiB a rank; 512-point
                                  # passes on fft_fourstep (256 runs torch)
DIST_1D = 1 << 26                 # four-step (8192, 8192)
DIST_STOCKHAM = (16, 1 << 21)     # local rows of 2^21 on fft_stockham
DIST_NCCL = (16384, 16384)
DIST_RANKS = 4
DIST_RUNS = 3                     # timed calls a transform (median)
# float64 numpy bounds (PERF.md section 2): 2-D of max|X|, 3-D relative
# norm, 1-D of max|X|, roundtrips of max|x|; the compressed wires at the
# reference tests' own bounds (tests/test_dist_rfft.py)
TOL_DIST = {"none": TOL_NUMPY, "bf16": 5e-2, "int8": 0.35}
# the compressed wires against float64 numpy with the same wire rounding
# applied to each rank's row-FFT block (of max|X|): only the values whose
# rounding the fp32 row pass flips differ, about 5e-5 (bf16) and 1e-4
# (int8); an uncompressed wire is 1.5e-3 / 1.1e-2 away, an int8 block
# dequantised with another rank's scale about 1e-2 (PERF.md section 6)
TOL_WIRE = {"bf16": 5e-4, "int8": 1e-3}
PIPE = (4, 1024, 64, 4)           # stages, width, batch, microbatches

_MESHES = {}


def _rank_mesh(shape, names):
    from repro_torch.dist import make_mesh
    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(shape, names, device="cuda")
    return _MESHES[key]


def _rank_setup():
    import torch
    from repro_torch.core.fft1d import assert_full_fp32
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert_full_fp32()
    ops.reset_launches()


def _rank_block(path, mesh, spec):
    """This rank's block of a global .npy array, as a host array."""
    import numpy as np
    from repro_torch.dist import local_block
    return np.array(local_block(np.load(path, mmap_mode="r"), mesh, spec))


def _rank_complex(tmp, name, mesh, spec):
    import torch
    from repro_torch.core.complexmath import SplitComplex
    return SplitComplex(*(torch.from_numpy(_rank_block(
        f"{tmp}/{name}_{part}.npy", mesh, spec)).to("cuda")
        for part in ("re", "im")))


def _rank_err(got, ref_block):
    """(max |got - ref|, max |ref|, sum |got - ref|^2, sum |ref|^2) of this
    rank's block, in float64 on the card."""
    import torch
    ref = torch.from_numpy(ref_block).to("cuda")
    if isinstance(got, tuple):
        g = torch.complex(got.re.double(), got.im.double())
    else:
        g = got.double()
    d = (g - ref).abs()
    r = ref.abs()
    return (d.max().item(), r.max().item(), float((d * d).sum().item()),
            float((r * r).sum().item()))


def _rank_timed(fn, runs=DIST_RUNS):
    """(last output, wall seconds of each of ``runs`` calls after one
    warm-up; every rank starts each call together)."""
    import torch
    import torch.distributed as dist
    out = fn()
    times = []
    for _ in range(runs):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def _rank_exchange_split(fn):
    """(wall seconds, seconds inside the exchanges) of one call, the card
    synchronized around every exchange."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import pencil
    spent, orig = [], pencil._a2a

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = orig(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return y
    pencil._a2a = timed
    try:
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pencil._a2a = orig
    return wall, sum(spent)


def _rank_case(name, fn, ref_path, ref_spec, mesh, *, transpose=None,
               exchange_bytes=None):
    """Run one transform: timings, the exchange split, its wire log and
    its block's error against the float64 reference."""
    import numpy as np
    from repro_torch.dist import local_block, pencil
    pencil.reset_wire_log()
    fn()
    logged = pencil.logged_exchange_bytes()
    out, times = _rank_timed(fn)
    wall, exch = _rank_exchange_split(fn)
    ref = np.load(ref_path, mmap_mode="r")
    if transpose is not None:
        ref = ref.transpose(transpose)
    err = _rank_err(out, np.array(local_block(ref, mesh, ref_spec)))
    return out, {"case": name, "err": err, "times": times,
                 "split": [wall, exch], "logged_bytes": logged,
                 "priced_bytes": exchange_bytes}


def _rank_launches():
    from repro_torch.kernels import ops
    return dict(ops.LAUNCHES)


def _rank_pfft2_cases(tmp):
    """pfft2 at DIST_2D: chunks, both layouts and the roundtrip, the wire
    formats, verify under wire faults; then the two-hop hierarchy."""
    import numpy as np
    import torch
    from repro_torch.dist import local_block, pencil
    from repro_torch.resilience import faults
    _rank_setup()
    m = _rank_mesh((DIST_RANKS,), ("data",))
    x = _rank_complex(tmp, "x", m, ("data", None))
    h, w = DIST_2D
    ref = f"{tmp}/fft2.npy"
    res = []
    for chunks, t, c in ((1, True, "none"), (4, True, "none"),
                         (1, False, "none"), (1, True, "bf16"),
                         (1, True, "int8")):
        def fn(chunks=chunks, t=t, c=c):
            return pencil.pfft2(x, m, chunks=chunks, transposed_output=t,
                                compress=c, backend="cuda")
        out, r = _rank_case(
            f"pfft2/chunks{chunks}/{'T' if t else 'N'}/{c}", fn, ref,
            ("data", None), m, transpose=(1, 0) if t else None,
            exchange_bytes=pencil.exchange_bytes(h, w, DIST_RANKS, method=c,
                                                 transposed_output=t))
        r["wire"] = c
        if c != "none":
            wref = np.load(f"{tmp}/fft2_{c}.npy", mmap_mode="r").T
            r["err_wire"] = _rank_err(out, np.array(
                local_block(wref, m, ("data", None))))
        res.append(r)
        if not t:
            natural = out
    back, times = _rank_timed(lambda: pencil.pfft2(
        natural, m, inverse=True, transposed_output=False, backend="cuda"))
    x_host = (_rank_block(f"{tmp}/x_re.npy", m, ("data", None))
              + 1j * _rank_block(f"{tmp}/x_im.npy", m, ("data", None)))
    res.append({"case": "pfft2/roundtrip", "err": _rank_err(back, x_host),
                "times": times, "wire": "roundtrip"})
    del natural, back
    # verify=True under each wire fault, and a fault that persists
    clean = pencil.pfft2(x, m, backend="cuda")
    verify = {}
    for kind in ("drop", "corrupt", "nan"):
        pencil.reset_exchange_log()
        with faults.inject("dist.exchange", kind) as fp:
            y = pencil.pfft2(x, m, backend="cuda", verify=True)
        verify[kind] = {
            "attempts": [e["ok"] for e in pencil.exchange_log()],
            "fired": fp.fired(),
            "bit_identical": bool(torch.equal(y.re, clean.re)
                                  and torch.equal(y.im, clean.im))}
    try:
        with faults.inject("dist.exchange", "corrupt", times=None):
            pencil.pfft2(x, m, backend="cuda", verify=True)
        verify["persistent"] = "no error"
    except pencil.ExchangeIntegrityError as e:
        verify["persistent"] = type(e).__name__ + ": " + e.tag
    del clean, y, x
    torch.cuda.empty_cache()
    mh = _rank_mesh((2, 2), ("pod", "data"))
    xh = _rank_complex(tmp, "x", mh, (("pod", "data"), None))
    _, r = _rank_case("pfft2_hierarchical/(2,2)", lambda: pencil.
                      pfft2_hierarchical(xh, mh, backend="cuda"), ref,
                      (("data", "pod"), None), mh, transpose=(1, 0))
    res.append(r)
    return res, verify, _rank_launches()


def _rank_prfft2(tmp):
    import torch
    from repro_torch.dist import pencil
    _rank_setup()
    m = _rank_mesh((DIST_RANKS,), ("data",))
    h, w = DIST_2D
    xr = torch.from_numpy(_rank_block(f"{tmp}/xr.npy", m,
                                      ("data", None))).to("cuda")
    out, r = _rank_case(
        "prfft2", lambda: pencil.prfft2(xr, m, backend="cuda"),
        f"{tmp}/rfft2_packed_t.npy", ("data", None), m,
        exchange_bytes=pencil.exchange_bytes(h, w, DIST_RANKS, real=True))
    back, times = _rank_timed(lambda: pencil.pirfft2(out, m,
                                                     backend="cuda"))
    rt = {"case": "pirfft2/roundtrip",
          "err": _rank_err(back, xr.double().cpu().numpy()),
          "times": times}
    return [r, rt], _rank_launches()


def _rank_pfft3(tmp):
    from repro_torch.dist import pencil
    _rank_setup()
    m = _rank_mesh((2, 2), ("data", "model"))
    x = _rank_complex(tmp, "x3", m, ("data", "model", None))
    _, r = _rank_case("pfft3/(2,2)", lambda: pencil.pfft3(
        x, m, backend="cuda"), f"{tmp}/fftn_t.npy", ("model", "data", None),
        m)
    return [r], _rank_launches()


def _rank_pfft1d(tmp):
    from repro_torch.dist import pencil
    _rank_setup()
    m = _rank_mesh((DIST_RANKS,), ("data",))
    v = _rank_complex(tmp, "v", m, ("data",))
    out, r = _rank_case("pfft1d", lambda: pencil.pfft1d(
        v, m, backend="cuda"), f"{tmp}/fft1d_fourstep.npy", ("data",), m)
    back, times = _rank_timed(lambda: pencil.pfft1d(out, m, inverse=True,
                                                    backend="cuda"))
    v_host = (_rank_block(f"{tmp}/v_re.npy", m, ("data",))
              + 1j * _rank_block(f"{tmp}/v_im.npy", m, ("data",)))
    return [r, {"case": "pfft1d/inverse", "err": _rank_err(back, v_host),
                "times": times}], _rank_launches()


def _rank_stockham(tmp):
    from repro_torch.core.plan import get_plan
    from repro_torch.dist import pencil
    _rank_setup()
    m = _rank_mesh((DIST_RANKS,), ("data",))
    x = _rank_complex(tmp, "xs", m, ("data", None))
    h, w = DIST_STOCKHAM
    _, r = _rank_case(
        f"pfft2/{h}x{w}", lambda: pencil.pfft2(x, m, backend="cuda"),
        f"{tmp}/fft2_stockham.npy", ("data", None), m, transpose=(1, 0),
        exchange_bytes=pencil.exchange_bytes(h, w, DIST_RANKS))
    plans = {}
    for n in (w, h):
        pl = get_plan((n,), backend="cuda")
        plans[str(n)] = [pl.algo, pl.backend, pl.demote_reason]
    r["plans"] = plans
    return [r], _rank_launches()


def _rank_pipeline():
    """pipelined_apply over 4 stages against the sequential loop on the
    rank's card: forward, the rank's stage gradient and dx."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist._compat import p2p_route
    from repro_torch.dist.pipeline import pipelined_apply
    _rank_setup()
    m = _rank_mesh((DIST_RANKS,), ("pod",))
    stages, width, batch, micro = PIPE
    g = torch.Generator(device="cuda")
    g.manual_seed(23)
    ws = torch.randn((stages, width, width), generator=g,
                     device="cuda") / width ** 0.5
    x = torch.randn((batch, width), generator=g, device="cuda")
    i = m.get_local_rank("pod")

    def stage(w, v):
        return torch.tanh(v @ w)
    w = ws[i].clone().requires_grad_()
    xx = x.clone().requires_grad_()
    out, times = _rank_timed(lambda: pipelined_apply(m, "pod", stage, w,
                                                     xx, micro))
    (out ** 2).sum().backward()
    wr, xr = ws.clone().requires_grad_(), x.clone().requires_grad_()
    y = xr
    for s in range(stages):
        y = stage(wr[s], y)
    (y ** 2).sum().backward()

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()
    return {"exchange": dist.get_backend(m.get_group("pod")),
            "p2p": p2p_route(m, "pod", "cuda"),
            "forward": rel(out.detach(), y.detach()),
            "grad_w": rel(w.grad, wr.grad[i]), "grad_x": rel(xx.grad,
                                                           xr.grad),
            "times": times}


def _rank_nccl_pfft2(shape):
    """pfft2 at ``shape`` over every card of the host on NCCL; each rank
    makes the global input from one seed and holds its block against
    float64 ``torch.fft.fft2`` of it on its card."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.complexmath import SplitComplex
    from repro_torch.dist import local_block, pencil
    _rank_setup()
    world = dist.get_world_size()
    m = _rank_mesh((world,), ("data",))
    g = torch.Generator(device="cuda")
    g.manual_seed(16)
    glob = torch.complex(torch.randn(shape, generator=g, device="cuda"),
                         torch.randn(shape, generator=g, device="cuda"))
    blk = local_block(glob, m, ("data", None))
    x = SplitComplex(blk.real.contiguous(), blk.imag.contiguous())
    pencil.reset_wire_log()
    out, times = _rank_timed(lambda: pencil.pfft2(x, m, backend="cuda"))
    logged = pencil.logged_exchange_bytes() // (DIST_RUNS + 1)
    ref = torch.fft.fft2(glob.to(torch.complex128)).T
    del glob
    want = local_block(ref, m, ("data", None))
    d = (torch.complex(out.re.double(), out.im.double()) - want).abs()
    err = (d.max() / want.abs().max()).item()
    return {"err": err, "times": times, "logged_bytes": logged,
            "priced_bytes": pencil.exchange_bytes(*shape, world),
            "backend": dist.get_backend(), "launches": _rank_launches()}


def dist_path(failures, smi):
    """The pencil FFTs and the pipeline over 4 ranks: emits the phase's
    line, appends to ``failures`` and returns the cases.  With 4 cards or more NCCL runs
    one rank a card; otherwise the ranks share cuda:0 over gloo (NCCL
    refuses two ranks on one card), chosen here, never after a failure."""
    import numpy as np
    import torch
    from repro_torch.dist.local import LocalGroup
    n_cards = torch.cuda.device_count()
    dist_backend = "nccl" if n_cards >= DIST_RANKS else "gloo"
    torch.cuda.empty_cache()
    drng = np.random.default_rng(23)
    dist_cases, dist_launches, dist_verify = [], {}, {}

    def add_launches(counts):
        for k, v in counts.items():
            dist_launches[k] = dist_launches.get(k, 0) + v

    def save_complex(tmp, name, z):
        np.save(f"{tmp}/{name}_re.npy", np.ascontiguousarray(z.real,
                                                              np.float32))
        np.save(f"{tmp}/{name}_im.npy", np.ascontiguousarray(z.imag,
                                                              np.float32))

    def wire_reference(z, method):
        """float64 fft2 of ``z`` with ``method``'s wire rounding applied
        to each rank's row-FFT block, one int8 scale a block and plane,
        as dist.compression.all_to_all_compressed rounds pfft2's
        exchange."""
        y = np.fft.fft(z, axis=1)
        rows = y.shape[0] // DIST_RANKS
        for plane in (y.real, y.imag):
            for r in range(DIST_RANKS):
                blk = plane[r * rows:(r + 1) * rows]
                if method == "bf16":
                    blk[...] = torch.from_numpy(blk).float().bfloat16() \
                        .double().numpy()
                else:
                    s = np.float32(np.abs(blk).max()) / np.float32(127)
                    blk[...] = np.round(blk / s) * s
        return np.fft.fft(y, axis=0)

    def complex_input(shape):
        z = np.empty(shape, np.complex128)
        z.real = drng.standard_normal(shape, dtype=np.float32)
        z.imag = drng.standard_normal(shape, dtype=np.float32)
        return z

    def collect(results, bound, norm=False):
        """One line a case from every rank's result: the error over the
        assembled output, the median wall over runs of the slowest rank,
        the exchange split, and the wire log against exchange_bytes."""
        for rs in zip(*results):
            r0 = rs[0]
            errs = [r["err"] for r in rs]
            if norm:
                err = (sum(e[2] for e in errs) / sum(e[3] for e in errs)) \
                    ** 0.5
            else:
                err = max(e[0] for e in errs) / max(e[1] for e in errs)
            lim = bound(r0)
            walls = sorted(max(t) for t in zip(*(r["times"] for r in rs)))
            line = {"case": r0["case"], "err": err, "bound": lim,
                    "wall_ms": walls[len(walls) // 2] * 1e3}
            if "split" in r0:
                line["exchange_ms"] = max(r["split"][1] for r in rs) * 1e3
                line["local_ms"] = max(r["split"][0] - r["split"][1]
                                       for r in rs) * 1e3
                line["bytes_per_rank"] = r0["logged_bytes"]
                if r0["priced_bytes"] is not None and any(
                        r["logged_bytes"] != r["priced_bytes"] for r in rs):
                    failures.append(f"dist {r0['case']}: logged bytes "
                                    f"{[r['logged_bytes'] for r in rs]} != "
                                    f"exchange_bytes {r0['priced_bytes']}")
            if "plans" in r0:
                line["plans"] = r0["plans"]
            if "err_wire" in r0:
                e = [r["err_wire"] for r in rs]
                werr = max(x[0] for x in e) / max(x[1] for x in e)
                wlim = TOL_WIRE[r0["wire"]]
                line["err_vs_wire_ref"], line["wire_bound"] = werr, wlim
                if not werr <= wlim:
                    failures.append(f"dist {r0['case']} against the wire "
                                    f"reference: {werr} > {wlim}")
            if not err <= lim:
                failures.append(f"dist {r0['case']}: {err} > {lim}")
            dist_cases.append(line)

    t_dist, rank_s = time.perf_counter(), [0.0]

    def ranks(fn, *args):
        t0 = time.perf_counter()
        out = group.run(fn, *args)
        rank_s[0] += time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp, \
            LocalGroup(DIST_RANKS, backend=dist_backend, device="cuda",
                       threads=2, timeout_s=600) as group:
        # complex 8192^2: pfft2 and the hierarchy
        z = complex_input(DIST_2D)
        save_complex(tmp, "x", z)
        np.save(f"{tmp}/fft2.npy", np.fft.fft2(z))
        for c in ("bf16", "int8"):
            np.save(f"{tmp}/fft2_{c}.npy", wire_reference(z, c))
        del z
        res, dist_verify, counts = zip(*ranks(_rank_pfft2_cases, tmp))
        add_launches({k: sum(c[k] for c in counts) for k in counts[0]})
        collect(res, lambda r: TOL_ROUNDTRIP if r.get("wire") == "roundtrip"
                else TOL_DIST.get(r.get("wire"), TOL_NUMPY))
        dist_verify = dist_verify[0] if all(
            v == dist_verify[0] for v in dist_verify) else list(dist_verify)
        # real 8192^2: prfft2 -> pirfft2; the packed transposed reference
        zr = drng.standard_normal(DIST_2D, dtype=np.float32)
        np.save(f"{tmp}/xr.npy", zr)
        spec_t = np.fft.rfft2(zr.astype(np.float64)).T
        packed = spec_t[:-1].copy()
        packed[0] = spec_t[0] + 1j * spec_t[-1]
        np.save(f"{tmp}/rfft2_packed_t.npy", packed)
        del zr, spec_t, packed
        res, counts = zip(*ranks(_rank_prfft2, tmp))
        add_launches({k: sum(c[k] for c in counts) for k in counts[0]})
        collect(res, lambda r: TOL_ROUNDTRIP if "roundtrip" in r["case"]
                else TOL_NUMPY)
        for f in Path(tmp).glob("*.npy"):
            f.unlink()
        # 512^3 on a (2, 2) mesh; the reference in its (Z, Y, X) layout
        z = complex_input(DIST_3D)
        save_complex(tmp, "x3", z)
        np.save(f"{tmp}/fftn_t.npy",
                np.ascontiguousarray(np.fft.fftn(z).transpose(2, 1, 0)))
        del z
        res, counts = zip(*ranks(_rank_pfft3, tmp))
        add_launches({k: sum(c[k] for c in counts) for k in counts[0]})
        if sum(c.get("fft_fourstep", 0) for c in counts) <= 0:
            failures.append("kernel fft_fourstep was not launched by pfft3")
        collect(res, lambda r: TOL_3D_NUMPY, norm=True)
        for f in Path(tmp).glob("*.npy"):
            f.unlink()
        # 2^26 points, four-step (8192, 8192)
        from repro_torch.dist.pencil import fourstep_split
        h1, w1 = fourstep_split(DIST_1D, DIST_RANKS)
        z = complex_input((DIST_1D,))
        save_complex(tmp, "v", z)
        np.save(f"{tmp}/fft1d_fourstep.npy", np.ascontiguousarray(
            np.fft.fft(z).reshape(w1, h1).T).reshape(-1))
        del z
        res, counts = zip(*ranks(_rank_pfft1d, tmp))
        add_launches({k: sum(c[k] for c in counts) for k in counts[0]})
        collect(res, lambda r: TOL_ROUNDTRIP if "inverse" in r["case"]
                else TOL_1D)
        for f in Path(tmp).glob("*.npy"):
            f.unlink()
        # (16, 2^21): local rows of 2^21 on fft_stockham
        z = complex_input(DIST_STOCKHAM)
        save_complex(tmp, "xs", z)
        np.save(f"{tmp}/fft2_stockham.npy", np.fft.fft2(z))
        del z
        res, counts = zip(*ranks(_rank_stockham, tmp))
        add_launches({k: sum(c[k] for c in counts) for k in counts[0]})
        collect(res, lambda r: TOL_NUMPY)
        pipe = ranks(_rank_pipeline)
    dist_s = time.perf_counter() - t_dist
    for kind in ("drop", "corrupt", "nan"):
        v = dist_verify.get(kind, {}) if isinstance(dist_verify, dict) \
            else {}
        if v != {"attempts": [False, True], "fired": 1,
                 "bit_identical": True}:
            failures.append(f"dist verify {kind}: {dist_verify}")
    if not (isinstance(dist_verify, dict) and dist_verify.get(
            "persistent") == "ExchangeIntegrityError: pfft2"):
        failures.append(f"dist verify persistent: {dist_verify}")
    pipe_walls = sorted(max(t) for t in zip(*(p["times"] for p in pipe)))
    pipe_line = {k: max(p[k] for p in pipe)
                 for k in ("forward", "grad_w", "grad_x")}
    for k, lim in (("forward", 1e-5), ("grad_w", 1e-4), ("grad_x", 1e-4)):
        if not pipe_line[k] <= lim:
            failures.append(f"pipelined_apply {k}: {pipe_line[k]} > {lim}")
    for k in ("fft_fourstep", "fft_stockham"):
        if dist_launches.get(k, 0) <= 0:
            failures.append(f"kernel {k} was not launched on the dist path")
    emit({"phase": "dist_path", "ranks": DIST_RANKS, "cards": n_cards,
          "backend": dist_backend, "exchange": pipe[0]["exchange"],
          "p2p": pipe[0]["p2p"],
          "note": ("gloo moves card tensors through host memory: these "
                   "exchange times are not NVLink numbers")
          if dist_backend == "gloo" else "NCCL, one rank a card",
          "cases": dist_cases, "verify": dist_verify,
          "pipeline": dict(pipe_line, stages=PIPE[0], width=PIPE[1],
                           batch=PIPE[2], microbatches=PIPE[3],
                           wall_ms=pipe_walls[len(pipe_walls) // 2] * 1e3),
          "launches": dist_launches, "seconds": dist_s,
          "rank_seconds": rank_s[0],
          "nvidia_smi": smi})
    return dist_cases


def nccl_path(failures, smi, n_cards):
    """One pfft2 at DIST_NCCL over every card of the host on NCCL (on one
    card: one rank, a self-exchange)."""
    from repro_torch.dist.local import LocalGroup
    with LocalGroup(n_cards, backend="nccl", device="cuda",
                    timeout_s=600) as group:
        nccl = group.run(_rank_nccl_pfft2, DIST_NCCL)
    nccl_err = max(r["err"] for r in nccl)
    nccl_walls = sorted(max(t) for t in zip(*(r["times"] for r in nccl)))
    nccl_launches = {k: sum(r["launches"][k] for r in nccl)
                     for k in nccl[0]["launches"]}
    if not nccl_err <= TOL_NUMPY:
        failures.append(f"NCCL pfft2{DIST_NCCL}: {nccl_err} > {TOL_NUMPY}")
    if any(r["logged_bytes"] != r["priced_bytes"] for r in nccl):
        failures.append(f"NCCL pfft2 logged bytes: {nccl}")
    if nccl_launches["fft_fourstep"] <= 0:
        failures.append("kernel fft_fourstep was not launched on the NCCL "
                        "pfft2")
    emit({"phase": "dist_nccl", "shape": DIST_NCCL, "ranks": n_cards,
          "backend": nccl[0]["backend"], "err_vs_fp64": nccl_err,
          "reference": "torch.fft.fft2 in complex128 on the card",
          "wall_ms": nccl_walls[len(nccl_walls) // 2] * 1e3,
          "bytes_per_rank": nccl[0]["logged_bytes"],
          "launches": nccl_launches, "nvidia_smi": smi})



def tt_path(failures, smi, dist_cases):
    """Model-pruned autotune on the main path's key, the model's exchange
    bytes against dist_path's wire log, and the cost model's predictions
    for the main path's keys (wormhole_n300 model inputs)."""
    import torch
    from repro_torch.core.plan import clear_plan_cache, get_plan
    from repro_torch.tt.trace import trace_dist, trace_plan
    key = dict(dtype=torch.float32, backend="cuda", device="cuda",
               tune=True, tune_batch=MAIN_2D[0])
    clear_plan_cache()
    full = get_plan(MAIN_2D[1:], **key).tune_report
    clear_plan_cache()
    pruned_plan = get_plan(MAIN_2D[1:], prune="model", **key)
    pruned = pruned_plan.tune_report
    clear_plan_cache()
    kept = [k for k, v in pruned.items() if isinstance(v, float)]
    if pruned["n_measured"] >= pruned["n_candidates"] or "default" not in kept:
        failures.append(f"prune='model' measured {pruned}")
    logged = {c["case"]: c.get("bytes_per_rank") for c in dist_cases}
    tt_bytes = {}
    for real_in, case in ((False, "pfft2/chunks1/T/none"),
                          (True, "prfft2")):
        tr = trace_dist(DIST_2D, devices=DIST_RANKS, real=real_in,
                        backend="cuda")
        want = logged[case] * (DIST_RANKS - 1) / DIST_RANKS
        tt_bytes[case] = {"predicted_wire_bytes": tr.exchange_wire_bytes,
                          "logged_payload_bytes": logged[case]}
        if tr.exchange_wire_bytes != want:
            failures.append(f"trace_dist {case}: {tr.exchange_wire_bytes} "
                            f"!= {want}")
    predictions = {}
    for name, shape, kw, batch in (
            ("fft2_1024", MAIN_2D[1:], {}, MAIN_2D[0]),
            ("rfft2_1024", MAIN_RFFT2[1:], {"kind": "rfft"}, MAIN_RFFT2[0]),
            ("fft_2^20", MAIN_FOURSTEP[1:], {}, MAIN_FOURSTEP[0]),
            ("fft_2^22", MAIN_STOCKHAM[1:], {}, MAIN_STOCKHAM[0]),
            ("fft3_256", MAIN_3D[1:], {}, MAIN_3D[0])):
        pl = get_plan(shape, backend="cuda", **kw)
        t = trace_plan(pl, arch="wormhole_n300", batch=batch)
        # predict_cost is t.seconds where the working set fits the arch's
        # SRAM budget, +inf where it does not
        predictions[name] = {"algo": pl.algo, "batch": batch,
                             "predicted_s": t.seconds, "fits": t.fits,
                             "stages": len(t.stages)}
    emit({"phase": "tt_path", "key": [MAIN_2D[0], *MAIN_2D[1:]],
          "model_arch": "tpu_v5e (get_plan's default)",
          "kept": kept, "pruned": pruned.get("model_pruned", "").split("|"),
          "kept_us": {k: pruned[k] for k in kept},
          "winner": pruned["winner"], "unpruned_winner": full["winner"],
          "unpruned_us": {k: v for k, v in full.items()
                          if isinstance(v, float)},
          "unpruned_winner_kept": full["winner"] in kept,
          "exchange_bytes": tt_bytes,
          "predictions": {"model": "wormhole_n300 (the reference's cost "
                                   "model; not an H100 number)",
                          **predictions},
          "nvidia_smi": smi})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import (SplitComplex, from_numpy, fft2, fft3,
                                  get_plan, plan_fft, clear_plan_cache, rfft,
                                  irfft, rfft2, irfft2, fft_conv,
                                  circular_conv, fourier_mix, fft,
                                  fft_cooley_tukey)
    from repro_torch.core import fftconv as FC
    from repro_torch.core.fft1d import assert_full_fp32
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fft2d_gemm as G
    from repro_torch.kernels import fft_fourstep as F
    from repro_torch.kernels import fft_stockham as S
    from repro_torch.kernels import rfft2d_fused as R
    from repro_torch.kernels import fftconv_fused as C
    from repro_torch.kernels import fft3d_fused as V
    from repro_torch.kernels import axis_fft as AX
    from repro_torch.kernels import fft2d_fused as S2
    from repro_torch.kernels import fft_stage as ST
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels.rfft2d_fused import fourstep_factors
    from repro_torch import resilience
    from repro_torch.core.plan import (_plan_key, autotune_count,
                                       load_wisdom, save_wisdom)
    from repro_torch.resilience import config as rconfig
    from repro_torch.resilience import executor as rexec
    from repro_torch.resilience import faults as rfaults
    from repro_torch.resilience import guards as rguards
    from repro_torch.resilience import policy as rpolicy
    from repro_torch.resilience.policy import RUNTIME_DEMOTE_REASON
    from repro_torch.serve.spectral import (BucketConfig, MixItem,
                                            SpectralServer, closed_loop)
    from repro_torch.serve.spectral.loadgen import _pick, make_payload

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert_full_fp32()
    failures = []
    dev = "cuda"
    rng = np.random.default_rng(0)

    def rand(shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    def real(shape):
        return rng.standard_normal(shape)

    def real_on_card(z):
        return torch.from_numpy(z).to(dev, torch.float32)

    def bf16(x):
        return SplitComplex(x.re.bfloat16(), x.im.bfloat16())

    def decode_case(shape, window, ring, seed):
        """fp32 q, K and V made on the card from a seed (the caches are
        gigabytes), positions from numpy: a full cache of per-row lengths
        (one row full, the rest a quarter to all of S; empty slots -1), or
        a ring of S slots at per-row q_pos that wrap mid-array, where slot
        i holds the newest position = i (mod S) that is <= q_pos, with a
        few short rows (empty slots) and a last row with no slot at all."""
        b, s, h, kv, d = shape
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        q = torch.randn((b, h, d), generator=g, device=dev)
        k = torch.randn((b, s, kv, d), generator=g, device=dev)
        v = torch.randn((b, s, kv, d), generator=g, device=dev)
        prng = np.random.default_rng(seed)
        slot = np.arange(s)
        if ring:
            q_pos = prng.integers(s, 8 * s, b)
            q_pos[(q_pos + 1) % s == 0] += 1          # wrap mid-array
            q_pos[1:4] = (s // 3, 17, s - 2)[:len(q_pos[1:4])]
            kv_pos = q_pos[:, None] - (q_pos[:, None] - slot) % s
            kv_pos[kv_pos < 0] = -1
            kv_pos[-1] = -1
        else:
            n = prng.integers(s // 4, s + 1, b)
            n[0] = s
            q_pos = n - 1
            kv_pos = np.where(slot < n[:, None], slot, -1)
        return (q, k, v,
                torch.from_numpy(kv_pos).to(dev, torch.int32),
                torch.from_numpy(q_pos).to(dev, torch.int32))

    def as_bf16(case):
        return tuple(t.bfloat16() if t.is_floating_point() else t
                     for t in case)

    def decode_numpy(case, window):
        """The dense formula in float64 on the host, a row at a time."""
        q, k, v, kv_pos, q_pos = case
        b, h, d = q.shape
        kv = k.shape[2]
        g = h // kv
        qn = q.double().cpu().numpy() / np.sqrt(d)
        pn, qp = kv_pos.cpu().numpy(), q_pos.cpu().numpy()
        out = np.empty((b, h, d))
        for i in range(b):
            kk, vv = k[i].double().cpu().numpy(), v[i].double().cpu().numpy()
            mask = (pn[i] >= 0) & (pn[i] <= qp[i])
            if window is not None:
                mask &= pn[i] > qp[i] - window
            for j in range(kv):
                sc = np.where(mask, qn[i, j * g:(j + 1) * g] @ kk[:, j].T,
                              -1e30)
                p = np.exp(sc - sc.max(axis=-1, keepdims=True))
                out[i, j * g:(j + 1) * g] = \
                    (p / p.sum(axis=-1, keepdims=True)) @ vv[:, j]
        return out

    def visibility(case, window):
        """(visible (row, slot) pairs, rows with no visible slot)."""
        _, _, _, kv_pos, q_pos = case
        mask = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
        if window is not None:
            mask &= kv_pos > q_pos[:, None] - window
        return int(mask.sum().item()), int((~mask.any(dim=1)).sum().item())

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    ptxas = {n: ptxas_report(log) for n, log in logs.items()}
    # the fp32 GEMM core's instance, cg::cgemm_kernel<false, false, EPI_F32>
    f32_gemm = {n: r[k] for n, r in ptxas.items() for k in r
                if "cgemm_kernel" in k and "Lb0ELb0ELi0E" in k}
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": round(build_s, 3),
          "libraries": [_build.library_path(n).name for n in _build.SOURCES],
          "ptxas": ptxas, "cgemm_f32": f32_gemm})

    # 3. kernel vs plain version, forward and inverse (for the real-input
    # pair the inverse is irfft2d_fused, fed a random half spectrum whose
    # DC and Nyquist bins have imaginary parts)
    def three_launches(x, inverse=False, variant="plain"):
        return V._fft3d_cuda(x, inverse=inverse, variant=variant,
                             planes=False)

    def c2c(kern, plain, tol):
        def make(shape, inverse):
            return from_numpy(rand(shape), device=dev)
        return (lambda x, inverse: kern(x, inverse=inverse),
                lambda x, inverse: plain(x, inverse=inverse), make, tol)

    def real_pair(shape, inverse):
        b, h, w = shape
        if inverse:
            return from_numpy(rand((b, h, w // 2 + 1)), device=dev)
        return real_on_card(real(shape))

    impls = {"fft2d_gemm": c2c(G.fft2d_gemm_cuda, G.fft2d_gemm_plain,
                               TOL_2D),
             "fft_fourstep": c2c(F.fft_fourstep_cuda, F.fft_fourstep_plain,
                                 TOL_1D),
             "fft_stockham": c2c(S.fft_stockham_cuda, S.fft_stockham_plain,
                                 TOL_1D),
             "fft_stockham_r2": c2c(S.fft_stockham_r2_cuda,
                                    S.fft_stockham_r2_plain, TOL_1D),
             "fft3d_fused": c2c(V.fft3d_fused_cuda, V.fft3d_fused_plain,
                                TOL_2D),
             "fft3d_three": c2c(three_launches, V.fft3d_fused_plain, TOL_2D),
             "fft2d_fused": c2c(S2.fft2d_fused_cuda, S2.fft2d_fused_plain,
                                TOL_2D),
             "fft_staged": c2c(ST.fft_staged_cuda, ST.fft_staged_plain,
                               TOL_1D),
             "rfft2d_fused": (
                 lambda x, inverse: R.irfft2d_fused_cuda(x) if inverse
                 else R.rfft2d_fused_cuda(x),
                 lambda x, inverse: R.irfft2d_fused_plain(x) if inverse
                 else R.rfft2d_fused_plain(x), real_pair, TOL_2D)}
    main_err = {}
    for name, shape in CHECKS:
        kern, plain, make, tol = impls[name]
        for inverse in (False, True):
            kname = "irfft2d_fused" if name == "rfft2d_fused" and inverse \
                else name
            x = make(shape, inverse)
            got = kern(x, inverse)
            torch.cuda.synchronize()
            ref = plain(x, inverse)
            abs_err, rel = errors(got, ref)
            ok = rel <= tol
            if not ok:
                failures.append(f"{kname}{shape} inverse={inverse}: {rel}")
            if shape == MAIN_SHAPE[kname] and \
                    (not inverse or kname == "irfft2d_fused"):
                main_err[kname] = abs_err
            emit({"phase": "kernel_vs_plain", "kernel": kname,
                  "shape": shape, "inverse": inverse,
                  "max_abs_err": abs_err, "err_over_max": rel, "tol": tol,
                  "ok": ok})
            del x, got, ref
    torch.cuda.empty_cache()
    # the radix-4 kernel's per-stage route above 2^24, against float64 numpy
    z = rand(STOCKHAM_STAGES)
    x = from_numpy(z, device=dev)
    for inverse in (False, True):
        got = S.fft_stockham_cuda(x, inverse=inverse)
        torch.cuda.synchronize()
        rel = np_errors(got, np.fft.ifft(z) if inverse else np.fft.fft(z))
        ok = rel <= TOL_1D
        if not ok:
            failures.append(f"fft_stockham{STOCKHAM_STAGES} per-stage "
                            f"inverse={inverse}: {rel}")
        emit({"phase": "kernel_vs_numpy", "kernel": "fft_stockham",
              "route": "per_stage", "shape": STOCKHAM_STAGES,
              "inverse": inverse, "err_over_max": rel, "tol": TOL_1D,
              "ok": ok})
        del got
    del x, z
    torch.cuda.empty_cache()
    bf16_kernels = {"fft2d_gemm": (G.fft2d_gemm_cuda, G.fft2d_gemm_plain),
                    "fft3d_fused": (V.fft3d_fused_cuda, V.fft3d_fused_plain),
                    "fft3d_three": (three_launches, V.fft3d_fused_plain)}
    for name, shape, variant in BF16_CHECKS:
        kern, plain = bf16_kernels[name]
        for inverse in (False, True):
            x = bf16(from_numpy(rand(shape), device=dev))
            got = kern(x, inverse=inverse, variant=variant)
            torch.cuda.synchronize()
            ref = plain(x, inverse=inverse, variant=variant)
            abs_err, rel = errors(tuple(t.float() for t in got),
                                  tuple(t.float() for t in ref))
            ok = rel <= TOL_BF16 and got.re.dtype == torch.bfloat16
            if not ok:
                failures.append(f"{name}{shape} bf16 {variant} "
                                f"inverse={inverse}: {rel}")
            if (name, shape, variant, inverse) == (
                    "fft2d_gemm", MAIN_2D, "compensated", False):
                main_err["fft2d_gemm_bf16"] = abs_err
            emit({"phase": "kernel_vs_plain", "kernel": name,
                  "dtype": "bfloat16", "variant": variant, "shape": shape,
                  "inverse": inverse, "max_abs_err": abs_err,
                  "err_over_max": rel, "tol": TOL_BF16, "ok": ok})
            del x, got, ref
    torch.cuda.empty_cache()
    # decode attention: fp32 within the reference's 2e-5 absolute, bf16
    # within one bf16 ulp at the top of the range
    for i, (shape, window, ring, chunk) in enumerate(DECODE_CHECKS):
        case32 = decode_case(shape, window, ring, seed=100 + i)
        for case, tol in ((case32, TOL_DECODE), (as_bf16(case32), TOL_BF16)):
            got = DA.decode_attention_cuda(*case, window=window, chunk=chunk)
            torch.cuda.synchronize()
            ref = DA.decode_attention_plain(*case, window=window)
            abs_err, rel = errors(got.float(), ref.float())
            bf = case[0].dtype == torch.bfloat16
            ok = (rel if bf else abs_err) <= tol and got.dtype == ref.dtype \
                and bool(torch.isfinite(got).all())
            if not ok:
                failures.append(f"decode_attention{shape} window={window} "
                                f"{case[0].dtype}: {abs_err}")
            if bf and shape == STARCODER2[:5]:
                main_err["decode_attention"] = abs_err
            emit({"phase": "kernel_vs_plain", "kernel": "decode_attention",
                  "shape": shape, "window": window, "ring": ring,
                  "chunk": chunk, "dtype": str(case[0].dtype)[6:],
                  "route": DA.route(case[0].dtype, case[1].dtype, shape[4],
                                    shape[2] // shape[3]),
                  "max_abs_err": abs_err, "err_over_max": rel,
                  "tol": tol, "tol_is": "err_over_max" if bf else
                  "max_abs_err", "ok": ok})
            del got, ref
        del case32, case
        torch.cuda.empty_cache()

    # 4. main path through the registry
    clear_plan_cache()
    z16, z1 = rand(MAIN_2D), rand(MAIN_2D_SINGLE)
    za, zb = rand(MAIN_FOURSTEP), rand(MAIN_STOCKHAM)
    x16, x1 = from_numpy(z16, device=dev), from_numpy(z1, device=dev)
    xa, xb = from_numpy(za, device=dev), from_numpy(zb, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    y16 = fft2(x16, backend="cuda")
    back16 = fft2(y16, inverse=True, backend="cuda")
    y1 = fft2(x1, backend="cuda")
    back1 = fft2(y1, inverse=True, backend="cuda")
    yr = fft2(x1, algo="row_col", backend="cuda")   # two Stockham passes
    backr = fft2(yr, inverse=True, algo="row_col", backend="cuda")
    ys16 = fft2(x16, algo="fused_stockham", backend="cuda")   # the oracle
    backs16 = fft2(ys16, inverse=True, algo="fused_stockham", backend="cuda")
    ya = plan_fft(MAIN_FOURSTEP[1], backend="cuda")(xa)
    yb = plan_fft(MAIN_STOCKHAM[1], backend="cuda")(xb)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    p2 = get_plan(MAIN_2D[1:], backend="cuda")
    pa = plan_fft(MAIN_FOURSTEP[1], backend="cuda")
    pb = plan_fft(MAIN_STOCKHAM[1], backend="cuda")
    checks = {
        "fft2_b16_vs_numpy": np_errors(y16, np.fft.fft2(z16)),
        "fft2_b16_roundtrip": np_errors(back16, z16),
        "fft2_b1_vs_numpy": np_errors(y1, np.fft.fft2(z1)),
        "fft2_b1_roundtrip": np_errors(back1, z1),
        "fft2_row_col_b1_vs_numpy": np_errors(yr, np.fft.fft2(z1)),
        "fft2_row_col_b1_roundtrip": np_errors(backr, z1),
        "fft2_fused_stockham_b16_vs_numpy": np_errors(ys16, np.fft.fft2(z16)),
        "fft2_fused_stockham_b16_roundtrip": np_errors(backs16, z16),
        "fft_2^20_vs_numpy": np_errors(ya, np.fft.fft(za)),
        "fft_2^22_vs_numpy": np_errors(yb, np.fft.fft(zb)),
    }
    limits = {"fft2_b16_vs_numpy": TOL_NUMPY, "fft2_b1_vs_numpy": TOL_NUMPY,
              "fft2_b16_roundtrip": TOL_ROUNDTRIP,
              "fft2_b1_roundtrip": TOL_ROUNDTRIP,
              "fft2_row_col_b1_vs_numpy": TOL_NUMPY,
              "fft2_row_col_b1_roundtrip": TOL_ROUNDTRIP,
              "fft2_fused_stockham_b16_vs_numpy": TOL_NUMPY,
              "fft2_fused_stockham_b16_roundtrip": TOL_ROUNDTRIP,
              "fft_2^20_vs_numpy": TOL_1D, "fft_2^22_vs_numpy": TOL_1D}
    for k, v in checks.items():
        if not (v <= limits[k]):
            failures.append(f"main path {k}: {v} > {limits[k]}")
    if (p2.algo, p2.backend, p2.demote_reason) != ("fused", "cuda", None):
        failures.append(f"1024x1024 plan resolved to {p2}")
    if (pa.algo, pb.algo) != ("four_step", "stockham") or \
            pa.backend != "cuda" or pb.backend != "cuda":
        failures.append(f"1-D plans resolved to {pa}, {pb}")
    for k in C2C_KERNELS:
        if launches[k] <= 0:
            failures.append(f"kernel {k} was not launched on the main path")
    del x16, y16, back16, xa, ya, xb, yb, yr, backr, ys16, backs16
    torch.cuda.empty_cache()
    # a shape with no kernel path demotes to the torch backend
    zd = rand(DEMOTED_2D)
    yd = fft2(from_numpy(zd, device=dev), backend="cuda")
    pd = get_plan(DEMOTED_2D[1:], backend="cuda")
    reason = ("kernels need power-of-two tile dims >= 2, "
              f"got {DEMOTED_2D[1:]}")
    demote_err = np_errors(yd, np.fft.fft2(zd))
    if pd.backend != "torch" or pd.demote_reason != reason:
        failures.append(f"1000x1000 plan: {pd}")
    if not demote_err <= TOL_NUMPY:
        failures.append(f"1000x1000 torch path error {demote_err}")
    emit({"phase": "main_path", "launches": launches, "errors": checks,
          "limits": limits,
          "plans": {"fft2_1024": [p2.algo, p2.backend, p2.demote_reason],
                    "fft_2^20": [pa.algo, pa.backend],
                    "fft_2^22": [pb.algo, pb.backend]},
          "demoted_1000x1000": {"backend": pd.backend,
                                "demote_reason": pd.demote_reason,
                                "err_vs_numpy": demote_err}})

    # 4b. the real-input main path through the registry
    clear_plan_cache()
    zr16, zr1 = real(MAIN_RFFT2), real(MAIN_RFFT2_SINGLE)
    zra, zrb = real(MAIN_RFFT_FOURSTEP), real(MAIN_RFFT_STOCKHAM)
    zc = rand(MAIN_R2)
    xr16, xr1 = real_on_card(zr16), real_on_card(zr1)
    xra, xrb = real_on_card(zra), real_on_card(zrb)
    xc = from_numpy(zc, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    f16 = rfft2(xr16, backend="cuda")
    b16 = irfft2(f16, backend="cuda")
    f1 = rfft2(xr1, backend="cuda")
    b1 = irfft2(f1, backend="cuda")
    s1 = irfft2(f1, s=IRFFT2_S, backend="cuda")   # complex Nyquist after fit
    fa = rfft(xra, backend="cuda")                # inner four-step, 2^20
    ba = irfft(fa, backend="cuda")                # inner Stockham, 2^21
    fb = rfft(xrb, backend="cuda")                # inner Stockham, 2^22
    bb = irfft(fb, backend="cuda")                # inner Stockham, 2^23
    f2 = rfft2(xr1, algo="stockham2", backend="cuda")   # radix-2 row-column
    b2 = irfft2(f2, algo="stockham2", backend="cuda")
    p_r2 = plan_fft(MAIN_R2[1], algo="stockham2", backend="cuda")
    yc = p_r2(xc)
    torch.cuda.synchronize()
    launches_real = dict(ops.LAUNCHES)
    f1_np = to_numpy(f1)
    rchecks = {
        "rfft2_b16_vs_numpy": np_errors(f16, np.fft.rfft2(zr16)),
        "irfft2_b16_roundtrip": np_errors(b16, zr16),
        "rfft2_b1_vs_numpy": np_errors(f1, np.fft.rfft2(zr1)),
        "irfft2_b1_roundtrip": np_errors(b1, zr1),
        "irfft2_s_vs_numpy": np_errors(s1, np.fft.irfft2(f1_np, s=IRFFT2_S)),
        "rfft_2^21_vs_numpy": np_errors(fa, np.fft.rfft(zra)),
        "irfft_2^21_roundtrip": np_errors(ba, zra),
        "rfft_2^23_vs_numpy": np_errors(fb, np.fft.rfft(zrb)),
        "irfft_2^23_roundtrip": np_errors(bb, zrb),
        "rfft2_stockham2_b1_vs_numpy": np_errors(f2, np.fft.rfft2(zr1)),
        "irfft2_stockham2_b1_roundtrip": np_errors(b2, zr1),
        "fft_stockham2_2^20_vs_numpy": np_errors(yc, np.fft.fft(zc)),
    }
    rlimits = {k: TOL_ROUNDTRIP if "roundtrip" in k else
               TOL_NUMPY if k.startswith(("rfft2", "irfft2")) else TOL_1D
               for k in rchecks}
    for k, v in rchecks.items():
        if not (v <= rlimits[k]):
            failures.append(f"real-input path {k}: {v} > {rlimits[k]}")
    rplans = {
        "rfft2_1024": get_plan(MAIN_RFFT2[1:], kind="rfft", backend="cuda"),
        "irfft2_1024": get_plan(MAIN_RFFT2[1:], kind="rfft", inverse=True,
                                backend="cuda"),
        "rfft_2^21": get_plan(MAIN_RFFT_FOURSTEP[1:], kind="rfft",
                              backend="cuda"),
        "irfft_2^21": get_plan(MAIN_RFFT_FOURSTEP[1:], kind="rfft",
                               inverse=True, backend="cuda"),
        "rfft_2^23": get_plan(MAIN_RFFT_STOCKHAM[1:], kind="rfft",
                              backend="cuda"),
        "fft_stockham2_2^20": p_r2}
    want = {"rfft2_1024": "fused", "irfft2_1024": "fused",
            "rfft_2^21": "four_step", "irfft_2^21": "stockham",
            "rfft_2^23": "stockham", "fft_stockham2_2^20": "stockham"}
    for k, p in rplans.items():
        if (p.algo, p.backend, p.demote_reason) != (want[k], "cuda", None):
            failures.append(f"{k} plan resolved to {p}")
    if p_r2.radix != 2:
        failures.append(f"stockham2 plan has radix {p_r2.radix}")
    for k in REAL_KERNELS:
        if launches_real[k] <= 0:
            failures.append(f"kernel {k} was not launched on the "
                            "real-input path")
    del xr16, f16, b16, xra, fa, ba, xrb, fb, bb, xc, yc
    torch.cuda.empty_cache()
    zd = real(DEMOTED_2D)
    yd = rfft2(real_on_card(zd), backend="cuda")
    pdr = get_plan(DEMOTED_2D[1:], kind="rfft", backend="cuda")
    reason = ("fused rfft kernel needs power-of-two dims >= 2, "
              f"got {DEMOTED_2D[1:]}")
    rdemote_err = np_errors(yd, np.fft.rfft2(zd))
    if pdr.backend != "torch" or pdr.demote_reason != reason:
        failures.append(f"1000x1000 rfft plan: {pdr}")
    if not rdemote_err <= TOL_NUMPY:
        failures.append(f"1000x1000 rfft torch path error {rdemote_err}")
    emit({"phase": "real_input_path", "launches": launches_real,
          "errors": rchecks, "limits": rlimits,
          "plans": {k: [p.algo, p.backend, p.radix, p.demote_reason]
                    for k, p in rplans.items()},
          "demoted_1000x1000": {"backend": pdr.backend,
                                "demote_reason": pdr.demote_reason,
                                "err_vs_numpy": rdemote_err}})

    # 4c. the spectral-convolution path: the fused conv kernel against its
    # plain version, then the conv entry points through the registry
    def conv_operands(shape, klead):
        m = shape[-1]
        x = real_on_card(real(shape))
        kf = from_numpy(rand(klead + (m // 2 + 1,)), device=dev)
        return x, C.pack_filter(kf, m, torch.float32)

    for shape, klead in CONV_CHECKS:
        x, ef = conv_operands(shape, klead)
        got = C.fftconv_fused_cuda(x, ef)
        torch.cuda.synchronize()
        ref = C.fftconv_fused_plain(x, ef)
        abs_err, rel = errors(got, ref)
        ok = rel <= TOL_CONV
        if not ok:
            failures.append(f"fftconv_fused{shape} bank {klead}: {rel}")
        if shape == MAIN_CONV:
            main_err["fftconv_fused"] = abs_err
        emit({"phase": "kernel_vs_plain", "kernel": "fftconv_fused",
              "shape": shape, "bank": klead,
              "schedule": "one_pass" if shape[-1] <= C.MAX_ONE_PASS
              else "multi_launch", "max_abs_err": abs_err,
              "err_over_max": rel, "tol": TOL_CONV, "ok": ok})
        del x, ef, got, ref
    torch.cuda.empty_cache()

    clear_plan_cache()
    L, K = SSM_X[-1], SSM_K[-1]
    m_ssm = 1 << (L + K - 2).bit_length()
    zx, zk = real(SSM_X), real(SSM_K)
    xs, ks = real_on_card(zx), real_on_card(zk)
    t11 = []
    for m in TABLE11_M + (DEMOTED_CONV_M,):
        zk11 = np.zeros((TABLE11_ROWS, m))
        zk11[:, :TABLE11_TAPS] = real((TABLE11_ROWS, TABLE11_TAPS))
        t11.append((m, real((TABLE11_ROWS, m)), zk11))
    zg, zgk = real(SSM_GRAD_X), real(SSM_K)
    zf = real(FNET_X)
    xf_mix = real_on_card(zf)
    torch.cuda.synchronize()
    ops.reset_launches()
    ys = [fft_conv(xs, ks, backend="cuda") for _ in range(4)]
    ssm_plan = get_plan((m_ssm,), kind="conv_causal", backend="cuda")
    stats = dict(FC.SPECTRUM_STATS.get(FC._spectrum_key(ssm_plan), {}))
    ys_full = fft_conv(xs, ks, causal=False, backend="cuda")
    yc = [circular_conv(real_on_card(zx11), real_on_card(zk11),
                        backend="cuda") for _, zx11, zk11 in t11]

    def conv_grads(backend):
        xg = real_on_card(zg).requires_grad_(True)
        kg = real_on_card(zgk).requires_grad_(True)
        loss = (fft_conv(xg, kg, backend=backend) ** 2).sum()
        return torch.autograd.grad(loss, (xg, kg))

    g_cuda = conv_grads("cuda")
    ym = fourier_mix(xf_mix, backend="cuda")
    torch.cuda.synchronize()
    launches_conv = dict(ops.LAUNCHES)
    g_torch = conv_grads("torch")

    def conv_ref(zx_, zk_, n, out_len):
        spec = np.fft.rfft(zx_, n) * np.fft.rfft(zk_, n)
        return np.fft.irfft(spec, n)[..., :out_len]

    def rel_norm(got, ref):
        d = to_numpy(got) - ref
        return float(np.linalg.norm(d) / np.linalg.norm(ref))

    cchecks = {"fft_conv_ssm_vs_numpy": rel_norm(
        ys[0], conv_ref(zx, zk, m_ssm, L))}
    cchecks["fft_conv_ssm_full_vs_numpy"] = rel_norm(
        ys_full, conv_ref(zx, zk, m_ssm, L + K - 1))
    cchecks["fft_conv_ssm_repeat_equal"] = max(
        float((y - ys[0]).abs().max().item()) for y in ys[1:])
    for (m, zx11, zk11), y in zip(t11, yc):
        cchecks[f"circular_conv_64x{m}_vs_numpy"] = rel_norm(
            y, conv_ref(zx11, zk11, m, m))
    for name, a, b in zip(("x", "k"), g_cuda, g_torch):
        cchecks[f"grad_{name}_cuda_vs_torch"] = errors(a, b)[1]
    cchecks["fourier_mix_vs_numpy"] = np_errors(
        ym, np.real(np.fft.fft2(zf)))
    climits = {k: TOL_GRAD if k.startswith("grad") else
               0.0 if k.endswith("repeat_equal") else
               TOL_1D if k.startswith("fourier") else TOL_CONV_NUMPY
               for k in cchecks}
    for k, v in cchecks.items():
        if not (v <= climits[k]):
            failures.append(f"conv path {k}: {v} > {climits[k]}")
    cplans = {"conv_causal_ssm": ssm_plan}
    for m, _, _ in t11:
        cplans[f"conv_circular_{m}"] = get_plan((m,), kind="conv_circular",
                                                backend="cuda")
    reason = ("fused conv kernel needs a power-of-two FFT length "
              f">= 4, got {DEMOTED_CONV_M}")
    for k, p in cplans.items():
        want = (("unfused", "torch", reason) if k.endswith(
            f"_{DEMOTED_CONV_M}") else ("fused", "cuda", None))
        if (p.algo, p.backend, p.demote_reason) != want:
            failures.append(f"{k} plan resolved to {p}")
    if stats != {"computes": 1, "hits": 3}:
        failures.append(f"spectrum cache at the SSM key: {stats}")
    for k in CONV_KERNELS:
        if launches_conv[k] <= 0:
            failures.append(f"kernel {k} was not launched on the conv path")
    emit({"phase": "conv_path", "launches": launches_conv, "errors": cchecks,
          "limits": climits, "spectrum_stats_ssm": stats,
          "plans": {k: [p.algo, p.backend, p.block_batch, p.demote_reason]
                    for k, p in cplans.items()}})
    del xs, ys, ys_full, yc, g_cuda, g_torch, ym, xf_mix
    torch.cuda.empty_cache()

    # 4d. the volume path: fft3 through the registry at the DNS slab and
    # the PME grid, the row_col baseline, bf16, and a shape that demotes
    clear_plan_cache()
    zv, zp = rand(MAIN_3D), rand(PME_3D)
    xv, xp = from_numpy(zv, device=dev), from_numpy(zp, device=dev)
    xvb = bf16(xv)
    torch.cuda.synchronize()
    ops.reset_launches()
    yv = fft3(xv, backend="cuda")
    backv = fft3(yv, inverse=True, backend="cuda")
    yp = fft3(xp, backend="cuda")
    backp = fft3(yp, inverse=True, backend="cuda")
    yrc = fft3(xv, algo="row_col", backend="cuda")   # three Stockham passes
    yvb = fft3(xvb, backend="cuda")                  # bf16: compensated
    torch.cuda.synchronize()
    launches_vol = dict(ops.LAUNCHES)
    fv = np.fft.fftn(zv, axes=(-3, -2, -1))
    fp = np.fft.fftn(zp, axes=(-3, -2, -1))
    vchecks = {"fft3_256^3x2_vs_numpy": np_rel_norm(yv, fv),
               "fft3_256^3x2_roundtrip": np_errors(backv, zv),
               "fft3_128^3x8_vs_numpy": np_rel_norm(yp, fp),
               "fft3_128^3x8_roundtrip": np_errors(backp, zp),
               "fft3_row_col_256^3x2_vs_numpy": np_rel_norm(yrc, fv),
               "fft3_bf16_256^3x2_vs_numpy": np_rel_norm(yvb, fv)}
    del fp
    vlimits = {k: TOL_ROUNDTRIP if "roundtrip" in k else
               TOL_BF16_NUMPY if "bf16" in k else TOL_3D_NUMPY
               for k in vchecks}
    for k, v in vchecks.items():
        if not (v <= vlimits[k]):
            failures.append(f"volume path {k}: {v} > {vlimits[k]}")
    if yvb.re.dtype != torch.bfloat16:
        failures.append(f"bf16 fft3 returned {yvb.re.dtype}")
    vplans = {"fft3_256^3": get_plan(MAIN_3D[1:], backend="cuda"),
              "fft3_128^3": get_plan(PME_3D[1:], backend="cuda"),
              "fft3_256^3_bf16": get_plan(MAIN_3D[1:], dtype=torch.bfloat16,
                                          backend="cuda")}
    vwant = {"fft3_256^3": "plain", "fft3_128^3": "plain",
             "fft3_256^3_bf16": "compensated"}
    for k, pl in vplans.items():
        if (pl.algo, pl.backend, pl.variant, pl.demote_reason) != \
                ("fused", "cuda", vwant[k], None):
            failures.append(f"{k} plan resolved to {pl}")
    for k in VOLUME_KERNELS:
        if launches_vol[k] <= 0:
            failures.append(f"kernel {k} was not launched on the volume "
                            "path")
    del xv, yv, backv, xp, yp, backp, yrc, xvb, yvb
    torch.cuda.empty_cache()
    zd = rand(DEMOTED_3D)
    yd = fft3(from_numpy(zd, device=dev), backend="cuda")
    pd3 = get_plan(DEMOTED_3D[1:], backend="cuda")
    reason = ("kernels need power-of-two tile dims >= 2, "
              f"got {DEMOTED_3D[1:]}")
    vdemote_err = np_errors(yd, np.fft.fftn(zd, axes=(-3, -2, -1)))
    if (pd3.backend, pd3.algo, pd3.demote_reason) != ("torch", "row_col",
                                                      reason):
        failures.append(f"{DEMOTED_3D[1:]} plan: {pd3}")
    if not vdemote_err <= TOL_NUMPY:
        failures.append(f"{DEMOTED_3D[1:]} torch path error {vdemote_err}")
    emit({"phase": "volume_path", "launches": launches_vol,
          "errors": vchecks, "limits": vlimits,
          "plans": {k: [pl.algo, pl.backend, pl.variant, pl.demote_reason]
                    for k, pl in vplans.items()},
          "demoted_96x128x128": {"backend": pd3.backend,
                                 "demote_reason": pd3.demote_reason,
                                 "err_vs_numpy": vdemote_err}})
    del zd, yd
    torch.cuda.empty_cache()

    # 4e. bf16 images: fft2 on 16 1024^2 bf16 images, compensated through
    # the registry and plain by explicit variant, against float64 numpy of
    # the unrounded input (as the reference's bound is stated)
    clear_plan_cache()
    zb = rand(MAIN_2D)
    xb = bf16(from_numpy(zb, device=dev))
    plain_plan = get_plan(MAIN_2D[1:], dtype=torch.bfloat16, backend="cuda",
                          variant="plain")
    torch.cuda.synchronize()
    ops.reset_launches()
    yb_c = fft2(xb, backend="cuda")
    yb_p = plain_plan(xb)
    backb = fft2(yb_c, inverse=True, backend="cuda")
    torch.cuda.synchronize()
    launches_bf16 = dict(ops.LAUNCHES)
    fb = np.fft.fft2(zb)
    bchecks = {"fft2_bf16_compensated_vs_numpy": np_rel_norm(yb_c, fb),
               "fft2_bf16_plain_vs_numpy": np_rel_norm(yb_p, fb),
               "fft2_bf16_compensated_roundtrip": np_rel_norm(backb, zb)}
    blimits = {"fft2_bf16_compensated_vs_numpy": TOL_BF16_NUMPY}
    for k, v in blimits.items():
        if not (bchecks[k] <= v):
            failures.append(f"bf16 path {k}: {bchecks[k]} > {v}")
    if not all(np.isfinite(v) for v in bchecks.values()):
        failures.append(f"bf16 path: non-finite errors {bchecks}")
    comp_plan = get_plan(MAIN_2D[1:], dtype=torch.bfloat16, backend="cuda")
    bplans = {"fft2_1024_bf16": comp_plan, "fft2_1024_bf16_plain": plain_plan}
    for k, want in (("fft2_1024_bf16", "compensated"),
                    ("fft2_1024_bf16_plain", "plain")):
        pl = bplans[k]
        if (pl.algo, pl.backend, pl.variant) != ("fused", "cuda", want):
            failures.append(f"{k} plan resolved to {pl}")
    if launches_bf16["fft2d_gemm"] <= 0:
        failures.append("kernel fft2d_gemm was not launched on the bf16 "
                        "path")
    for y in (yb_c, yb_p, backb):
        if y.re.dtype != torch.bfloat16:
            failures.append(f"bf16 fft2 returned {y.re.dtype}")
    emit({"phase": "bf16_path", "launches": launches_bf16,
          "errors": bchecks, "limits": blimits,
          "plans": {k: [pl.algo, pl.backend, pl.variant]
                    for k, pl in bplans.items()}})
    del xb, yb_c, yb_p, backb
    torch.cuda.empty_cache()

    # 4f. the paper's Table 1 ladder: the per-stage "Initial" kernel forward
    # and inverse (a round trip) at Table 1's size and at a loaded batch,
    # and the same inputs through the port's other rungs
    clear_plan_cache()
    t1_z = {shape: rand(shape) for shape in (TABLE1, TABLE1_LOADED)}
    t1_x = {shape: from_numpy(z, device=dev) for shape, z in t1_z.items()}
    rungs = {
        "initial_two_reorder": lambda x: fft_cooley_tukey(
            x, variant="two_reorder"),
        "single_copy_one_reorder": lambda x: fft_cooley_tukey(
            x, variant="one_reorder"),
        "stockham_kernel": lambda x: ops.fft_stockham(x),
        "auto_torch_backend": lambda x: fft(x, algo="auto"),
        "auto_cuda_backend": lambda x: plan_fft(x.shape[-1],
                                                backend="cuda")(x)}
    torch.cuda.synchronize()
    ops.reset_launches()
    t1_out = {}
    for shape, x in t1_x.items():
        y = ops.fft_staged(x)
        t1_out[shape, "staged"] = y
        t1_out[shape, "staged_roundtrip"] = ops.fft_staged(y, inverse=True)
        for name, fn in rungs.items():
            t1_out[shape, name] = fn(x)
    torch.cuda.synchronize()
    launches_t1 = dict(ops.LAUNCHES)
    t1checks = {}
    for shape, z in t1_z.items():
        want = np.fft.fft(z)
        tag = f"{shape[0]}x{shape[1]}"
        for name in ("staged",) + tuple(rungs):
            t1checks[f"{name}_{tag}_vs_numpy"] = np_errors(
                t1_out[shape, name], want)
        t1checks[f"staged_{tag}_roundtrip"] = np_errors(
            t1_out[shape, "staged_roundtrip"], z)
    t1limits = {k: TOL_ROUNDTRIP if "roundtrip" in k else TOL_1D
                for k in t1checks}
    for k, v in t1checks.items():
        if not (v <= t1limits[k]):
            failures.append(f"table1 path {k}: {v} > {t1limits[k]}")
    p_t1 = plan_fft(TABLE1[1], backend="cuda")
    if (p_t1.algo, p_t1.backend) != ("four_step", "cuda"):
        failures.append(f"16384-point cuda plan resolved to {p_t1}")
    if launches_t1["fft_staged"] != 4:
        failures.append(f"fft_staged counted {launches_t1['fft_staged']} "
                        "launches for 4 calls")
    for k in TABLE1_KERNELS:
        if launches_t1[k] <= 0:
            failures.append(f"kernel {k} was not launched on the table1 "
                            "path")
    emit({"phase": "table1_path", "launches": launches_t1,
          "errors": t1checks, "limits": t1limits,
          "plans": {"fft_16384_cuda": [p_t1.algo, p_t1.backend]}})
    del t1_out
    torch.cuda.empty_cache()

    # 4g. the decode path: one decode step's attention for one layer of each
    # cell in bf16 (the cells' dtype) and fp32, and the danube cell at
    # chunk 64; bf16 against the plain version, fp32 against float64 numpy
    dec = {name: decode_case(c[:5], c[5], c[6], seed=7 + i)
           for i, (name, c) in enumerate(DECODE_CELLS.items())}
    dec16 = {name: as_bf16(case) for name, case in dec.items()}
    torch.cuda.synchronize()
    ops.reset_launches()
    dec_out = {}
    for name, c in DECODE_CELLS.items():
        dec_out[name, "bf16"] = ops.decode_attention(*dec16[name],
                                                     window=c[5])
        dec_out[name, "fp32"] = ops.decode_attention(*dec[name],
                                                     window=c[5])
    dec_out["chunk64"] = ops.decode_attention(
        *dec["h2o-danube-1.8b"], window=DANUBE[5], chunk=64)
    torch.cuda.synchronize()
    launches_dec = dict(ops.LAUNCHES)
    dchecks, dlimits = {}, {}
    for name, c in DECODE_CELLS.items():
        got = dec_out[name, "bf16"]
        ref = DA.decode_attention_plain(*dec16[name], window=c[5])
        dchecks[f"{name}_bf16_vs_plain"] = errors(got.float(),
                                                  ref.float())[1]
        dlimits[f"{name}_bf16_vs_plain"] = TOL_BF16
        if got.dtype != torch.bfloat16:
            failures.append(f"decode {name} bf16 returned {got.dtype}")
        want = decode_numpy(dec[name], c[5])
        dchecks[f"{name}_fp32_vs_numpy"] = float(
            np.abs(to_numpy(dec_out[name, "fp32"]) - want).max())
        dlimits[f"{name}_fp32_vs_numpy"] = TOL_DECODE
        del ref, want
    dchecks["h2o-danube-1.8b_chunk64_vs_chunk512"] = float(
        (dec_out["chunk64"] - dec_out["h2o-danube-1.8b", "fp32"])
        .abs().max().item())
    dlimits["h2o-danube-1.8b_chunk64_vs_chunk512"] = TOL_DECODE
    empty_row = dec_out["h2o-danube-1.8b", "fp32"][-1]
    v_mean = dec["h2o-danube-1.8b"][2][-1].double().mean(dim=0)
    dchecks["h2o-danube-1.8b_empty_row_vs_mean_v"] = float(
        (empty_row.double() - v_mean.repeat_interleave(
            DANUBE[2] // DANUBE[3], dim=0)).abs().max().item())
    dlimits["h2o-danube-1.8b_empty_row_vs_mean_v"] = TOL_DECODE
    for k, v in dchecks.items():
        if not (v <= dlimits[k]):
            failures.append(f"decode path {k}: {v} > {dlimits[k]}")
    if launches_dec["decode_attention"] != 5:
        failures.append(f"decode_attention counted "
                        f"{launches_dec['decode_attention']} launches for "
                        "5 calls")
    emit({"phase": "decode_path", "launches": launches_dec,
          "errors": dchecks, "limits": dlimits,
          "cells": {name: dict(zip(("B", "S", "H", "KV", "D", "window",
                                    "ring"), c))
                    for name, c in DECODE_CELLS.items()},
          "visible": {name: visibility(dec[name], c[5])
                      for name, c in DECODE_CELLS.items()}})
    del dec_out, dec
    torch.cuda.empty_cache()

    # 4h. the long axes through the entry points: fft2/ifft2 (the fused
    # route and the fused_stockham oracle), rfft2/irfft2 and fft3 with an
    # axis past 4096; the four-step plans whose factors pass 1024 and
    # ops.fft_fourstep at explicit factors; radix 2 past 2^24
    clear_plan_cache()
    lz = {s_: rand(s_) for s_ in LONG_2D + LONG_3D}
    lr = {s_: real(s_) for s_ in LONG_2D}
    lx = {s_: from_numpy(z, device=dev) for s_, z in lz.items()}
    lxr = {s_: real_on_card(z) for s_, z in lr.items()}
    fz = {(s_, n1): rand(s_) for s_, n1, _ in FOURSTEP_FACTORS}
    fx = {k: from_numpy(z, device=dev) for k, z in fz.items()}
    r2z = rand(R2_STAGES)
    r2x = from_numpy(r2z, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    lout = {}
    for s_ in LONG_2D:
        lout[s_, "fft2"] = fft2(lx[s_], backend="cuda")
        lout[s_, "ifft2"] = fft2(lx[s_], inverse=True, backend="cuda")
        lout[s_, "fft2_stockham"] = fft2(lx[s_], algo="fused_stockham",
                                         backend="cuda")
        lout[s_, "ifft2_stockham"] = fft2(lx[s_], inverse=True,
                                          algo="fused_stockham",
                                          backend="cuda")
        lout[s_, "rfft2"] = rfft2(lxr[s_], backend="cuda")
        lout[s_, "irfft2"] = irfft2(lout[s_, "rfft2"], s=s_[1:],
                                    backend="cuda")
    for s_ in LONG_3D:
        lout[s_, "fft3"] = fft3(lx[s_], backend="cuda")
        lout[s_, "ifft3"] = fft3(lx[s_], inverse=True, backend="cuda")
    fplans = {}
    for s_, n1, how in FOURSTEP_FACTORS:
        if how == "plan":
            fplans[s_] = get_plan(s_[1:], algo="four_step", backend="cuda")
            lout[s_, n1] = fplans[s_](fx[s_, n1])
        else:
            lout[s_, n1] = ops.fft_fourstep(fx[s_, n1], n1=n1)
    p_r2s = plan_fft(R2_STAGES[1], algo="stockham2", backend="cuda")
    lout["r2"] = p_r2s(r2x)
    lout["r2_inverse"] = plan_fft(R2_STAGES[1], algo="stockham2",
                                  inverse=True, backend="cuda")(r2x)
    torch.cuda.synchronize()
    launches_long = dict(ops.LAUNCHES)
    lchecks, llimits = {}, {}
    for s_ in LONG_2D:
        tag = "x".join(map(str, s_))
        z, zr_ = lz[s_], lr[s_]
        for k, want in (("fft2", np.fft.fft2(z)), ("ifft2", np.fft.ifft2(z)),
                        ("fft2_stockham", np.fft.fft2(z)),
                        ("ifft2_stockham", np.fft.ifft2(z)),
                        ("rfft2", np.fft.rfft2(zr_)), ("irfft2", zr_)):
            lchecks[f"{k}_{tag}_vs_numpy"] = np_errors(lout[s_, k], want)
            llimits[f"{k}_{tag}_vs_numpy"] = TOL_NUMPY
    for s_ in LONG_3D:
        tag = "x".join(map(str, s_))
        z = lz[s_]
        for k, want in (("fft3", np.fft.fftn(z, axes=(-3, -2, -1))),
                        ("ifft3", np.fft.ifftn(z, axes=(-3, -2, -1)))):
            lchecks[f"{k}_{tag}_vs_numpy"] = np_rel_norm(lout[s_, k], want)
            llimits[f"{k}_{tag}_vs_numpy"] = TOL_3D_NUMPY
    for s_, n1, how in FOURSTEP_FACTORS:
        tag = f"{s_[0]}x{s_[1]}_n1={n1}"
        got = lout[s_, n1]
        lchecks[f"fourstep_{tag}_vs_numpy"] = np_errors(got,
                                                        np.fft.fft(fz[s_, n1]))
        llimits[f"fourstep_{tag}_vs_numpy"] = TOL_1D
        lchecks[f"fourstep_{tag}_vs_plain"] = errors(
            got, F.fft_fourstep_plain(fx[s_, n1], n1=n1))[1]
        llimits[f"fourstep_{tag}_vs_plain"] = TOL_1D
    lchecks["stockham2_2^25_vs_numpy"] = np_errors(lout["r2"],
                                                   np.fft.fft(r2z))
    lchecks["stockham2_2^25_inverse_vs_numpy"] = np_errors(
        lout["r2_inverse"], np.fft.ifft(r2z))
    r2_plain = S.fft_stockham_r2_plain(r2x)
    lchecks["stockham2_2^25_vs_plain"] = errors(lout["r2"], r2_plain)[1]
    main_err["fft_stockham_r2_stages"] = errors(lout["r2"], r2_plain)[0]
    del r2_plain
    for k in ("stockham2_2^25_vs_numpy", "stockham2_2^25_inverse_vs_numpy",
              "stockham2_2^25_vs_plain"):
        llimits[k] = TOL_1D
    for k, v in lchecks.items():
        if not (v <= llimits[k]):
            failures.append(f"long-axis path {k}: {v} > {llimits[k]}")
    lplans = {f"fft2_{'x'.join(map(str, s_[1:]))}":
              get_plan(s_[1:], backend="cuda") for s_ in LONG_2D}
    lplans.update({f"rfft2_{'x'.join(map(str, s_[1:]))}":
                   get_plan(s_[1:], kind="rfft", backend="cuda")
                   for s_ in LONG_2D})
    lplans.update({f"fft3_{'x'.join(map(str, s_[1:]))}":
                   get_plan(s_[1:], backend="cuda") for s_ in LONG_3D})
    for k, pl in lplans.items():
        if (pl.algo, pl.backend, pl.demote_reason) != ("fused", "cuda",
                                                       None):
            failures.append(f"{k} plan resolved to {pl}")
    for s_, pl in fplans.items():
        if (pl.algo, pl.backend, pl.demote_reason) != ("four_step", "cuda",
                                                       None):
            failures.append(f"four-step plan at {s_} resolved to {pl}")
    if (p_r2s.algo, p_r2s.backend, p_r2s.radix) != ("stockham", "cuda", 2):
        failures.append(f"stockham2 plan at 2^25 resolved to {p_r2s}")
    for k in LONG_KERNELS:
        if launches_long[k] <= 0:
            failures.append(f"kernel {k} was not launched on the long-axis "
                            "path")
    emit({"phase": "long_axis_path", "launches": launches_long,
          "errors": lchecks, "limits": llimits,
          "plans": {k: [pl.algo, pl.backend, pl.demote_reason]
                    for k, pl in lplans.items()},
          "fourstep_factors": {str(s_): list(F.kernel_factors(s_[1], n1))
                               + [F.kernel_route(s_[1], n1)]
                               for s_, n1, _ in FOURSTEP_FACTORS},
          "split_factors": {str(s_): [list(AX.split_factors(n))
                                      for n in s_[1:]]
                            for s_ in LONG_2D + LONG_3D}})
    del lx, lxr, lout, fx, r2x
    S.tw.packed_radix2_twiddles_np.cache_clear()
    S.tw.clear_table_cache()
    torch.cuda.empty_cache()

    # 4i. bf16 planes on the 1-D, real-input, conv, stage and fused
    # Stockham kernels: kernel and plain version against float64 numpy of
    # the bf16-rounded input
    def bf16_case(name, shape):
        """(kernel call, plain call, bf16 input, float64 numpy output)."""
        if name in ("rfft2d_fused", "irfft2d_fused"):
            b, h, w = shape
            if name == "rfft2d_fused":
                x = real_on_card(real(shape)).bfloat16()
                xn = x.double().cpu().numpy()
                return (R.rfft2d_fused_cuda, R.rfft2d_fused_plain, x,
                        np.fft.rfft2(xn))
            x = bf16(from_numpy(rand((b, h, w // 2 + 1)), device=dev))
            xn = to_numpy(x)
            return (R.irfft2d_fused_cuda, R.irfft2d_fused_plain, x,
                    np.fft.irfft2(xn, s=(h, w)))
        if name == "fftconv_fused":
            m = shape[-1]
            x = real_on_card(real(shape)).bfloat16()
            zk = rand((shape[1], m // 2 + 1))
            zk[:, 0] = zk[:, 0].real
            zk[:, -1] = zk[:, -1].real
            ef = C.pack_filter(from_numpy(zk, device=dev), m,
                               torch.bfloat16)
            want = np.fft.irfft(np.fft.rfft(x.double().cpu().numpy()) * zk,
                                m)
            return (lambda t: C.fftconv_fused_cuda(t, ef),
                    lambda t: C.fftconv_fused_plain(t, ef), x, want)
        x = bf16(from_numpy(rand(shape), device=dev))
        xn = to_numpy(x)
        fns = {"fft_stockham": (S.fft_stockham_cuda, S.fft_stockham_plain),
               "fft_stockham_r2": (S.fft_stockham_r2_cuda,
                                   S.fft_stockham_r2_plain),
               "fft_fourstep": (F.fft_fourstep_cuda, F.fft_fourstep_plain),
               "fft_staged": (ST.fft_staged_cuda, ST.fft_staged_plain),
               "fft2d_fused": (S2.fft2d_fused_cuda, S2.fft2d_fused_plain)}
        want = np.fft.fft2(xn) if name == "fft2d_fused" else np.fft.fft(xn)
        return (*fns[name], x, want)

    for name, shape in BF16_F4:
        kern, plain, x, want = bf16_case(name, shape)
        got = kern(x)
        torch.cuda.synchronize()
        pl = plain(x)
        scale = float(np.abs(want).max())
        k_err = float(np.abs(to_numpy(got) - want).max()) / scale
        p_err = float(np.abs(to_numpy(pl) - want).max()) / scale
        dtype = (got.re if isinstance(got, SplitComplex) else got).dtype
        ok = (k_err <= TOL_BF16_REF and k_err <= p_err + BF16_SLACK
              and dtype == torch.bfloat16)
        if not ok:
            failures.append(f"{name}{shape} bf16: {k_err} (plain {p_err})")
        if shape in (MAIN_SHAPE.get(name), MAIN_CONV, TABLE1):
            main_err[f"{name}_bf16"] = k_err * scale
        emit({"phase": "kernel_vs_numpy", "kernel": name,
              "dtype": "bfloat16", "shape": shape, "err_over_max": k_err,
              "plain_err_over_max": p_err, "tol": TOL_BF16_REF,
              "tol_vs_plain": p_err + BF16_SLACK, "ok": ok})
        del x, got, pl, want
        torch.cuda.empty_cache()

    # 4j. every plan call above ran through the guarded executor: none may
    # have fallen back (a fallback would have hidden a kernel)
    stats = rexec.stats()
    hidden = {str(k): v for k, v in stats.items()
              if v["failures"] or v["fallbacks"] or v["short_circuits"]}
    if hidden:
        failures.append(f"the guarded executor fell back: {hidden}")
    emit({"phase": "guarded_executor", "cuda_keys": len(stats),
          "attempts": sum(v["attempts"] for v in stats.values()),
          "fell_back": hidden})

    # 4k. the serving path: a threaded, pre-warmed SpectralServer on the
    # card, a seeded closed loop over the four buckets, every spectrum held
    # to float64 numpy of its (padded) input
    clear_plan_cache()
    resilience.reset()
    S.tw.clear_table_cache()          # pre-warm uploads the tables again
    buckets = [BucketConfig(s, kind=k, inverse=i, max_batch=b)
               for s, k, i, b in SERVE_BUCKETS]
    mix = [MixItem(s, k, inverse=i, weight=w) for s, k, i, w in SERVE_MIX]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    srv = SpectralServer(buckets, unmatched="pad_up", device=dev)
    startup_s = time.perf_counter() - t0
    records = {}
    result = srv.result

    def keep(rid, timeout=None):
        """The server's result() with a bound on the wait, keeping every
        record for the checks below."""
        rec = result(rid, timeout=SERVE_WAIT_S if timeout is None
                     else timeout)
        if rec is None:
            raise RuntimeError(f"request {rid!r} not done in "
                               f"{SERVE_WAIT_S} s")
        records[rid] = rec
        return rec

    srv.result = keep
    summary = closed_loop(srv, mix, requests=SERVE_REQUESTS,
                          concurrency=SERVE_CONCURRENCY, seed=SERVE_SEED,
                          rid_prefix="serve")
    # one request a bucket, served again by the degraded server below
    probe_rng = np.random.default_rng(SERVE_SEED + 1)
    probes = {b.label: make_payload(probe_rng, MixItem(b.shape, b.kind,
                                                       inverse=b.inverse))
              for b in buckets}
    for b in buckets:
        srv.submit(("probe", b.label), probes[b.label], kind=b.kind,
                   inverse=b.inverse)
    healthy = {lbl: keep(("probe", lbl)).value for lbl in probes}
    snap = srv.snapshot()
    threads = list(srv.executor._threads)
    closed = srv.close(timeout_s=SERVE_WAIT_S)
    torch.cuda.synchronize()
    launches_serve = dict(ops.LAUNCHES)
    orphans = srv._n_outstanding() + len(srv._done)
    if not closed or orphans or any(t.is_alive() for t in threads):
        failures.append(f"serve_path: close() {closed}, {orphans} requests "
                        "left, pipeline threads alive: "
                        f"{[t.name for t in threads if t.is_alive()]}")
    if srv.degraded_buckets or snap["totals"]["fallback_served"]:
        failures.append(f"serve_path: degraded {srv.degraded_buckets}, "
                        f"{snap['totals']['fallback_served']} served by a "
                        "fallback")
    for k in SERVE_KERNELS:
        if launches_serve[k] <= 0:
            failures.append(f"kernel {k} was not launched on the serve "
                            "path")
    # replay the closed loop's seeded draws: the same items and payloads
    replay = np.random.default_rng(SERVE_SEED)
    serve_err, lat, t_payload = {}, {}, 0.0
    for i in range(SERVE_REQUESTS):
        t1 = time.perf_counter()
        item = _pick(replay, mix)
        payload = make_payload(replay, item)
        t_payload += time.perf_counter() - t1
        rec = records.get(f"serve-{SERVE_SEED}-{i}")
        if rec is None or rec.status != "completed":
            failures.append(f"serve_path request {i}: "
                            f"{None if rec is None else rec.status}")
            continue
        bshape = srv.states[rec.bucket].cfg.shape
        want = serve_reference(payload, item.kind, item.inverse, bshape)
        err = float(np.abs(host_value(rec.value) - want).max()
                    / np.abs(want).max())
        tol = TOL_1D if len(bshape) == 1 else TOL_NUMPY
        if not err <= tol:
            failures.append(f"serve_path request {i} ({rec.bucket}, padded "
                            f"{rec.padded}): {err} > {tol}")
        lbl = rec.bucket + ("/padded" if rec.padded else "")
        serve_err[lbl] = max(serve_err.get(lbl, 0.0), err)
        lat.setdefault(rec.bucket, []).append(rec.latency_s * 1e3)
    del records
    buckets_out = {}
    for lbl, sec in snap["buckets"].items():
        if lbl not in lat:
            continue
        ms = np.asarray(lat[lbl])
        buckets_out[lbl] = {
            "completed": sec["counters"]["completed"],
            "padded_up": sec["counters"]["padded_up"],
            "batches": sec["counters"]["batches"],
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "occupancy_mean": sec["gauges"]["batch_occupancy"]["mean"],
            "queue_mean_ms": sec["latency"]["queue"]["mean_ms"],
            "service_mean_ms": sec["latency"]["service"]["mean_ms"],
            "plan": [sec["plan_backend"], sec["plan_algo"]],
            "prewarm_s": sec["prewarm_compile_s"]}
    rep = srv.prewarm_report
    emit({"phase": "serve_path", "launches": launches_serve,
          "requests": SERVE_REQUESTS, "concurrency": SERVE_CONCURRENCY,
          "requests_per_s": summary["achieved_qps"],
          "p50_ms": summary["p50_ms"], "p99_ms": summary["p99_ms"],
          "wall_s": summary["wall_s"],
          "client_payload_s": t_payload,
          "startup_s": startup_s, "prewarm_s": rep.total_s,
          "build_s_apart": build_s, "buckets": buckets_out,
          "err_over_max": serve_err,
          "limits": {"2-D": TOL_NUMPY, "1-D": TOL_1D},
          "fallback_served": snap["totals"]["fallback_served"],
          "degraded": srv.degraded_buckets, "nvidia_smi": smi})

    # one bucket tuned on the card, its winner saved as wisdom and loaded
    # back into a fresh registry: the second server does not measure
    clear_plan_cache()
    tb = BucketConfig(SERVE_BUCKETS[0][0], max_batch=16)
    with SpectralServer([tb], threaded=False, tune=True, tune_batch=16,
                        device=dev) as tsrv:
        tplan = tsrv.states[tb.label].plan
        tsrv.submit("tuned", probes[tb.label])
        tsrv.drain(timeout_s=SERVE_WAIT_S)
        trec = tsrv.result("tuned", timeout=SERVE_WAIT_S)
    tuned_err = None
    if trec is not None and trec.status == "completed":
        want = serve_reference(probes[tb.label], "c2c", False, tb.shape)
        tuned_err = float(np.abs(host_value(trec.value) - want).max()
                          / np.abs(want).max())
    runs_tuned = autotune_count(tb.shape, backend="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        wpath = str(Path(tmp) / "wisdom.json")
        saved = save_wisdom(wpath)
        clear_plan_cache()
        loaded = load_wisdom(wpath)
    with SpectralServer([tb], threaded=False, tune=True, tune_batch=16,
                        prewarm=False, device=dev) as wsrv:
        wplan = wsrv.states[tb.label].plan
    runs_wisdom = autotune_count(tb.shape, backend="cuda")
    if not (tplan.tuned and runs_tuned == 1 and saved == 1 and loaded == 1
            and runs_wisdom == 0
            and wplan.tune_report.get("source") == "wisdom"
            and (wplan.algo, wplan.block_batch, wplan.variant)
            == (tplan.algo, tplan.block_batch, tplan.variant)):
        failures.append(f"tune/wisdom: runs {runs_tuned} then "
                        f"{runs_wisdom}, saved {saved}, loaded {loaded}, "
                        f"{tplan} vs {wplan}")
    if tuned_err is None or not tuned_err <= TOL_NUMPY:
        failures.append(f"tuned bucket's spectrum: {tuned_err}")
    emit({"phase": "serve_tune", "bucket": tb.label,
          "tune_report_us": tplan.tune_report,
          "winner": [tplan.algo, tplan.block_batch, tplan.variant],
          "err_over_max": tuned_err, "autotune_runs": runs_tuned,
          "wisdom_saved": saved, "wisdom_loaded": loaded,
          "autotune_runs_after_wisdom": runs_wisdom,
          "note": "the CUDA kernels take no batch tile: the bb candidates "
                  "time the same launches", "nvidia_smi": smi})

    # the same buckets behind a serve.prewarm fault: every bucket comes up
    # degraded (its torch twin, on the card) and serves the probes within
    # 1e-6 of max|healthy| (the reference's BENCH_serve.json criterion)
    clear_plan_cache()
    with rfaults.inject("serve.prewarm", "error", times=None):
        dsrv = SpectralServer(buckets, unmatched="pad_up", device=dev)
    with dsrv:
        for b in buckets:
            dsrv.submit(("probe", b.label), probes[b.label], kind=b.kind,
                        inverse=b.inverse)
        degraded = {lbl: dsrv.result(("probe", lbl), timeout=SERVE_WAIT_S)
                    for lbl in probes}
        dsnap = dsrv.snapshot()
        dlabels = dsrv.degraded_buckets
    degrade_err = {}
    for lbl, rec in degraded.items():
        if rec is None or rec.status != "completed":
            failures.append(f"degraded server {lbl}: {rec}")
            continue
        h = host_value(healthy[lbl])
        degrade_err[lbl] = float(np.abs(host_value(rec.value) - h).max()
                                 / max(1.0, np.abs(h).max()))
        if not degrade_err[lbl] <= TOL_DEGRADED:
            failures.append(f"degraded server {lbl}: {degrade_err[lbl]} > "
                            f"{TOL_DEGRADED}")
    if sorted(dlabels) != sorted(probes):
        failures.append(f"degraded server: degraded {dlabels}")
    emit({"phase": "serve_degraded", "degraded": dlabels,
          "fallback_served": dsnap["totals"]["fallback_served"],
          "err_vs_healthy": degrade_err, "tol": TOL_DEGRADED})
    del healthy, degraded, probes
    torch.cuda.empty_cache()

    # 4l. the guarded executor on the card: an output fault, then a launch
    # fault, each three times; the breaker opens after failure_threshold
    # failures (the key demoted), cooldown_calls calls later the half-open
    # probe restores it, and every call's result is on the card within the
    # numpy bound
    clear_plan_cache()
    resilience.reset()
    hw = RESILIENCE_2D[1:]
    zg = rand(RESILIENCE_2D)
    xg = from_numpy(zg, device=dev)
    wantg = torch.from_numpy(np.fft.fft2(zg)).to(dev)
    scale_g = wantg.abs().max().item()
    key = _plan_key(hw, torch.float32, False, "cuda", "c2c")
    threshold = rconfig.get("failure_threshold")
    cooldown = rconfig.get("cooldown_calls")
    want_states = ["closed"] * (threshold - 1) + ["open"] * cooldown + \
        ["closed"]
    torch.cuda.synchronize()
    ops.reset_launches()
    walks = {}
    for site, kind in (("plan.output", "nan"), ("plan.execute", "error")):
        resilience.reset()
        fp = rfaults.FaultPlan(seed=0).add(site, kind, times=threshold)
        rows = []
        with fp:
            for _ in range(threshold + cooldown):
                pl = get_plan(hw, backend="cuda")
                y = pl(xg)
                torch.cuda.synchronize()
                err = (torch.complex(y.re.double(), y.im.double())
                       - wantg).abs().max().item() / scale_g
                live = get_plan(hw, backend="cuda")
                rows.append({"served_by": pl.backend,
                             "device": str(y.re.device), "err": err,
                             "state": rpolicy.breaker_state(key),
                             "registry": [live.backend,
                                          live.demote_reason]})
                del y
        br = rpolicy.breaker(key)
        st = rexec.stats(key)
        walks[f"{site}:{kind}"] = {"calls": rows, "stats": st,
                                   "transitions": br.transitions,
                                   "fired": fp.fired()}
        demoted = rows[threshold - 1]["registry"]
        if not ([r["state"] for r in rows] == want_states
                and br.transitions == ["open", "half_open", "closed"]
                and demoted == ["torch", RUNTIME_DEMOTE_REASON]
                and rows[-1]["registry"] == ["cuda", None]
                and fp.fired() == threshold
                and (st["failures"], st["fallbacks"], st["short_circuits"])
                == (threshold, threshold, cooldown - 1)
                and all(r["device"].startswith("cuda") and
                        r["err"] <= TOL_NUMPY for r in rows)):
            failures.append(f"resilience_path {site}:{kind}: "
                            f"{walks[f'{site}:{kind}']}")
    torch.cuda.synchronize()
    launches_res = dict(ops.LAUNCHES)
    if launches_res["fft2d_gemm"] <= 0:
        failures.append("kernel fft2d_gemm was not launched on the "
                        "resilience path")
    # the guard's cost: guarded call against the raw _execute, in turns
    resilience.reset()
    pl = get_plan(hw, backend="cuda")

    def wall_ms(fn, runs=25):
        """Median host time of fn() and a synchronize."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(runs):
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t1) * 1e3)
        return sorted(ts)[runs // 2]

    raw = lambda: pl._execute(xg)         # noqa: E731
    guarded = lambda: pl(xg)              # noqa: E731
    turns = [wall_ms(raw), wall_ms(guarded), wall_ms(guarded), wall_ms(raw)]
    ev = {"raw": time_ms(raw, torch), "guarded": time_ms(guarded, torch)}
    yg = pl._execute(xg)
    scan_ms = time_ms(lambda: rguards.finite_check(yg), torch)
    # the scans the guard could have been, on the same output
    other_scans = {
        "aminmax": time_ms(lambda: bool(torch.isfinite(torch.stack(
            [torch.stack(torch.aminmax(q)) for q in yg])).all()), torch),
        "isfinite_all": time_ms(lambda: bool(torch.stack(
            [torch.isfinite(q).all() for q in yg]).all()), torch),
        "sum_float64": time_ms(lambda: bool(torch.isfinite(sum(
            q.sum(dtype=torch.float64) for q in yg))), torch),
        "sum_float32": time_ms(lambda: bool(torch.isfinite(sum(
            q.sum() for q in yg))), torch)}
    # the scan sees a NaN or an infinity anywhere on the card
    for bad in (float("nan"), float("inf"), float("-inf")):
        for plane in (0, 1):
            for at in (0, yg.re.numel() // 3, yg.re.numel() - 1):
                poisoned = [yg.re.clone(), yg.im.clone()]
                poisoned[plane].view(-1)[at] = bad
                if rguards.finite_check(SplitComplex(*poisoned)):
                    failures.append(f"finite_check missed {bad} at "
                                    f"plane {plane}, element {at}")
                del poisoned
    raw_ms, guard_ms = min(turns[0], turns[3]), min(turns[1], turns[2])
    emit({"phase": "resilience_path", "shape": RESILIENCE_2D,
          "launches": launches_res, "walks": walks,
          "failure_threshold": threshold, "cooldown_calls": cooldown,
          "tol": TOL_NUMPY, "wall_ms_turns": turns,
          "event_ms": ev, "finite_scan_ms": scan_ms,
          "other_scans_ms": other_scans,
          "finite_scan_bound_ms": 2 * yg.re.numel() * 4
          / PEAK_HBM_BYTES * 1e3,
          "guard_overhead_share": (guard_ms - raw_ms) / raw_ms,
          "nvidia_smi": smi})
    del xg, wantg, yg, zg
    resilience.reset()
    torch.cuda.empty_cache()

    # 4m. the guard's cost on every entry-point path at its main shape:
    # each entry point guarded (the default) against the same call with
    # the executor off (enabled=False runs plan._execute raw), in turns
    # raw, guarded, guarded, raw.  "sync" is one call and a synchronize;
    # "stream" is GUARD_STREAM calls back to back and one synchronize, where
    # the raw calls queue on the card and each guarded one waits for it
    clear_plan_cache()
    resilience.reset()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_SEED)

    def card_real(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def card_complex(shape):
        return SplitComplex(card_real(shape), card_real(shape))

    x2g, xr2g, x3g = (card_complex(MAIN_2D), card_real(MAIN_RFFT2),
                      card_complex(MAIN_3D))
    xsg, ksg = card_real(SSM_X), card_real(SSM_K)
    xgg = card_real(SSM_GRAD_X).requires_grad_(True)
    kgg = card_real(SSM_K).requires_grad_(True)

    def ssm_grad():
        loss = (fft_conv(xgg, kgg, backend="cuda") ** 2).sum()
        return torch.autograd.grad(loss, (xgg, kgg))

    def bank(m):
        k = torch.zeros((TABLE11_ROWS, m), device=dev)
        k[:, :TABLE11_TAPS] = card_real((TABLE11_ROWS, TABLE11_TAPS))
        return card_real((TABLE11_ROWS, m)), k

    guard_paths = {
        "fft2": lambda: fft2(x2g, backend="cuda"),
        "rfft2": lambda: rfft2(xr2g, backend="cuda"),
        "fft3": lambda: fft3(x3g, backend="cuda"),
        "ssm_fft_conv": lambda: fft_conv(xsg, ksg, backend="cuda"),
        "ssm_fft_conv_grad": ssm_grad}
    for m in TABLE11_M:
        xb, kb = bank(m)
        guard_paths[f"circular_conv_m{m}"] = \
            (lambda xb=xb, kb=kb: circular_conv(xb, kb, backend="cuda"))

    def host_ms(fn, calls, runs):
        """Median host time a call of ``calls`` back-to-back calls of fn()
        and one synchronize."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(runs):
            t1 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t1) * 1e3 / calls)
        return sorted(ts)[runs // 2]

    def unguarded(fn):
        def run():
            with rconfig.overrides(enabled=False):
                return fn()
        return run

    def flat(out):
        ts = out if isinstance(out, tuple) else (out,)
        return [q for t in ts for q in _planes(t)]

    guard_cost = {}
    for name, fn in guard_paths.items():
        got, want = flat(fn()), flat(unguarded(fn)())
        err = max((a - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(got, want))
        del got, want
        row = {"guarded_vs_raw": err}
        for mode, calls, runs in (("sync", 1, 15),
                                  ("stream", GUARD_STREAM, 5)):
            turns = [host_ms(unguarded(fn), calls, runs),
                     host_ms(fn, calls, runs), host_ms(fn, calls, runs),
                     host_ms(unguarded(fn), calls, runs)]
            raw_t, guard_t = min(turns[0], turns[3]), min(turns[1], turns[2])
            row[mode] = {"raw_ms": raw_t, "guarded_ms": guard_t,
                         "share": (guard_t - raw_t) / raw_t, "turns": turns}
        guard_cost[name] = row
        if not err <= TOL_2D:
            failures.append(f"guard_cost {name}: guarded and raw calls "
                            f"differ by {err:.3g}")
    gstats = rexec.stats()
    if not gstats or any(st["fallbacks"] or st["failures"]
                         for st in gstats.values()):
        failures.append(f"guard_cost: the guarded calls fell back or never "
                        f"ran through the executor: {gstats}")
    emit({"phase": "guard_cost", "paths": guard_cost,
          "stream_calls": GUARD_STREAM,
          "executor_keys": {"x".join(map(str, k[0])) + "/" + k[4]:
                            st["attempts"] for k, st in gstats.items()},
          "nvidia_smi": smi})
    del x2g, xr2g, x3g, xsg, ksg, xgg, kgg, guard_paths
    resilience.reset()
    torch.cuda.empty_cache()

    # 5. timing at the main paths' shapes; each spec makes its kernel's
    # input and the library call's input from one seeded array
    def design_floor(name, shape, nbytes, k_ms):
        """The grid launches of a call of the redesigned kernels and the
        bytes they move, each launch one pass over the planes."""
        if name == "fft_fourstep":
            grids, floor = fourstep_launches(shape[1]), \
                fourstep_floor_bytes(*shape)
        elif name.startswith("fft2d_gemm"):
            grids = len(AX.plan2d(*shape))
            floor = grids * nbytes
        elif name.startswith("fft3d"):
            grids = len(AX.plan3d(*shape, planes=False if "three" in name
                                  else None))
            floor = grids * nbytes
        elif name == "fft_stockham_r2":
            grids = len(S.r2_plan(*shape))
            floor = grids * nbytes
        elif name == "fft_stockham":
            grids = len(S.r4_plan(*shape))
            floor = grids * nbytes
        elif name == "rfft2d_fused":
            rows, cols = R.plan(*shape)
            grids, floor = 2, rfft2d_floor_bytes(*shape, cols.inner)
        elif name == "irfft2d_fused":
            cols, rows = R.inverse_plan(*shape)
            grids, floor = 2, rfft2d_floor_bytes(*shape, cols.inner)
        elif name == "fft2d_fused":
            grids = len(S2.plan(*shape))
            floor = grids * nbytes
        else:
            return {}
        return {"grid_launches": grids, "floor_bytes": floor,
                "floor_us": floor / PEAK_HBM_BYTES * 1e6,
                "hbm_tb_per_s": floor / k_ms / 1e9}

    def complex_inputs(shape):
        x = from_numpy(rand(shape), device=dev)
        return x, torch.complex(x.re, x.im)

    def real_inputs(shape):
        x = real_on_card(real(shape))
        return x, x

    def half_inputs(shape):
        b, h, w = shape
        x = from_numpy(rand((b, h, w // 2 + 1)), device=dev)
        return x, torch.complex(x.re, x.im)

    def bf16_inputs(shape):
        """bf16 planes, and the same values as complex64 for the library
        call (cuFFT has no bf16 transform)."""
        x = bf16(from_numpy(rand(shape), device=dev))
        return x, torch.complex(x.re.float(), x.im.float())

    def bf16_counts(batch, n):
        """fft_counts with 2-byte planes: 8 bytes a complex point in and
        out."""
        flops, nbytes = fft_counts(batch, n)
        return flops, nbytes // 2

    # which timed calls are entry points: since the guarded executor every
    # plan call runs through it; the timed kernel rows below call the
    # kernel wrappers and plain versions directly
    emit({"phase": "timed_entry_points",
          "guarded": ["table1_ladder.auto_cuda_backend"],
          "guarded_and_raw": ["guard_cost." + k for k in guard_cost],
          "executor_unguarded": ["table1_ladder.auto_torch_backend"],
          "direct": "every other timed call (the kernel wrappers, their "
                    "plain versions, fft3(algo='row_col') and the library "
                    "calls)"})
    n3 = MAIN_3D[1] * MAIN_3D[2] * MAIN_3D[3]
    n2 = MAIN_2D[1] * MAIN_2D[2]

    kernels = []
    hw = MAIN_RFFT2[1:]
    specs = [
        ("fft2d_gemm", MAIN_2D, G.fft2d_gemm_cuda,
         G.fft2d_gemm_plain, lambda c: torch.fft.fft2(c), complex_inputs,
         fft_counts(MAIN_2D[0], MAIN_2D[1] * MAIN_2D[2]),
         method_axis(MAIN_2D[0], MAIN_2D[1:]),
         "src/repro/kernels/fft2d_gemm.py:79", "fft2d_gemm",
         launches["fft2d_gemm"]),
        ("fft_fourstep", MAIN_FOURSTEP, F.fft_fourstep_cuda,
         F.fft_fourstep_plain, lambda c: torch.fft.fft(c), complex_inputs,
         fft_counts(*MAIN_FOURSTEP),
         method_fourstep(*MAIN_FOURSTEP, F._split_n(MAIN_FOURSTEP[1])[0]),
         "src/repro/kernels/fft_fourstep.py:45", "fft_fourstep",
         launches["fft_fourstep"]),
        ("fft_stockham", MAIN_STOCKHAM, S.fft_stockham_cuda,
         S.fft_stockham_plain, lambda c: torch.fft.fft(c), complex_inputs,
         fft_counts(*MAIN_STOCKHAM), method_stockham(*MAIN_STOCKHAM),
         "src/repro/kernels/fft_stockham.py:45", "fft_stockham",
         launches["fft_stockham"]),
        ("fft_stockham_r2", MAIN_R2, S.fft_stockham_r2_cuda,
         S.fft_stockham_r2_plain, lambda c: torch.fft.fft(c),
         complex_inputs, fft_counts(*MAIN_R2), method_stockham_r2(*MAIN_R2),
         "src/repro/kernels/fft_stockham.py:59", "fft_stockham",
         launches_real["fft_stockham_r2"]),
        ("rfft2d_fused", MAIN_RFFT2, R.rfft2d_fused_cuda,
         R.rfft2d_fused_plain, lambda c: torch.fft.rfft2(c), real_inputs,
         rfft_counts(*MAIN_RFFT2), method_rfft2d(*MAIN_RFFT2),
         "src/repro/kernels/rfft2d_fused.py:135", "rfft2d_fused",
         launches_real["rfft2d_fused"]),
        ("irfft2d_fused", MAIN_RFFT2, R.irfft2d_fused_cuda,
         R.irfft2d_fused_plain, lambda c: torch.fft.irfft2(c, s=hw),
         half_inputs, rfft_counts(*MAIN_RFFT2), method_rfft2d(*MAIN_RFFT2),
         "src/repro/kernels/rfft2d_fused.py:163", "rfft2d_fused",
         launches_real["irfft2d_fused"]),
        ("fft3d_fused", MAIN_3D, V.fft3d_fused_cuda, V.fft3d_fused_plain,
         lambda c: torch.fft.fftn(c, dim=(-3, -2, -1)), complex_inputs,
         fft_counts(MAIN_3D[0], n3), method_axis(MAIN_3D[0], MAIN_3D[1:]),
         "src/repro/kernels/fft3d_fused.py:76", "fft3d_fused",
         launches_vol["fft3d_fused"]),
        ("fft2d_fused", MAIN_2D, S2.fft2d_fused_cuda, S2.fft2d_fused_plain,
         lambda c: torch.fft.fft2(c), complex_inputs,
         fft_counts(MAIN_2D[0], n2), method_stockham2d(*MAIN_2D),
         "src/repro/kernels/fft2d_fused.py:37", "fft2d_fused",
         launches["fft2d_fused"]),
        # row 1's bf16 line: the compensated variant the registry picks
        ("fft2d_gemm_bf16", MAIN_2D,
         lambda x: G.fft2d_gemm_cuda(x, variant="compensated"),
         lambda x: G.fft2d_gemm_plain(x, variant="compensated"),
         lambda c: torch.fft.fft2(c), bf16_inputs,
         bf16_counts(MAIN_2D[0], n2), method_axis(MAIN_2D[0], MAIN_2D[1:]),
         "src/repro/kernels/fft2d_gemm.py:79", "fft2d_gemm",
         launches_bf16["fft2d_gemm"]),
    ]
    for name, shape, kern, plain, lib, inputs, (flops, nbytes), \
            (method_flops, table_bytes), replaces, source, count in specs:
        x, c = inputs(shape)
        k_ms = time_ms(lambda: kern(x), torch)
        p_ms = time_ms(lambda: plain(x), torch)
        l_ms = time_ms(lambda: lib(c), torch)
        b_ms, b_by = bound_ms(flops, nbytes)
        emit({"phase": "timing", "kernel": name, "shape": shape,
              "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
              "bound_us": b_ms * 1e3, "bound_by": b_by, "fft_flops": flops,
              "io_bytes": nbytes, "method_flops": method_flops,
              "table_bytes": table_bytes,
              "method_tflops": method_flops / k_ms / 1e9,
              "launches": count, "nvidia_smi": smi,
              **design_floor(name, shape, nbytes, k_ms)})
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{source}.cu",
                        "replaces": replaces, "launches": count,
                        "max_abs_err": main_err[name], "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": l_ms})
        del x, c
        torch.cuda.empty_cache()

    # the fused conv at the SSM conv branch's shape; no single PyTorch call
    # computes it, so the library time is three calls: torch.fft.rfft,
    # the complex multiply and torch.fft.irfft
    xc, efc = conv_operands(MAIN_CONV, MAIN_CONV[1:2])
    m = MAIN_CONV[-1]
    kfc = torch.complex(*(t.contiguous() for t in
                          from_numpy(rand((MAIN_CONV[1], m // 2 + 1)),
                                     device=dev)))
    k_ms = time_ms(lambda: C.fftconv_fused_cuda(xc, efc), torch)
    p_ms = time_ms(lambda: C.fftconv_fused_plain(xc, efc), torch)
    l_ms = time_ms(lambda: torch.fft.irfft(torch.fft.rfft(xc) * kfc, n=m),
                   torch)
    flops, nbytes = conv_counts(*MAIN_CONV, MAIN_CONV[1])
    method_flops, table_bytes = method_conv(*MAIN_CONV)
    b_ms, b_by = bound_ms(flops, nbytes)
    emit({"phase": "timing", "kernel": "fftconv_fused", "shape": MAIN_CONV,
          "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
          "library": "torch.fft.irfft(torch.fft.rfft(x) * kf, n=m): "
                     "three calls", "bound_us": b_ms * 1e3,
          "bound_by": b_by, "fft_flops": flops, "io_bytes": nbytes,
          "method_flops": method_flops, "table_bytes": table_bytes,
          "method_tflops": method_flops / k_ms / 1e9,
          "hbm_tb_per_s": nbytes / k_ms / 1e9,
          "launches": launches_conv["fftconv_fused"], "grid_launches": 1,
          "bound_share": b_ms / k_ms,
          "rows_a_tile": C.rows_a_tile(MAIN_CONV[0] * MAIN_CONV[1], m,
                                       _build.sm_count(xc.device)),
          "nvidia_smi": smi})
    kernels.append({"name": "fftconv_fused", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/fftconv_fused.cu",
                    "replaces": "src/repro/kernels/fftconv_fused.py:178",
                    "launches": launches_conv["fftconv_fused"],
                    "max_abs_err": main_err["fftconv_fused"], "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": l_ms})
    del xc, efc, kfc
    torch.cuda.empty_cache()
    # table 11's 64-row bank at batch 1: 64 rows fill 64 (m = 1024: 32) of
    # the card's 132 SMs; recorded, not a kernels-line entry
    for m in TABLE11_M:
        shape = (1, TABLE11_ROWS, m)
        xc, efc = conv_operands(shape, (TABLE11_ROWS,))
        kfc = torch.complex(*(t.contiguous() for t in from_numpy(
            rand((TABLE11_ROWS, m // 2 + 1)), device=dev)))
        k_ms = time_ms(lambda: C.fftconv_fused_cuda(xc, efc), torch)
        l_ms = time_ms(lambda: torch.fft.irfft(torch.fft.rfft(xc) * kfc,
                                               n=m), torch)
        b_ms, b_by = bound_ms(*conv_counts(*shape, TABLE11_ROWS))
        emit({"phase": "timing", "kernel": "fftconv_fused", "shape": shape,
              "cell": "table11", "kernel_ms": k_ms, "library_ms": l_ms,
              "bound_us": b_ms * 1e3, "bound_by": b_by,
              "bound_share": b_ms / k_ms, "grid_launches": 1,
              "rows_a_tile": C.rows_a_tile(TABLE11_ROWS, m,
                                           _build.sm_count(xc.device)),
              "nvidia_smi": smi})
        del xc, efc, kfc
    torch.cuda.empty_cache()

    # the long-axis routes: fft2 at 8192^2 (each axis two launches of the
    # split), the four-step kernel at 2^21 = 1024 x 2048 (the axis route)
    # and radix 2 at 2^25 (a launch a stage), each with its plain version,
    # the library call and the bound; launches from the long-axis window
    route_specs = [
        ("fft2d_gemm", "split_axis_8192^2", LONG_TIMED, G.fft2d_gemm_cuda,
         G.fft2d_gemm_plain, lambda c: torch.fft.fft2(c),
         fft_counts(LONG_TIMED[0], LONG_TIMED[1] * LONG_TIMED[2]),
         len(AX.plan2d(*LONG_TIMED)), launches_long["fft2d_gemm"], 25),
        ("fft_fourstep", "axis_route_1024x2048", FOURSTEP_FACTORS[0][0],
         F.fft_fourstep_cuda, F.fft_fourstep_plain,
         lambda c: torch.fft.fft(c), fft_counts(*FOURSTEP_FACTORS[0][0]),
         len(F.axis_plan(*FOURSTEP_FACTORS[0][0])),
         launches_long["fft_fourstep"], 25),
        ("fft_stockham_r2", "per_stage_2^25", R2_STAGES,
         S.fft_stockham_r2_cuda, S.fft_stockham_r2_plain,
         lambda c: torch.fft.fft(c), fft_counts(*R2_STAGES),
         R2_STAGES[1].bit_length() - 1, launches_long["fft_stockham_r2"],
         5)]
    for name, cell, shape, kern, plain, lib, (flops, nbytes), grids, \
            count, runs in route_specs:
        x, c = complex_inputs(shape)
        k_ms = time_ms(lambda: kern(x), torch)
        p_ms = time_ms(lambda: plain(x), torch, runs=runs, warmup=1)
        l_ms = time_ms(lambda: lib(c), torch)
        b_ms, b_by = bound_ms(flops, nbytes)
        emit({"phase": "timing", "kernel": name, "cell": cell,
              "shape": shape, "kernel_ms": k_ms, "plain_ms": p_ms,
              "library_ms": l_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
              "bound_share": b_ms / k_ms, "fft_flops": flops,
              "io_bytes": nbytes, "grid_launches": grids,
              "floor_us": grids * nbytes / PEAK_HBM_BYTES * 1e6,
              "launches": count, "nvidia_smi": smi})
        del x, c
        S.tw.packed_radix2_twiddles_np.cache_clear()
        S.tw.clear_table_cache()
        torch.cuda.empty_cache()

    # recorded beside the kernels line, not entries of it: the 3-D kernel
    # at the PME grid and in bf16, plain bf16 images, and the fused 3-D
    # kernel against the whole row_col schedule (three Stockham passes and
    # their relayouts, whose plain twin is the torch backend's schedule),
    # each with its plain version, the library call and the bound
    fftn = lambda c: torch.fft.fftn(c, dim=(-3, -2, -1))  # noqa: E731
    extra = [
        ("fft3d_fused", "pme_128^3x8", PME_3D, V.fft3d_fused_cuda,
         V.fft3d_fused_plain, fftn, complex_inputs,
         fft_counts(PME_3D[0], PME_3D[1] ** 3),
         method_axis(PME_3D[0], PME_3D[1:]), launches_vol["fft3d_fused"]),
        ("fft3d_three", "pme_128^3x8_three_launches", PME_3D, three_launches,
         V.fft3d_fused_plain, fftn, complex_inputs,
         fft_counts(PME_3D[0], PME_3D[1] ** 3),
         method_axis(PME_3D[0], PME_3D[1:]), 0),
        ("fft3d_fused", "bf16_compensated", MAIN_3D,
         lambda x: V.fft3d_fused_cuda(x, variant="compensated"),
         lambda x: V.fft3d_fused_plain(x, variant="compensated"), fftn,
         bf16_inputs, bf16_counts(MAIN_3D[0], n3),
         method_axis(MAIN_3D[0], MAIN_3D[1:]), launches_vol["fft3d_fused"]),
        ("fft2d_gemm", "bf16_plain", MAIN_2D,
         lambda x: G.fft2d_gemm_cuda(x, variant="plain"),
         lambda x: G.fft2d_gemm_plain(x, variant="plain"),
         lambda c: torch.fft.fft2(c), bf16_inputs,
         bf16_counts(MAIN_2D[0], n2),
         method_fft2d(*MAIN_2D, fourstep_factors),
         launches_bf16["fft2d_gemm"]),
        ("fft3_row_col", "row_col_schedule", MAIN_3D,
         lambda x: fft3(x, algo="row_col", backend="cuda"),
         lambda x: fft3(x, algo="row_col", backend="torch"), fftn,
         complex_inputs, fft_counts(MAIN_3D[0], n3), (None, None),
         launches_vol["fft_stockham"]),
    ]
    for name, cell, shape, kern, plain, lib, inputs, (flops, nbytes), \
            (method_flops, table_bytes), count in extra:
        x, c = inputs(shape)
        k_ms = time_ms(lambda: kern(x), torch)
        p_ms = time_ms(lambda: plain(x), torch)
        l_ms = time_ms(lambda: lib(c), torch)
        b_ms, b_by = bound_ms(flops, nbytes)
        emit({"phase": "timing", "kernel": name, "cell": cell,
              "shape": shape, "kernel_ms": k_ms, "plain_ms": p_ms,
              "library_ms": l_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
              "fft_flops": flops, "io_bytes": nbytes,
              "method_flops": method_flops, "table_bytes": table_bytes,
              "method_tflops": method_flops / k_ms / 1e9
              if method_flops else None, "launches": count,
              "nvidia_smi": smi,
              **(design_floor(name, shape, nbytes, k_ms)
                 if "plain" not in cell else {})})
        del x, c
        torch.cuda.empty_cache()

    # the Table 1 ladder on the card: every rung at Table 1's size and at
    # the loaded batch, on one seeded input each; the staged kernel's row
    # at the loaded batch is its kernels-line entry, with the design's
    # floor (log2(n) passes over the planes) beside the bound
    for shape in (TABLE1, TABLE1_LOADED):
        x, c = complex_inputs(shape)
        ladder = {"staged_kernel": lambda: ST.fft_staged_cuda(x),
                  **{k: (lambda f=f: f(x)) for k, f in rungs.items()},
                  "torch_fft": lambda: torch.fft.fft(c)}
        t1_ms = {k: time_ms(f, torch) for k, f in ladder.items()}
        emit({"phase": "timing", "kernel": "table1_ladder", "shape": shape,
              "ms": t1_ms, "nvidia_smi": smi})
        k_ms = t1_ms["staged_kernel"]
        p_ms = time_ms(lambda: ST.fft_staged_plain(x), torch)
        l_ms = t1_ms["torch_fft"]
        flops, nbytes = fft_counts(*shape)
        b_ms, b_by = bound_ms(flops, nbytes)
        floor = staged_floor_bytes(*shape)
        ln = shape[1].bit_length() - 1
        emit({"phase": "timing", "kernel": "fft_staged", "shape": shape,
              "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
              "bound_us": b_ms * 1e3, "bound_by": b_by, "fft_flops": flops,
              "io_bytes": nbytes, "floor_bytes": floor,
              "floor_us": floor / PEAK_HBM_BYTES * 1e6,
              "method_flops": shape[0] * ln * (shape[1] // 2) * 10,
              "table_bytes": 4 * shape[1], "hbm_tb_per_s": floor / k_ms / 1e9,
              "launches": launches_t1["fft_staged"],
              "grid_launches": staged_launches(shape[1]),
              "nvidia_smi": smi})
        if shape == TABLE1_LOADED:
            kernels.append({
                "name": "fft_staged", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/fft_stage.cu",
                "replaces": "src/repro/kernels/fft_stage.py:25",
                "launches": launches_t1["fft_staged"],
                "max_abs_err": main_err["fft_staged"], "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": l_ms})
        del x, c
        torch.cuda.empty_cache()

    # decode attention at each cell in bf16; the library call is one
    # scaled_dot_product_attention with the positions' boolean mask and
    # GQA, on (B, KV, S, D) views of the caches.  The bound counts the
    # visible slots of this run's positions; the whole cache beside it
    nnf = torch.nn.functional
    for name, c in DECODE_CELLS.items():
        b, s_len, h, kv, d, window, _ = c
        q, k, v, kv_pos, q_pos = case = dec16[name]
        mask = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
        if window is not None:
            mask &= kv_pos > q_pos[:, None] - window
        mask = mask[:, None, None, :]
        qq, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        k_ms = time_ms(lambda: DA.decode_attention_cuda(*case,
                                                        window=window),
                       torch)
        p_ms = time_ms(lambda: DA.decode_attention_plain(*case,
                                                         window=window),
                       torch)
        l_ms = time_ms(lambda: nnf.scaled_dot_product_attention(
            qq, kt, vt, attn_mask=mask, enable_gqa=True), torch)
        visible, empty_rows = visibility(case, window)
        flops, nbytes = decode_counts(visible, empty_rows, b, s_len, h, kv,
                                      d, 2, 2)
        route = DA.route(q.dtype, k.dtype, d, h // kv)
        split = DA.split_length(s_len, b, kv, h // kv)
        skipped = skipped_shares(mask[:, 0, 0], split,
                                 32 if route == "mma" else 64)
        b_ms, b_by = bound_ms(flops, nbytes)
        cache_bytes = 2 * b * s_len * kv * d * 2
        count = launches_dec["decode_attention"]
        emit({"phase": "timing", "kernel": "decode_attention", "cell": name,
              "shape": c[:5], "window": window, "dtype": "bfloat16",
              "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
              "library": "scaled_dot_product_attention(attn_mask=bool, "
                         "enable_gqa=True)",
              "bound_us": b_ms * 1e3, "bound_by": b_by, "flops": flops,
              "io_bytes": nbytes, "visible_slots": visible,
              "empty_rows": empty_rows, "cache_bytes": cache_bytes,
              "cache_us": cache_bytes / PEAK_HBM_BYTES * 1e6,
              "cache_tb_per_s": cache_bytes / k_ms / 1e9,
              "tflops": flops / k_ms / 1e9,
              "hbm_tb_per_s": nbytes / k_ms / 1e9, "route": route,
              "split": split, "splits": -(-s_len // split),
              "tiles_skipped": skipped[0], "splits_skipped": skipped[1],
              "launches": count, "grid_launches": 2, "nvidia_smi": smi})
        if c == STARCODER2:
            kernels.append({
                "name": "decode_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                "replaces": "src/repro/kernels/decode_attention.py:28",
                "launches": count,
                "max_abs_err": main_err["decode_attention"], "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": l_ms})
        del q, k, v, kv_pos, q_pos, case, mask, qq, kt, vt
    del dec16
    torch.cuda.empty_cache()

    dist_cases = dist_path(failures, smi)
    nccl_path(failures, smi, torch.cuda.device_count())
    tt_path(failures, smi, dist_cases)

    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:                     # report, then exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
