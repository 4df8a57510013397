"""Dry-run of the paper's own workload at production scale (counterpart
of :mod:`repro.launch.fft_dryrun`): a distributed 2-D FFT on the 16x16
(and 2x16x16) mesh, with the collective-schedule variants of
:mod:`repro_torch.dist.pencil`, counted per rank on fake tensors over a
fake process group (:mod:`repro_torch.launch.dryrun`'s machinery).
Emits the reference's record fields and roofline terms per variant.

    python -m repro_torch.launch.fft_dryrun --size 16384 [--mesh both] \\
        [--arch tpu_v5e|h100_sxm]

The reference's flat ``("data", "model")`` axis over all 256 (512) ranks
is a one-dimensional mesh of the same ranks here (row-major, so the same
rank order); its hierarchical variants run ``pfft2_hierarchical`` over
(data, model) and over (pod, the 256 ranks of a pod).  The local passes
run on the plan registry's torch backend (fake tensors run no kernel).
"""
from __future__ import annotations

import argparse
import os

import torch


def run_variant(name, fn, args, out_dir, size, *, arch="tpu_v5e",
                world=256):
    """Count ``fn(*args)`` (args fake, this rank's blocks) and write the
    variant's record to ``out_dir/<name>.json``."""
    from repro_torch.analysis.roofline import hw_table
    from .dryrun import count_call, write_record
    cost, ops, memory, secs = count_call(fn, args)
    hw = hw_table(arch)
    rec = {
        "variant": name, "size": size, "devices": world, "arch": arch,
        "trace_s": round(secs, 2),
        "flops": cost.flops,
        "traffic_bytes": cost.traffic,
        "collective_bytes": dict(cost.collectives),
        "collective_total": cost.collective_total,
        "compute_s": cost.flops / hw["peak_flops_f32"],
        "memory_s": cost.traffic / hw["hbm_bw"],
        "collective_s": cost.collective_total / hw["ici_bw"],
        "temp_bytes": memory["temp_size_in_bytes"],
    }
    write_record(rec, ops, os.path.join(out_dir, f"{name}.json"))
    print(f"[fft-dryrun] {name}: compute {rec['compute_s']:.2e}s "
          f"memory {rec['memory_s']:.2e}s collective "
          f"{rec['collective_s']:.2e}s (coll "
          f"{rec['collective_total'] / 2**30:.2f} GiB/dev)", flush=True)
    return rec


def run(size: int, mesh: str = "single", out: str = "runs/fft_dryrun",
        arch: str = "tpu_v5e", pod: int = 16) -> list:
    """Every variant of ``mesh`` ("single", "multi" or "both") at a global
    ``size`` x ``size`` image; returns their records.  A pod is ``pod`` x
    ``pod`` ranks (16: the production 256 a pod, 512 over two); a variant
    is named by its rank count, as the reference names them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.resilience import config as rconfig
    from . import mesh as mesh_lib
    from .dryrun import fake_group
    torch.set_num_threads(1)
    n = size
    recs = []
    # the guards read values back (finite checks): fake tensors have none
    with rconfig.overrides(enabled=False):
        for multi in {"single": [False], "multi": [True],
                      "both": [False, True]}[mesh]:
            world = pod * pod * (2 if multi else 1)
            with fake_group(world):
                flat = mesh_lib.make_mesh((world,), ("flat",), device="cpu")
                if multi:
                    two = mesh_lib.make_mesh((2, pod * pod), ("pod", "inner"),
                                             device="cpu")
                else:
                    two = mesh_lib.make_mesh((pod, pod), ("data", "model"),
                                             device="cpu")
                with FakeTensorMode(allow_non_fake_inputs=True):
                    recs += _variants(flat, two, multi, n, out, arch, world)
    return recs


def _variants(flat, two, multi, n, out, arch, world) -> list:
    from repro_torch.core import SplitComplex
    from repro_torch.dist import pencil
    recs = []
    rows = n // world

    def block():
        return SplitComplex(torch.zeros(rows, n), torch.zeros(rows, n))

    def variant(name, fn, *args):
        recs.append(run_variant(name, fn, args, out, n, arch=arch,
                                world=world))

    def base(z):
        return pencil.pfft2(z, flat, "flat")
    if multi:
        variant(f"pfft2_base_{world}", base, block())
        # intra-pod hop over a pod's ranks, inter-pod hop over pod
        variant(f"pfft2_hier_{world}", lambda z: pencil.pfft2_hierarchical(
            z, two, pod_axis="pod", data_axis="inner"), block())
        return recs
    variant(f"pfft2_base_{world}", base, block())
    variant(f"pfft2_chunks4_{world}",
            lambda z: pencil.pfft2(z, flat, "flat", chunks=4), block())
    variant(f"pfft2_hier_{world}", lambda z: pencil.pfft2_hierarchical(
        z, two, pod_axis="data", data_axis="model"), block())

    # real input: even/odd columns packed as complex, then the half-width
    # 2-D pencil FFT (the reference's)
    def rfft2_packed(x):
        return base(SplitComplex(x[:, 0::2], x[:, 1::2]))
    variant(f"prfft2_packed_{world}", rfft2_packed, torch.zeros(rows, n))
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=16384,
                    help="global H=W (paper used 1024; production-scale "
                         "default 16384)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default="runs/fft_dryrun")
    ap.add_argument("--arch", default="tpu_v5e",
                    help="the roofline's hardware table: tpu_v5e (the "
                         "reference's), h100_sxm or any tt.arch entry")
    ap.add_argument("--pod", type=int, default=16,
                    help="a pod is pod x pod ranks (16: the production "
                         "256 and 512)")
    args = ap.parse_args(argv)
    run(args.size, args.mesh, args.out, args.arch, args.pod)


if __name__ == "__main__":
    main()
