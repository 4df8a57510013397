"""Distributed pencil FFTs on the PyTorch port (counterpart of
``examples/distributed_fft.py``), over spawned ranks of one
``torch.distributed`` group (``repro_torch.dist.local.LocalGroup``) in
place of the reference's 8 emulated XLA devices.

Shows the paper's Section 5 pattern at multi-rank scale: local row FFTs,
an all_to_all global transpose, local column FFTs, plus the chunked and
hierarchical multi-pod schedules, the 3-D pencil FFT and one giant 1-D
FFT.  Each rank runs the per-rank body on its block; the parent
assembles the blocks and compares with numpy.

    python examples/torch_distributed_fft.py [--ranks 8] [--device cuda|cpu]

On the card the ranks share it over gloo and the local passes run the
kernels (``--backend cuda``, the default); on the CPU their plain
versions.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402


def _case(name, x, mesh_shape, names, spec, device, backend, **kw):
    """One transform on this rank: its block of ``x`` in, its output
    block out (numpy complex)."""
    import torch
    from repro_torch.core import from_numpy, to_complex
    from repro_torch.dist import local_block, make_mesh, pencil
    from repro_torch.kernels import ops
    mesh = make_mesh(mesh_shape, names, device=device)
    z = from_numpy(local_block(x, dict(zip(names, mesh_shape)), spec),
                   device=device)
    fn = {"pfft2": pencil.pfft2, "hier": pencil.pfft2_hierarchical,
          "pfft3": pencil.pfft3, "pfft1d": pencil.pfft1d}[name]
    ops.reset_launches()
    out = fn(z, mesh, backend=backend, **kw)
    if name == "pfft1d":
        out = pencil.pfft1d(out, mesh, backend=backend, inverse=True)
    if device == "cuda":
        torch.cuda.synchronize()
    return (to_complex(out).cpu().numpy(),
            {k: v for k, v in ops.LAUNCHES.items() if v})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--size", type=int, default=512, help="H = W")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="cuda",
                    help="the local passes' plan backend (cuda or torch)")
    args = ap.parse_args(argv)
    from repro_torch.dist import assemble
    from repro_torch.dist.local import LocalGroup

    p, n = args.ranks, args.size
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    ref = np.fft.fft2(x)
    x3 = (rng.standard_normal((32, 32, 64))
          + 1j * rng.standard_normal((32, 32, 64))).astype(np.complex64)
    v = (rng.standard_normal(1 << 16)
         + 1j * rng.standard_normal(1 << 16)).astype(np.complex64)
    flat, grid = ((p,), ("data",)), ((2, p // 2), ("pod", "data"))
    grid3 = ((2, p // 2), ("data", "model"))
    errs, launches = {}, {}

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    with LocalGroup(p, device=args.device, timeout_s=600) as group:
        def run(label, name, arr, mesh, spec, **kw):
            outs = group.run(_case, name, arr, mesh[0], mesh[1], spec,
                             args.device, args.backend, **kw)
            launches[label] = outs[0][1]
            return [o[0] for o in outs]

        got = assemble(run("pfft2", "pfft2", x, flat, ("data", None)),
                       dict(zip(flat[1], flat[0])), ("data", None))
        errs["pfft2"] = rel(got.T, ref)                   # 1 all_to_all
        print(f"pfft2 (single all_to_all)        rel err {errs['pfft2']:.2e}")

        got = assemble(run("pfft2_chunks4", "pfft2", x, flat,
                           ("data", None), chunks=4),
                       dict(zip(flat[1], flat[0])), ("data", None))
        errs["pfft2_chunks4"] = rel(got.T, ref)           # overlapped
        print(f"pfft2 (4-chunk overlap schedule) rel err "
              f"{errs['pfft2_chunks4']:.2e}")

        got = assemble(run("hier", "hier", x, grid, (("pod", "data"), None)),
                       dict(zip(grid[1], grid[0])), (("data", "pod"), None))
        errs["pfft2_hierarchical"] = rel(got.T, ref)      # two-hop
        print(f"pfft2_hierarchical (2 pods x {p // 2})  rel err "
              f"{errs['pfft2_hierarchical']:.2e}")

        # 3-D pencil FFT over a 2-D process grid: (Z, Y, X) pencils out
        got = assemble(run("pfft3", "pfft3", x3, grid3,
                           ("data", "model", None)),
                       dict(zip(grid3[1], grid3[0])),
                       ("model", "data", None))
        errs["pfft3"] = rel(got.transpose(2, 1, 0), np.fft.fftn(x3))
        print(f"pfft3 (2x{p // 2} process grid)         rel err "
              f"{errs['pfft3']:.2e}")

        # one giant distributed 1-D FFT, forward then inverse
        back = assemble(run("pfft1d", "pfft1d", v, flat, ("data",)),
                        dict(zip(flat[1], flat[0])), ("data",))
        errs["pfft1d_roundtrip"] = float(np.abs(back - v).max())
        print(f"pfft1d 65536 roundtrip           max err "
              f"{errs['pfft1d_roundtrip']:.2e}")
    return {"errors": errs, "launches": launches}


if __name__ == "__main__":
    main()
