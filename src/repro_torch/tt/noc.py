"""Tile-granular NoC transfer model: point-to-point, global transpose,
and compressed all_to_all.

The Wormhole routes 32x32 tiles over two toroidal NoCs laid over the
physical core grid (``arch.noc_grid``).  The §5 bottleneck — the global
transpose between the row and column FFT passes — is an all-to-all over
that grid: with the image row-banded over P cores, a fraction (P-1)/P of
every plane must cross the NoC, and the sustained rate is set by the
mesh bisection, not the per-link rate.

The distributed-pencil exchanges of :mod:`repro_torch.dist.pencil` reuse the
same math at device granularity via :func:`all_to_all_s`, whose wire
volume comes from :func:`repro_torch.dist.compression.wire_bytes` so the
bf16/int8 compressed collectives are priced exactly as the training
stack ships them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from .arch import chip_grid, get_arch
from .tensix import TILE_DIM, TILE_ELEMS


def mean_hops(grid: Tuple[int, int]) -> float:
    """Mean Manhattan hop count between two uniformly random cores of a
    ``(gx, gy)`` torus (each axis contributes ~extent/4)."""
    gx, gy = grid
    return (gx / 4.0) + (gy / 4.0)


def bisection_bw(arch) -> float:
    """Aggregate bytes/s across the mesh bisection: links crossing the cut
    (the shorter grid axis), both toroidal directions, both NoCs."""
    a = get_arch(arch)
    gx, gy = a.noc_grid
    cut_links = max(1, min(gx, gy)) * 2        # torus: two crossings per row
    nocs = 2 if a.kind == "tensix" else 1      # NoC0 + NoC1
    return cut_links * nocs * a.noc_bw


def transfer_s(nbytes: float, arch, *, hops: Optional[float] = None) -> float:
    """Point-to-point transfer: per-hop latency plus serialisation."""
    a = get_arch(arch)
    if hops is None:
        hops = mean_hops(a.noc_grid)
    return hops * a.noc_latency_s + nbytes / a.noc_bw


def n_tiles(h: int, w: int) -> int:
    return math.ceil(h / TILE_DIM) * math.ceil(w / TILE_DIM)


def global_transpose(h: int, w: int, *, arch, elem_bytes: int = 8) -> dict:
    """The §5 global transpose of one (h, w) split-complex plane.

    The plane is row-banded over the cores; transposing moves every tile
    whose destination band differs from its source band — (P-1)/P of the
    plane — across the NoC at bisection rate, plus per-tile routing
    latency amortised over the many tiles in flight (one mean-hop charge
    per wavefront of P tiles).
    """
    a = get_arch(arch)
    p = max(1, a.cores)
    plane = float(h) * float(w) * elem_bytes
    cross = plane * (p - 1) / p
    tiles = n_tiles(h, w)
    lat = mean_hops(a.noc_grid) * a.noc_latency_s * max(1, tiles // p)
    return {
        "noc_bytes": cross,
        "tiles": tiles,
        "seconds": lat + cross / bisection_bw(a),
    }


def eth_hops(devices: int, grid: Optional[Tuple[int, int]] = None) -> float:
    """Mean chip-to-chip hop count of one all_to_all over ``devices`` chips
    laid out on the :func:`repro_torch.tt.arch.chip_grid` mesh (or an explicit
    ``grid``).  Same Manhattan-torus math as the on-chip NoC, one level up."""
    return mean_hops(grid if grid is not None else chip_grid(devices))


def all_to_all_s(tree_or_bytes, devices: int, arch, *,
                 method: str = "none", multichip: bool = False,
                 grid: Optional[Tuple[int, int]] = None) -> dict:
    """One all_to_all over ``devices`` chips (the pencil-FFT exchange).

    ``tree_or_bytes`` is either a pytree (priced per device through
    :func:`repro_torch.dist.compression.wire_bytes`, honouring the compressed
    wire format) or a plain per-device byte count.  Each device keeps its
    diagonal block, so (devices-1)/devices of the payload crosses the
    off-chip links.

    With ``multichip=True`` the exchange is priced on the arch's ethernet/
    ICI fabric instead of a single generic link: the per-device traffic
    stripes across ``eth_links`` links of ``eth_bw`` each, and per-hop
    latency comes from the :func:`eth_hops` chip-grid hop table — this is
    what :func:`repro_torch.tt.trace.trace_dist` charges the dist.pencil
    exchange legs with.
    """
    import numpy as np
    from repro_torch.dist.compression import wire_bytes
    a = get_arch(arch)
    if isinstance(tree_or_bytes, (int, float)):
        # scalar payloads are f32 bytes; derive the wire factor from
        # wire_bytes itself so the two models can never drift
        probe = np.zeros((1,), np.float32)
        per_device = float(tree_or_bytes) \
            * wire_bytes(probe, method) / wire_bytes(probe, "none")
    else:
        per_device = float(wire_bytes(tree_or_bytes, method))
    wire = per_device * max(0, devices - 1) / max(1, devices)
    if multichip:
        bw = (a.eth_bw or a.link_bw) * max(1, a.eth_links)
        lat = a.eth_latency_s or a.noc_latency_s
        hops = eth_hops(devices, grid)
        return {
            "wire_bytes": wire,
            "seconds": wire / bw + hops * lat,
            "method": method,
            "hops": hops,
            "grid": grid if grid is not None else chip_grid(devices),
        }
    return {
        "wire_bytes": wire,
        "seconds": wire / a.link_bw + a.noc_latency_s * max(0, devices - 1),
        "method": method,
    }
