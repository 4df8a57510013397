"""Markdown/JSON emitters for the Wormhole-vs-Xeon comparison (paper §6;
counterpart of :mod:`repro.tt.report`).

The paper's headline is an efficiency, not a speed, result: on the 2-D
FFT the Wormhole n300 is slower than the 24-core Xeon baseline but draws
~8x less power and therefore spends ~2.8x less energy.  Two sources
back the table:

- ``source="paper"`` (default) — the published §6 measurement anchors
  stored on each :class:`repro_torch.tt.arch.Arch` (``published["time_ms"]``,
  ``published["power_w"]``).  This reproduces the paper's ratios exactly
  and is what the acceptance test pins.
- ``source="model"`` — the analytic traces of :mod:`repro_torch.tt.trace`
  (fused plan on the accelerator, row-column on the CPU) with the
  energy integral.  Roofline-optimistic by construction; useful for the
  *relative* what-if questions (sizes, block_batch, compression), not
  for absolute cross-arch claims.

``python -m repro_torch.tt.report`` prints the table.  Every number is
the model's or the paper's, for the arch it names: none describes the
card the port runs on.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

from .arch import get_arch
from . import trace as tttrace


def _model_row_seconds(arch, size: int,
                       transform: str = "fft2") -> "tttrace.PlanTrace":
    """Model trace of one (size, size) f32 2-D transform on ``arch``: the
    fused single-kernel schedule on accelerators, row-column on CPUs.
    ``transform="rfft2"`` traces the real-input schedule instead (the
    fused rfft kernel / the torch rfft row-column path)."""
    from repro_torch.core.plan import FFTPlan

    assert transform in ("fft2", "rfft2"), transform
    a = get_arch(arch)
    kind = "rfft" if transform == "rfft2" else "c2c"
    if a.kind == "cpu":
        from repro_torch.core.fft1d import resolve_algo
        algo = resolve_algo(size // 2) if kind == "rfft" else "row_col"
        plan = FFTPlan(shape=(size, size), algo=algo, block_batch=8,
                       backend="torch", kind=kind)
    else:
        plan = FFTPlan(shape=(size, size), algo="fused", block_batch=1,
                       backend="cuda", kind=kind)
    return tttrace.trace_plan(plan, arch=a, batch=1)


def compare(arch_a="wormhole_n300", arch_b="xeon_8160", *,
            sizes: Optional[Sequence[int]] = None,
            source: str = "paper", transform: str = "fft2") -> List[dict]:
    """Per-size comparison rows of ``arch_a`` (the paper's accelerator)
    against ``arch_b`` (the baseline).

    Ratios follow the paper's phrasing: ``time_ratio`` is a_time/b_time
    (>1 means a is slower), ``power_ratio`` and ``energy_ratio`` are
    b/a (>1 means a draws/spends less).  ``transform="rfft2"`` compares
    the real-input transform the distributed path actually ships — model
    source only, since the paper published no real-input anchors.
    """
    a, b = get_arch(arch_a), get_arch(arch_b)
    assert source in ("paper", "model"), source
    assert transform in ("fft2", "rfft2"), transform
    if transform == "rfft2" and source != "model":
        raise ValueError("transform='rfft2' has no published anchors; "
                         "pass source='model'")
    if source == "paper":
        ta = a.published.get("time_ms", {})
        tb = b.published.get("time_ms", {})
        common = set(ta) & set(tb)
        if sizes is None:
            sizes = sorted(common)
        if not sizes or not common.issuperset(sizes):
            raise ValueError(
                f"sizes {sorted(set(sizes or ()) - common)} have no "
                f"published anchors for {a.name} vs {b.name} "
                f"(published: {sorted(common)}); pass source='model' or "
                f"extend the arch tables")
        rows = []
        for s in sizes:
            t_a, t_b = float(ta[s]), float(tb[s])
            p_a = float(a.published.get("power_w", a.power_w))
            p_b = float(b.published.get("power_w", b.power_w))
            rows.append(_row(s, source, a.name, b.name,
                             t_a, t_b, p_a, p_b))
        return rows
    rows = []
    for s in (sizes or (256, 512, 1024)):
        tr_a = _model_row_seconds(a, s, transform)
        tr_b = _model_row_seconds(b, s, transform)
        rows.append(_row(s, source, a.name, b.name,
                         tr_a.seconds * 1e3, tr_b.seconds * 1e3,
                         tr_a.power_w, tr_b.power_w, transform=transform))
    return rows


def _row(size, source, name_a, name_b, t_a_ms, t_b_ms, p_a, p_b, *,
         transform: str = "fft2") -> dict:
    e_a = p_a * t_a_ms * 1e-3                  # joules
    e_b = p_b * t_b_ms * 1e-3
    return {
        "size": int(size), "source": source, "transform": transform,
        "arch_a": name_a, "arch_b": name_b,
        "time_a_ms": t_a_ms, "time_b_ms": t_b_ms,
        "power_a_w": p_a, "power_b_w": p_b,
        "energy_a_j": e_a, "energy_b_j": e_b,
        "time_ratio": t_a_ms / t_b_ms,
        "power_ratio": p_b / p_a,
        "energy_ratio": e_b / e_a,
    }


def markdown_table(rows: List[dict]) -> str:
    """The paper's §6 table shape: per-size time/power/energy + ratios."""
    a, b = rows[0]["arch_a"], rows[0]["arch_b"]
    out = [
        f"| size | {a} t (ms) | {b} t (ms) | {a} P (W) | {b} P (W) | "
        f"{a} E (J) | {b} E (J) | slowdown | power x less | energy x less |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        tf = r.get("transform", "fft2")
        cell = f"{r['size']}x{r['size']}" if tf == "fft2" \
            else f"{tf} {r['size']}x{r['size']}"
        out.append(
            f"| {cell} | {r['time_a_ms']:.2f} | "
            f"{r['time_b_ms']:.2f} | {r['power_a_w']:.0f} | "
            f"{r['power_b_w']:.0f} | {r['energy_a_j']:.3f} | "
            f"{r['energy_b_j']:.3f} | {r['time_ratio']:.2f} | "
            f"{r['power_ratio']:.1f} | {r['energy_ratio']:.1f} |")
    return "\n".join(out)


def to_json(rows: List[dict], *, indent: int = 2) -> str:
    return json.dumps({"wormhole_vs_xeon": rows}, indent=indent,
                      sort_keys=True)


# ---------------------------------------------------------------------------
# Distributed pencil schedules (the halved-exchange table)
# ---------------------------------------------------------------------------

def dist_compare(sizes: Sequence[int] = (512, 1024), *, devices: int = 8,
                 arch="wormhole_n300", method: str = "none",
                 backend: str = "torch") -> List[dict]:
    """Per-size model rows of the complex vs real-input pencil 2-D FFT on
    ``devices`` chips: predicted wall time, energy and per-device exchange
    wire bytes from :func:`repro_torch.tt.trace.trace_dist`.  The headline
    column is ``wire_ratio`` ~ (N/2)/N = 0.5 — the ROADMAP's "halve the
    all_to_all bytes" as a number."""
    rows = []
    for s in sizes:
        tc = tttrace.trace_dist((s, s), devices=devices, arch=arch,
                                method=method, backend=backend)
        tr = tttrace.trace_dist((s, s), devices=devices, arch=arch,
                                method=method, backend=backend, real=True)
        rows.append({
            "size": int(s), "devices": devices, "arch": tc.arch,
            "method": method,
            "pfft2_wire_bytes": tc.exchange_wire_bytes,
            "prfft2_wire_bytes": tr.exchange_wire_bytes,
            "wire_ratio": tr.exchange_wire_bytes / tc.exchange_wire_bytes,
            "pfft2_ms": tc.seconds * 1e3, "prfft2_ms": tr.seconds * 1e3,
            "pfft2_energy_j": tc.energy_j, "prfft2_energy_j": tr.energy_j,
        })
    return rows


def dist_markdown_table(rows: List[dict]) -> str:
    out = [
        "| size | devices | method | pfft2 wire (B/dev) | prfft2 wire "
        "(B/dev) | ratio | pfft2 t (ms) | prfft2 t (ms) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            f"| {r['size']}x{r['size']} | {r['devices']} | {r['method']} | "
            f"{r['pfft2_wire_bytes']:.0f} | {r['prfft2_wire_bytes']:.0f} | "
            f"{r['wire_ratio']:.2f} | {r['pfft2_ms']:.3f} | "
            f"{r['prfft2_ms']:.3f} |")
    return "\n".join(out)


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch-a", default="wormhole_n300")
    ap.add_argument("--arch-b", default="xeon_8160")
    ap.add_argument("--source", default="paper", choices=("paper", "model"))
    ap.add_argument("--transform", default="fft2",
                    choices=("fft2", "rfft2"),
                    help="rfft2 compares the real-input transform "
                         "(model source only)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    rows = compare(args.arch_a, args.arch_b, source=args.source,
                   transform=args.transform)
    print(to_json(rows) if args.json else markdown_table(rows))


if __name__ == "__main__":
    main()
