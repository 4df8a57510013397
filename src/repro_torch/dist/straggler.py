"""Straggler mitigation: deterministic work rebalancing + ejection policy
(a copy of :mod:`repro.dist.straggler`, numpy only).

Production fleets are heterogeneous in practice (thermal throttling, noisy
neighbours, a failing NIC); a synchronous data-parallel step runs at the
speed of the slowest host.  ``rebalance`` reassigns per-host work shares
inversely proportional to measured step times — deterministically, so every
host computes the identical assignment from the identical timing gossip and
no coordinator round is needed — and ``should_eject`` flags hosts so slow
that dropping them beats carrying them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def rebalance(times: Sequence[float], total: int, *,
              smoothing: float = 1.0,
              prev_assignment: Optional[Sequence[int]] = None) -> List[int]:
    """Split ``total`` work units over hosts inversely to ``times``.

    Guarantees: the result sums to ``total``, every host gets at least one
    unit, and the function is a pure deterministic map of its inputs (ties
    broken by speed then index).  At ``smoothing=1.0`` (the default) a
    slower host additionally never receives more than a faster one.
    ``smoothing`` in (0, 1] damps reassignment swings: the target share is
    ``smoothing * speed_share + (1 - smoothing) * previous_share`` (uniform
    when ``prev_assignment`` is None) — deliberately biased toward the
    previous assignment, so with a small ``smoothing`` a skewed
    ``prev_assignment`` can outweigh current speeds for a few rounds; the
    speed-monotonicity guarantee applies to the blended shares, not to raw
    speeds.
    """
    n = len(times)
    assert n > 0 and total >= n, (n, total)
    speed = np.array([1.0 / max(float(t), 1e-12) for t in times])
    share = speed / speed.sum()
    if smoothing < 1.0:
        if prev_assignment is not None:
            prev = np.asarray(prev_assignment, dtype=np.float64)
        else:
            prev = np.ones(n)
        prev_share = prev / prev.sum()
        share = smoothing * share + (1.0 - smoothing) * prev_share
        share = share / share.sum()

    # one guaranteed unit each, then largest-remainder apportionment of the
    # rest; the floor (and the remainder at equal floors) is monotone in
    # share, so hosts with larger blended shares never get fewer units —
    # which at smoothing=1.0 is the slower-never-gets-more invariant
    quota = (total - n) * share
    floors = np.floor(quota).astype(int)
    assign = 1 + floors
    leftover = total - int(assign.sum())
    rem = quota - floors
    order = sorted(range(n), key=lambda i: (-rem[i], -share[i], i))
    for i in order[:leftover]:
        assign[i] += 1
    return [int(a) for a in assign]


def should_eject(times: Sequence[float], *,
                 eject_threshold: float = 3.0) -> Tuple[List[int], float]:
    """Hosts slower than ``eject_threshold`` x the median step time.

    Returns ``(indices, median)``.  The median (not the mean) is the
    yardstick so one pathological host cannot mask itself by dragging the
    average up.
    """
    med = float(np.median(np.asarray(times, dtype=np.float64)))
    idx = [i for i, t in enumerate(times)
           if float(t) > eject_threshold * med]
    return idx, med
