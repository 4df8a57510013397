"""The port's straggler policy (a numpy-only copy) against the reference
on the same seeded timings: ``rebalance`` and ``should_eject`` return the
reference's values exactly, and keep its invariants (the assignment sums
to the total, every host gets a unit, a slower host never gets more at
smoothing 1)."""
import numpy as np
import pytest

from repro.dist import straggler as ref
from repro_torch.dist import straggler

SEEDS = range(12)


def _case(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    times = list(rng.uniform(0.5, 3.0, n))
    if seed % 3 == 0:
        times[int(rng.integers(n))] *= 8.0          # one straggler
    total = n + int(rng.integers(0, 200))
    return rng, times, total


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("smoothing", [1.0, 0.5, 0.1])
def test_rebalance_matches_reference(seed, smoothing):
    rng, times, total = _case(seed)
    prev = None if seed % 2 else list(rng.integers(1, 9, len(times)))
    got = straggler.rebalance(times, total, smoothing=smoothing,
                              prev_assignment=prev)
    assert got == ref.rebalance(times, total, smoothing=smoothing,
                                prev_assignment=prev)
    assert sum(got) == total and min(got) >= 1
    if smoothing == 1.0:
        order = np.argsort(times)                   # fastest first
        assert all(got[order[i]] >= got[order[i + 1]]
                   for i in range(len(order) - 1))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("threshold", [1.5, 3.0])
def test_should_eject_matches_reference(seed, threshold):
    _, times, _ = _case(seed)
    assert straggler.should_eject(times, eject_threshold=threshold) \
        == ref.should_eject(times, eject_threshold=threshold)


def test_rebalance_refuses_fewer_units_than_hosts():
    with pytest.raises(AssertionError):
        straggler.rebalance([1.0, 1.0, 1.0], 2)
