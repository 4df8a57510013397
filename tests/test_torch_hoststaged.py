"""``repro_torch.dist.hoststaged``: the process-group backend that runs a
gloo group's collectives on host copies (the sharded step's ranks on one
card).  Over 4 ranks on the CPU (one spawned group, rank function in
``_torch_train_ranks.py``) every collective equals what it computes by
definition, and a DTensor redistribution goes through it."""
import numpy as np
import pytest

from repro_torch.dist.local import LocalGroup

import _torch_train_ranks as ranks

WORLD = 4


@pytest.fixture(scope="module")
def results():
    with LocalGroup(WORLD, backend="gloo-host") as group:
        return group.run(ranks.host_staged_collectives)


def _x(r):
    return np.arange(4.0) + 10 * r


def test_backend_is_host_staged(results):
    assert all(r["backend"] == "gloo-host" for r in results)


@pytest.mark.parametrize("name", ["all_reduce", "all_gather_into_tensor",
                                  "all_gather", "reduce_scatter_tensor",
                                  "all_to_all_single", "broadcast",
                                  "scatter", "funcol_all_gather"])
def test_collectives_compute_their_definition(results, name):
    total = sum(_x(r) for r in range(WORLD))
    gathered = np.concatenate([_x(r) for r in range(WORLD)])
    for rank, res in enumerate(results):
        want = {"all_reduce": total,
                "all_gather_into_tensor": gathered, "all_gather": gathered,
                "funcol_all_gather": gathered,
                "reduce_scatter_tensor": total[rank:rank + 1],
                "all_to_all_single": gathered[rank::4],
                "broadcast": _x(1),
                "scatter": np.array([float(rank)])}[name]
        np.testing.assert_array_equal(res[name], want)


def test_dtensor_redistributes_through_it(results):
    """A (Shard(0) over data, Partial over model) DTensor made Replicate:
    the two model ranks' blocks summed, the two data blocks joined."""
    rows = [_x(0) + _x(1), _x(2) + _x(3)]
    for res in results:
        np.testing.assert_array_equal(res["dtensor"], np.concatenate(rows))


def test_ring_shift_goes_through_it(results):
    for rank, res in enumerate(results):
        np.testing.assert_array_equal(res["sendrecv"], _x((rank - 1) % 4))


def test_bytes_moved_equal_the_opcount(results):
    """SPENT's bytes by kind equal ``analysis.opcount``'s count of the same
    calls (a reduce-scatter and an all-gather DTensor issues); the ring
    shift's receive counts as collective-permute (a Python backend's
    point-to-point calls do not pass the op dispatcher, so opcount sees
    those on a fake or a native group only)."""
    for res in results:
        moved = dict(res["moved"])
        assert moved.pop("collective-permute") == 4 * 4
        counted = dict(res["counted"])
        assert counted.pop("collective-permute") == 0
        assert moved == counted
        assert moved["reduce-scatter"] > 0 and moved["all-gather"] > 0
