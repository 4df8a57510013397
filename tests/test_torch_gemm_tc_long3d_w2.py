"""The plain bf16/float16 route's long axes on 3-D volumes under the
emulator (``_emulated``): columns of 512 over 2-wide rows."""
import pytest
import torch

from _emulated import emulated_fixture, long_axis_route

emulated = emulated_fixture("fft3d_fused")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(1, 512, 2, 2)])
def test_long_axis_route_matches_the_plain_version(emulated, shape, dtype):
    """The long-axis products with the thresholds lowered to 256: 3-D
    columns of 512 (16 x 32) over the 4 columns of 2 x 2 planes, loaded
    element by element, in two launches through the scratch pair, both
    directions."""
    long_axis_route(shape, dtype)
