"""The plain bf16/float16 route's long axes on 3-D volumes under the
emulator (``_emulated``): columns of 512 over 8 columns."""
import pytest
import torch

from _emulated import emulated_fixture, long_axis_route

emulated = emulated_fixture("fft3d_fused")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(1, 4, 512, 8)])
def test_long_axis_route_matches_the_plain_version(emulated, shape, dtype):
    """The long-axis products with the thresholds lowered to 256: 3-D
    columns of 512 (16 x 32) over 8 columns, in two launches through the
    scratch pair, both directions."""
    long_axis_route(shape, dtype)
