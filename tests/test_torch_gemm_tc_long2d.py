"""The plain bf16/float16 route's long axes on 2-D images under the
emulator (``_emulated``): rows of 1024 and columns of 512."""
import pytest
import torch

from _emulated import emulated_fixture, long_axis_route

emulated = emulated_fixture("fft2d_gemm")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(2, 2, 1024), (1, 512, 16)])
def test_long_axis_route_matches_the_plain_version(emulated, shape, dtype):
    """The long-axis products with the thresholds lowered to 256: rows of
    1024 (32 x 32, the second product's images folded into columns) and
    columns of 512 (16 x 32: one image of 16 columns) in two launches
    through the scratch pair, both directions."""
    long_axis_route(shape, dtype)
