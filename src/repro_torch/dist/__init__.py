"""Multi-rank layer (counterpart of :mod:`repro.dist`): pencil FFTs,
compressed collectives, straggler mitigation, pipeline parallelism.

Everything here runs on one rank of a ``torch.distributed`` group over a
named ``DeviceMesh`` (:func:`make_mesh`); each function takes and returns
the rank's local blocks.  The reference's ``shard_map`` has no
counterpart: the functions are the per-rank bodies.
"""
from . import compression, hoststaged, pencil, pipeline, straggler  # noqa: F401
from ._compat import all_to_all, assemble, local_block, make_mesh  # noqa: F401
from .compression import (all_to_all_compressed, psum_compressed,  # noqa: F401
                          wire_bytes)
from .pencil import (pfft1d, pfft2, pfft2_hierarchical, pfft3,  # noqa: F401
                     pirfft2, prfft2, pack_half_spectrum,
                     unpack_half_spectrum)
from .pipeline import pipelined_apply  # noqa: F401
from .straggler import rebalance, should_eject  # noqa: F401

hoststaged.register()
