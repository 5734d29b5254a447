"""nthash_tpu_torch: the PyTorch/CUDA port of nthash_tpu for NVIDIA Hopper.

A second package beside the JAX one, importing torch and numpy only. The
layout mirrors ``nthash_tpu``: the four iterator classes, ``parse_seeds``,
``NTHASH_FN_NAME`` and ``typedefs`` at top level (the reference's public
API, include/nthash/nthash.hpp:34-60), host constants, the oracle and 64-bit
primitives beside them, the engines, the blind scans and hand-written CUDA
kernels under ops/ (sources in csrc/), the count-min sketch, the packed
Bloom filter and the streaming pipeline under models/, data and sequence
parallelism over ``torch.distributed`` under parallel/, FASTX streaming
under io/, checkpoint/profiling/metrics under utils/. The JAX package's ``U64`` limb pair has
no counterpart: the port holds a uint64 as the bits of an int64 (``u64.py``).
"""

from .api import (
    BlindNtHash,
    BlindSeedNtHash,
    NtHash,
    SeedNtHash,
    parse_seeds,
)
from . import typedefs
from .constants import NTHASH_FN_NAME

__version__ = "0.1.0"

__all__ = [
    "NtHash",
    "BlindNtHash",
    "SeedNtHash",
    "BlindSeedNtHash",
    "parse_seeds",
    "NTHASH_FN_NAME",
    "typedefs",
]
