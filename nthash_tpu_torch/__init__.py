"""nthash_tpu_torch: the PyTorch/CUDA port of nthash_tpu for NVIDIA Hopper.

A second package beside the JAX one, importing torch and numpy only. The
layout mirrors ``nthash_tpu``: host constants and 64-bit primitives at top
level, the engines and hand-written CUDA kernels under ops/ (sources in
csrc/), the count-min sketch, the packed Bloom filter and the streaming
pipeline under models/,
one-device long-sequence hashing under parallel/, FASTX streaming under
io/, checkpoint/profiling under utils/.
"""

from .constants import NTHASH_FN_NAME

__version__ = "0.1.0"

__all__ = ["NTHASH_FN_NAME"]
