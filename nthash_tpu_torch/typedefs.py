"""Type aliases mirroring the reference's installed typedefs
(reference include/nthash/nthash.hpp, namespace nthash::typedefs); a copy
of ``nthash_tpu/typedefs.py``.

Python is untyped at runtime, but downstream code that ported from the
C++ API can keep using these names; the dtypes document the reference's
value ranges (num_hashes fits uint8, k fits uint16).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

#: Number of hashes per k-mer / per seed (reference: uint8_t).
NUM_HASHES_TYPE = np.uint8

#: k-mer size (reference: uint16_t).
K_TYPE = np.uint16

#: Per-seed list of [start, end) care/ignore block pairs
#: (reference: std::vector<std::array<unsigned, 2>> per seed).
SpacedSeedBlocks = List[List[Tuple[int, int]]]

#: Per-seed list of monomer positions
#: (reference: std::vector<std::vector<unsigned>>).
SpacedSeedMonomers = List[List[int]]
