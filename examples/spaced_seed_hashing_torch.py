#!/usr/bin/env python
"""Spaced-seed hashing with the PyTorch/CUDA port, two ways (mirrors
examples/spaced_seed_hashing.py).

1. The scalar facade: SeedNtHash walks a sequence under two patterns.
2. The batched engine: the same hashes for every window of a read batch in
   one call (``ops.seed_kernel.hash_seeds_batch``: the CUDA kernel on a GPU
   tensor, its plain version on a CPU one).

    python examples/spaced_seed_hashing_torch.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from nthash_tpu_torch import SeedNtHash
from nthash_tpu_torch.constants import encode_ascii
from nthash_tpu_torch.ops.seed_kernel import hash_seeds_batch
from nthash_tpu_torch.u64 import to_numpy_u64

SEQ = "TGACTGATCGAGTCGTACTAG"
SEEDS = ("10101", "11011")

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

print("== scalar facade ==")
nth = SeedNtHash(SEQ, SEEDS, 3, 5, device=args.device)
while nth.roll():
    p = nth.get_pos()
    print(p, SEQ[p : p + 5], *(hex(h) for h in nth.hashes()[:2]), "...")

print("\n== batched engine ==")
batch = np.stack([encode_ascii(SEQ), encode_ascii(SEQ[::-1])])
hashes, valid = hash_seeds_batch(torch.from_numpy(batch).to(args.device),
                                 SEEDS, 3)
host = to_numpy_u64(hashes)
print("hashes shape [B, W, S*H]:", host.shape)
print("read 0, window 0:", [hex(int(h)) for h in host[0, 0][:3]])
