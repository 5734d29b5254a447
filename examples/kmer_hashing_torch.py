#!/usr/bin/env python
"""k-mer hashing walk with the PyTorch/CUDA port (mirrors
examples/kmer_hashing.py, reference examples/kmer_hashing.cpp:1-20): roll a
25-bp sequence at k=9, printing each k-mer and its 3 hash values.

    python examples/kmer_hashing_torch.py [--device cuda|cpu]

The facade hashes a tile this short on the host oracle; ``engine="kernel"``
sends it through the one-sequence kernel on ``--device`` instead, with the
same output.
"""

import argparse

from nthash_tpu_torch import NtHash

SEQ = "AGCTACGATCAGCATCGATCAGCAT"
K = 9

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

for engine in ("auto", "kernel"):
    print(f"== engine={engine} ==")
    nth = NtHash(SEQ, 3, K, engine=engine, device=args.device)
    while nth.roll():
        p = nth.get_pos()
        print(SEQ[p : p + K], *(hex(h) for h in nth.hashes()))
