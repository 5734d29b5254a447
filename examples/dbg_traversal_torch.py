#!/usr/bin/env python
"""Batched de Bruijn graph probing with the PyTorch/CUDA port (mirrors
examples/dbg_traversal.py): the BlindNtHash use case over many walks.

The reference's BlindNtHash probes one graph walk at a time with
peek('A'/'C'/'G'/'T') (reference src/kmer.cpp:377-384). Here 4096 walks
advance in lockstep: ``peek4`` hashes all four extensions of every walk, a
membership oracle (a count-min sketch here; a Bloom filter in the wild)
scores them, and ``roll_select`` commits the best base per walk. Then
``roll_many`` replays 20 caller-fed bases per walk in one call (one launch of
the blind-roll kernel on a GPU).

    python examples/dbg_traversal_torch.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from nthash_tpu_torch.models import sketch as cms
from nthash_tpu_torch.ops import blind_scan
from nthash_tpu_torch.ops.kmer_kernel import hash_sequence

K, WIDTH_LOG2, WALKS, STEPS = 11, 16, 4096, 20

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = torch.device(args.device)
rng = np.random.default_rng(7)

# Build a "genome" and fill a sketch with its k-mer set.
genome = rng.integers(0, 4, size=200_000, dtype=np.uint8)
hashes, valid = hash_sequence(torch.from_numpy(genome).to(dev), K, 1)
sk = cms.update(cms.CountMinSketch.zeros(1, WIDTH_LOG2, dev),
                torch.stack(hashes, -1), valid, WIDTH_LOG2)

# Start walks at random genome k-mers and extend greedily by sketch support.
starts = rng.integers(0, len(genome) - K - STEPS, size=WALKS)
windows = np.stack([genome[s : s + K] for s in starts])
state = blind_scan.init_state(torch.from_numpy(windows).to(dev))
start_state = state

on_genome = 0
for _ in range(STEPS):
    probes = blind_scan.peek4(state)                 # int64 [WALKS, 4, 1]
    counts = cms.query(sk, probes, WIDTH_LOG2)       # [WALKS, 4]
    choice = torch.argmax(counts, dim=1).to(torch.int32)
    state = blind_scan.roll_select(state, choice)
    on_genome += int((counts.amax(dim=1) > 0).sum())

print(f"{WALKS} walks x {STEPS} steps; sketch-supported extensions: "
      f"{on_genome}/{WALKS * STEPS}")

# The same walks fed the genome's own next bases, all steps in one call.
follow = np.stack([genome[s + K : s + K + STEPS] for s in starts], axis=1)
_, walked = blind_scan.roll_many(start_state,
                                 torch.from_numpy(follow).to(dev))
seen = cms.query(sk, walked, WIDTH_LOG2)             # [STEPS, WALKS]
print(f"roll_many over the genome: {int((seen > 0).sum())}/"
      f"{STEPS * WALKS} windows found in the sketch")
