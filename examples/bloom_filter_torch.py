#!/usr/bin/env python
"""Packed Bloom filter over a read batch with the PyTorch/CUDA port (mirrors
examples/bloom_filter.py): build, merge, union across ranks, query.

    python examples/bloom_filter_torch.py [width_log2] [--device cuda|cpu]

The hash kernel gives every window's hashes, one ``bloom_words`` launch sets
their bits (``csrc/bloom.cu`` on a GPU, its plain version on the CPU), and
queries are gathers. Two half-filters merge by OR; ``union_across`` is the
same OR over the ranks of a process group (one all-gather), here a group of
one, formed on an in-memory store.
"""

import argparse

import numpy as np
import torch
import torch.distributed as dist

from nthash_tpu_torch.models.bloom import (
    BloomFilter, contains, fill_ratio, insert, merge, union_across,
)
from nthash_tpu_torch.ops.kmer_kernel import hash_kmers_tm_auto, prepare_codes
from nthash_tpu_torch.ops.kmer_torch import window_valid_tm
from nthash_tpu_torch.parallel import sp
from nthash_tpu_torch.parallel.mesh import device_mesh

K, NUM_HASHES = 25, 3

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("width_log2", nargs="?", type=int, default=20)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev, wl = torch.device(args.device), args.width_log2

rng = np.random.default_rng(7)
reads = rng.integers(0, 4, size=(512, 100), dtype=np.uint8)


def batch_hash(codes):
    """-> hashes int64 [W, B, H], valid [W, B]"""
    tm = prepare_codes(torch.from_numpy(codes).to(dev))
    return (torch.stack(hash_kmers_tm_auto(tm, K, NUM_HASHES), -1),
            window_valid_tm(tm, K))


# build: one filter per half of the batch, then a lossless OR-merge, and
# the same OR over the ranks of a process group (here one rank)
halves = [insert(BloomFilter.zeros(wl, dev), *batch_hash(part), wl)
          for part in (reads[:256], reads[256:])]
bf = merge(*halves)
mesh = device_mesh(device_type=dev.type)
bf = BloomFilter(union_across(bf.words, mesh))

# query: every inserted k-mer must be present (no false negatives)
hashes, valid = batch_hash(reads)
hits = int((contains(bf, hashes, wl) & valid).sum())
total = int(valid.sum())
assert hits == total, "a Bloom filter never has false negatives"

# negative controls: random k-mers should mostly miss at low fill
probe = torch.from_numpy(rng.integers(0, 4, size=20_000, dtype=np.uint8))
phashes, pvalid = sp.hash_long_sequence(probe.to(dev), K, NUM_HASHES)
fp = int((contains(bf, torch.stack(phashes, -1), wl) & pvalid).sum())
print(
    f"width 2^{wl}: inserted {total} k-mers, "
    f"fill {float(fill_ratio(bf)):.4f}, "
    f"0 false negatives, {fp}/{int(pvalid.sum())} probe hits"
)
dist.destroy_process_group()
