#!/usr/bin/env python
"""Genome-scale sequences and long reads with the PyTorch/CUDA port (mirrors
examples/long_sequence.py):

- one chromosome-length sequence sharded over the ranks of a process group
  (here one, formed on an in-memory store; several under torchrun) with a
  (k-1)-base halo from the next rank, each chunk hashed in one pass
  (``parallel/sp.py``), and
- long reads through ``hash_kmers_tm_auto``, which takes the segmented
  kernel for a few long reads.

    python examples/long_sequence_torch.py [length] [--device cuda|cpu]
"""

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from nthash_tpu_torch.ops.kmer_kernel import hash_kmers_tm_auto, prepare_codes
from nthash_tpu_torch.ops.kmer_torch import window_valid_tm
from nthash_tpu_torch.parallel import sp
from nthash_tpu_torch.parallel.mesh import (
    SEQ_AXIS, all_reduce_sum, device_mesh, initialize_distributed,
    size_and_rank,
)
from nthash_tpu_torch.u64 import to_numpy_u64

K = 32

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("length", nargs="?", type=int, default=1 << 20)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = torch.device(args.device)

rng = np.random.default_rng(0)
seq = rng.integers(0, 4, size=(args.length,), dtype=np.uint8)

if "WORLD_SIZE" in os.environ:   # started by a launcher such as torchrun
    initialize_distributed(dev)
mesh = device_mesh(axis=SEQ_AXIS, device_type=dev.type)
n, rank = size_and_rank(mesh)
length = args.length - args.length % n  # shard evenly
chunk = sp.shard_sequence(torch.from_numpy(seq[:length]).to(dev), mesh)

hashes, valid = sp.hash_long_sequence(chunk, K, 2, mesh)
nvalid = int(all_reduce_sum(valid.sum(), mesh))
if rank == 0:
    h0 = to_numpy_u64(hashes[0][:1])[0]   # first nte64 hash, window 0
    print(f"hashed {length:,} bases over {n} device(s): "
          f"{nvalid:,} valid {K}-mers")
    print(f"window 0 hash: {int(h0):#018x}")

    # long reads: the segmented kernel on a GPU, its plain version on the
    # CPU
    reads = rng.integers(0, 4, size=(4, 10_000), dtype=np.uint8)
    tm = prepare_codes(torch.from_numpy(reads).to(dev))
    res = hash_kmers_tm_auto(tm, K, 2)             # 2 x [W, R]
    first = to_numpy_u64(res[0][:1, :1])[0, 0]
    print(
        f"long reads: {reads.shape[0]} x {reads.shape[1]:,} bp -> "
        f"{int(window_valid_tm(tm, K).sum()):,} windows, "
        f"first hash {int(first):#018x}"
    )
dist.destroy_process_group()
