#!/usr/bin/env python
"""Where the facade's kernel engine starts to beat the host oracle on a tile.

The stored-sequence classes hash one tile at a time, through the host oracle
or through the one-sequence kernel entry (``engine="kernel"``, on
``--device``: the CUDA kernel on a GPU, its plain PyTorch version on the
CPU). This times one tile both ways at 2**4 .. 2**16 windows (k=32, h=1,
the CLI's defaults; medians of 3 host timings, the kernel's host->device and
device->host copies included) and prints where the kernel starts to win:
``nthash_tpu_torch.api.AUTO_DEVICE_THRESHOLD_CPU`` is that number for
``--device cpu``; ``--device cuda`` measures the card's
(``AUTO_DEVICE_THRESHOLD``: 64 windows on an NVIDIA H100 80GB HBM3 at
700 W; CHANGES.md, readings behind the comments).

    python examples/facade_threshold_torch.py [--device cuda|cpu]
"""

import argparse
import statistics
import time

import numpy as np
import torch

from nthash_tpu_torch import api, oracle

K = 32

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
ap.add_argument("--max-log2", type=int, default=16)
args = ap.parse_args()
dev = torch.device(args.device)


def median_s(fn, runs=3):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


codes = np.random.default_rng(0).integers(
    0, 4, size=(1 << args.max_log2) + K - 1, dtype=np.uint8)
api._kernel_tile(codes[:K], K, 1, dev)  # warm-up: the build, the context
wins = None
for e in range(4, args.max_log2 + 1):
    chunk = codes[:(1 << e) + K - 1]
    t_o = median_s(lambda: oracle.hash_all_windows(chunk, K, 1))
    t_k = median_s(lambda: api._kernel_tile(chunk, K, 1, dev))
    wins = (wins or 1 << e) if t_k < t_o else None
    print(f"{1 << e} windows: oracle {t_o * 1e3:.4f} ms, kernel tile "
          f"{t_k * 1e3:.4f} ms on {dev}")
print(f"the kernel wins from {wins} windows on ({dev}); the facade's "
      f"constant: {api._auto_device_threshold(dev)}")
