#!/usr/bin/env python
"""Streaming k-mer counting with the PyTorch/CUDA port (mirrors
examples/streaming_count.py): FASTA/FASTQ file -> hash+sketch, data-parallel
over the GPUs of a process group.

    python examples/streaming_count_torch.py reads.fq [k] [parse_threads]
        [--device cuda|cpu]

With parse_threads > 1 the file parses as byte-range shards in parallel
(each worker resyncs to a record boundary; the sketch is order-invariant, so
the result is bit-identical to the serial parse). Started by torchrun, one
process a GPU (``torchrun --nproc-per-node N examples/...``), every rank
joins the group, streams the file and hashes its block of each batch, and
the ranks' counts merge into every rank's sketch.
"""

import argparse
import os

from nthash_tpu_torch.models.pipeline import PipelineConfig, ReadHashingPipeline
from nthash_tpu_torch.parallel.mesh import initialize_distributed
from nthash_tpu_torch.utils import metrics

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("path")
ap.add_argument("k", nargs="?", type=int, default=32)
ap.add_argument("threads", nargs="?", type=int, default=1)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

if "WORLD_SIZE" in os.environ:   # started by a launcher such as torchrun
    initialize_distributed(args.device)
metrics.configure_logging()
pipe = ReadHashingPipeline(PipelineConfig(k=args.k, num_hashes=4),
                           device=args.device)
total = pipe.run_file(args.path, threads=args.threads)
print(f"hashed {total} valid {args.k}-mers from {args.path} "
      f"across {pipe.n_devices} device(s) "
      f"({args.threads} parse thread(s))")
