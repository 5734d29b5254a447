"""Command-line interface: ``python -m nthash_tpu_torch <command>``.

Counterpart of ``nthash_tpu/__main__.py``. Commands:

- ``hash``:  print ntHash2 hashes for a sequence (or stdin lines), through
  the facade (``NtHash`` / ``SeedNtHash``): the oracle below the facade's
  threshold, the kernels on ``--device`` above it.
- ``count``: stream a FASTA/FASTQ file through the hash-and-sketch pipeline;
  print totals, throughput and the devices it ran on (the process group's
  world size when one was formed, else 1). ``--trace DIR`` runs the count
  under ``utils/profiling.trace``: one Chrome trace in DIR with the
  stream's spans (parse, wait, copy, step) beside the device's rows.
"""

from __future__ import annotations

import argparse
import sys
import time
from contextlib import nullcontext


def _cmd_hash(args) -> int:
    from . import NtHash, SeedNtHash

    seqs = args.sequence or [line.strip() for line in sys.stdin if line.strip()]
    for seq in seqs:
        if args.seeds:
            nth = SeedNtHash(seq, tuple(args.seeds), args.num_hashes, args.k,
                             device=args.device)
        else:
            nth = NtHash(seq, args.num_hashes, args.k, device=args.device)
        while nth.roll():
            p = nth.get_pos()
            print(seq[p : p + args.k], *(f"{h:016x}" for h in nth.hashes()))
    return 0


def _cmd_count(args) -> int:
    import torch

    from .models.pipeline import PipelineConfig, ReadHashingPipeline
    from .utils import metrics, profiling

    metrics.configure_logging()
    pipe = ReadHashingPipeline(
        PipelineConfig(k=args.k, num_hashes=args.num_hashes,
                       sketch_width_log2=args.width_log2),
        device=args.device,
    )
    where = f"on {pipe.n_devices} device(s) ({pipe.device})"
    traced = profiling.trace(args.trace) if args.trace else nullcontext()
    t0 = time.perf_counter()
    if args.fused:
        with traced:
            reads = pipe.count_file(args.file, batch_size=args.batch_size,
                                    threads=args.threads)
        total = int(pipe.sketch.rows[0].sum(dtype=torch.int64))
        dt = time.perf_counter() - t0
        print(f"{reads} reads, {total} valid {args.k}-mers in {dt:.2f}s "
              f"({reads / max(dt, 1e-9):.3g} reads/s) {where}")
        return 0
    with traced:
        total = pipe.run_file(args.file, batch_size=args.batch_size,
                              threads=args.threads)
    dt = time.perf_counter() - t0
    print(f"{total} valid {args.k}-mers in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.3g} k-mers/s) {where}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nthash_tpu_torch",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="command", required=True)

    ph = sub.add_parser("hash", help="print hashes of sequences")
    ph.add_argument("sequence", nargs="*", help="sequences (default: stdin)")
    ph.add_argument("-k", type=int, default=32)
    ph.add_argument("-n", "--num-hashes", type=int, default=1)
    ph.add_argument("-s", "--seeds", action="append",
                    help="spaced-seed pattern (repeatable)")
    ph.add_argument("--device", default="cuda",
                    help="torch device to hash on (default: cuda)")
    ph.set_defaults(fn=_cmd_hash)

    pc = sub.add_parser("count", help="stream a FASTA/FASTQ into a sketch")
    pc.add_argument("file")
    pc.add_argument("-k", type=int, default=32)
    pc.add_argument("-n", "--num-hashes", type=int, default=4)
    pc.add_argument("--width-log2", type=int, default=20,
                    help="sketch width 2**W, W in [10, 30] (default 20)")
    pc.add_argument("--batch-size", type=int, default=65536)
    pc.add_argument("--fused", action="store_true",
                    help="fused hash->count path (sketch only, fastest)")
    pc.add_argument("--threads", type=int, default=1,
                    help="byte-range shard parse threads (native parser)")
    pc.add_argument("--device", default="cuda",
                    help="torch device to count on (default: cuda)")
    pc.add_argument("--trace", metavar="DIR",
                    help="write a Chrome trace of the count, the program's "
                    "spans beside the device's rows, to DIR/trace.<pid>.json")
    pc.set_defaults(fn=_cmd_count)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, FileNotFoundError) as e:
        # reference raise_error prints to stderr and exits 1
        # (reference src/internal.hpp:16-22)
        print(e, file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
