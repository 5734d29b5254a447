"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py [--seed N]

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and nvcc; it
imports nothing of JAX. Phases, each printing its own lines:

1. environment: card name and power limit, torch / CUDA / nvcc versions;
2. build the eight CUDA sources from ``nthash_tpu_torch/csrc`` (one nvcc
   each, all at once) and print each kernel instance's registers and
   spills (template arguments demangled); no ``seed_hash`` instance, no
   one-sequence instance and no partition instance may spill; the four
   one-sequence instances' resident warps a multiprocessor; the merge's
   cluster pass's shared bytes and the clusters of 2, 4 and 8 blocks
   resident at once (each must be at least one), the resident blocks of
   ``partition_bounds_kernel`` and of each grouped merge pass;
3. golden ntHash2 vectors through the rolling-hash kernel;
4. each kernel against its plain PyTorch version on the card, exact (the
   hash kernel also on one full main-path batch of 2**18 reads);
5. the width-2**14 path: ``ReadHashingPipeline.count_file`` over a 1M-read,
   150-bp FASTQ at k=32, 4 hashes, checked against the plain hash->count,
   with both kernels' launch counts (every histogram launch by private
   counters);
6. timings (median of 5 CUDA-event timings after warm-up) of each kernel
   and its plain version at that path's shapes (the histogram by private
   counters beside direct atomics forced, in turns, with its bound and
   ``torch.bincount``), the fused step and ``count_file``;
7. one warm ``count_file`` at 2**14 under ``torch.profiler``: device busy
   time, the device's idle share, device time per kernel and copy;
8. the partition kernels against their plain versions at every planned
   width 2**19..2**30, the partitioned histogram against the plain one
   (sparsely at 2**30), a skewed stream through the gated fallback and a
   mostly-sentinel stream that must not trip it;
9. the main path at ``PipelineConfig()`` (width 2**20): ``count_file`` over
   the same FASTQ against the plain hash->count, the hash and histogram
   kernels' launch counts (the histogram by the rule's route, binned on
   every batch: one binning pass and one range pass a launch) and no
   partition kernel's; off the path, ``partitioned_histogram_rows`` over
   the same reads' buckets against the sketch, each partition kernel
   against its plain version on the main path's own batches, and whether
   the overflow flag fired;
10. timings at 2**20: each partition kernel, its plain version, its bound
   and its library call (``torch.sort`` for the tile sort,
   ``torch.searchsorted`` over the prepared row maxima for the table, with
   the table's sector floor); the same at the 2**30 plan on the Bloom
   path's buckets of the 1M reads (four batches of [1, 64, 16384, 128],
   every kernel first checked against its plain version on batch 0); the
   sub-histograms by both routes; the partitioned
   against the rule's histogram per batch at 2**20..2**30; the histogram
   at full width over all 1M reads, binned and direct; the fused step
   beside the old partitioned route, in turns; ``count_file``, and one traced ``count_file`` for the
   idle share;
11. the long-read kernel B2 (``hash_kmers_tm_long``) and the spaced-seed
   kernels B1 (``hash_seeds_tm``) and B3 (``hash_seeds_tm_long``) against
   their plain versions at edge shapes (L = k, a time tile >= W or not
   dividing W, R = 1, R not a multiple of 32, k = 1 to 64, one-care-position
   seeds, one to four seeds, 41 care runs, a 3,002-base seed, fwd/rev and
   bucket modes), the staged seed kernel as the wrappers pick it and the
   global one forced, and A1 against B2 there;
12. the SEED18 golden vectors through B1 and B3 and the BASELINE seeds'
   goldens through ``hash_seeds_batch``;
13. spaced seeds at the BASELINE configuration (seeds 10101 and 11011, 3
   hashes each): ``hash_seeds_batch`` over the 1M reads (B1, the staged
   kernel) against the plain version in 65,536-read chunks and the direct
   engine, and ``hash_seeds_tm_long`` at [10000, 16384] (B3); launches;
   timings, the staged kernel beside the global one (the old design) in
   turns;
14. long reads: ``count_file`` at ``PipelineConfig()`` over 16,384 reads x
   10,000 bp in batches of 4,096 (through B2) against the plain
   hash->count on every batch, launches per kernel (no partition kernel), reads/s, bases/s and
   the traced idle share with device time by row; B2 against its plain
   version and A1 at [10000, 16384], and their timings;
15. the A1/B2 crossover grid (L in 150, 1,000, 10,000; R from 4,096 to
   2**20) that sets ``kmer_kernel.long_read_threshold``;
16. one long sequence on one device: ``sp.hash_long_sequence`` over 2**27
   bases and ``sp.hash_long_sequence_seeds`` over 2**25, each one launch of
   its one-pass entry (kmer_hash.cu's, seed_hash.cu's) and no read kernel,
   against its plain version, the old pseudo-read route (rebuilt here from
   ``pseudo_reads``, ``prepare_codes``, the read kernel and the transpose)
   and a whole-sequence roll at segment boundaries, and at a prime length,
   padded and not, for the tail; each timed beside the old route and the
   segmented read kernel over the sequence as one read [C, 1], with its
   bound and windows/s;
17. the Bloom kernels C1 (``bloom_words``) and C2 (``bloom_words_rows``)
   against their plain versions at edge shapes (widths 2**12, 2**13, 2**18,
   2**26 and, for C1, 2**31; R = 1, 3, 5; weights, gate, ``out``; at 2**26
   and 2**31 more updates than the grid has threads, into sparse words),
   with the fill ratio of the words compared;
18. the Bloom path over the same 1M reads in batches of 2**18:
   ``hash_kmers_tm_auto(..., emit_buckets=wl)`` -> ``insert_from_buckets``
   at 2**17, 2**20 and 2**30 (one C1 call a batch by the rule's route:
   private words at 2**17 and 2**20, binned at 2**30; no partition kernel),
   each filter against the plain hash -> plain insert, with ``contains``
   true on every valid window, a merge of two half-filters equal to the
   whole, C1 against plain at batch 0's launch shape (sparse as well as
   saturated: the stream emitted at 2**30); off the path, the partitioned
   words (C3, through C2) over the same reads at 2**20 and 2**30 against
   the filter, C2 on batch 0's windows, and whether the overflow flag
   fired;
19. Bloom timings: C1 as the path launches it at each width, C2 at the
   2**20 and 2**30 sub-widths and ``partitioned_bloom_words`` whole, the
   scatter yardstick (``index_fill_`` into a uint8 presence, then a pack),
   the plain versions, the byte bounds, the Bloom step's k-mers/s at each
   width beside the old route forced, in turns, and one traced step at
   2**20.

20. the two redesigned kernels against their plain versions: both routes of
   the presence-word kernel (private words in shared memory, direct
   atomics), each forced, with weights, a closed and an open gate and an
   ``out`` that already holds bits, at widths 2**12..2**20, on the hot-row
   shape [128, N] at 2**13, on the 2**30 plan's [8192, 32768] rows at 2**17
   and on sparse words at 2**18; the route the shapes select; ``sort_tiles``
   against ``sort_tiles_plain`` at tiles of 128 ints up to 2**15, in chunks
   of one, two and 64 tiles, on random 21- and 31-bit keys, all-equal keys,
   all-sentinel tiles, sorted and reversed input, and the merge rounds up
   to a sorted chunk (chunks of up to 256 tiles: every launch
   ``part_kernel.merge_plan`` picks);
21. their timings in one call with their yardsticks: per batch at 2**20,
   the presence words of the windows by private words, by direct atomics,
   and the sub-histograms (A2) of the same windows; the direct route on the
   same windows shuffled inside each row and interleaved across rows (what
   makes the direct route slow there); C1 at 2**17 and the 2**30 plan's rows
   by both routes; one unpartitioned C1 launch at full width 2**20 by both;
   both routes on fresh sparse words at 1 to 64 entries per word (what the
   route rule's constant rests on);
22. the row histogram (A2) by route: private counters, direct atomics
   (each forced) and plain against each other, exactly, at 2**10..2**15
   with weights per row, shared and absent, gate 0 and 1, an accumulating
   ``out``, odd N, an unaligned view and out-of-range indices; the same on
   the partitioned path's sub-histograms of batch 0 at 2**20 and 2**30
   (run right after phase 4);
23. its timings in one call: two skewed streams at 2**20 (every entry one
   value; one eighth one value), the direct histogram beside the
   partitioned one; private against direct counters at 1 to 64 entries per
   counter a block (what the route rule's constant rests on);
24. the unpack kernel (``ops/unpack_kernel.py``, ``csrc/unpack.cu``) against
   its plain version, exactly, at L = 1, 3, 4, 7, 8, 31, 150 and 10,000 x
   B = 1, 33, 4,096 and 2**18 (all five codes, padding rows), and on each
   packed batch of the 1M reads against ``prepare_codes`` of the batch
   unpacked; its time, its byte bound, the plain version's and
   ``prepare_codes``' (the yardstick);
25. ``count_file`` by route over the 1M-read FASTQ at 2**14 and 2**20:
   threads 1, 2, 4, 8 (up to the cores available, printed first) x
   ``pack_h2d`` off and on, each sketch against the plain count (phases 5
   and 9), with its launches (no partition kernel; the unpack kernel on
   every packed batch and on no other), reads/s as the median of 3, the
   parse alone per thread count; at 2**20 the two places the host work
   could go instead (the producer copying codes into the pinned buffer, at
   one thread and at half the cores; the Prefetcher thread packing after a
   parallel parse, at half the cores); one traced run of every route at
   2**20 (its idle share and copy time), by row for the fastest and the
   serial one; host->device copy rates
   from pageable and pinned memory, codes and packed; the long reads by
   the fastest route against the serial one; and 1M reads in 62 batches of
   2**14, packed and not, against the plain count;
26. the one-sequence entries with ``emit_fwd_rev=True`` (the facade's
   tiles) against their plain versions at every entry, invalid windows
   included, at C in {1, k, span - 1, span + 1, 2**22 + 17}, k in {1, 5, 32,
   97}, h in {1, 4}, the BASELINE seeds and SEEDS18 (the seed route also
   through B1 over pseudo-reads, where seeds do not fit the entry); their
   hashes and validity equal the route without the flag; both instances
   timed in turns at 2**27 bases (k=32, h=1) and 2**25 (BASELINE seeds)
   beside the route without the flag and the old pseudo-read route with
   fwd/rev; after the last phase one ``[share]`` line an instance gives
   its time against its byte bound;
27. the facade over 2**25 bases with ~1% N in runs, k=32, h=4, tiles of
   2**22 windows: ``NtHash.__iter__`` over every window (its count against
   ``oracle.nthash_positions``, its hashes against the oracle at 10,000
   seeded positions and +-32 around each of the seven tile boundaries),
   ``roll()`` over 2**21 + 1,000 windows across a boundary, ``roll_back()``
   across another and ``peek``/``peek_back`` in lockstep with the oracle
   engine, ``SeedNtHash`` (BASELINE seeds) over 2**23 bases against
   ``oracle.seed_nthash_positions`` and the oracle at windows holding an N,
   ``BlindNtHash`` / ``BlindSeedNtHash`` over 200,000 fed bases; rates
   (medians of 3), each tile's kernel and device->host copy ms, and the
   fwd/rev launches (one a tile);
28. the facade's threshold: one tile through the oracle and through the
   kernel (copies included) at 2**4 .. 2**16 windows, and where the kernel
   starts to win (``api.AUTO_DEVICE_THRESHOLD``);
29. the blind-roll kernel (``csrc/blind.cu``, ``roll_many`` of
   ``ops/blind_scan.py`` and ``ops/blind_seed_scan.py``) against the step
   loop at B in {1, 31, 33, 4097}, T in {1, k - 1, k, k + 1, 257}, k in {1,
   5, 32, 97}, h in {1, 4}, the BASELINE seeds and SEEDS18; the DBG probe at
   2**20 walks, k=32, 64 steps (``peek4`` -> Bloom ``contains`` at 2**30
   bits -> argmax -> ``roll_select``; the filter filled with a 2**25-base
   genome), the chosen bases replayed through ``roll_many`` (one launch)
   and its plain version against the walked state, ms per step and its
   parts, ``roll_select`` / ``roll_back_select`` alone; ``roll_many`` at
   B = 2**20, T = 64, h = 4 against its byte bound and the plain loop, and
   the seed kernel on 2**18 walks fed the genome (BASELINE seeds, h=3)
   against its plain version and ``hash_seeds_sequence``;
30. the multi-GPU paths (``parallel/mesh.py``, ``parallel/dp.py``, the halo
   exchange of ``parallel/sp.py``, ``models/bloom.union_across``): in a real
   NCCL group of world size 1 (a FileStore, no port), ``count_file`` at
   ``PipelineConfig(n_devices=1)`` over the 1M reads against phase 9's
   sketch, ``dp.fused_count`` and ``hash_and_sketch`` on one 2**18 batch
   against the one-device step, the 1M reads through ``dp.fused_count`` and
   their 2**20 filter through ``union_across`` against phases 9 and 18,
   ``union_across`` of phase 18's 2**30 filter, ``sp.hash_long_sequence``
   (2**27) and ``_seeds`` (2**25) over the mesh against phase 16, with the
   A1/A2/C1/sequence launches and no plain version on the card; gloo groups
   of 2 and 4 ranks sharing the one card (CUDA tensors, every rank a
   process of this script started with ``--rank``), each rank's blocks of
   the 1M reads, 2**20 filter and chunk of a 2**24-base sequence against
   the one-device results; times of the sketch's all-reduce, the dp step
   beside ``fused_count_step`` and ``union_across`` at 2**30;
31. the binned routes of A2 and C1 (``csrc/bin.cuh``'s binning pass, then
   ``histogram_ranges_kernel`` / ``bloom_ranges_kernel``; run after phase
   29): each forced, against plain and direct with ``torch.equal`` on whole
   tables, on batch 0's [4, n] buckets at 2**20 and stream at 2**30 and at
   edge shapes (n of 1 to 100,003, fewer than the ranges, a row off a
   16-byte boundary, every entry in one range, every entry one value,
   sentinel-only rows, a gate of 0 and 1 into an accumulating ``out``, C1
   weights, 5M updates) at widths 2**16..2**27 (A2) and 2**21..2**31 (C1),
   one C1 compare below a fill of 0.5; ``bin_ranges`` against its plain
   version (counts, starts, blocks; each range's offsets as a multiset);
   forced binned routes refused where there is none. Then, in turns with
   the card's name and power limit on each line: binned against direct
   for A2 at 2**20 and C1 at 2**30 over the 1M reads, each pass alone, the
   plain versions, bounds and yardsticks; phase 23's skewed streams; the
   fused step at 2**20 and the Bloom step at 2**30 by the rule and without
   a binned route; the sweep of updates a call that sets
   ``hist_kernel.BINNED_MIN_ENTRIES`` and ``BINNED_MIN_WORD_ENTRIES``;
32. screening at the ``screen_short_resident`` cell's shape (run after
   phase 31): a 2**28-bit filter of a 4,641,652-base genome under the
   cell's four spaced seeds (k=32, 4 hashes each), built through B1 and
   ``insert_from_buckets``, against the plain hash -> plain insert and
   with every genome window hitting; one batch of 2**18 genome reads
   through ``bloom.screen_reads`` (one B1 launch, one probe launch), B1's
   16 bucket planes against ``hash_seeds_tm_plain`` and the probe's
   counts against ``probe_counts_plain``; both kernels timed with their
   plain versions and byte bounds, and ``screen_reads`` whole.

A failed check raises, so the exit code is not 0. The line before the last
is the kernels' JSON record; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from nthash_tpu_torch import (
    BlindNtHash,
    BlindSeedNtHash,
    NtHash,
    SeedNtHash,
    api,
    oracle,
)
from nthash_tpu_torch.io import native_loader
from nthash_tpu_torch.io.stream import (
    Prefetcher,
    pack_codes,
    packed_batches,
    packed_shapes,
    stream_code_batches,
    stream_code_batches_parallel,
)
from nthash_tpu_torch.constants import encode_ascii, extend_hashes
from nthash_tpu_torch.models import bloom
from nthash_tpu_torch.models import sketch as cms
from nthash_tpu_torch.models.pipeline import (
    PipelineConfig,
    ReadHashingPipeline,
    fused_count_step,
)
from nthash_tpu_torch.ops import (
    blind_kernel,
    blind_scan,
    blind_seed_scan,
    cuda_build,
    hist_kernel,
    kmer_kernel,
    kmer_torch,
    probe_kernel,
    seed_torch,
    unpack_kernel,
)
from nthash_tpu_torch.ops import part_kernel as pk
from nthash_tpu_torch.ops import seed_kernel as sk
from nthash_tpu_torch.ops.hist_kernel import histogram_rows, histogram_rows_plain
from nthash_tpu_torch.ops.kmer_kernel import (
    hash_kmers_tm,
    hash_kmers_tm_plain,
    prepare_codes,
)
from nthash_tpu_torch.parallel import dp, mesh, sp
from nthash_tpu_torch.u64 import to_numpy_u64
from nthash_tpu_torch.utils.profiling import timeit, trace_device

K, H, WLOG, L = 32, 4, 14, 150
N_READS = 1_000_000
BATCH = 1 << 18
N_RATE = 0.01

# NtHash("TGACTGATCGAGTCGTACTAG", k=5): (pos, fwd, rev, canonical), captured
# from a build of the reference library (tests/test_golden.py README_K5).
GOLDEN_SEQ = "TGACTGATCGAGTCGTACTAG"
GOLDEN_K5 = [
    (0, 0x2C984DF375275F54, 0x33D712CF31D61DD9, 0x606F60C2A6FD7D2D),
    (1, 0x53AB9BBF14511759, 0x1E926CF9780AB81D, 0x723E08B88C5BCF76),
    (2, 0x9D9B16C7F7804E4F, 0x82D449FBB3710CC2, 0x206F60C3AAF15B11),
    (3, 0x831C12341C225650, 0x1D7F3B212029E306, 0xA09B4D553C4C3956),
    (4, 0x05D3D5630EE1EE7A, 0x1D856FFCF44D5255, 0x23594560032F40CF),
    (5, 0x013CAA9FE3DC7505, 0x89BB52619AC71FDB, 0x8AF7FD017EA394E0),
    (6, 0x38B57486189A8AF7, 0xC940D6B7C217DF21, 0x01F64B3DDAB26A18),
    (7, 0xC027A1920BA2B853, 0xE936D7E76EF87970, 0xA95E79797A9B31C3),
    (8, 0x83B3345820EFBE24, 0xA2612D0D21FF79CE, 0x2614616542EF37F2),
    (9, 0x048D99BB777A3E92, 0x420A64EAF4A61F31, 0x4697FEA66C205DC3),
    (10, 0x2F6ED7AC26473A89, 0xA0F0CAF1E101AEF5, 0xD05FA29E0748E97E),
    (11, 0xE6F790E3BFACBFDD, 0x8C6D7AA40911B21D, 0x73650B87C8BE71FA),
    (12, 0xF723007CA07B1F47, 0xCBABC2D50BFC89C2, 0xC2CEC351AC77A909),
    (13, 0xF57CFFF55E1E9F16, 0xF8B3F1B66A6F749F, 0xEE30F1ABC88E13B5),
    (14, 0xF1D48693A3DA13ED, 0x24FF5C94287C6C91, 0x16D3E327CC56807E),
    (15, 0xD9652C9C98964727, 0x9FE2D1CD1B4A6684, 0x7947FE69B3E0ADAB),
    (16, 0xB8515960CF3327BE, 0xC8888D786D4485B3, 0x80D9E6D93C77AD71),
]
# NtHash("ACATGCATGCA", h=3, k=5) windows 1..2 (reference tests.cpp:54-57).
GOLDEN_ACATG = [
    (1, (0x38CC00F940AEBDAE, 0xAB7E1B110E086FC6, 0x011A1818BCFDD553)),
    (2, (0x603A48C5A11C794A, 0xE66016E61816B9C4, 0xC5B13CB146996FFE)),
]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|; int64 tensors are compared as the uint64 they hold."""
    if a.dtype == torch.int64:
        x, y = to_numpy_u64(a), to_numpy_u64(b)
        return float(np.where(x > y, x - y, y - x).max(initial=0))
    return float((a.long() - b.long()).abs().max())


def phase_env() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    release = next((ln.split("release")[1].split(",")[0].strip()
                    for ln in nvcc.splitlines() if "release" in ln), "?")
    print(smi)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {release} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi, torch.cuda.get_device_name(0)


SOURCES = ("kmer_hash", "histogram", "partition", "seed_hash", "bloom",
           "unpack", "blind", "probe")
#: Updates in phase 17's widest checks: five per thread of the largest grid
GRID_STRIDE_N = 5 * (1 << 20) + 3


def phase_build() -> None:
    t0 = time.perf_counter()
    for name in SOURCES:  # build anew, so ptxas reports every instance
        (cuda_build.BUILD_DIR / f"lib{name}.so").unlink(missing_ok=True)
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source
        list(pool.map(cuda_build.build, SOURCES))
    for name in SOURCES:
        cuda_build.load(name)
    print(f"[build] {len(SOURCES)} sources built and loaded in "
          f"{time.perf_counter() - t0:.3f} s")
    spills = []
    for name in SOURCES:
        kernel = "?"
        for ln in cuda_build.BUILD_LOGS.get(name, "").splitlines():
            instance = kernel_instance(ln)
            if instance:
                kernel = instance
            elif "spill" in ln or "registers" in ln:
                print(f"[build] {name} {kernel}: "
                      f"{ln.replace('ptxas info    :', '').strip()}")
                if ((name == "seed_hash" or "_sequence_kernel" in kernel
                     or name == "partition" or "bin_scatter_kernel" in kernel)
                        and re.search(r"[1-9]\d* bytes spill", ln)):
                    spills.append(kernel)
    require(all(cuda_build.BUILD_LOGS.get(name) for name in SOURCES),
            "a source was not built in this run: no ptxas report")
    require(not spills, "seed_hash, one-sequence, partition or binning "
            f"scatter instances spill: {spills}")
    res = pk.merge_resources()
    span = pk.MERGE_MAX_SPAN
    print(f"[build] partition: sort_span_kernel<4, true> (the merge's cluster "
          f"pass) {(span + span // 2) * 4} bytes of dynamic shared memory a "
          f"block (the tile and the half it receives), "
          f"512 threads; clusters resident at once by size {res['clusters']}; "
          f"resident blocks a multiprocessor {res['blocks']} (256 threads, no "
          "dynamic shared memory)")
    require(all(n > 0 for n in res["clusters"].values()),
            f"a merge cluster size cannot be resident: {res['clusters']}")
    for fr in (False, True):  # k=32 and the BASELINE seeds, h=1
        print(f"[build] resident warps a multiprocessor, fwd/rev {fr}: "
              f"kmer_sequence_kernel {kmer_kernel.sequence_resident_warps(K, 1, fr)}, "
              f"seed_sequence_kernel {sk.sequence_resident_warps(SEEDS, 1, fr)}")


#: Itanium codes of the template type arguments the kernels take.
TYPE_CODES = {"t": "unsigned short", "j": "unsigned int", "i": "int"}


def kernel_instance(line: str) -> str | None:
    """The kernel a ptxas line names, with its template arguments (ints,
    bools and types) demangled: ``seed_staged_kernel<true>``,
    ``sort_span_kernel<4>``, ``bin_scatter_kernel<unsigned short>``."""
    m = re.search(r"([a-z][a-z_]*_kernel)(?:I((?:L[a-z]+\d+E|[a-z])+)E)?E",
                  line)
    if not m:
        return None
    args = [TYPE_CODES.get(ty, ty) if ty else
            ("true" if v == "1" else "false") if t == "b" else v
            for t, v, ty in re.findall(r"L([a-z]+?)(\d+)E|([a-z])",
                                       m.group(2) or "")]
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def phase_golden(dev) -> None:
    reps = 3  # several identical reads: every thread must agree
    tm = prepare_codes(torch.from_numpy(
        np.tile(encode_ascii(GOLDEN_SEQ), (reps, 1))).to(dev))
    outs = hash_kmers_tm(tm, 5, 3, emit_fwd_rev=True)
    canon, e1, e2, fwd, rev = (to_numpy_u64(o) for o in outs)
    for pos, f, r, c in GOLDEN_K5:
        want = extend_hashes(f, r, 5, 3)
        require(want[0] == c, "host extend_hashes disagrees with the golden")
        for got, exp in ((fwd, f), (rev, r), (canon, c), (e1, want[1]),
                         (e2, want[2])):
            require(bool((got[pos] == np.uint64(exp)).all()),
                    f"golden mismatch at window {pos}")
    tm2 = prepare_codes(torch.from_numpy(encode_ascii("ACATGCATGCA")[None]).to(dev))
    h3 = [to_numpy_u64(o) for o in hash_kmers_tm(tm2, 5, 3)]
    for pos, vals in GOLDEN_ACATG:
        require(tuple(int(h[pos, 0]) for h in h3) == vals,
                f"ACATGCATGCA golden mismatch at window {pos}")
    print(f"[golden] {len(GOLDEN_K5)} windows of {GOLDEN_SEQ} (k=5, h=3, fwd/rev) "
          f"and {len(GOLDEN_ACATG)} of ACATGCATGCA match through the kernel")


def make_codes(rng, n: int, length: int = L) -> np.ndarray:
    codes = rng.integers(0, 4, size=(n, length), dtype=np.uint8)
    codes[rng.random((n, length)) < N_RATE] = 4
    return codes


def phase_kernels_vs_plain(rng, codes: np.ndarray, dev) -> tuple[float, float]:
    k_err = 0.0
    for n, k, h, kw in ((1024, K, H, {"emit_fwd_rev": True}),
                        (1024, K, H, {"emit_buckets": WLOG}),
                        (1024, 65, 2, {}),
                        (BATCH, K, H, {"emit_buckets": WLOG})):  # main path's
        tm = prepare_codes(torch.from_numpy(codes[:n]).to(dev))
        got = hash_kmers_tm(tm, k, h, **kw)
        want = hash_kmers_tm_plain(tm, k, h, **kw)
        torch.cuda.synchronize()
        require(len(got) == len(want), "output count differs")
        for g, w in zip(got, want):
            require(g.shape == w.shape and g.dtype == w.dtype, "shape/dtype")
            k_err = max(k_err, max_abs_err(g, w))
            require(torch.equal(g, w), f"kmer_hash != plain at k={k} {kw}")
        print(f"[check] kmer_hash == plain on {n} reads x {L} bp, k={k} "
              f"h={h} {kw or ''}: {len(got)} x {tuple(got[0].shape)} "
              f"{got[0].dtype}")
        del tm, got, want
    h_err = 0.0
    n = 1 << 20
    for wl in (10, 14, 18, 26):
        width = 1 << wl
        idx = rng.integers(0, width, size=(4, n)).astype(np.int32)
        idx[:, rng.random(n) < 0.01] = -1
        idx[:, rng.random(n) < 0.01] = width
        w = rng.integers(-(2**31), 2**31, size=(4, n), dtype=np.int64)
        idx_d = torch.from_numpy(idx).to(dev)
        w_d = torch.from_numpy(w.astype(np.int32)).to(dev)
        for weight, label in ((w_d, "per-row"), (w_d[0], "shared"),
                              (None, "none")):
            got = histogram_rows(idx_d, weight, wl)
            want = histogram_rows_plain(idx_d, weight, wl)
            torch.cuda.synchronize()
            h_err = max(h_err, max_abs_err(got, want))
            require(torch.equal(got, want),
                    f"histogram != plain at width 2**{wl}, {label} weights")
        print(f"[check] histogram == plain at width 2**{wl}, 4 rows x 2**20, "
              "full-range int32 weights (per-row, shared, none), "
              "indices -1 and width dropped")
    return k_err, h_err


def write_fastq(path: Path, codes: np.ndarray) -> None:
    n, length = codes.shape
    rec = np.empty((n, 3 + length + 3 + length + 1), dtype=np.uint8)
    rec[:, 0:3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3:3 + length] = np.frombuffer(b"ACGTN", np.uint8)[codes]
    rec[:, 3 + length:6 + length] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + length:6 + 2 * length] = ord("I")
    rec[:, -1] = ord("\n")
    path.write_bytes(rec.tobytes())


def valid_windows(codes: np.ndarray, k: int) -> int:
    bad = np.cumsum(codes >= 4, axis=1, dtype=np.int32)
    bad = np.concatenate([np.zeros((codes.shape[0], 1), np.int32), bad], axis=1)
    return int(((bad[:, k:] - bad[:, :-k]) == 0).sum())


def plain_count(codes: np.ndarray, dev) -> torch.Tensor:
    """The plain hash->count (plain hash, plain histogram) over the same
    batches as count_file."""
    rows = torch.zeros((H, 1 << WLOG), dtype=torch.int32, device=dev)
    for s in range(0, codes.shape[0], BATCH):
        tm = prepare_codes(torch.from_numpy(codes[s:s + BATCH]).to(dev))
        for r, b in enumerate(hash_kmers_tm_plain(tm, K, H, emit_buckets=WLOG)):
            rows[r] += histogram_rows_plain(b.reshape(1, -1), None, WLOG)[0]
    return rows


def reset_part_launches() -> None:
    for name in pk.LAUNCHES:
        pk.LAUNCHES[name] = 0


def reset_hist_launches() -> None:
    hist_kernel.LAUNCHES = 0
    for counts in (hist_kernel.ROUTE_LAUNCHES, hist_kernel.BIN_LAUNCHES,
                   hist_kernel.RANGE_LAUNCHES,
                   hist_kernel.SCATTER_ROUTE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def phase_main_path(codes: np.ndarray, path: Path, dev):
    cfg = PipelineConfig(k=K, num_hashes=H, sketch_width_log2=WLOG)
    pipe = ReadHashingPipeline(cfg, device=dev)
    kmer_kernel.LAUNCHES = 0
    reset_hist_launches()
    t0 = time.perf_counter()
    reads = pipe.count_file(path, batch_size=BATCH)
    seconds = time.perf_counter() - t0
    launches = {"kmer_hash": kmer_kernel.LAUNCHES,
                "histogram": hist_kernel.LAUNCHES}
    routes = dict(hist_kernel.ROUTE_LAUNCHES)
    require(reads == N_READS, f"count_file streamed {reads} reads")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    require(routes["private"] == launches["histogram"] and not routes["direct"],
            f"the 2**{WLOG} path's histogram did not go through private "
            f"counters: {routes}")
    nvalid = valid_windows(codes, K)
    sums = pipe.sketch.rows.sum(dim=1, dtype=torch.int64).tolist()
    require(all(s == nvalid for s in sums),
            f"row sums {sums} != {nvalid} valid windows")
    want = plain_count(codes, dev)
    require(torch.equal(pipe.sketch.rows, want),
            "count_file sketch != plain hash->count")
    print(f"[main] count_file: {reads} reads in {-(-N_READS // BATCH)} batches "
          f"of {BATCH}, {nvalid} valid {K}-mers per row, sketch == plain "
          f"hash->count; launches {launches}, histogram by route {routes}; "
          f"native parser {native_loader.available()}; first run "
          f"{seconds:.3f} s")
    return pipe, launches


def phase_timings(codes: np.ndarray, path: Path, pipe, dev, card: str):
    tag = f"[{card}]"
    tm = prepare_codes(torch.from_numpy(codes).to(dev))
    reads, w = tm.shape[1], L - K + 1
    times = {}

    def both(label, items, unit, kernel_fn, plain_fn, *args, nbytes=None):
        # one timing of these kernels can move by several percent between
        # consecutive rounds on one card: the median of three rounds
        rounds = []
        for _ in range(3):
            rounds.append(timeit(kernel_fn, *args).seconds_per_call)
            torch.cuda.empty_cache()
        t_k = statistics.median(rounds)
        t_p = timeit(plain_fn, *args).seconds_per_call
        torch.cuda.empty_cache()
        times[label] = (t_k, t_p)
        bound = "" if nbytes is None else \
            f", bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e9:.4f} GB)"
        print(f"[time] {label}: kernel {t_k * 1e3:.4f} ms, plain "
              f"{t_p * 1e3:.4f} ms ({items / t_k:.6g} vs "
              f"{items / t_p:.6g} {unit}/s){bound} {tag}")

    for h in (1, H):
        # the codes read once (int32), the hashes written once
        both(f"kmer_hash k={K} h={h} hashes {reads}x{L}", reads * w, "windows",
             lambda x, h=h: hash_kmers_tm(x, K, h),
             lambda x, h=h: hash_kmers_tm_plain(x, K, h), tm,
             nbytes=(4 * L + 8 * h * w) * reads)
    both(f"kmer_hash k={K} h={H} buckets 2**{WLOG} {reads}x{L}", reads * w,
         "windows", lambda x: hash_kmers_tm(x, K, H, emit_buckets=WLOG),
         lambda x: hash_kmers_tm_plain(x, K, H, emit_buckets=WLOG), tm)
    times.update(time_path_histogram(codes, dev, card))
    sk = cms.CountMinSketch.zeros(H, WLOG, dev)
    t_step = timeit(lambda x: fused_count_step(x, sk, K), tm).seconds_per_call
    print(f"[time] fused_count_step k={K} h={H} 2**{WLOG} {reads}x{L}: "
          f"{t_step * 1e3:.4f} ms, {reads * w / t_step:.6g} k-mers/s "
          f"(all windows) {tag}")
    del tm
    torch.cuda.empty_cache()

    def host_median(fn):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t0)
        return statistics.median(runs)

    def count():
        pipe.sketch.rows.zero_()
        pipe.count_file(path, batch_size=BATCH)

    def parse_only():
        with Prefetcher(stream_code_batches(path, BATCH)) as pf:
            for _ in pf:
                pass

    t_file = host_median(count)
    print(f"[time] count_file {N_READS} reads x {L} bp, k={K} h={H} "
          f"2**{WLOG}, batch {BATCH}: median of 3 {t_file:.4f} s, "
          f"{N_READS / t_file:.6g} reads/s (host clock, parse included) {tag}")
    t_parse = host_median(parse_only)
    print(f"[time] parse only (same file, batches, prefetch thread): median "
          f"of 3 {t_parse:.4f} s, {N_READS / t_parse:.6g} reads/s {tag}")
    return times


def in_turns(fns: dict, *args, rounds: int = 2, device=None) -> dict:
    """Seconds per call of each function on the same arguments, timed in
    turns (A B B A ...), so that a drift of the card's clock falls on every
    one alike: the mean over the rounds of each timing's median of 5 CUDA
    events after warm-up."""
    names = list(fns)
    got = {name: [] for name in names}
    for i in range(rounds):
        for name in (names if i % 2 == 0 else names[::-1]):
            got[name].append(timeit(fns[name], *args,
                                    device=device).seconds_per_call)
            torch.cuda.empty_cache()
    return {name: statistics.mean(v) for name, v in got.items()}


def path_buckets(codes: np.ndarray, wl: int, dev) -> list:
    """Per main-path batch, the hash kernel's buckets at 2**wl as the one
    [H, n] view that the sketch's histogram counts."""
    out = []
    for s in range(0, codes.shape[0], BATCH):
        tm = prepare_codes(torch.from_numpy(codes[s:s + BATCH]).to(dev))
        view = hist_kernel.rows_view(hash_kmers_tm(tm, K, H, emit_buckets=wl))
        require(view is not None, "the hash kernel's buckets are not views "
                "of one output")
        out.append(view)
    return out


def time_path_histogram(codes: np.ndarray, dev, card: str) -> dict:
    """A2 as the 2**14 path launches it (one [H, n] launch a batch), summed
    over the 1M reads' batches: the private counters the rule picks beside
    the old design (direct atomics, forced), timed in turns; the plain
    version, the byte bound and ``torch.bincount``."""
    tag = f"[{card}]"
    tot = dict.fromkeys(("private", "direct", "plain", "library"), 0.0)
    nbytes = 0
    grid = None
    for idx in path_buckets(codes, WLOG, dev):
        grid = hist_kernel.private_counts_grid(*idx.shape, WLOG)
        got = in_turns({
            "private": lambda x: histogram_rows(x, None, WLOG),
            "direct": lambda x: hist_kernel._launch(x, None, WLOG, None, None,
                                                    route="direct")}, idx)
        for route, v in got.items():
            tot[route] += v
        tot["plain"] += timeit(lambda x: histogram_rows_plain(x, None, WLOG),
                               idx).seconds_per_call
        # the library call: one bincount over row * (width + 1) + idx,
        # invalid windows in each row's spare bin (preparation untimed)
        spare = (idx.long() + torch.arange(H, device=dev)[:, None]
                 * ((1 << WLOG) + 1)).reshape(-1)
        tot["library"] += timeit(
            lambda x: torch.bincount(x, minlength=H * ((1 << WLOG) + 1)),
            spare).seconds_per_call
        nbytes += idx.numel() * 4 + H * (1 << WLOG) * 4
        del idx, spare
        torch.cuda.empty_cache()
    print(f"[time] histogram (A2) on the 2**{WLOG} path, one [{H}, n] launch "
          f"a batch, over {N_READS} reads: private counters (the rule's "
          f"grid {grid}) {tot['private'] * 1e3:.4f} ms, direct atomics "
          f"forced (the old design) {tot['direct'] * 1e3:.4f} ms, in turns; "
          f"plain {tot['plain'] * 1e3:.4f} ms, torch.bincount "
          f"{tot['library'] * 1e3:.4f} ms, bound {bound_ms(nbytes):.4f} ms "
          f"({nbytes / 1e9:.4f} GB) {tag}")
    return {"histogram": (tot["private"], tot["plain"]),
            "histogram direct": tot["direct"],
            "library histogram": tot["library"], "histogram bytes": nbytes}


def phase_trace(path: Path, pipe, dev, card: str) -> None:
    """One warm count_file under torch.profiler: the device's idle share."""

    def count():
        pipe.sketch.rows.zero_()
        pipe.count_file(path, batch_size=BATCH)

    tr = trace_device(count, device=dev)
    require(tr.busy_seconds > 0, "the trace recorded no device activity")
    print(f"[trace] count_file {N_READS} reads under torch.profiler: wall "
          f"{tr.wall_seconds * 1e3:.3f} ms, device busy "
          f"{tr.busy_seconds * 1e3:.3f} ms (union of device rows), idle share "
          f"{tr.idle_share:.4f} [{card}]")
    for name, (t, n) in sorted(tr.by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"[trace]   {t * 1e3:9.3f} ms  x{n:<3d} {name[:90]}")

# ------------------------------------------------ the partitioned path ----

WIDE = 20            # PipelineConfig()'s width: the main path of this slice
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
PART_KERNELS = ("sort_tiles", "merge_phase", "partition_bounds", "windows")


def bound_ms(nbytes: float) -> float:
    """The least time for a function that must move ``nbytes`` (each input
    read once, each output written once) at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_partition_kernels(chunks, sub_log2, p_log2, cap, errs) -> torch.Tensor:
    """Each partition kernel against its plain version on the same inputs,
    exact; returns the kernels' overflow flags (on the device)."""
    chunk = chunks.shape[2] * pk.LANES

    def same(name, got, want):
        errs[name] = max(errs[name], max_abs_err(got, want))
        require(torch.equal(got, want), f"{name} != plain, chunk {chunk}, "
                f"P 2**{p_log2}, {tuple(chunks.shape)}")

    x, tile = pk.sort_tiles(chunks)
    same("sort_tiles", x, pk.sort_tiles_plain(chunks, tile))
    k = 2 * tile
    while k <= chunk:
        want = pk.merge_phase_plain(x, k)
        pk.merge_phase(x, tile, k)
        same("merge_phase", x, want)
        k *= 2
    fb, flags = pk.partition_bounds(x, sub_log2, p_log2, cap)
    pfb, pflags = pk.partition_bounds_plain(x, sub_log2, p_log2, cap)
    same("partition_bounds", fb, pfb)
    same("partition_bounds", flags, pflags)
    same("windows", pk.windows(x, fb, p_log2, sub_log2, cap),
         pk.partition_windows_plain(x, pfb, p_log2, sub_log2, cap_rows=cap))
    return flags


def phase_partition_widths(rng, dev) -> dict:
    """Phase 8: the partition kernels at every planned width, the whole
    partitioned histogram against the plain one, skew and sentinels."""
    errs = dict.fromkeys(PART_KERNELS, 0.0)
    for wl in range(pk.PART_MIN_WIDTH_LOG2, pk.PART_MAX_WIDTH_LOG2 + 1):
        p_log2, sub_log2, rows, cap = pk.plan(wl)
        x = torch.from_numpy(rng.integers(0, (1 << wl) + 1,
                                          size=(2, 8, rows, pk.LANES),
                                          dtype=np.int32)).to(dev)
        flags = check_partition_kernels(x, sub_log2, p_log2, cap, errs)
        srt, fb = pk.sort_chunks(x, sub_log2, p_log2)
        psrt, pfb = pk.sort_chunks_plain(x, sub_log2, p_log2)
        over = pk.check_overflow(fb, p_log2, srt, sub_log2, cap)
        require(torch.equal(srt, psrt) and torch.equal(fb, pfb),
                f"sort_chunks != plain at 2**{wl}")
        require(bool(over) == bool(pk.check_overflow_plain(
            pfb, p_log2, psrt, sub_log2, cap)) == bool(flags[0]),
            f"overflow flag != plain at 2**{wl}")
        wins = pk.partition_windows(srt, fb, p_log2, sub_log2, cap_rows=cap)
        require(torch.equal(wins, pk.partition_windows_plain(
            psrt, pfb, p_log2, sub_log2, cap_rows=cap)),
            f"partition_windows != plain at 2**{wl}")
        print(f"[check] 2**{wl}: sort_chunks, table, flag ({bool(over)}) and "
              f"windows == plain on 2 rows x 8 chunks of {rows} x 128, "
              f"P 2**{p_log2}, cap {cap}")
        del x, srt, psrt, wins
    n = 1 << 22
    for wl in (19, 20, 22, 26):
        width = 1 << wl
        idx = rng.integers(0, width, size=(4, n)).astype(np.int32)
        idx[:, rng.random(n) < 0.01] = -1
        idx[:, rng.random(n) < 0.01] = width
        idx_d = torch.from_numpy(idx).to(dev)
        got = pk.partitioned_histogram_rows(idx_d, wl)
        require(torch.equal(got, histogram_rows_plain(idx_d, None, wl)),
                f"partitioned_histogram_rows != plain at 2**{wl}")
        print(f"[check] partitioned_histogram_rows == histogram_rows_plain at "
              f"2**{wl}, 4 rows x 2**22 with -1 and width sentinels")
        del idx_d, got
    torch.cuda.empty_cache()
    idx = torch.from_numpy(rng.integers(-1, (1 << 30) + 1, size=(1, n))
                           .astype(np.int32)).to(dev)
    got = pk.partitioned_histogram_rows(idx, 30)[0]
    valid = idx[0][(idx[0] >= 0) & (idx[0] < (1 << 30))].long()
    vals, cnt = torch.unique(valid, return_counts=True)
    require(torch.equal(got[vals].long(), cnt)
            and int(got.sum(dtype=torch.int64)) == valid.numel(),
            "partitioned_histogram_rows at 2**30 != unique counts")
    print(f"[check] partitioned_histogram_rows at 2**30, 1 row x 2**22: the "
          f"{vals.numel()} counted buckets equal torch.unique's counts, row "
          f"sum {valid.numel()}")
    del idx, got, valid, vals, cnt
    torch.cuda.empty_cache()
    p_log2, sub_log2, rows, cap = pk.plan(WIDE)
    skew = torch.full((1, 1 << 20), 77, dtype=torch.int32, device=dev)
    srt, fb = pk.sort_chunks(pk._pad_chunks(skew, 1 << WIDE, rows * pk.LANES),
                             sub_log2, p_log2)
    require(bool(pk.check_overflow(fb, p_log2, srt, sub_log2, cap)),
            "the all-identical stream must set the overflow flag")
    got = pk.partitioned_histogram_rows(skew, WIDE)
    require(int(got[0, 77]) == 1 << 20 and int(got.sum()) == 1 << 20,
            "the gated fallback must count the skewed stream exactly")
    sent = torch.full((1, 1 << 20), 1 << WIDE, dtype=torch.int32, device=dev)
    sent[0, :130] = torch.from_numpy(rng.integers(0, 1 << WIDE, size=130,
                                                  dtype=np.int32)).to(dev)
    srt, fb = pk.sort_chunks(pk._pad_chunks(sent, 1 << WIDE, rows * pk.LANES),
                             sub_log2, p_log2)
    require(not bool(pk.check_overflow(fb, p_log2, srt, sub_log2, cap)),
            "a mostly-sentinel stream must not set the overflow flag")
    require(torch.equal(pk.partitioned_histogram_rows(sent, WIDE),
                        histogram_rows_plain(sent, None, WIDE)),
            "mostly-sentinel stream != plain")
    print("[check] 2**20: all-identical 1 x 2**20 stream sets the flag and "
          "counts exactly through the gated fallback; a mostly-sentinel "
          "stream does not set it")
    return errs


def wide_batches(codes: np.ndarray, dev):
    """(chunks, valid) of every main-path batch at 2**20, as count_file
    feeds them to the partition kernels."""
    _, _, rows, _ = pk.plan(WIDE)
    out = []
    for s in range(0, codes.shape[0], BATCH):
        tm = prepare_codes(torch.from_numpy(codes[s:s + BATCH]).to(dev))
        b = torch.stack([x.reshape(-1) for x in
                         hash_kmers_tm(tm, K, H, emit_buckets=WIDE)])
        out.append(pk._pad_chunks(b, 1 << WIDE, rows * pk.LANES))
    return out


def phase_main_wide(codes: np.ndarray, path: Path, dev, errs: dict):
    """Phase 9: count_file at PipelineConfig(), width 2**20."""
    cfg = PipelineConfig()
    require((cfg.k, cfg.num_hashes, cfg.sketch_width_log2) == (K, H, WIDE),
            f"PipelineConfig() is {cfg}")
    pipe = ReadHashingPipeline(cfg, device=dev)
    kmer_kernel.LAUNCHES = 0
    reset_hist_launches()
    reset_part_launches()
    t0 = time.perf_counter()
    reads = pipe.count_file(path, batch_size=BATCH)
    seconds = time.perf_counter() - t0
    launches = {"kmer_hash": kmer_kernel.LAUNCHES,
                "histogram": hist_kernel.LAUNCHES}
    routes = dict(hist_kernel.ROUTE_LAUNCHES)
    bins = dict(hist_kernel.BIN_LAUNCHES)
    bodies = dict(hist_kernel.SCATTER_ROUTE_LAUNCHES)
    parts = dict(pk.LAUNCHES)
    launches["bin_ranges_counts"] = bins["histogram"]
    launches["histogram_ranges"] = hist_kernel.RANGE_LAUNCHES["histogram"]
    require(reads == N_READS, f"count_file streamed {reads} reads")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the 2**20 main path never launched: {launches}")
    wide_launches = dict(launches)
    want_routes = dict.fromkeys(routes, 0)
    for s in range(0, N_READS, BATCH):
        n = min(BATCH, N_READS - s) * (L - K + 1)
        want_routes[hist_kernel._counts_route(H, n, WIDE, False, None)[0]] += 1
    want_body = hist_kernel.scatter_body(WIDE, hist_kernel.COUNTS_RANGE_LOG2)
    require(not any(parts.values()) and routes == want_routes
            and bins["histogram"] == routes["binned"]
            == launches["histogram_ranges"] == bodies[want_body]
            == sum(bodies.values()),
            f"the 2**20 path must count by the rule's route ({want_routes}), "
            f"binning once a binned launch by the {want_body} scatter, with "
            f"no partition kernel: partition launches {parts}, histogram by "
            f"route {routes}, binning passes {bins}, scatters {bodies}")
    want = torch.zeros((H, 1 << WIDE), dtype=torch.int64, device=dev)
    for s in range(0, codes.shape[0], BATCH):
        tm = prepare_codes(torch.from_numpy(codes[s:s + BATCH]).to(dev))
        for r, b in enumerate(hash_kmers_tm_plain(tm, K, H, emit_buckets=WIDE)):
            want[r] += histogram_rows_plain(b.reshape(1, -1), None, WIDE)[0]
    require(torch.equal(pipe.sketch.rows.long(), want),
            "count_file sketch at 2**20 != plain hash->count")
    nvalid = valid_windows(codes, K)
    require(int(want[0].sum()) == nvalid, "plain row sum != valid windows")
    print(f"[main] count_file at PipelineConfig() (k={K}, h={H}, 2**{WIDE}): "
          f"{reads} reads, {nvalid} valid {K}-mers per row, sketch == plain "
          f"hash->count (int64); launches {launches}, histogram by route "
          f"{routes}, partition kernels {parts}; first run {seconds:.3f} s")
    del want
    # the partitioned histogram (off the path) over the same reads' buckets
    # builds the same sketch; its launches are the partition kernels' count
    reset_part_launches()
    part = torch.zeros_like(pipe.sketch.rows)
    for idx in path_buckets(codes, WIDE, dev):
        pk.partitioned_histogram_rows(idx, WIDE, out=part)
        del idx
    require(torch.equal(part, pipe.sketch.rows),
            "partitioned_histogram_rows over the 1M reads != the direct sketch")
    part_launches = dict(pk.LAUNCHES)
    print(f"[main] partitioned_histogram_rows over the same {N_READS} reads' "
          f"buckets == the direct sketch; launches {part_launches}")
    del part
    torch.cuda.empty_cache()
    # the partition kernels on the main path's own batches, against plain,
    # and the overflow flag of every batch (read once, at the end)
    p_log2, sub_log2, _, cap = pk.plan(WIDE)
    batches = wide_batches(codes, dev)
    fired = []
    for i, chunks in enumerate(batches):
        if i == 0:
            fired.append(check_partition_kernels(chunks, sub_log2, p_log2,
                                                 cap, errs)[0])
        else:
            x = pk._sorted(chunks)
            fired.append(pk.partition_bounds(x, sub_log2, p_log2, cap)[1][0])
            del x
    fired = [int(f) for f in fired]
    print(f"[main] partition kernels == plain on batch 0 ({tuple(batches[0].shape)}); "
          f"overflow flag per batch {fired} (fired: {any(fired)})")
    return pipe, {**part_launches, **wide_launches}, batches


def time_prepared(prepare, fn, calls: int = 5) -> float:
    """Median seconds of ``fn(prepare())`` by CUDA events around ``fn`` only,
    after one warm-up: for a kernel that works in place."""
    fn(prepare())
    samples = []
    for _ in range(calls):
        x = prepare()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / 1e3)
    return statistics.median(samples)


def plan_batches(codes: np.ndarray, dev) -> list:
    """The Bloom path's buckets of every main-path batch at 2**30 (its
    codes, ``emit_buckets=30``), as one row padded to the 2**30 plan's
    chunks: [1, 64, 16384, 128] a batch, as C3 partitions them."""
    _, _, rows, _ = pk.plan(pk.PART_MAX_WIDTH_LOG2)
    out = []
    for tm in bloom_tms(codes, dev):
        b = torch.stack([x.reshape(-1) for x in hash_kmers_tm(
            tm, K, H, emit_buckets=pk.PART_MAX_WIDTH_LOG2)]).reshape(1, -1)
        out.append(pk._pad_chunks(b, 1 << pk.PART_MAX_WIDTH_LOG2,
                                  rows * pk.LANES))
        del tm, b
    return out


def merge_rounds(chunk: int, tile: int) -> list:
    """The merge rounds after tiles of ``tile`` ints: 2 tile .. chunk."""
    rounds, k = [], 2 * tile
    while k <= chunk:
        rounds.append(k)
        k *= 2
    return rounds


def searchsorted_inputs(srt: torch.Tensor, sub_log2: int, p_log2: int):
    """The library call's inputs for the partition table, prepared once:
    the row maxima [R G, rows] and the queries [R G, P], contiguous."""
    r, g, rows = srt.shape[:3]
    lastq = (srt[..., pk.LANES - 1] >> sub_log2).reshape(r * g, rows)
    queries = torch.arange(1 << p_log2, dtype=torch.int32, device=srt.device)
    return lastq.contiguous(), queries.expand(r * g, -1).contiguous()


def add_time(tot: dict, name: str, i: int, k_s: float, p_s: float,
             lib_s: float | None, nbytes: int, where: str, tag: str) -> None:
    """Add batch i's kernel, plain and library seconds and bytes to
    tot[name] (library None: no such call); print batch 0's."""
    row = tot.setdefault(name, [0.0, 0.0, None if lib_s is None else 0.0,
                                0.0])
    row[0] += k_s
    row[1] += p_s
    if lib_s is not None:
        row[2] += lib_s
    row[3] += nbytes
    if i == 0:
        lib = "" if lib_s is None else f", library {lib_s * 1e3:.4f} ms"
        print(f"[time] {name} {where}: kernel {k_s * 1e3:.4f} ms, plain "
              f"{p_s * 1e3:.4f} ms{lib}, bound {bound_ms(nbytes):.4f} ms {tag}")


def print_totals(tot: dict, where: str, tag: str) -> None:
    for name, (k_s, p_s, lib_s, nbytes) in tot.items():
        lib = "" if lib_s is None else f", library {lib_s * 1e3:.4f} ms"
        print(f"[time] {name} {where + ' ' if where else ''}over {N_READS} "
              f"reads: kernel {k_s * 1e3:.4f} ms, plain {p_s * 1e3:.4f} ms"
              f"{lib}, bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e9:.4f} GB) "
              f"{tag}")


def time_partition_plan(batches: list, wl: int, tag: str) -> dict:
    """Each partition kernel over the batches padded to the plan for 2**wl,
    its plain version, its bound and the library call (``torch.sort`` for
    the tile sort, ``torch.searchsorted`` over the prepared row maxima for
    the table): name -> [kernel, plain, library or None, bytes] in seconds
    summed over the batches (each batch's median), batch 0 printed."""
    p_log2, sub_log2, rows, cap = pk.plan(wl)
    p = 1 << p_log2
    tot = {}
    where = f"at the 2**{wl} plan"

    def add(name, i, k_s, p_s, lib_s, nbytes):
        add_time(tot, name, i, k_s, p_s, lib_s, nbytes,
                 f"{where} {tuple(batches[0].shape)}", tag)

    for i, chunks in enumerate(batches):
        r, g = chunks.shape[:2]
        nbytes = chunks.numel() * 4
        tiles, tile = pk.sort_tiles(chunks)
        add("sort_tiles", i,
            timeit(lambda x: pk.sort_tiles(x), chunks).seconds_per_call,
            timeit(lambda x: pk.sort_tiles_plain(x, tile), chunks)
            .seconds_per_call,
            timeit(lambda x: torch.sort(x.view(r * g, -1), dim=-1), chunks)
            .seconds_per_call, 2 * nbytes)
        rounds = merge_rounds(rows * pk.LANES, tile)

        def merges(x):
            for k in rounds:
                pk.merge_phase(x, tile, k)

        def merges_plain(x):
            for k in rounds:
                x = pk.merge_phase_plain(x, k)
            return x

        add("merge_phase", i, time_prepared(tiles.clone, merges),
            timeit(merges_plain, tiles).seconds_per_call, None,
            2 * nbytes * len(rounds))
        del tiles
        srt = pk._sorted(chunks)
        fb, _ = pk.partition_bounds(srt, sub_log2, p_log2, cap)
        lastq, queries = searchsorted_inputs(srt, sub_log2, p_log2)
        add("partition_bounds", i,
            timeit(lambda x: pk.partition_bounds(x, sub_log2, p_log2, cap),
                   srt).seconds_per_call,
            timeit(lambda x: pk.partition_bounds_plain(x, sub_log2, p_log2,
                                                       cap), srt)
            .seconds_per_call,
            timeit(lambda a, q: torch.searchsorted(a, q, side="left"),
                   lastq, queries).seconds_per_call,
            (r * g * rows + r * g * p + 2) * 4)
        del lastq, queries
        add("windows", i,
            timeit(lambda x: pk.windows(x, fb, p_log2, sub_log2, cap), srt)
            .seconds_per_call,
            timeit(lambda x: pk.partition_windows_plain(
                x, fb, p_log2, sub_log2, cap_rows=cap), srt).seconds_per_call,
            None, nbytes + r * p * g * cap * pk.LANES * 4)
        del srt, fb
        torch.cuda.empty_cache()
    chunks = sum(b.shape[0] * b.shape[1] for b in batches)
    print_totals(tot, where, tag)
    print(f"[time] partition_bounds at the 2**{wl} plan: sector floor "
          f"{bound_ms(chunks * (rows * 32 + p * 4)):.4f} ms (a 32-byte sector "
          f"a row maximum, {chunks} chunks of {rows} rows, P {p}) {tag}")
    return tot


def phase_wide_timings(codes, path, pipe, batches, dev, card: str,
                       errs: dict) -> dict:
    """Phase 10: timings at 2**20, per 2**18-read batch and over 1M reads
    (the sum over the four batches of each batch's median); the partition
    kernels also at the 2**30 plan (the Bloom path's buckets), checked
    against their plain versions on batch 0 first."""
    tag = f"[{card}]"
    tot = time_partition_plan(batches, WIDE, tag)
    widest = plan_batches(codes, dev)
    p_log2, sub_log2, _, cap = pk.plan(pk.PART_MAX_WIDTH_LOG2)
    fired = int(check_partition_kernels(widest[0], sub_log2, p_log2, cap,
                                        errs)[0])
    print(f"[check] partition kernels == plain at the 2**30 plan on batch 0 "
          f"of the Bloom path's buckets {tuple(widest[0].shape)} (overflow "
          f"flag {fired})")
    torch.cuda.empty_cache()
    time_partition_plan(widest, pk.PART_MAX_WIDTH_LOG2, tag)
    del widest
    torch.cuda.empty_cache()
    p_log2, sub_log2, rows, cap = pk.plan(WIDE)
    p = 1 << p_log2
    sub_tot = {}

    def add(name, i, k_s, p_s, lib_s, nbytes):
        add_time(sub_tot, name, i, k_s, p_s, lib_s, nbytes, "batch 0", tag)

    for i, chunks in enumerate(batches):
        r, g = chunks.shape[:2]
        srt = pk._sorted(chunks)
        fb, _ = pk.partition_bounds(srt, sub_log2, p_log2, cap)
        wins = pk.windows(srt, fb, p_log2, sub_log2, cap)
        flat = wins.reshape(r * p, -1)
        spare = (torch.where((flat >= 0) & (flat < (1 << sub_log2)),
                             flat.long(), 1 << sub_log2)
                 + torch.arange(r * p, device=dev)[:, None]
                 * ((1 << sub_log2) + 1)).reshape(-1)
        sub = in_turns({
            "private": lambda x: histogram_rows(x, None, sub_log2),
            "direct": lambda x: hist_kernel._launch(x, None, sub_log2, None,
                                                    None, route="direct")},
            flat)
        t_plain = timeit(lambda x: histogram_rows_plain(x, None, sub_log2),
                         flat).seconds_per_call
        sub_bytes = flat.numel() * 4 + r * (1 << WIDE) * 4
        grid = hist_kernel.private_counts_grid(*flat.shape, sub_log2)
        add(f"histogram (sub-histograms at 2**{sub_log2}, {r * p} rows, "
            f"private counters {grid})", i, sub["private"], t_plain,
            timeit(lambda x: torch.bincount(
                x, minlength=r * p * ((1 << sub_log2) + 1)), spare)
            .seconds_per_call, sub_bytes)
        add(f"histogram (sub-histograms at 2**{sub_log2}, {r * p} rows, "
            "direct atomics forced)", i, sub["direct"], t_plain, None,
            sub_bytes)
        del srt, fb, wins, flat, spare
        torch.cuda.empty_cache()
    print_totals(sub_tot, "", tag)

    # does partitioning pay on this card? the whole partitioned histogram
    # against the direct one at full width, on one batch's buckets
    tm = prepare_codes(torch.from_numpy(codes[:BATCH]).to(dev))
    for wl in (20, 22, 24, 26, 28, 30):
        idx = torch.stack(hash_kmers_tm(tm, K, H, emit_buckets=wl)).reshape(H, -1)
        t_part = timeit(lambda x: pk.partitioned_histogram_rows(x, wl), idx)
        t_dir = timeit(lambda x: histogram_rows(x, None, wl), idx)
        route = hist_kernel._counts_route(H, idx.shape[1], wl, False, None)[0]
        print(f"[time] crossover at 2**{wl}, {H} x {idx.shape[1]} buckets "
              f"(one batch): partitioned_histogram_rows "
              f"{t_part.seconds_per_call * 1e3:.4f} ms, the histogram (the "
              f"rule's route, {route}) {t_dir.seconds_per_call * 1e3:.4f} ms "
              f"{tag}")
        del idx
        torch.cuda.empty_cache()
    del tm
    tm = prepare_codes(torch.from_numpy(codes).to(dev))
    reads, w = tm.shape[1], L - K + 1
    idx = torch.stack(hash_kmers_tm(tm, K, H, emit_buckets=WIDE)).reshape(H, -1)
    whole = in_turns({r: (lambda x, r=r: hist_by(r, x, None, WIDE))
                      for r in ("binned", "direct")}, idx)
    print(f"[time] histogram (A2) alone at full width 2**{WIDE}, {H} rows x "
          f"{idx.shape[1]} (the 1M reads in one launch): binned "
          f"{whole['binned'] * 1e3:.4f} ms, direct atomics "
          f"{whole['direct'] * 1e3:.4f} ms, in turns; bound "
          f"{bound_ms(idx.numel() * 4 + H * (1 << WIDE) * 4):.4f} ms {tag}")
    del idx
    torch.cuda.empty_cache()
    # the step on the path's route beside the old one: the hash kernel's
    # buckets stacked into the partitioned histogram, as before this port
    # counted directly
    sk = cms.CountMinSketch.zeros(H, WIDE, dev)

    def old_step(x):
        b = kmer_kernel.hash_kmers_tm_auto(x, K, H, emit_buckets=WIDE)
        pk.partitioned_histogram_rows(
            torch.stack([t.reshape(-1) for t in b]), WIDE, out=sk.rows)

    steps = in_turns({"path": lambda x: fused_count_step(x, sk, K),
                      "partitioned": old_step}, tm)
    route = hist_kernel._counts_route(H, reads * w, WIDE, False, None)[0]
    print(f"[time] fused_count_step k={K} h={H} 2**{WIDE} {reads}x{L} (the "
          f"histogram {route}): {steps['path'] * 1e3:.4f} ms, "
          f"{reads * w / steps['path']:.6g} k-mers/s (all windows); the old "
          f"route (partitioned_histogram_rows) {steps['partitioned'] * 1e3:.4f}"
          f" ms, in turns {tag}")
    del tm, sk
    torch.cuda.empty_cache()

    def count():
        pipe.sketch.rows.zero_()
        pipe.count_file(path, batch_size=BATCH)

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        count()
        runs.append(time.perf_counter() - t0)
    t_file = statistics.median(runs)
    print(f"[time] count_file {N_READS} reads x {L} bp, PipelineConfig() "
          f"2**{WIDE}, batch {BATCH}: median of 3 {t_file:.4f} s, "
          f"{N_READS / t_file:.6g} reads/s (host clock, parse included) {tag}")
    tr = trace_device(count, device=dev)
    require(tr.busy_seconds > 0, "the trace recorded no device activity")
    print(f"[trace] count_file at 2**{WIDE} under torch.profiler: wall "
          f"{tr.wall_seconds * 1e3:.3f} ms, device busy "
          f"{tr.busy_seconds * 1e3:.3f} ms (union of device rows), idle share "
          f"{tr.idle_share:.4f} {tag}")
    for name, (t, n) in sorted(tr.by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[trace]   {t * 1e3:9.3f} ms  x{n:<4d} {name[:90]}")
    return tot



# ---------------------------- long reads, spaced seeds, one long sequence ----

LONG_L, LONG_READS, LONG_BATCH = 10_000, 16_384, 4096   # bench.py:52, :458
SEEDS = ("10101", "11011")       # BASELINE.json's spaced seeds, 3 hashes each
SEED_H = 3
SEED_CHUNK = 65_536
SP_LEN, SP_SEED_LEN = 1 << 27, 1 << 25                  # bench.py:53-54
SP_PRIME = 1_000_003             # a length no tile divides: the padded tail
#: (L, R) of the A1/B2 crossover grid.
CROSSOVER = ((150, 4096), (150, 1 << 18),
             *((length, reads) for length in (1000, 10_000)
               for reads in (4096, 1 << 14, 1 << 15, 1 << 16, 1 << 17,
                             1 << 18)),
             (1000, 1 << 20))
SLICE3_KERNELS = ("kmer_hash_long", "seed_hash", "seed_hash_long")
MANY_RUNS = "10" * 40 + "1"             # 41 care runs of one base, k = 81
LONG_SEED = "1" + "0" * 3000 + "1"      # two runs, a ring of 4,096 rows

# SeedNtHash(SEQ_N, SEEDS18, 2, 18) windows 0..3 (pos, s0h0, s0h1, s1h0,
# s1h1), captured from a build of the reference library
# (tests/test_golden_extended.py SEED18; an N hashes as the zero seed).
SEQ_N = ("GATTACAGATTACACCTTGGAACCNGGTTCCAAGGTTCCAAGG"
         "ACGTACGTACGTAGCTAGCTAGCTAGGCCATGCATGG")
SEEDS18 = ("110100110011001011", "111111000000111111")
SEED18 = [
    (0, 0x598ABFC133B99142, 0xC1ABAFAF1EADE78F, 0xE895A7F010ED432F, 0xD20AF1F39F107A60),
    (1, 0x08D30224F3A941EB, 0x63487068D9263251, 0xC8FC673BA0E04862, 0x431C2FA6A657F2D2),
    (2, 0x6BDC168D8C6CC144, 0x4949B5354A2B6F18, 0x93CD153100CB51BD, 0x4FA225D16ED71112),
    (3, 0xAA6F5971F0ED0F70, 0x9E0DEFC4409FB6C0, 0x26C49A263927408C, 0x5C8FE2172136F6EA),
]
# The BASELINE seeds over GOLDEN_SEQ, h=3 (SURVEY.md section 8): (window,
# hash index, value).
GOLDEN_SEEDS = [(0, 0, 0x9F8F9FBF890D6351), (0, 3, 0x7539D859409E5B0A),
                (1, 5, 0xA2B26F83A7BF55DE), (2, 0, 0x9F8F9FBF890D6351)]


def same_outputs(errs: dict, name: str, got, want, what: str) -> None:
    """Kernel outputs against plain ones, exactly; the largest difference
    (0 when equal) goes into ``errs[name]``."""
    torch.cuda.synchronize()
    require(len(got) == len(want), f"{what}: output count differs")
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"{what}: shape/dtype {tuple(g.shape)} {g.dtype}")
        eq = torch.equal(g, w)
        errs[name] = max(errs[name], 0.0 if eq else max_abs_err(g, w))
        require(eq, f"{what}: kernel != plain")


def rand_tm(gen: torch.Generator, length: int, reads: int, dev) -> torch.Tensor:
    """[L, R] int32 codes made on the card: ACGT with ~1% N."""
    tm = torch.randint(0, 4, (length, reads), dtype=torch.int32, device=dev,
                       generator=gen)
    n = torch.rand((length, reads), device=dev, generator=gen) < N_RATE
    return tm.masked_fill_(n, 4)


def phase_edges(gen, dev) -> dict:
    """B2, B1 and B3 (and A1) against their plain versions at edge shapes:
    L = k, time tile >= W, a tile that does not divide W, R = 1, R not a
    multiple of 32, k = 1, one-care-position seeds, every output mode."""
    errs = dict.fromkeys(SLICE3_KERNELS, 0.0)
    modes = ({}, {"emit_fwd_rev": True}, {"emit_buckets": 11})
    for b, length, k, tile in ((33, 40, 5, 10), (1, 300, 7, 14),
                               (100, 32, 32, 32), (37, 1000, 32, 64),
                               (5, 50, 1, 3), (64, 513, 32, None),
                               (3, 70, 5, 5000)):
        tm = rand_tm(gen, length, b, dev)
        for kw in modes:
            what = f"{b} reads x {length} bp, k={k}, tile {tile}, {kw}"
            long = kmer_kernel.hash_kmers_tm_long(tm, k, 3, time_tile=tile,
                                                  **kw)
            same_outputs(errs, "kmer_hash_long", long,
                         kmer_kernel.hash_kmers_tm_long_plain(
                             tm, k, 3, time_tile=tile, **kw), f"B2 {what}")
            same_outputs(errs, "kmer_hash_long", long,
                         hash_kmers_tm_plain(tm, k, 3, **kw),
                         f"B2 vs whole-read plain {what}")
            require(all(torch.equal(x, y) for x, y in zip(
                long, hash_kmers_tm(tm, k, 3, **kw))), f"A1 != B2 {what}")
    for seeds in (SEEDS, ("1",), ("00100",), ("0110", "1001", "1111"),
                  SEEDS18, ("11", "01", "10", "11"), ("1" * 64,),
                  (MANY_RUNS,), ("1" * 33, "1" + "0" * 31 + "1")):
        k = len(seeds[0])
        for b, length, tile in ((33, k, None), (1, 3 * k + 7, k),
                                (70, 150 + k, 2 * k), (5, 41 + k, 3 * k),
                                (129, 300, 1000 * k)):
            length = max(length, k)
            tm = rand_tm(gen, length, b, dev)
            for kw in modes:
                what = f"{seeds} {b} reads x {length} bp, tile {tile}, {kw}"
                want = sk.hash_seeds_tm_plain(tm, seeds, 2, **kw)
                same_outputs(errs, "seed_hash",
                             sk.hash_seeds_tm(tm, seeds, 2, **kw), want,
                             f"B1 {what}")
                same_outputs(errs, "seed_hash_long",
                             sk.hash_seeds_tm_long(tm, seeds, 2,
                                                   time_tile=tile, **kw),
                             want, f"B3 {what}")
                seg = min(sk.resolve_time_tile(k, tile), length - k + 1)
                same_outputs(errs, "seed_hash_long", old_seed_kernel(
                    tm, seeds, 2, seg, **kw), want, f"B3, global {what}")
    k = len(LONG_SEED)
    tm = rand_tm(gen, k + 300, 40, dev)
    want = sk.hash_seeds_tm_plain(tm, (LONG_SEED,), 1)
    same_outputs(errs, "seed_hash_long",
                 sk.hash_seeds_tm_long(tm, (LONG_SEED,), 1, time_tile=k),
                 want, "B3, a seed of 3,002 bases (one warp a block)")
    print("[check] B2, B1, B3 == plain at the edge shapes (L = k, tile >= W, "
          "tile not dividing W, R = 1, R = 33, k = 1, one-care seeds '1' and "
          "'00100', three and four seeds, SEEDS18, k = 33 and 64, 41 care "
          "runs, a 3,002-base seed) in hashes, fwd/rev and bucket modes; the "
          "global seed kernel forced there too; A1 == B2 there; seed routes "
          f"launched {dict(sk.ROUTE_LAUNCHES)}")
    return errs


def old_seed_kernel(tm, seeds, h, seg, **kw):
    """The global seed kernel (one thread per read, seed and segment), forced:
    the design the staged kernel replaced on every default shape."""
    return sk._launch(tm, tuple(seeds), len(seeds[0]), h,
                      kw.get("emit_fwd_rev", False), kw.get("emit_buckets"),
                      seg, "global")


def phase_seed_goldens(dev) -> None:
    codes = torch.from_numpy(np.tile(encode_ascii(SEQ_N), (3, 1))).to(dev)
    tm = prepare_codes(codes)
    k = len(SEEDS18[0])
    for label, outs in (
            ("B1", sk.hash_seeds_tm(tm, SEEDS18, 2)),
            ("B3", sk.hash_seeds_tm_long(tm, SEEDS18, 2, time_tile=k))):
        got = [to_numpy_u64(o) for o in outs]
        for pos, *want in SEED18:
            for g, w in zip(got, want):
                require(bool((g[pos] == np.uint64(w)).all()),
                        f"SEED18 golden mismatch through {label} at {pos}")
    h, _ = sk.hash_seeds_batch(torch.from_numpy(
        np.tile(encode_ascii(GOLDEN_SEQ), (4, 1))).to(dev), SEEDS, SEED_H)
    h = to_numpy_u64(h)
    for w, i, want in GOLDEN_SEEDS:
        require(bool((h[:, w, i] == np.uint64(want)).all()),
                f"BASELINE seed golden mismatch at window {w}, hash {i}")
    print(f"[golden] SEED18 windows 0..3 ({len(SEED18)} x 4 values) through "
          f"B1 and B3 (tile 18); the BASELINE seeds' {len(GOLDEN_SEEDS)} "
          "golden values through hash_seeds_batch")


def phase_seeds(codes: np.ndarray, gen, dev, card: str) -> tuple[dict, dict]:
    """Path 2: hash_seeds_batch at the BASELINE seeds over the 1M reads
    (B1) and hash_seeds_tm_long at [10000, 16384] (B3), each held against
    its plain version on all of its output; timings."""
    tag = f"[{card}]"
    errs = dict.fromkeys(SLICE3_KERNELS, 0.0)
    x = torch.from_numpy(codes).to(dev)
    sk.LAUNCHES = sk.LONG_LAUNCHES = 0
    sk.ROUTE_LAUNCHES.update({"staged": 0, "global": 0})
    t0 = time.perf_counter()
    hashes, valid = sk.hash_seeds_batch(x, SEEDS, SEED_H)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"seed_hash": sk.LAUNCHES}
    require(launches["seed_hash"] > 0, "hash_seeds_batch never launched B1")
    require(sk.ROUTE_LAUNCHES["staged"] == launches["seed_hash"]
            and sk.ROUTE_LAUNCHES["global"] == 0,
            f"the BASELINE seeds must take the staged kernel: "
            f"{sk.ROUTE_LAUNCHES}")
    nout = len(SEEDS) * SEED_H
    require(tuple(hashes.shape) == (N_READS, L - 4, nout),
            f"hash_seeds_batch shape {tuple(hashes.shape)}")
    for s in range(0, N_READS, SEED_CHUNK):
        tm = prepare_codes(x[s:s + SEED_CHUNK])
        want = sk.hash_seeds_tm_plain(tm, SEEDS, SEED_H)
        same_outputs(errs, "seed_hash",
                     [hashes[s:s + SEED_CHUNK, :, i].T for i in range(nout)],
                     want, f"hash_seeds_batch reads {s}..")
        if s == 0:  # and the independent direct engine on one chunk
            ref = seed_torch.hash_kmers_seeds(x[:SEED_CHUNK], SEEDS, SEED_H)
            require(torch.equal(ref.hashes, hashes[:SEED_CHUNK])
                    and torch.equal(ref.valid, valid[:SEED_CHUNK]),
                    "hash_seeds_batch != seed_torch.hash_kmers_seeds")
        del tm, want
    print(f"[seeds] hash_seeds_batch {N_READS} reads x {L} bp, seeds "
          f"{SEEDS}, h={SEED_H}: {nout} x [{N_READS}, {L - 4}] int64 == plain "
          f"(in {SEED_CHUNK}-read chunks) and == the direct engine on the "
          f"first chunk; launches {launches}; first run {seconds:.3f} s")
    del hashes, valid
    torch.cuda.empty_cache()

    tm = prepare_codes(x)
    del x
    times = {}
    t = in_turns({"staged": lambda c: sk.hash_seeds_tm(c, SEEDS, SEED_H),
                  "global": lambda c: old_seed_kernel(c, SEEDS, SEED_H,
                                                      L - 4)}, tm, rounds=4)
    times["seed_hash"] = (
        t["staged"],
        timeit(lambda c: sk.hash_seeds_tm_plain(c, SEEDS, SEED_H), tm,
               calls=3).seconds_per_call,
        4 * L * N_READS + 8 * (L - 4) * N_READS * nout)
    print(f"[time] seed_hash {N_READS} x {L} bp, BASELINE, h={SEED_H}, in "
          f"turns over 4 rounds: staged {t['staged'] * 1e3:.4f} ms, global "
          f"(the old design) {t['global'] * 1e3:.4f} ms {tag}")
    del tm
    torch.cuda.empty_cache()

    tm = rand_tm(gen, LONG_L, LONG_READS, dev)
    w = LONG_L - 4
    sk.LONG_LAUNCHES = 0
    got = sk.hash_seeds_tm_long(tm, SEEDS, 1)
    launches["seed_hash_long"] = sk.LONG_LAUNCHES
    same_outputs(errs, "seed_hash_long", got,
                 sk.hash_seeds_tm_long_plain(tm, SEEDS, 1),
                 f"B3 [{LONG_L}, {LONG_READS}]")
    del got
    torch.cuda.empty_cache()
    seg = kmer_kernel.pick_time_tile(len(SEEDS[0]))
    t = in_turns({"staged": lambda c: sk.hash_seeds_tm_long(c, SEEDS, 1),
                  "global": lambda c: old_seed_kernel(c, SEEDS, 1, seg)},
                 tm, rounds=4)
    times["seed_hash_long"] = (
        t["staged"],
        timeit(lambda c: sk.hash_seeds_tm_long_plain(c, SEEDS, 1), tm,
               calls=3).seconds_per_call,
        4 * LONG_L * LONG_READS + 8 * w * LONG_READS * len(SEEDS))
    print(f"[time] seed_hash_long [{LONG_L}, {LONG_READS}], BASELINE, h=1, "
          f"in turns over 4 rounds: staged {t['staged'] * 1e3:.4f} ms, "
          f"global (the old design) {t['global'] * 1e3:.4f} ms {tag}")
    del tm
    torch.cuda.empty_cache()
    print(f"[seeds] hash_seeds_tm_long [{LONG_L}, {LONG_READS}], h=1 per "
          f"seed: == plain; launches {launches['seed_hash_long']}")
    for name, (k_s, p_s, nbytes) in times.items():
        print(f"[time] {name}: kernel {k_s * 1e3:.4f} ms, plain "
              f"{p_s * 1e3:.4f} ms, bound {bound_ms(nbytes):.4f} ms "
              f"({nbytes / 1e9:.4f} GB) {tag}")
    return errs, {"launches": launches, "times": times}


def phase_long_count(rng, tmp: Path, dev, card: str):
    """Path 1: count_file at PipelineConfig() over 16,384 reads x 10,000 bp
    (through B2), against the plain hash->count on every batch; B2 against
    its plain version and A1 at [10000, 16384]; rates and the idle share."""
    tag = f"[{card}]"
    errs = dict.fromkeys(SLICE3_KERNELS, 0.0)
    codes = make_codes(rng, LONG_READS, LONG_L)
    path = tmp / "long.fq"
    write_fastq(path, codes)
    pipe = ReadHashingPipeline(PipelineConfig(), device=dev)
    kmer_kernel.LAUNCHES = kmer_kernel.LONG_LAUNCHES = 0
    reset_hist_launches()
    reset_part_launches()
    t0 = time.perf_counter()
    reads = pipe.count_file(path, batch_size=LONG_BATCH, read_length=LONG_L)
    seconds = time.perf_counter() - t0
    launches = {"kmer_hash": kmer_kernel.LAUNCHES,
                "kmer_hash_long": kmer_kernel.LONG_LAUNCHES,
                "histogram": hist_kernel.LAUNCHES, **pk.LAUNCHES}
    nbatch = LONG_READS // LONG_BATCH
    require(reads == LONG_READS, f"count_file streamed {reads} reads")
    require(launches["kmer_hash_long"] == nbatch and launches["kmer_hash"] == 0,
            f"the long-read batches did not all go through B2: {launches}")
    require(launches["histogram"] == nbatch
            and not any(launches[k] for k in PART_KERNELS),
            f"the long-read path must count directly, one histogram a batch "
            f"and no partition kernel: {launches}")
    want = torch.zeros((H, 1 << WIDE), dtype=torch.int64, device=dev)
    for s in range(0, LONG_READS, LONG_BATCH):
        tm = prepare_codes(torch.from_numpy(codes[s:s + LONG_BATCH]).to(dev))
        plain = kmer_kernel.hash_kmers_tm_long_plain(tm, K, H,
                                                     emit_buckets=WIDE)
        if s == 0:  # the segments' warm-up against whole-read rolls
            require(all(torch.equal(a, b) for a, b in zip(
                plain, hash_kmers_tm_plain(tm, K, H, emit_buckets=WIDE))),
                "segmented plain != whole-read plain on batch 0")
        for r, b in enumerate(plain):
            want[r] += histogram_rows_plain(b.reshape(1, -1), None, WIDE)[0]
        del tm, plain
    require(torch.equal(pipe.sketch.rows.long(), want),
            "long-read count_file sketch != plain hash->count")
    nvalid = valid_windows(codes, K)
    require(int(want[0].sum()) == nvalid, "plain row sum != valid windows")
    print(f"[long] count_file at PipelineConfig(): {reads} reads x {LONG_L} "
          f"bp in {nbatch} batches of {LONG_BATCH}, {nvalid} valid {K}-mers "
          f"per row, sketch == plain hash->count on every batch (batch 0's "
          f"segmented plain == its whole-read plain); launches {launches}; "
          f"first run {seconds:.3f} s")
    del want
    torch.cuda.empty_cache()

    def count():
        pipe.sketch.rows.zero_()
        pipe.count_file(path, batch_size=LONG_BATCH, read_length=LONG_L)

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        count()
        runs.append(time.perf_counter() - t0)
    t_file = statistics.median(runs)
    print(f"[time] count_file {LONG_READS} reads x {LONG_L} bp, "
          f"PipelineConfig(), batch {LONG_BATCH}: median of 3 {t_file:.4f} s, "
          f"{LONG_READS / t_file:.6g} reads/s, "
          f"{LONG_READS * LONG_L / t_file:.6g} bases/s (host clock, parse "
          f"included) {tag}")
    tr = trace_device(count, device=dev)
    require(tr.busy_seconds > 0, "the trace recorded no device activity")
    print(f"[trace] long-read count_file under torch.profiler: wall "
          f"{tr.wall_seconds * 1e3:.3f} ms, device busy "
          f"{tr.busy_seconds * 1e3:.3f} ms (union of device rows), idle share "
          f"{tr.idle_share:.4f} {tag}")
    for name, (t, n) in sorted(tr.by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"[trace]   {t * 1e3:9.3f} ms  x{n:<4d} {name[:90]}")
    del pipe
    torch.cuda.empty_cache()

    # B2 at the hashes-mode shape of the slice: [10000, 16384], h=1
    tm = prepare_codes(torch.from_numpy(codes).to(dev))
    del codes
    w = LONG_L - K + 1
    got = kmer_kernel.hash_kmers_tm_long(tm, K, 1)
    same_outputs(errs, "kmer_hash_long", got,
                 kmer_kernel.hash_kmers_tm_long_plain(tm, K, 1),
                 f"B2 [{LONG_L}, {LONG_READS}] h=1")
    require(torch.equal(got[0], hash_kmers_tm(tm, K, 1)[0]),
            "A1 != B2 at the long-read shape")
    del got
    torch.cuda.empty_cache()
    t_b2 = timeit(lambda c: kmer_kernel.hash_kmers_tm_long(c, K, 1), tm)
    t_a1 = timeit(lambda c: hash_kmers_tm(c, K, 1), tm, calls=3)
    t_pl = timeit(lambda c: kmer_kernel.hash_kmers_tm_long_plain(c, K, 1), tm,
                  calls=3)
    nbytes = 4 * LONG_L * LONG_READS + 8 * w * LONG_READS
    print(f"[time] kmer_hash_long [{LONG_L}, {LONG_READS}] h=1 hashes: B2 "
          f"{t_b2.seconds_per_call * 1e3:.4f} ms, A1 (one thread per read) "
          f"{t_a1.seconds_per_call * 1e3:.4f} ms, plain "
          f"{t_pl.seconds_per_call * 1e3:.4f} ms, bound "
          f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e9:.4f} GB) {tag}")
    del tm
    torch.cuda.empty_cache()
    return errs, launches, (t_b2.seconds_per_call, t_pl.seconds_per_call,
                            nbytes)


def phase_crossover(gen, dev, card: str) -> None:
    """A1 (one thread per read) against B2 (segments of 256 windows) at
    k=32, one hash, buckets at 2**20: the grid that sets
    ``kmer_kernel.long_read_threshold``. Timed A1, B2, B2, A1."""
    for length, reads in CROSSOVER:
        tm = rand_tm(gen, length, reads, dev)
        a1 = hash_kmers_tm(tm, K, 1, emit_buckets=WIDE)
        require(torch.equal(a1[0], kmer_kernel.hash_kmers_tm_long(
            tm, K, 1, emit_buckets=WIDE)[0]), f"A1 != B2 at [{length}, {reads}]")
        del a1
        torch.cuda.empty_cache()
        t = []
        for fn in (hash_kmers_tm, kmer_kernel.hash_kmers_tm_long,
                   kmer_kernel.hash_kmers_tm_long, hash_kmers_tm):
            t.append(timeit(lambda c, f=fn: f(c, K, 1, emit_buckets=WIDE), tm)
                     .seconds_per_call * 1e3)
            torch.cuda.empty_cache()
        route = "B2" if kmer_kernel.long_read_threshold(length, K, reads) \
            else "A1"
        print(f"[cross] L={length} R={reads} h=1 buckets 2**{WIDE}: A1 "
              f"{t[0]:.4f} / {t[3]:.4f} ms, B2 {t[1]:.4f} / {t[2]:.4f} ms, "
              f"outputs equal; the rule picks {route} [{card}]")
        del tm
        torch.cuda.empty_cache()


def old_sequence_route(seq: torch.Tensor, k: int, h: int, seeds=None,
                       emit_fwd_rev: bool = False):
    """The pseudo-read route of PRs 3-6, rebuilt: the sequence padded by
    k - 1 invalid codes, cut into overlapping rows (``sp.pseudo_reads``),
    cast and transposed (``prepare_codes``), hashed by the read kernel (A1,
    or the seed kernel), its [t, rows] planes transposed back, and
    ``window_valid`` over an int32 copy of the rows."""
    t = sp.pick_tile(seq.shape[0], k, None if seeds is None else 128)
    pseudo = sp.pseudo_reads(
        torch.nn.functional.pad(seq, (0, k - 1), value=4), k, t)
    tm = prepare_codes(pseudo)
    planes = (hash_kmers_tm(tm, k, h, emit_fwd_rev=emit_fwd_rev)
              if seeds is None
              else sk.hash_seeds_tm(tm, seeds, h, emit_fwd_rev=emit_fwd_rev))
    return ([p.T.reshape(-1) for p in planes],
            kmer_torch.window_valid(pseudo.to(torch.int32), k).reshape(-1))


def reset_sequence_launches() -> None:
    kmer_kernel.LAUNCHES = kmer_kernel.LONG_LAUNCHES = 0
    kmer_kernel.SEQUENCE_LAUNCHES = 0
    sk.LAUNCHES = sk.LONG_LAUNCHES = sk.SEQUENCE_LAUNCHES = 0


def phase_sp(rng, dev, card: str) -> tuple[dict, dict, dict, dict]:
    """Path 3: one 2**27-base sequence through ``sp.hash_long_sequence``
    (the one-pass entry of kmer_hash.cu), one 2**25-base one through
    ``sp.hash_long_sequence_seeds`` (seed_hash.cu's), each one launch and no
    read kernel, against its plain version (the pseudo-read route on the
    batch-major engines) everywhere, the old pseudo-read route on the
    kernels, and a whole-sequence plain roll at segment boundaries; a prime
    length for the padded tail. Timed beside the old route and the
    segmented read kernel over the sequence as one read [C, 1]. Also
    returns each sequence with its outputs, which phase 30 holds the
    distributed route to."""
    tag = f"[{card}]"
    launches, times, keep = {}, {}, {}
    errs = {"kmer_sequence": 0.0, "seed_sequence": 0.0}
    for name, label, n, seeds in (
            ("kmer_sequence", "hash_long_sequence", SP_LEN, None),
            ("seed_sequence", "hash_long_sequence_seeds", SP_SEED_LEN, SEEDS)):
        k = K if seeds is None else len(seeds[0])
        seq = torch.from_numpy(rng.integers(0, 4, size=n, dtype=np.uint8)).to(dev)

        def run(x, engine="auto", seeds=seeds, k=k):
            if seeds is None:
                return sp.hash_long_sequence(x, k, 1, engine=engine)
            return sp.hash_long_sequence_seeds(x, seeds, 1, engine=engine)

        reset_sequence_launches()
        got, valid = run(sp.shard_sequence(seq, k=k))
        launches[name] = (kmer_kernel.SEQUENCE_LAUNCHES if seeds is None
                          else sk.SEQUENCE_LAUNCHES)
        others = (kmer_kernel.LAUNCHES + kmer_kernel.LONG_LAUNCHES + sk.LAUNCHES
                  + sk.LONG_LAUNCHES + kmer_kernel.SEQUENCE_LAUNCHES
                  + sk.SEQUENCE_LAUNCHES - launches[name])
        require(launches[name] == 1 and others == 0,
                f"{label}: {launches[name]} launches of its entry, {others} "
                "of other hash kernels")
        want, pvalid = run(seq, "torch")
        same_outputs(errs, name, got + [valid], want + [pvalid],
                     f"{label} vs its plain version")
        old, ovalid = old_sequence_route(seq, k, 1, seeds)
        require(all(torch.equal(a, b) for a, b in zip(got, old))
                and torch.equal(valid, ovalid), f"{label} != the old route")
        del want, pvalid, old, ovalid
        span = kmer_kernel.sequence_span(k, seeds=seeds is not None)
        for start in (0, 5 * span - 64, n // 2 - 64, n - 128 - k + 1):
            part = prepare_codes(seq[start:start + 128 + k - 1][None])
            direct = (hash_kmers_tm_plain(part, k, 1) if seeds is None
                      else sk.hash_seeds_tm_plain(part, seeds, 1))[0][:, 0]
            require(torch.equal(got[0][start:start + 128], direct),
                    f"{label} != whole-sequence roll at {start}")
        require(bool(valid[:n - k + 1].all()) and not bool(valid[n - k + 1:].any()),
                f"{label}: validity")
        keep[name] = (seq, got, valid)
        del got, valid
        torch.cuda.empty_cache()
        one = seq.to(torch.int32)[:, None].contiguous()
        long = ((lambda x: kmer_kernel.hash_kmers_tm_long(one, k, 1))
                if seeds is None
                else (lambda x: sk.hash_seeds_tm_long(one, seeds, 1)))
        t = in_turns({"entry": run, "old route":
                      lambda x: old_sequence_route(x, k, 1, seeds),
                      "[C, 1]": long}, seq, rounds=2)
        del one
        t_p = timeit(lambda x: run(x, "torch"), seq, calls=3).seconds_per_call
        nbytes = n + 8 * n * (1 if seeds is None else len(seeds)) + n
        times[name] = (t["entry"], t_p, nbytes)
        print(f"[sp] {label} {n} bases, k={k}, h=1, one pass: == plain, == "
              f"the old pseudo-read route, == a whole-sequence roll at "
              f"windows 0, {5 * span - 64}, {n // 2 - 64} and the tail; "
              f"launches {launches[name]}")
        print(f"[time] {label} {n} bases: entry {t['entry'] * 1e3:.4f} ms "
              f"({(n - k + 1) / t['entry']:.6g} windows/s), old pseudo-read "
              f"route {t['old route'] * 1e3:.4f} ms "
              f"({(n - k + 1) / t['old route']:.6g} windows/s), "
              f"{'B2' if seeds is None else 'B3'} over [C, 1] "
              f"{t['[C, 1]'] * 1e3:.4f} ms, plain route {t_p * 1e3:.4f} ms, "
              f"bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e9:.4f} GB) {tag}")
        del seq
        torch.cuda.empty_cache()
        # a prime length: the padded tail, and the unpadded one
        m = SP_PRIME
        seq = torch.from_numpy(rng.integers(0, 8, size=m, dtype=np.uint8)).to(dev)
        for x in (sp.shard_sequence(seq, k=k), seq):
            got, valid = run(x)
            want, pvalid = run(x, "torch")
            same_outputs(errs, name, got + [valid], want + [pvalid],
                         f"{label} at length {x.shape[0]}")
        tail = prepare_codes(seq[m - 300:][None])
        direct = (hash_kmers_tm_plain(tail, k, 1) if seeds is None
                  else sk.hash_seeds_tm_plain(tail, seeds, 1))[0][:, 0]
        require(torch.equal(got[0][m - 300:m - k + 1], direct)
                and not bool(valid[m - k + 1:].any()),
                f"{label}: the tail at length {m}")
        print(f"[sp] {label} at prime length {m}, codes 0-7, padded to "
              f"{sp.shard_sequence(seq, k=k).shape[0]} and not: == plain; "
              "the last windows == a whole-sequence roll; every window past "
              "the end invalid")
        del seq, got, valid, want, pvalid
        torch.cuda.empty_cache()
    return errs, launches, times, keep


# ----------------------------------------------------- the Bloom filter ----

#: The JAX bench's three Bloom widths: BLOOM_WIDTH_LOG2 (bench.py:51, direct),
#: WIDE_WIDTH_LOG2 (:43, partitioned) and BLOOM_HUGE_WIDTH_LOG2 (:47, 128 MB
#: of words, 8,192 partitions).
BLOOM_WIDTHS = (17, 20, 30)
#: The widths at which the Bloom phases also run the partitioned words (C3,
#: through C2), off the default path.
PART_BLOOM_WIDTHS = (20, 30)
BLOOM_KERNELS = ("bloom_words", "bloom_words_rows")


def bloom_stream(gen, n: int, wl: int, rows=None) -> torch.Tensor:
    """int32 indices made on the card with -1, the sentinel and values past
    it among them (at 2**31, where no int32 is past the width, negatives)."""
    shape = (n,) if rows is None else (rows, n)
    width = 1 << wl
    idx = torch.randint(0, width, shape, device=gen.device, generator=gen,
                        dtype=torch.int64)
    for value in ((-1, width, width + 10) if wl < 31 else (-1, -(1 << 31), -7)):
        idx[torch.rand(shape, device=gen.device, generator=gen) < 0.01] = value
    return idx.to(torch.int32)


def phase_bloom_edges(gen, dev) -> dict:
    """Phase 17: C1 (``bloom_words``) and C2 (``bloom_words_rows``) against
    their plain versions at the edge shapes: widths 2**12, 2**13, 2**18,
    2**26 (and 2**31 for C1), R = 1 and R not a power of two, with and
    without a weight, gated on and off, OR-ed into random words."""
    errs = dict.fromkeys(BLOOM_KERNELS, 0.0)
    fills = {}   # width -> fill ratios of the plain results compared

    def same(name, got, want, what):
        torch.cuda.synchronize()
        errs[name] = max(errs[name], max_abs_err(got, want))
        require(torch.equal(got, want), f"{name} != plain: {what}")
        fills.setdefault(wl, []).append(fill_of(want))

    # 2**20 updates is one update per thread of the largest grid (4,096
    # blocks x 256); at 2**26 and 2**31 every thread loops, into filters
    # that stay sparse
    for wl, n in ((12, 1 << 20), (13, 1 << 20), (18, 1 << 20),
                  (26, GRID_STRIDE_N), (31, GRID_STRIDE_N)):
        idx = bloom_stream(gen, n, wl)
        w = torch.randint(-1, 2, (n,), device=dev, generator=gen,
                          dtype=torch.int32)
        for weight in (None, w):
            same("bloom_words", hist_kernel.bloom_words(idx, weight, wl),
                 hist_kernel.bloom_words_plain(idx, weight, wl),
                 f"2**{wl}, weight {weight is not None}")
        base = torch.randint(-(1 << 31), 1 << 31, (1 << (wl - 5),),
                             device=dev, generator=gen, dtype=torch.int32)
        for g in (0, 1):
            gate = torch.full((1,), g, dtype=torch.int32, device=dev)
            same("bloom_words",
                 hist_kernel.bloom_words(idx, w, wl, gate=gate,
                                         out=base.clone()),
                 hist_kernel.bloom_words_plain(idx, w, wl, gate=gate,
                                               out=base.clone()),
                 f"2**{wl}, gate {g}, out")
        if wl == 31:
            continue
        for rows in (1, 3, 5):
            idx = bloom_stream(gen, n // rows, wl, rows)
            base = torch.randint(-(1 << 31), 1 << 31, (rows, 1 << (wl - 5)),
                                 device=dev, generator=gen, dtype=torch.int32)
            for g in (0, 1):
                gate = torch.full((1,), g, dtype=torch.int32, device=dev)
                same("bloom_words_rows",
                     hist_kernel.bloom_words_rows(idx, wl, gate=gate,
                                                  out=base.clone()),
                     hist_kernel.bloom_words_rows_plain(idx, wl, gate=gate,
                                                        out=base.clone()),
                     f"2**{wl}, {rows} rows, gate {g}")
            same("bloom_words_rows", hist_kernel.bloom_words_rows(idx, wl),
                 hist_kernel.bloom_words_rows_plain(idx, wl),
                 f"2**{wl}, {rows} rows")
        torch.cuda.empty_cache()
    require(all(min(fills[wl]) < 0.5 for wl in (26, 31)),
            f"the grid-stride checks filled their filters: {fills}")
    print("[check] bloom_words == plain at 2**12, 2**13, 2**18 (2**20 "
          f"updates) and 2**26, 2**31 ({GRID_STRIDE_N} updates), with -1, "
          "the sentinel and past it; weights -1/0/1 and none; gate 0/1 into "
          "random words; bloom_words_rows == plain at 2**12..2**26 with 1, 3 "
          "and 5 rows, gated and not; fill ratio of the compared words, min "
          "/ max by width: " + ", ".join(
              f"2**{wl} {min(f):.6f} / {max(f):.6f}"
              for wl, f in fills.items()))
    # C3 under skew: one bucket 2**20 times overflows every window and
    # must go through the gated C1; a mostly-sentinel stream must not
    wl = 20
    p_log2, sub_log2, rows, cap = pk.plan(wl)
    skew = torch.full((1 << 20,), 77, dtype=torch.int32, device=dev)
    sent = torch.full((1 << 20,), 1 << wl, dtype=torch.int32, device=dev)
    sent[:130] = torch.randint(0, 1 << wl, (130,), device=dev, generator=gen,
                               dtype=torch.int32)
    for label, x, over in (("skewed", skew, 1), ("mostly-sentinel", sent, 0)):
        _, flags = pk._partition(x[None], wl, p_log2, sub_log2, rows, cap)
        require(flags.tolist() == [over, 1 - over],
                f"{label} stream: overflow flags {flags.tolist()}")
        require(torch.equal(pk.partitioned_bloom_words(x, wl),
                            hist_kernel.bloom_words_plain(x, None, wl)),
                f"partitioned_bloom_words != plain on the {label} stream")
    print("[check] 2**20: the all-identical stream sets the overflow flag "
          "and packs exactly through the gated bloom_words; a "
          "mostly-sentinel stream does not set it and packs exactly")
    return errs


def fill_of(words: torch.Tensor) -> float:
    """Fraction of set bits in words of any shape."""
    return int(bloom.count_set_bits(bloom.BloomFilter(words.reshape(-1)))) \
        / (words.numel() * 32)


def bloom_tms(codes: np.ndarray, dev) -> list:
    """The 1M reads' time-major codes on the card, one tensor per batch."""
    return [prepare_codes(torch.from_numpy(codes[s:s + BATCH]).to(dev))
            for s in range(0, codes.shape[0], BATCH)]


def bloom_build(tms, wl: int, dev):
    """The Bloom path as a user calls it: per batch, the fused hash kernel
    emits buckets at the filter's width and ``insert_from_buckets`` ORs
    them in."""
    bf = bloom.BloomFilter.zeros(wl, device=dev)
    for tm in tms:
        bloom.insert_from_buckets(
            bf, kmer_kernel.hash_kmers_tm_auto(tm, K, H, emit_buckets=wl),
            emitted_width_log2=wl)
    return bf


def reset_launches() -> None:
    kmer_kernel.LAUNCHES = kmer_kernel.LONG_LAUNCHES = 0
    for counts in (pk.LAUNCHES, hist_kernel.BLOOM_LAUNCHES,
                   hist_kernel.BIN_LAUNCHES, hist_kernel.RANGE_LAUNCHES,
                   hist_kernel.SCATTER_ROUTE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def phase_bloom_path(codes: np.ndarray, dev, errs: dict
                     ) -> tuple[dict, dict]:
    """Phase 18: the Bloom path over the 1M reads at 2**17, 2**20 and 2**30
    against the plain hash -> plain insert, contains on every valid window,
    the merge of two half-filters, C1 against plain on the path's own
    batch-0 launch shape (and, where the path's data saturates the words,
    on the same shape into words that stay sparse, each compare with its
    fill ratio); launches per kernel. Then, off the path, the partitioned
    words (C3, through C2) over the same reads at 2**20 and 2**30 against
    the same filter, C2 on batch 0's windows, and whether the overflow flag
    fired. Returns the launches by kernel (C1's on the default path, C2's
    in the partitioned runs) and the words of the 2**20 and 2**30 filters,
    which phase 30 unions across ranks."""
    tms = bloom_tms(codes, dev)
    total = dict.fromkeys((*BLOOM_KERNELS, "bin_ranges_words",
                           "bloom_ranges"), 0)
    filters = {}
    for wl in BLOOM_WIDTHS:
        reset_launches()
        t0 = time.perf_counter()
        bf = bloom_build(tms, wl, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"kmer_hash": kmer_kernel.LAUNCHES,
                    "kmer_hash_long": kmer_kernel.LONG_LAUNCHES,
                    **hist_kernel.BLOOM_LAUNCHES, **pk.LAUNCHES,
                    "bin_ranges_words": hist_kernel.BIN_LAUNCHES["bloom"],
                    "bloom_ranges": hist_kernel.RANGE_LAUNCHES["bloom"]}
        binned = sum(hist_kernel._words_route_of(
            1, H * tm.shape[1] * (tm.shape[0] - K + 1), wl, None)[0]
            == "binned" for tm in tms)
        bodies = dict(hist_kernel.SCATTER_ROUTE_LAUNCHES)
        want_bodies = dict.fromkeys(bodies, 0)
        if binned:
            want_bodies[hist_kernel.scatter_body(
                wl, hist_kernel.WORDS_RANGE_LOG2)] = binned
        require(launches["kmer_hash"] > 0
                and launches["bloom_words"] == len(tms)
                and not launches["bloom_words_rows"]
                and not any(launches[k] for k in PART_KERNELS)
                and launches["bin_ranges_words"] == binned
                == launches["bloom_ranges"] and bodies == want_bodies,
                f"the 2**{wl} Bloom path must take one bloom_words call a "
                f"batch, binned on the {binned} batches where the rule bins "
                f"(one binning and one range pass each, the scatter by the "
                f"rule's body: {want_bodies}, took {bodies}), and no "
                f"partition kernel: {launches}")
        for name in total:
            if name != "bloom_words_rows":
                total[name] += launches[name]
        want = torch.zeros_like(bf.words)
        for tm in tms:
            for b in hash_kmers_tm_plain(tm, K, H, emit_buckets=wl):
                hist_kernel.bloom_words_plain(b, None, wl, out=want)
        require(torch.equal(bf.words, want),
                f"Bloom filter at 2**{wl} != plain hash -> plain insert")
        bits = int(bloom.count_set_bits(bf))
        require(bits == int(bloom.count_set_bits(bloom.BloomFilter(want))),
                "popcount != plain")
        del want
        for tm in tms:
            hashes = torch.stack(kmer_kernel.hash_kmers_tm_auto(tm, K, H), -1)
            valid = kmer_torch.window_valid_tm(tm, K)
            require(bool(bloom.contains(bf, hashes, wl)[valid].all()),
                    f"a false negative at 2**{wl}")
            del hashes, valid
        half = bloom.merge(bloom_build(tms[:2], wl, dev),
                           bloom_build(tms[2:], wl, dev))
        require(torch.equal(half.words, bf.words),
                f"merge of two half-filters != the whole at 2**{wl}")
        del half
        fired = []
        compared = []   # (what was compared, fill ratio of the plain words)

        def same(name, got, want, what, n):
            torch.cuda.synchronize()
            errs[name] = max(errs[name], max_abs_err(got, want))
            require(torch.equal(got, want),
                    f"{name} != plain on batch 0: {what}")
            fill = fill_of(want)
            compared.append((f"{what}: {n} updates, fill {fill:.6f}", fill))
            return fill

        # C1 on the path's own shape: batch 0's [H, n] view as one stream,
        # at the path's width and, at the same launch shape, emitted at
        # 2**30 into a filter that stays sparse
        for ewl in sorted({wl, 30}):
            stream = hist_kernel.rows_view(hash_kmers_tm(
                tms[0], K, H, emit_buckets=ewl)).reshape(-1)
            route = hist_kernel._words_route_of(1, stream.numel(), ewl, None)
            same("bloom_words", hist_kernel.bloom_words(stream, None, ewl),
                 hist_kernel.bloom_words_plain(stream, None, ewl),
                 f"bloom_words, batch 0's stream at 2**{ewl} (route {route})",
                 stream.numel())
            del stream
        if wl in PART_BLOOM_WIDTHS:
            # off the path: the partitioned words over the same reads
            p_log2, sub_log2, rows, cap = pk.plan(wl)
            part = torch.zeros_like(bf.words)
            part_launches = dict.fromkeys(("bloom_words", "bloom_words_rows",
                                           *PART_KERNELS), 0)
            for i, tm in enumerate(tms):
                stream = torch.cat([b.reshape(-1) for b in hash_kmers_tm(
                    tm, K, H, emit_buckets=wl)])
                # the launches of the function's own run, not of the checks
                reset_launches()
                pk.partitioned_bloom_words(stream, wl, out=part)
                for k, v in {**hist_kernel.BLOOM_LAUNCHES,
                             **pk.LAUNCHES}.items():
                    part_launches[k] += v
                wins, flags = pk._partition(stream[None], wl, p_log2, sub_log2,
                                            rows, cap)
                fired.append(int(flags[0]))
                if i == 0:  # C2 on its own launch shape, and the fallback's
                    flat = wins.reshape(1 << p_log2, -1)
                    if same("bloom_words_rows",
                            hist_kernel.bloom_words_rows(flat, sub_log2),
                            hist_kernel.bloom_words_rows_plain(flat, sub_log2),
                            f"bloom_words_rows, {1 << p_log2} rows at "
                            f"2**{sub_log2}", flat.numel()) >= 0.5:
                        # saturated: the same launch shape again, on random
                        # buckets into rows wide enough to stay sparse
                        sparse = torch.randint(
                            0, 1 << 23, flat.shape, device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(wl), dtype=torch.int32)
                        same("bloom_words_rows",
                             hist_kernel.bloom_words_rows(sparse, 23),
                             hist_kernel.bloom_words_rows_plain(sparse, 23),
                             f"bloom_words_rows, the same [{flat.shape[0]}, "
                             f"{flat.shape[1]}] shape, random buckets at "
                             f"2**23", sparse.numel())
                        del sparse
                    del flat
                del stream, wins
            require(torch.equal(part, bf.words),
                    f"partitioned_bloom_words at 2**{wl} != the filter")
            require(all(part_launches[k] > 0 for k in
                        ("bloom_words_rows", *PART_KERNELS)),
                    f"a kernel of the partitioned words never launched: "
                    f"{part_launches}")
            total["bloom_words_rows"] += part_launches["bloom_words_rows"]
            del part
            print(f"[bloom] 2**{wl}, off the path: partitioned_bloom_words "
                  f"over the same {N_READS} reads == the filter; launches "
                  f"{part_launches}; overflow flag per batch {fired} (fired: "
                  f"{any(fired)})")
        require(min(f for _, f in compared) < 0.5,
                f"every batch-0 check at 2**{wl} was saturated: {compared}")
        print(f"[check] 2**{wl}, batch 0, kernel == plain: " +
              "; ".join(t for t, _ in compared))
        print(f"[bloom] 2**{wl}: {N_READS} reads in {len(tms)} batches, k={K} "
              f"h={H}: filter == plain hash -> plain insert (whole, "
              f"{bits} bits set, fill ratio {bits / (1 << wl):.6f}); contains "
              f"true on every valid window; merge of two halves == the whole; "
              f"launches {launches}; first run {seconds:.3f} s")
        if wl in DIST_BLOOM_WIDTHS:
            filters[wl] = bf.words
        del bf
        torch.cuda.empty_cache()
    return total, filters


def scatter_pack(flat: torch.Tensor, wl: int) -> torch.Tensor:
    """The library yardstick: ``index_fill_`` into a uint8 presence (the
    sentinel lands in a spare last slot), then a dense pack to words."""
    presence = torch.zeros((1 << wl) + 1, dtype=torch.uint8, device=flat.device)
    presence.index_fill_(0, flat, 1)
    return bloom.pack_presence(presence[:-1])


def phase_bloom_timings(codes: np.ndarray, dev, card: str) -> dict:
    """Phase 19: per 2**18-read batch and over the 1M reads (the sum of the
    four batches' medians of 5 CUDA-event timings after warm-up): C1 as the
    path launches it (one launch a batch over the hash kernel's [H, n]
    view) at 2**17, 2**20 and 2**30; off the path, C2 at the 2**20 and 2**30
    sub-widths and C3 whole; the scatter yardstick, the plain versions and
    the byte bounds; the Bloom step's k-mers/s at each width beside the old
    route forced (one C1 launch a tensor at 2**17, the partitioned words at
    2**20 and 2**30) in turns, and one traced step at 2**20."""
    tag = f"[{card}]"
    tms = bloom_tms(codes, dev)
    w = L - K + 1
    tot = {}   # name -> [kernel, plain or None, scatter or None, bytes]

    def add(name, k_s, p_s, lib_s, nbytes):
        row = tot.setdefault(name, [0.0, None if p_s is None else 0.0,
                                    None if lib_s is None else 0.0, 0.0])
        row[0] += k_s
        if p_s is not None:
            row[1] += p_s
        if lib_s is not None:
            row[2] += lib_s
        row[3] += nbytes

    def t(fn, *args):
        # CUDA events on the card even where the argument is a list
        return timeit(fn, *args, device=dev).seconds_per_call

    for wl in BLOOM_WIDTHS:
        width = 1 << wl
        nwords = width >> 5
        words = torch.zeros(nwords, dtype=torch.int32, device=dev)
        for tm in tms:
            stream = hist_kernel.rows_view(hash_kmers_tm(
                tm, K, H, emit_buckets=wl)).reshape(-1)
            n = stream.numel()
            flat = stream.long()
            lib_s = t(lambda x: scatter_pack(x, wl), flat)
            del flat
            route = hist_kernel._words_route_of(1, n, wl, None)
            add(f"bloom_words at 2**{wl} (one launch a batch, the path; "
                f"route {route})",
                t(lambda x: hist_kernel.bloom_words(x, None, wl, out=words),
                  stream),
                t(lambda x: hist_kernel.bloom_words_plain(x, None, wl,
                                                          out=words), stream),
                lib_s, 4 * n + 4 * nwords)
            if wl in PART_BLOOM_WIDTHS:
                p_log2, sub_log2, rows, cap = pk.plan(wl)
                p = 1 << p_log2
                wins, _ = pk._partition(stream[None], wl, p_log2, sub_log2,
                                        rows, cap)
                flat = wins.reshape(p, -1)
                del wins
                out2 = words.view(p, -1)
                add(f"bloom_words_rows at 2**{wl} ({p} rows at 2**{sub_log2})",
                    t(lambda x: hist_kernel.bloom_words_rows(
                        x, sub_log2, out=out2), flat),
                    t(lambda x: hist_kernel.bloom_words_rows_plain(
                        x, sub_log2, out=out2), flat),
                    None, 4 * flat.numel() + 4 * nwords)
                del flat
                add(f"partitioned_bloom_words at 2**{wl} (whole, off the path)",
                    t(lambda x: pk.partitioned_bloom_words(x, wl, out=words),
                      stream), None, lib_s, 4 * n + 4 * nwords)
            del stream
            torch.cuda.empty_cache()
        del words

        def step(wl=wl):
            bf = bloom.BloomFilter.zeros(wl, device=dev)
            for tm in tms:
                bloom.insert_from_buckets(
                    bf, kmer_kernel.hash_kmers_tm_auto(tm, K, H,
                                                       emit_buckets=wl),
                    emitted_width_log2=wl)
            return bf

        def old_step(wl=wl):
            # the route before this port filled every width directly
            bf = bloom.BloomFilter.zeros(wl, device=dev)
            for tm in tms:
                bucks = kmer_kernel.hash_kmers_tm_auto(tm, K, H,
                                                       emit_buckets=wl)
                if wl in PART_BLOOM_WIDTHS:
                    pk.partitioned_bloom_words(
                        torch.cat([b.reshape(-1) for b in bucks]), wl,
                        out=bf.words)
                else:
                    for b in bucks:
                        hist_kernel.bloom_words(b, None, wl, out=bf.words)
            return bf

        steps = in_turns({"new": step, "old": old_step}, device=dev)
        old = ("the partitioned words" if wl in PART_BLOOM_WIDTHS
               else "one bloom_words launch a tensor")
        print(f"[time] Bloom step (hash_kmers_tm_auto buckets + "
              f"insert_from_buckets) at 2**{wl}, {N_READS} reads x {L} bp "
              f"in {len(tms)} batches: {steps['new'] * 1e3:.4f} ms, "
              f"{N_READS * w / steps['new']:.6g} k-mers/s (all windows); the "
              f"old route ({old}) {steps['old'] * 1e3:.4f} ms, in turns {tag}")
        if wl == 20:
            tr = trace_device(step, device=dev)
            require(tr.busy_seconds > 0, "the trace recorded no device activity")
            print(f"[trace] Bloom step at 2**{wl} under torch.profiler: wall "
                  f"{tr.wall_seconds * 1e3:.3f} ms, device busy "
                  f"{tr.busy_seconds * 1e3:.3f} ms (union of device rows), "
                  f"idle share {tr.idle_share:.4f} {tag}")
            for name, (sec, c) in sorted(tr.by_name.items(),
                                         key=lambda kv: -kv[1][0])[:12]:
                print(f"[trace]   {sec * 1e3:9.3f} ms  x{c:<4d} {name[:90]}")
        torch.cuda.empty_cache()
    for name, (k_s, p_s, lib_s, nbytes) in tot.items():
        plain = "" if p_s is None else f", plain {p_s * 1e3:.4f} ms"
        lib = "" if lib_s is None else \
            f", scatter yardstick {lib_s * 1e3:.4f} ms"
        print(f"[time] {name} over {N_READS} reads: kernel {k_s * 1e3:.4f} ms"
              f"{plain}{lib}, bound {bound_ms(nbytes):.4f} ms "
              f"({nbytes / 1e9:.4f} GB) {tag}")
    return tot


# ------------------------------------------ the two redesigned kernels ----

WORD_ROUTES = ("private", "direct")


def words_by(route, idx, weight, wl, gate=None, out=None):
    """The presence-word kernel over idx [R, N] with its route forced."""
    return hist_kernel._words_launch(idx, weight, wl, gate, out,
                                     "bloom_words_rows", route=route)


def phase_redesign_checks(codes: np.ndarray, gen, dev) -> dict:
    """Phase 20: both routes of the presence-word kernel and the tile sort
    against their plain versions, exact."""
    errs = {"bloom_words_rows": 0.0, "sort_tiles": 0.0, "merge_phase": 0.0}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        errs[name] = max(errs[name], max_abs_err(got, want))
        require(torch.equal(got, want), f"{name} != plain: {what}")

    for wl, rows, n in ((12, 1, 1 << 20), (13, 5, 300_001), (17, 1, 3_000_003),
                        (18, 3, 1_000_001), (20, 1, 2_000_001),
                        (13, 7, 1000), (12, 1, 5)):
        idx = bloom_stream(gen, n, wl, rows)
        w = torch.randint(-1, 2, (n,), device=dev, generator=gen,
                          dtype=torch.int32) if rows == 1 else None
        base = torch.randint(-(1 << 31), 1 << 31, (rows, 1 << (wl - 5)),
                             device=dev, generator=gen, dtype=torch.int32)
        for g in (0, 1):
            gate = torch.full((1,), g, dtype=torch.int32, device=dev)
            want = hist_kernel._words_plain(idx, w, wl, gate, base.clone())
            for route in WORD_ROUTES:
                same("bloom_words_rows",
                     words_by(route, idx, w, wl, gate, base.clone()), want,
                     f"{route} route, 2**{wl}, {rows} x {n}, gate {g}, "
                     "weights, out holding bits")
        # rows that start off a 16-byte boundary (one row: the view itself;
        # more: an odd row length)
        want = hist_kernel._words_plain(idx[:, 1:], None, wl, None, None)
        for route in WORD_ROUTES:
            same("bloom_words_rows", words_by(route, idx[:, 1:], None, wl),
                 want, f"{route} route, 2**{wl}, unaligned")
    print("[check] presence words, private and direct route forced == plain "
          "at 2**12, 2**13, 2**17, 2**18, 2**20 (rows 1, 3, 5, 7; weights "
          "-1/0/1; gate 0/1; out holding random bits; short rows)")
    # the hot-row shape (the 2**20 plan's windows), the 2**30 plan's rows and
    # sparse words at 2**18, on random buckets so that the words stay sparse
    fills = []
    for what, wl, rows, n, top in (
            ("hot rows [128, 1462272] at 2**13, buckets below 2**11", 13, 128,
             1_462_272, 1 << 11),
            ("the 2**30 plan's rows [8192, 32768] at 2**17", 17, 8192, 32_768,
             1 << 17),
            ("sparse words [3, 100000] at 2**18", 18, 3, 100_000, 1 << 18)):
        idx = torch.randint(0, top, (rows, n), device=dev, generator=gen,
                            dtype=torch.int32)
        want = hist_kernel.bloom_words_rows_plain(idx, wl)
        fills.append(fill_of(want))
        grid = hist_kernel.private_words_grid(rows, n, wl)
        for route in WORD_ROUTES:
            same("bloom_words_rows", words_by(route, idx, None, wl), want,
                 f"{route} route, {what}")
        same("bloom_words_rows", hist_kernel.bloom_words_rows(idx, wl), want,
             f"the selected route, {what}")
        print(f"[check] presence words == plain by both routes and by the "
              f"selected one (blocks per row, threads: {grid}): {what}, fill "
              f"{fills[-1]:.6f}")
        del idx, want
    require(max(fills) < 0.5, f"a sparse check filled its words: {fills}")
    for rows, n, wl in ((128, 1_462_272, 13), (8192, 32_768, 17),
                        (1, 31_195_136, 17), (1, 124_780_544, 20),
                        (1, 31_195_136, 26), (1, 1 << 20, 31), (4, 100, 13)):
        print(f"[route] idx [{rows}, {n}] at 2**{wl}: (blocks per row, "
              f"threads) = {hist_kernel.private_words_grid(rows, n, wl)} "
              "((0, 0): direct atomics)")
    torch.cuda.empty_cache()

    # the tile sort
    kinds = ("random 21-bit", "random 31-bit", "all equal", "all sentinel",
             "sorted", "reversed")
    for rows, g in ((1, 5), (2, 8), (8, 3), (16, 4), (64, 8), (128, 8),
                    (256, 8), (512, 8), (16384, 2), (65536, 1)):
        shape = (2, g, rows, pk.LANES)
        for kind in kinds:
            if kind == "random 31-bit":
                x = torch.randint(0, (1 << 31) - 1, shape, device=dev,
                                  generator=gen, dtype=torch.int64).int()
            elif kind == "all equal":
                x = torch.full(shape, 77, dtype=torch.int32, device=dev)
            elif kind == "all sentinel":
                x = torch.full(shape, 1 << WIDE, dtype=torch.int32, device=dev)
            else:
                x = torch.randint(0, (1 << WIDE) + 1, shape, device=dev,
                                  generator=gen, dtype=torch.int32)
                if kind != "random 21-bit":
                    x = x.reshape(-1).sort(descending=kind == "reversed") \
                        .values.reshape(shape)
            got, tile = pk.sort_tiles(x)
            same("sort_tiles", got, pk.sort_tiles_plain(x, tile),
                 f"{kind}, chunks of {rows} x 128, tile {tile}")
            k = 2 * tile
            while k <= rows * pk.LANES:
                want = pk.merge_phase_plain(got, k)
                pk.merge_phase(got, tile, k)
                same("merge_phase", got, want,
                     f"{kind}, chunks of {rows} x 128, round {k}")
                k *= 2
            require(torch.equal(got, pk._sort_plain(x)),
                    f"tile sorts + merges != torch.sort: {kind}, {rows} rows")
            del x, got
        print(f"[check] sort_tiles == plain and merges == plain on {kinds} "
              f"in {shape[0] * g} chunks of {rows} x 128 (tile {tile}, "
              f"{rows * pk.LANES // tile} to a chunk)")
    torch.cuda.empty_cache()
    return errs


def phase_redesign_timings(codes: np.ndarray, gen, dev, card: str) -> None:
    """Phase 21: the presence-word kernel's two routes and their yardsticks,
    timed in one call (median of 5 CUDA-event timings after warm-up)."""
    tag = f"[{card}]"

    def t(fn, *args):
        return timeit(fn, *args, device=dev).seconds_per_call * 1e3

    tms = bloom_tms(codes, dev)
    p_log2, sub_log2, rows, cap = pk.plan(WIDE)
    p = 1 << p_log2
    tot = dict.fromkeys(("private", "direct", "A2"), 0.0)
    for i, tm in enumerate(tms):
        stream = torch.cat([b.reshape(-1) for b in hash_kmers_tm(
            tm, K, H, emit_buckets=WIDE)])[None]
        wins, _ = pk._partition(stream, WIDE, p_log2, sub_log2, rows, cap)
        flat = wins.reshape(p, -1)
        del wins, stream
        out = torch.zeros((p, 1 << (sub_log2 - 5)), dtype=torch.int32,
                          device=dev)
        for route in WORD_ROUTES:
            tot[route] += t(lambda x: words_by(route, x, None, sub_log2,
                                               out=out), flat)
        tot["A2"] += t(lambda x: histogram_rows(x, None, sub_log2), flat)
        if i == 0:
            # why the direct route is slow on these windows: (a) as they
            # are, (b) each row's entries shuffled (no two neighbours of a
            # warp stay neighbours; one row is still hot at a time), (c) the
            # rows interleaved in runs of 256 entries, as one row at 2**20
            # (neighbours kept, the blocks resident at one moment spread
            # over all 128 rows), (d) the same one row, not interleaved
            n = flat.shape[1]
            t_a = t(lambda x: words_by("direct", x, None, sub_log2, out=out),
                    flat)
            t_p = t(lambda x: words_by("private", x, None, sub_log2, out=out),
                    flat)
            shuf = flat[:, torch.randperm(n, device=dev, generator=gen)] \
                .contiguous()
            t_b = t(lambda x: words_by("direct", x, None, sub_log2, out=out),
                    shuf)
            del shuf
            valid = (flat >= 0) & (flat < (1 << sub_log2))
            full = torch.where(valid, flat + (torch.arange(
                p, device=dev, dtype=torch.int32) << sub_log2)[:, None], -1)
            del valid
            inter = full.view(p, n // 256, 256).transpose(0, 1).contiguous() \
                .view(1, -1)
            one = torch.zeros((1, 1 << (WIDE - 5)), dtype=torch.int32,
                              device=dev)
            t_c = t(lambda x: words_by("direct", x, None, WIDE, out=one),
                    inter)
            require(torch.equal(one.view(p, -1), words_by(
                "private", flat, None, sub_log2)),
                "the interleaved rows pack other words than the windows")
            t_d = t(lambda x: words_by("direct", x, None, WIDE, out=one),
                    full.view(1, -1))
            print(f"[time] direct atomics on batch 0's windows [{p}, {n}] at "
                  f"2**{sub_log2}: (a) as they are {t_a:.4f} ms, (b) each "
                  f"row shuffled {t_b:.4f} ms, (c) rows interleaved in runs "
                  f"of 256, one row at 2**{WIDE} {t_c:.4f} ms, (d) that one "
                  f"row not interleaved {t_d:.4f} ms; private words on (a) "
                  f"{t_p:.4f} ms, bound "
                  f"{bound_ms(4 * flat.numel() + 4 * out.numel()):.4f} ms "
                  f"{tag}")
            del full, inter, one
        del flat, out
        torch.cuda.empty_cache()
    print(f"[time] presence words of the 2**{WIDE} windows ({p} rows at "
          f"2**{sub_log2}) over {N_READS} reads: private words "
          f"{tot['private']:.4f} ms, direct atomics {tot['direct']:.4f} ms, "
          f"sub-histograms (A2) of the same windows {tot['A2']:.4f} ms {tag}")

    # C1 at 2**17 (4 tensors a batch) and the 2**30 plan's rows, both routes
    tot = {}
    for i, tm in enumerate(tms):
        bucks = hash_kmers_tm(tm, K, H, emit_buckets=17)
        words = torch.zeros((1, 1 << 12), dtype=torch.int32, device=dev)
        for route in WORD_ROUTES:
            tot[("C1 at 2**17", route)] = tot.get(("C1 at 2**17", route), 0) \
                + t(lambda bs: [words_by(route, b.reshape(1, -1), None, 17,
                                         out=words) for b in bs], bucks)
        del bucks
        stream = torch.cat([b.reshape(-1) for b in hash_kmers_tm(
            tm, K, H, emit_buckets=30)])[None]
        pl, sl, rw, cp = pk.plan(30)
        wins, _ = pk._partition(stream, 30, pl, sl, rw, cp)
        flat = wins.reshape(1 << pl, -1)
        del wins, stream
        out = torch.zeros((1 << pl, 1 << (sl - 5)), dtype=torch.int32,
                          device=dev)
        for route in WORD_ROUTES:
            key = (f"C2 at 2**30 ({1 << pl} rows at 2**{sl})", route)
            tot[key] = tot.get(key, 0) + t(
                lambda x: words_by(route, x, None, sl, out=out), flat)
        del flat, out
        stream = torch.cat([b.reshape(-1) for b in hash_kmers_tm(
            tm, K, H, emit_buckets=WIDE)])[None]
        one = torch.zeros((1, 1 << (WIDE - 5)), dtype=torch.int32, device=dev)
        for route in WORD_ROUTES:
            key = (f"C1 at full width 2**{WIDE} (yardstick)", route)
            tot[key] = tot.get(key, 0) + t(
                lambda x: words_by(route, x, None, WIDE, out=one), stream)
        del stream, one
        torch.cuda.empty_cache()
    for (name, route), v in tot.items():
        print(f"[time] {name} over {N_READS} reads, {route} route: "
              f"{v:.4f} ms {tag}")


    # the rule's constant: how many entries per word a row needs before
    # private words pay. Random buckets into fresh words (zeroed inside the
    # timing, on both routes), so every update sets a bit and every private
    # word is merged: the worst case for the private route.
    for wl, rows in ((17, 8192), (13, 128), (17, 1), (20, 1)):
        nwords = 1 << (wl - 5)
        cells = []
        for per_word in (1, 2, 4, 8, 16, 64):
            n = per_word * nwords
            if rows * n > 1 << 28:
                continue
            idx = torch.randint(0, 1 << wl, (rows, n), device=dev,
                                generator=gen, dtype=torch.int32)
            out = torch.zeros((rows, nwords), dtype=torch.int32, device=dev)

            def fresh(x, route):
                out.zero_()
                words_by(route, x, None, wl, out=out)

            cells.append(f"{per_word}: "
                         + " / ".join(f"{t(lambda x: fresh(x, r), idx):.4f}"
                                      for r in WORD_ROUTES))
            del idx, out
        print(f"[time] fresh sparse words, [{rows}, n] at 2**{wl}, entries "
              f"per word: private / direct ms: {'; '.join(cells)} {tag}")


# ----------------------------------- the row histogram (A2) by route ----

HIST_ROUTES = ("private", "direct")
#: (width_log2, rows) of the entries-per-counter sweep: the 2**14 path's one
#: launch a batch and one row, the 2**20 plan's sub-histograms, both ends.
HIST_SWEEP = ((10, 4), (12, 4), (13, 512), (14, 4), (14, 1), (15, 1))


def hist_by(route, idx, weight, wl, gate=None, out=None):
    """The histogram kernel over idx [R, N] with its route forced."""
    return hist_kernel._launch(idx, weight, wl, gate, out, route=route)


def sub_histogram_rows(idx: torch.Tensor, wl: int) -> tuple[torch.Tensor, int]:
    """The partitioned path's sub-histogram input for buckets idx [R, N] at
    2**wl: its windows as [R * P, n] rows, and their width's log2."""
    p_log2, sub_log2, rows, cap = pk.plan(wl)
    wins, _ = pk._partition(idx, wl, p_log2, sub_log2, rows, cap)
    return wins.reshape(idx.shape[0] << p_log2, -1), sub_log2


def phase_hist_route_checks(codes: np.ndarray, gen, dev) -> float:
    """Phase 22: private counters, direct atomics (each forced) and the
    plain version against each other, exactly, at widths 2**10..2**15:
    full-range weights per row, shared and absent; gate 0 and 1 into an
    ``out`` that accumulates; odd N, so rows start off a 16-byte boundary,
    and a view whose first row does; indices -1..-3 and past the width.
    Then the partitioned path's own sub-histogram shapes: batch 0's windows
    at 2**20 and at 2**30. Returns the largest difference (0 when equal)."""
    err = 0.0

    def same(got, want, what):
        # the difference only where they differ: at 2**30 the rows are
        # 16 GiB, and widening them would not fit the card
        nonlocal err
        torch.cuda.synchronize()
        eq = torch.equal(got, want)
        err = max(err, 0.0 if eq else max_abs_err(got, want))
        require(eq, f"histogram != plain: {what}")

    def full_range(shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, device=dev,
                             generator=gen, dtype=torch.int64).to(torch.int32)

    for wl in range(10, hist_kernel.PRIVATE_COUNTS_MAX_WIDTH_LOG2 + 1):
        width = 1 << wl
        for rows, n in ((3, 1_000_003), (5, 4099)):
            idx = torch.randint(-3, width + 3, (rows, n), device=dev,
                                generator=gen, dtype=torch.int32)
            w = full_range((rows, n))
            base = full_range((rows, width))
            for weight, label in ((w, "per row"), (w[1], "shared"),
                                  (None, "none")):
                what = f"2**{wl}, [{rows}, {n}], weights {label}"
                for g in (0, 1):
                    gate = torch.full((1,), g, dtype=torch.int32, device=dev)
                    want = histogram_rows_plain(idx, weight, wl, gate=gate,
                                                out=base.clone())
                    for route in HIST_ROUTES:
                        same(hist_by(route, idx, weight, wl, gate,
                                     base.clone()), want,
                             f"{route} route, {what}, gate {g}, out")
                # a view whose first row starts 4 bytes past a boundary
                flat = idx.reshape(-1)[1:1 + rows * (n - 1)].view(rows, n - 1)
                sub_w = None if weight is None else \
                    weight[..., 1:].contiguous()
                want = histogram_rows_plain(flat, sub_w, wl)
                for route in HIST_ROUTES:
                    same(hist_by(route, flat, sub_w, wl), want,
                         f"{route} route, {what}, unaligned view")
            del idx, w, base
    print("[check] histogram: private counters == direct atomics == plain at "
          "2**10..2**15, [3, 1000003] and [5, 4099], full-range int32 "
          "weights per row / shared / none, gate 0/1 into an accumulating "
          "out, an unaligned view, indices -3..-1 and past the width")
    for wl in (WIDE, 30):
        flat, sub_log2 = sub_histogram_rows(
            path_buckets(codes[:BATCH], wl, dev)[0], wl)
        grid = hist_kernel.private_counts_grid(*flat.shape, sub_log2)
        want = histogram_rows_plain(flat, None, sub_log2)
        same(histogram_rows(flat, None, sub_log2), want,
             f"the rule's route {grid}, batch 0's windows at 2**{wl}")
        routes = [r for r in HIST_ROUTES if r == "direct"
                  or sub_log2 <= hist_kernel.PRIVATE_COUNTS_MAX_WIDTH_LOG2]
        for route in routes:
            same(hist_by(route, flat, None, sub_log2), want,
                 f"{route} route, batch 0's windows at 2**{wl}")
        print(f"[check] histogram on batch 0's sub-histograms at 2**{wl} "
              f"({flat.shape[0]} rows x {flat.shape[1]} at 2**{sub_log2}): "
              f"the rule's route (grid {grid}) and {routes} forced == plain")
        del flat, want
        torch.cuda.empty_cache()
    for rows, n, wl in ((H, 31_195_136, WLOG), (1, 31_195_136, WLOG),
                        (512, 368_640, 13), (H, 31_195_136, WIDE),
                        (32768, 8192, 17), (3, 300_001, 15), (4, 4095, 10)):
        print(f"[route] histogram idx [{rows}, {n}] at 2**{wl}: (blocks per "
              f"row, threads) = {hist_kernel.private_counts_grid(rows, n, wl)}"
              " ((0, 0): direct atomics)")
    return err


def phase_hist_route_timings(codes: np.ndarray, gen, dev, card: str) -> None:
    """Phase 23: the histogram's routes timed in one call, in turns:
    two skewed streams at 2**20 on batch 0's buckets (direct atomics, the
    path's route, beside the partitioned histogram); and fresh counters at
    1 to 64 entries per counter a block, private against direct (what the
    rule's constant rests on)."""
    tag = f"[{card}]"
    bucks = path_buckets(codes[:BATCH], WIDE, dev)[0]
    n = bucks.shape[1]
    value = 12345
    for label, idx in (("(a) every entry one value",
                        torch.full_like(bucks, value)),
                       ("(b) one eighth of the entries one value",
                        bucks.clone().index_fill_(
                            1, torch.arange(0, n, 8, device=dev), value))):
        direct = histogram_rows(idx, None, WIDE)
        require(torch.equal(direct, pk.partitioned_histogram_rows(idx, WIDE))
                and torch.equal(direct, histogram_rows_plain(idx, None, WIDE)),
                f"skewed stream {label}: direct != partitioned != plain")
        del direct
        got = in_turns({
            "direct": lambda x: histogram_rows(x, None, WIDE),
            "partitioned": lambda x: pk.partitioned_histogram_rows(x, WIDE)},
            idx)
        print(f"[time] skewed stream at 2**{WIDE}, batch 0's [{H}, {n}] "
              f"buckets, {label}: direct histogram {got['direct'] * 1e3:.4f} "
              f"ms, partitioned_histogram_rows {got['partitioned'] * 1e3:.4f} "
              f"ms, in turns (results equal, and equal to plain) {tag}")
        del idx
        torch.cuda.empty_cache()
    del bucks
    torch.cuda.empty_cache()

    # the rule's constant: entries per counter that a block must cover
    # before private counters pay. Each row gets as many blocks as the rule
    # gives a full-size row, each block `per` entries per counter; random
    # buckets into fresh counters (zeroed inside the timing, on both
    # routes), so every block merges nearly every counter.
    for wl, rows in HIST_SWEEP:
        width = 1 << wl
        threads = 1024 if wl >= 14 else 512
        blocks = -(-hist_kernel.PRIVATE_TARGET_THREADS // (threads * rows))
        cells = []
        for per in (1, 2, 4, 8, 16, 64):
            m = per * width * blocks
            if rows * m > 1 << 28:
                continue
            idx = torch.randint(0, width, (rows, m), device=dev,
                                generator=gen, dtype=torch.int32)
            out = torch.zeros((rows, width), dtype=torch.int32, device=dev)
            require(hist_kernel._counts_route(rows, m, wl, False, "private")
                    == ("private", blocks, threads), "the sweep's grid")

            def fresh(x, route):
                out.zero_()
                hist_by(route, x, None, wl, out=out)

            got = in_turns({r: (lambda x, r=r: fresh(x, r))
                            for r in HIST_ROUTES}, idx)
            cells.append(f"{per}: {got['private'] * 1e3:.4f} / "
                         f"{got['direct'] * 1e3:.4f}")
            del idx, out
        print(f"[time] fresh counters, [{rows}, n] at 2**{wl}, {blocks} "
              f"blocks of {threads} a row, entries per counter a block: "
              f"private / direct ms: {'; '.join(cells)} {tag}")


# ----------------------- the packed wire format and the parse routes ----

UNPACK_LENGTHS = (1, 3, 4, 7, 8, 31, 150, 10_000)
UNPACK_READS = (1, 33, 4096, 1 << 18)
THREADS = (1, 2, 4, 8)
SMALL_BATCH = 1 << 14       # 62 batches over the 1M reads
COPY_KINDS = ("codes", "packed")


def packed_input(rng, gen, length: int, reads: int, dev):
    """(packed, nmask) on the card for ``reads`` reads of ``length`` bases
    holding all five codes, the last eighth (at least one row when there
    are more than one) padding rows as the stream pads them. Host
    ``pack_codes`` up to 2**28 codes; above, random plane bytes on the card
    (any bytes are valid input: bits past ``length`` are never read)."""
    pad = reads - max(1, reads - reads // 8) if reads > 1 else 0
    if reads * length <= 1 << 28:
        codes = rng.integers(0, 5, size=(reads, length), dtype=np.uint8)
        codes[reads - pad:] = 4
        packed, nmask = pack_codes(codes)
        return (torch.from_numpy(packed).to(dev),
                torch.from_numpy(nmask).to(dev))
    packed, nmask = (torch.randint(0, 256, shape, generator=gen, device=dev,
                                   dtype=torch.uint8)
                     for shape in packed_shapes((reads, length)))
    row_p, row_m = pack_codes(np.full((1, length), 4, np.uint8))
    packed[reads - pad:] = torch.from_numpy(row_p).to(dev)
    nmask[reads - pad:] = torch.from_numpy(row_m).to(dev)
    return packed, nmask


def unpack_bytes(length: int, reads: int) -> int:
    """Bytes the unpack must move: its planes read, its int32 codes written."""
    planes = packed_shapes((reads, length))
    return reads * (planes[0][1] + planes[1][1]) + 4 * length * reads


def phase_unpack(rng, gen, codes: np.ndarray, dev, card: str) -> dict:
    """Phase 24: the unpack kernel against its plain version, exactly, at
    every (L, B) of the grid; on each packed batch of the 1M reads against
    ``prepare_codes`` of the same batch unpacked; timings."""
    tag = f"[{card}]"
    err = 0.0
    chunk = 1 << 14      # the plain version, reads at a time, at 2**18 x 10,000
    for length in UNPACK_LENGTHS:
        for reads in UNPACK_READS:
            packed, nmask = packed_input(rng, gen, length, reads, dev)
            got = unpack_kernel.unpack_codes_tm(packed, nmask, length)
            for s in range(0, reads, chunk):
                want = unpack_kernel.unpack_codes_tm_plain(
                    packed[s:s + chunk], nmask[s:s + chunk], length)
                part = got[:, s:s + chunk]
                eq = torch.equal(part, want)
                err = max(err, 0.0 if eq else max_abs_err(part, want))
                require(eq, f"unpack != plain at L={length} B={reads}")
            require(got.shape == (length, reads) and got.is_contiguous()
                    and int(got.max()) <= 4 and int(got.min()) >= 0,
                    f"unpack output at L={length} B={reads}")
            del packed, nmask, got, want, part
        torch.cuda.empty_cache()
    print(f"[check] unpack == plain, exact, at L in {UNPACK_LENGTHS} x B in "
          f"{UNPACK_READS}, all five codes and padding rows")
    tot = dict.fromkeys(("kernel", "plain", "prepare"), 0.0)
    nbytes = 0
    for s in range(0, codes.shape[0], BATCH):
        batch = codes[s:s + BATCH]
        packed, nmask = (torch.from_numpy(a).to(dev) for a in pack_codes(batch))
        raw = torch.from_numpy(batch).to(dev)
        got = unpack_kernel.unpack_codes_tm(packed, nmask, L)
        want = prepare_codes(raw)
        eq = torch.equal(got, want)
        err = max(err, 0.0 if eq else max_abs_err(got, want))
        require(eq, f"unpack of batch {s // BATCH} != prepare_codes")
        del got, want
        tot["kernel"] += timeit(lambda a, b: unpack_kernel.unpack_codes_tm(
            a, b, L), packed, nmask).seconds_per_call
        tot["plain"] += timeit(lambda a, b: unpack_kernel.unpack_codes_tm_plain(
            a, b, L), packed, nmask).seconds_per_call
        tot["prepare"] += timeit(prepare_codes, raw).seconds_per_call
        nbytes += unpack_bytes(L, batch.shape[0])
        del packed, nmask, raw
        torch.cuda.empty_cache()
    print(f"[check] unpack == prepare_codes on each of the "
          f"{-(-N_READS // BATCH)} packed batches of the {N_READS} reads")
    print(f"[time] unpack_codes over {N_READS} reads x {L} bp in batches of "
          f"{BATCH}: kernel {tot['kernel'] * 1e3:.4f} ms, plain "
          f"{tot['plain'] * 1e3:.4f} ms, bound {bound_ms(nbytes):.4f} ms "
          f"({nbytes / 1e9:.4f} GB); prepare_codes on the unpacked batches "
          f"(the yardstick) {tot['prepare'] * 1e3:.4f} ms {tag}")
    return {"err": err, "ms": tot["kernel"] * 1e3,
            "plain_ms": tot["plain"] * 1e3, "bound_ms": bound_ms(nbytes)}


class CopyIntoPinned(ReadHashingPipeline):
    """The other place for the host copy: the parser writes into pageable
    arrays and the producer (the Prefetcher thread, or each shard's worker)
    copies every batch into a pinned buffer."""

    @staticmethod
    def _host_batches(path, batch_size, read_length, threads, pool, pack,
                      start_offset=0, with_offsets=False):
        require(pool is not None and not pack, "CopyIntoPinned: codes only")

        def pin(item):
            (dst,) = pool.arrays(item[0].shape)
            np.copyto(dst, item[0])
            return (dst,) + tuple(item[1:])

        if threads > 1:
            return stream_code_batches_parallel(
                path, batch_size, read_length, threads=threads, stage=pin)
        return (pin(item) for item in stream_code_batches(
            path, batch_size, read_length))


class PackInPrefetcher(ReadHashingPipeline):
    """Packing in the one Prefetcher thread after the parallel parse (the
    JAX package's place for it) in place of inside each shard's worker."""

    @staticmethod
    def _host_batches(path, batch_size, read_length, threads, pool, pack,
                      start_offset=0, with_offsets=False):
        require(pool is not None and pack and threads > 1,
                "PackInPrefetcher: packed, threads > 1")
        return packed_batches(stream_code_batches_parallel(
            path, batch_size, read_length, threads=threads), pool.arrays)


def host_median(fn, runs: int = 3) -> float:
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def reset_route_launches() -> None:
    kmer_kernel.LAUNCHES = kmer_kernel.LONG_LAUNCHES = 0
    unpack_kernel.LAUNCHES = 0
    reset_hist_launches()
    reset_part_launches()


def route_count(cls, path, wl, threads, pack, want, dev, batch=None):
    """One checked count_file by a route: its sketch against ``want``, its
    launches (no plain version on the card: every batch through the hash
    and histogram kernels, and the unpack kernel exactly when packed)."""
    pipe = cls(PipelineConfig(k=K, num_hashes=H, sketch_width_log2=wl,
                              pack_h2d=pack), device=dev)
    reset_route_launches()
    got = pipe.count_file(path, batch_size=batch or BATCH, threads=threads)
    hashed = kmer_kernel.LAUNCHES + kmer_kernel.LONG_LAUNCHES
    launches = {"hash": hashed, "histogram": hist_kernel.LAUNCHES,
                "unpack": unpack_kernel.LAUNCHES}
    what = f"{cls.__name__} threads={threads} pack_h2d={pack} 2**{wl}"
    require(got == N_READS, f"{what}: {got} reads")
    require(torch.equal(pipe.sketch.rows, want), f"{what}: sketch != plain")
    require(hashed > 0 and launches["histogram"] == hashed
            and launches["unpack"] == (hashed if pack else 0)
            and not any(pk.LAUNCHES.values()),
            f"{what}: launches {launches}, partition {dict(pk.LAUNCHES)}")
    return pipe, launches


def host_side_only(path, threads: int, pack: bool):
    """The host side of a route alone, as count_file drives it on the CPU:
    the parse into new arrays and, with ``pack``, pack_codes where the route
    runs it (the parse thread; each shard's worker for threads > 1), with
    no pinned buffer and no copy."""
    src = ReadHashingPipeline._host_batches(path, BATCH, None, threads, None,
                                            pack)
    with Prefetcher(src) as pf:
        for _ in pf:
            pass


def copy_rates(codes: np.ndarray, dev, card: str) -> None:
    """Host->device copy of one main-path batch, codes and packed, from
    pageable against pinned memory: host clock around the copy and a sync,
    median of 5 after one warm-up; ms per 1M reads and GB/s."""
    batch = codes[:BATCH]
    arrays = {"codes": (batch,), "packed": pack_codes(batch)}
    for kind in COPY_KINDS:
        host = arrays[kind]
        nbytes = sum(a.nbytes for a in host)
        pinned = [torch.from_numpy(a).pin_memory() for a in host]
        got = {}
        for label, srcs, nb in (
                ("pageable", [torch.from_numpy(a) for a in host], False),
                ("pinned", pinned, True)):
            def copy():
                out = [t.to(dev, non_blocking=nb) for t in srcs]
                torch.cuda.synchronize()
                return out
            copy()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                copy()
                times.append(time.perf_counter() - t0)
            got[label] = statistics.median(times)
        scale = N_READS / BATCH
        print(f"[copy] {kind} ({nbytes / BATCH:.0f} bytes a read, one batch "
              f"of {BATCH}): pageable {got['pageable'] * scale * 1e3:.4f} ms "
              f"per {N_READS} reads ({nbytes / got['pageable'] / 1e9:.4f} "
              f"GB/s), pinned {got['pinned'] * scale * 1e3:.4f} ms "
              f"({nbytes / got['pinned'] / 1e9:.4f} GB/s) [{card}]")
        del pinned


def traced(pipe, path, threads, label, card):
    """One warm count_file under torch.profiler: its idle share and its
    host->device copy time."""
    def count():
        pipe.sketch.rows.zero_()
        pipe.count_file(path, batch_size=BATCH, threads=threads)

    tr = trace_device(count, device=pipe.device)
    require(tr.busy_seconds > 0, "the trace recorded no device activity")
    h2d = sum(t for name, (t, _) in tr.by_name.items() if "HtoD" in name)
    print(f"[trace] {label}: wall {tr.wall_seconds * 1e3:.3f} ms, device "
          f"busy {tr.busy_seconds * 1e3:.3f} ms, idle share "
          f"{tr.idle_share:.4f}, host->device copies {h2d * 1e3:.3f} ms "
          f"[{card}]")
    return tr


def phase_routes(codes: np.ndarray, path: Path, long_path: Path, refs: dict,
                 dev, card: str) -> int:
    """Phase 25: count_file by route (threads x pack_h2d) at 2**14 and
    2**20, each sketch against the plain count; reads/s, parse-only rates,
    the two alternatives for where the host copy and the packing run, one
    traced run of the fastest route beside the serial one, copy rates, the
    long reads, and 62 small packed batches. Returns the unpack kernel's
    launches on the packed count_file at 2**20 (one thread)."""
    tag = f"[{card}]"
    cores = len(os.sched_getaffinity(0))
    print(f"[routes] os.cpu_count() {os.cpu_count()}, "
          f"len(os.sched_getaffinity(0)) {cores}")
    threads = [t for t in THREADS if t <= cores]
    rates, traces = {}, {}
    unpack_launches = 0
    for wl in (WLOG, WIDE):
        for t in threads:
            for pack in (False, True):
                pipe, launches = route_count(ReadHashingPipeline, path, wl, t,
                                             pack, refs[wl], dev)
                if wl == WIDE and t == 1 and pack:
                    unpack_launches = launches["unpack"]

                def count(pipe=pipe, t=t):
                    pipe.sketch.rows.zero_()
                    pipe.count_file(path, batch_size=BATCH, threads=t)

                rates[wl, t, pack] = N_READS / host_median(count)
                print(f"[routes] count_file 2**{wl} threads={t} pack_h2d="
                      f"{pack}: sketch == plain, launches {launches}; "
                      f"median of 3 {rates[wl, t, pack]:.6g} reads/s {tag}")
                if wl == WIDE:
                    traces[t, pack] = traced(
                        pipe, path, t, f"count_file 2**{wl} threads={t} "
                        f"pack_h2d={pack}", card)
                del pipe
                torch.cuda.empty_cache()
    for t in threads:
        for pack in (False, True):
            r = N_READS / host_median(lambda: host_side_only(path, t, pack))
            print(f"[routes] parse only threads={t}"
                  f"{' + pack_codes' if pack else ''}: median of 3 "
                  f"{r:.6g} reads/s {tag}")
    half = max(2, threads[-1] // 2)
    for cls, t, pack in ((CopyIntoPinned, 1, False),
                         (CopyIntoPinned, half, False),
                         (PackInPrefetcher, half, True)):
        pipe, _ = route_count(cls, path, WIDE, t, pack, refs[WIDE], dev)

        def count(pipe=pipe, t=t):
            pipe.sketch.rows.zero_()
            pipe.count_file(path, batch_size=BATCH, threads=t)

        r = N_READS / host_median(count)
        shipped = rates.get((WIDE, t, pack))
        print(f"[routes] {cls.__name__} 2**{WIDE} threads={t} pack_h2d="
              f"{pack}: sketch == plain; median of 3 {r:.6g} reads/s (the "
              f"route as shipped: {shipped and f'{shipped:.6g}'}) {tag}")
        del pipe
    best = max((key for key in rates if key[0] == WIDE), key=rates.get)
    _, bt, bp = best
    print(f"[routes] fastest at 2**{WIDE}: threads={bt} pack_h2d={bp} "
          f"{rates[best]:.6g} reads/s, serial {rates[WIDE, 1, False]:.6g}")
    pair = list(dict.fromkeys(((1, False), (bt, bp))))  # serial, fastest
    for t, pack in pair:
        print(f"[trace] by row, count_file 2**{WIDE} threads={t} "
              f"pack_h2d={pack}:")
        for name, (sec, n) in sorted(traces[t, pack].by_name.items(),
                                     key=lambda kv: -kv[1][0])[:8]:
            print(f"[trace]   {sec * 1e3:9.3f} ms  x{n:<4d} {name[:90]}")
    copy_rates(codes, dev, card)

    # the long reads: the fastest route against the serial one
    sketches = []
    for t, pack in pair:
        pipe = ReadHashingPipeline(PipelineConfig(pack_h2d=pack), device=dev)
        reset_route_launches()
        got = pipe.count_file(long_path, batch_size=LONG_BATCH,
                              read_length=LONG_L, threads=t)
        require(got == LONG_READS and kmer_kernel.LONG_LAUNCHES > 0
                and unpack_kernel.LAUNCHES == (kmer_kernel.LONG_LAUNCHES
                                               if pack else 0),
                f"long reads threads={t} pack_h2d={pack}: {got} reads")
        sketches.append(pipe.sketch.rows.clone())

        def count(pipe=pipe, t=t):
            pipe.sketch.rows.zero_()
            pipe.count_file(long_path, batch_size=LONG_BATCH,
                            read_length=LONG_L, threads=t)

        r = LONG_READS / host_median(count)
        print(f"[routes] long reads {LONG_READS} x {LONG_L} bp threads={t} "
              f"pack_h2d={pack}: median of 3 {r:.6g} reads/s, "
              f"{r * LONG_L:.6g} bases/s {tag}")
        del pipe
    require(torch.equal(sketches[0], sketches[-1]),
            "long-read sketch of the fastest route != the serial one")

    # many small batches: a pinned buffer reused before its copy completed
    # would show here
    for cls, t, pack in ((ReadHashingPipeline, 1, True),
                         (ReadHashingPipeline, threads[-1], True),
                         (ReadHashingPipeline, threads[-1], False)):
        route_count(cls, path, WLOG, t, pack, refs[WLOG], dev,
                    batch=SMALL_BATCH)
        print(f"[routes] count_file in batches of {SMALL_BATCH} "
              f"({-(-N_READS // SMALL_BATCH)} batches, threads={t}, pack_h2d="
              f"{pack}) == plain count")
    torch.cuda.empty_cache()
    return unpack_launches


# ------------------------- the facade, the blind scans (phases 26 to 29) ----

FACADE_LEN = 1 << 25         # a chromosome-scale sequence, ~33.5 Mbp
FACADE_H = 4
FACADE_SEED_LEN = 1 << 23
FACADE_SAMPLES = 10_000
FACADE_ROLLS = (1 << 21) + 1000   # roll() calls across a tile boundary
BLIND_FED = 200_000          # caller-fed bases through the Blind classes
BLIND_WALKS, BLIND_STEPS = 1 << 20, 64
BLIND_SEED_WALKS = 1 << 18
DBG_GENOME, DBG_WIDTH, DBG_H = 1 << 25, 30, 4
SEQ_FR_KERNELS = ("kmer_sequence_fwd_rev", "seed_sequence_fwd_rev")
BLIND_KERNELS = ("blind_roll_many", "blind_seed_roll_many")


def genome_with_n_runs(rng, n: int) -> np.ndarray:
    """n random bases with ~1% N, in runs of 1 to 20."""
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    starts = rng.integers(0, n, size=n // 1000)
    lengths = rng.integers(1, 21, size=starts.size)
    first = np.repeat(np.cumsum(lengths) - lengths, lengths)
    at = np.repeat(starts, lengths) + np.arange(lengths.sum()) - first
    codes[np.minimum(at, n - 1)] = 4
    return codes


def reset_fwd_rev_launches() -> None:
    reset_sequence_launches()
    kmer_kernel.FWD_REV_LAUNCHES = sk.FWD_REV_LAUNCHES = 0


def phase_fwd_rev(rng, dev, card: str) -> tuple[dict, dict]:
    """The one-sequence entries with ``emit_fwd_rev=True`` against their
    plain versions, every entry (invalid windows included), at C in {1, k,
    span - 1, span + 1, 2**22 + 17}, k in {1, 5, 32, 97}, h in {1, 4}, and
    for the BASELINE seeds and SEEDS18 (the seed route also through B1 over
    pseudo-reads); the hashes and validity equal the route without the flag.
    Then both instances timed in turns at 2**27 (k=32, h=1) and, for seeds,
    2**25 (BASELINE, h=1)."""
    errs = dict.fromkeys(SEQ_FR_KERNELS, 0.0)
    cases = 0
    for seeds in (None, SEEDS, SEEDS18):
        for k in ((1, 5, 32, 97) if seeds is None else (len(seeds[0]),)):
            span = kmer_kernel.sequence_span(k)
            for c in sorted({1, k, span - 1, span + 1, (1 << 22) + 17}):
                seq = torch.from_numpy(
                    rng.integers(0, 6, size=c, dtype=np.uint8)).to(dev)
                for h in (1, 4):
                    if seeds is None:
                        got, valid = kmer_kernel.hash_sequence(
                            seq, k, h, emit_fwd_rev=True)
                        want, wvalid = kmer_kernel.hash_sequence_plain(
                            seq, k, h, emit_fwd_rev=True)
                        base, bvalid = kmer_kernel.hash_sequence(seq, k, h)
                        name, groups = SEQ_FR_KERNELS[0], [got[:h]]
                    else:
                        got, valid = sk.hash_seeds_sequence(
                            seq, seeds, h, emit_fwd_rev=True)
                        want, wvalid = sk.hash_seeds_sequence_plain(
                            seq, seeds, h, emit_fwd_rev=True)
                        rows, rvalid = sk.hash_seeds_sequence_rows(
                            seq, seeds, h, emit_fwd_rev=True)
                        same_outputs(errs, SEQ_FR_KERNELS[1], rows + [rvalid],
                                     want + [wvalid],
                                     f"B1 over pseudo-reads, fwd/rev, C={c}")
                        base, bvalid = sk.hash_seeds_sequence(seq, seeds, h)
                        name = SEQ_FR_KERNELS[1]
                        groups = [got[s * (h + 2):s * (h + 2) + h]
                                  for s in range(len(seeds))]
                    same_outputs(errs, name, got + [valid], want + [wvalid],
                                 f"{name} C={c} k={k} h={h}")
                    flat = [g for group in groups for g in group]
                    require(all(torch.equal(a, b) for a, b in zip(flat, base))
                            and torch.equal(valid, bvalid),
                            f"{name} C={c} k={k} h={h}: the hashes differ from "
                            "the route without fwd/rev")
                    cases += 1
                del seq
    torch.cuda.empty_cache()
    print(f"[fwd/rev] {cases} cases of the one-sequence entries with fwd/rev "
          "== plain at every entry (invalid windows included), == the route "
          "without the flag, the seed route also through B1 over pseudo-reads")
    times = {}
    for name, n, seeds in ((SEQ_FR_KERNELS[0], SP_LEN, None),
                           (SEQ_FR_KERNELS[1], SP_SEED_LEN, SEEDS)):
        seq = torch.from_numpy(rng.integers(0, 4, size=n, dtype=np.uint8)).to(dev)
        if seeds is None:
            def run(x, fr):
                return kmer_kernel.hash_sequence(x, K, 1, emit_fwd_rev=fr)

            def plain(x):
                return kmer_kernel.hash_sequence_plain(x, K, 1,
                                                       emit_fwd_rev=True)
        else:
            def run(x, fr):
                return sk.hash_seeds_sequence(x, seeds, 1, emit_fwd_rev=fr)

            def plain(x):
                return sk.hash_seeds_sequence_plain(x, seeds, 1,
                                                    emit_fwd_rev=True)
        k = K if seeds is None else len(seeds[0])
        t = in_turns({"off": lambda x: run(x, False),
                      "on": lambda x: run(x, True),
                      "old": lambda x: old_sequence_route(
                          x, k, 1, seeds, emit_fwd_rev=True)},
                     seq, rounds=2)
        t_p = timeit(plain, seq, calls=3).seconds_per_call
        s = 1 if seeds is None else len(seeds)
        b_off, b_on = n + 8 * n * s + n, n + 24 * n * s + n
        times[name] = (t["on"], t_p, b_on)
        print(f"[time] {name} {n} bases, h=1: fwd/rev {t['on'] * 1e3:.4f} ms "
              f"(bound {bound_ms(b_on):.4f}), without it "
              f"{t['off'] * 1e3:.4f} ms (bound {bound_ms(b_off):.4f}), the "
              f"old pseudo-read route with fwd/rev {t['old'] * 1e3:.4f} ms, "
              f"in turns; plain with fwd/rev {t_p * 1e3:.4f} ms [{card}]")
        del seq
        torch.cuda.empty_cache()
    return errs, times


def phase_facade(rng, dev, card: str) -> dict:
    """The facade over a chromosome-scale sequence: 2**25 bases with ~1% N
    in runs (N cleared around the fourth tile boundary, so roll_back can
    cross it: it cannot cross an N island), k=32, h=4, tiles of 2**22
    windows (seven boundaries), engine "auto" on the card. NtHash.__iter__
    over every window (count == oracle.nthash_positions; hashes == the
    oracle at 10,000 seeded positions and at +-32 around every boundary);
    roll() over 2**21 + 1,000 windows across a boundary, then roll_back()
    across one and peek/peek_back, in lockstep with the oracle engine;
    SeedNtHash (BASELINE seeds, h=3) over 2**23 bases, its positions ==
    oracle.seed_nthash_positions and its hashes == the oracle at 10,000
    positions and at windows holding an N (the quirk); BlindNtHash and
    BlindSeedNtHash over 200,000 caller-fed bases against the oracle and
    the one-sequence entries. Rates (medians of 3), each tile's kernel and
    device->host copy ms, and the launches of the path."""
    k, h = K, FACADE_H
    tile = api.FACADE_TILE_WINDOWS
    codes = genome_with_n_runs(rng, FACADE_LEN)
    n_win = FACADE_LEN - k + 1
    bounds = list(range(tile, n_win, tile))
    require(len(bounds) == 7, f"{len(bounds)} tile boundaries, not 7")
    clear = bounds[3]
    codes[clear - 3000:clear + 3000] = rng.integers(0, 4, size=6000,
                                                    dtype=np.uint8)
    valid = oracle.window_valid(codes, k)
    want_count = len(oracle.nthash_positions(codes, k))
    samples = set(rng.integers(0, n_win, size=FACADE_SAMPLES).tolist())
    samples |= {b + d for b in bounds for d in range(-32, 33)}
    checked = sorted(p for p in samples if valid[p])

    reset_fwd_rev_launches()
    nth = NtHash(codes, h, k, device=dev)
    got, count, ti, nxt = {}, 0, 0, checked[0]
    t0 = time.perf_counter()
    for row in nth:
        count += 1
        if nth.get_pos() == nxt:
            got[nxt] = row.copy()
            ti += 1
            nxt = checked[ti] if ti < len(checked) else -1
    t_full = time.perf_counter() - t0
    launches = {"kmer": kmer_kernel.FWD_REV_LAUNCHES,
                "kmer_all": kmer_kernel.SEQUENCE_LAUNCHES}
    require(count == want_count,
            f"NtHash.__iter__ visited {count} windows, the oracle {want_count}")
    require(len(got) == len(checked), "a sampled window was not visited")
    for p in checked:
        _, _, want, _ = oracle.hash_all_windows(codes[p:p + k], k, h)
        require(np.array_equal(got[p], want[0]), f"NtHash window {p}")
    require(launches["kmer"] == len(bounds) + 1,
            f"{launches['kmer']} fwd/rev launches for {len(bounds) + 1} tiles")
    print(f"[facade] NtHash.__iter__ over {FACADE_LEN} bases (k={k}, h={h}, "
          f"{len(bounds) + 1} tiles of {tile} windows): {count} windows == "
          f"oracle.nthash_positions; {len(checked)} sampled windows (+-32 "
          f"around every boundary) == the oracle; {t_full:.3f} s "
          f"({count / t_full:.6g} k-mers/s); launches {launches}")

    # roll() across a boundary, roll_back() across another, peeks, in
    # lockstep with the oracle engine (its tiles small, so it stays cheap)
    start = bounds[0] - FACADE_ROLLS // 2
    r = NtHash(codes, h, k, pos=start, device=dev)
    expect = np.nonzero(valid[start:])[0][:FACADE_ROLLS] + start
    t0 = time.perf_counter()
    pos = []
    for _ in range(len(expect)):
        require(r.roll(), "roll() stopped early")
        pos.append(r.get_pos())
        if pos[-1] in got:
            require(np.array_equal(r.hashes(), got[pos[-1]]),
                    f"roll() at {pos[-1]}")
    t_roll = time.perf_counter() - t0
    require(pos == expect.tolist() and pos[-1] > bounds[0],
            "roll() positions != the valid windows")
    a = NtHash(codes, h, k, pos=clear + 400, device=dev)
    o = NtHash(codes, h, k, pos=clear + 400, engine="oracle",
               tile_windows=4096)
    steps = ["roll"] + ["roll_back"] * 900 + ["peek", "peek_back"] + \
        ["roll"] * 50 + ["peek_back", "roll_back", "peek"]
    crossed = False
    for op in steps:
        ra, ro = getattr(a, op)(), getattr(o, op)()
        require(ra == ro and a.get_pos() == o.get_pos()
                and np.array_equal(a.hashes(), o.hashes())
                and a.get_forward_hash() == o.get_forward_hash()
                and a.get_reverse_hash() == o.get_reverse_hash(),
                f"{op} at {a.get_pos()}: kernel engine != oracle engine")
        crossed |= a.get_pos() < clear
    require(crossed, "roll_back did not cross the tile boundary")
    print(f"[facade] roll() over {len(expect)} windows across the boundary "
          f"at {bounds[0]}: positions == the valid windows, hashes == the "
          f"oracle at the sampled ones; roll_back() across the boundary at "
          f"{clear}, peek/peek_back: == the oracle engine in lockstep")

    def iter_rate():
        one = NtHash(codes[:tile + k - 1], h, k, device=dev)
        t0 = time.perf_counter()
        n = sum(1 for _ in one)
        return n / (time.perf_counter() - t0)

    def roll_rate(at):
        one = NtHash(codes, h, k, pos=at, device=dev)
        one.roll()
        t0 = time.perf_counter()
        for _ in range(1 << 19):
            one.roll()
        return (1 << 19) / (time.perf_counter() - t0)

    rates = {"iter": statistics.median(iter_rate() for _ in range(3)),
             "roll": statistics.median(roll_rate(b + 4096) for b in bounds[:3])}

    # SeedNtHash over 2**23 bases: the quirk windows included
    seeds, sh = SEEDS, SEED_H
    scodes = codes[:FACADE_SEED_LEN]
    ks = len(seeds[0])
    want_pos = oracle.seed_nthash_positions(scodes, ks)
    wpos = np.asarray(want_pos)
    has_n = ~oracle.window_valid(scodes, ks)
    quirk = wpos[has_n[wpos]]
    pick = set(rng.choice(wpos, size=FACADE_SAMPLES, replace=False).tolist())
    pick |= set(quirk[:2000].tolist())
    pick = sorted(pick)
    reset_fwd_rev_launches()
    snt = SeedNtHash(scodes, seeds, sh, ks, device=dev)
    spos, srows, ti = [], {}, 0
    t0 = time.perf_counter()
    for row in snt:
        p = snt.get_pos()
        spos.append(p)
        if ti < len(pick) and p == pick[ti]:
            srows[p] = row.copy()
            ti += 1
    t_seed = time.perf_counter() - t0
    launches["seed"] = sk.FWD_REV_LAUNCHES
    require(spos == want_pos, "SeedNtHash positions != "
            "oracle.seed_nthash_positions")
    require(len(srows) == len(pick) and quirk.size > 0,
            f"{len(srows)} of {len(pick)} picked windows seen, "
            f"{quirk.size} quirk windows")
    for p in pick:
        _, _, want = oracle.hash_all_windows_seeds(scodes[p:p + ks], seeds, sh)
        require(np.array_equal(srows[p], want[0]), f"SeedNtHash window {p}")
    require(launches["seed"] == 2, f"{launches['seed']} seed fwd/rev launches")

    def seed_rate():
        s = SeedNtHash(scodes[:tile + ks - 1], seeds, sh, ks, device=dev)
        t0 = time.perf_counter()
        n = sum(1 for _ in s)
        return n / (time.perf_counter() - t0)

    rates["seed iter"] = statistics.median(
        [len(spos) / t_seed, seed_rate(), seed_rate()])
    print(f"[facade] SeedNtHash {seeds}, h={sh}, over {FACADE_SEED_LEN} "
          f"bases: {len(spos)} positions == oracle.seed_nthash_positions, "
          f"{len(pick)} windows ({quirk.size} hold an N: the quirk, "
          f"{min(quirk.size, 2000)} checked) == the oracle; launches "
          f"{launches['seed']}")

    # the Blind classes fed the sequence base by base
    fed = codes[:BLIND_FED + k]
    seq_h, _ = kmer_kernel.hash_sequence(torch.from_numpy(fed).to(dev), k, h)
    seq_h = np.stack([to_numpy_u64(x) for x in seq_h], -1)

    def blind_walk(check):
        b = BlindNtHash(fed, h, k)
        out = np.empty((BLIND_FED, h), np.uint64) if check else None
        t0 = time.perf_counter()
        for i in range(BLIND_FED):
            b.roll(int(fed[k + i]))
            if check:
                out[i] = b.hashes()
        return BLIND_FED / (time.perf_counter() - t0), out

    rate, walked = blind_walk(True)
    require(np.array_equal(walked, seq_h[1:BLIND_FED + 1]),
            "BlindNtHash != the one-sequence entry")
    for i in rng.integers(0, BLIND_FED, size=1000):
        _, _, want, _ = oracle.hash_all_windows(fed[i + 1:i + 1 + k], k, h)
        require(np.array_equal(walked[i], want[0]), f"BlindNtHash step {i}")
    rates["blind"] = statistics.median([rate, blind_walk(False)[0],
                                        blind_walk(False)[0]])
    sfed = codes[:BLIND_FED + ks]
    bs_ = BlindSeedNtHash(sfed, seeds, sh, ks)
    sq, _ = sk.hash_seeds_sequence(torch.from_numpy(sfed).to(dev), seeds, sh)
    sq = np.stack([to_numpy_u64(x) for x in sq], -1)
    t0 = time.perf_counter()
    for i in range(BLIND_FED):
        bs_.roll(int(sfed[ks + i]))
        if i % 97 == 0:
            require(np.array_equal(bs_.hashes(), sq[i + 1]),
                    f"BlindSeedNtHash step {i}")
    rates["blind seed"] = BLIND_FED / (time.perf_counter() - t0)
    for i in rng.integers(0, BLIND_FED, size=200):
        b2 = BlindSeedNtHash(sfed[i:i + ks], seeds, sh, ks)
        _, _, want = oracle.hash_all_windows_seeds(sfed[i:i + ks], seeds, sh)
        require(np.array_equal(b2.hashes(), want[0]) and
                np.array_equal(sq[i], want[0]), f"BlindSeedNtHash init {i}")
    print(f"[facade] BlindNtHash over {BLIND_FED} fed bases == the "
          f"one-sequence entry at every step, == the oracle at 1,000; "
          f"BlindSeedNtHash == hash_seeds_sequence every 97th step, "
          f"== the oracle at 200 windows")
    print(f"[time] facade, medians of 3: NtHash.__iter__ "
          f"{rates['iter']:.6g} k-mers/s (one tile, hashing included), "
          f"roll() {rates['roll']:.6g}/s, SeedNtHash.__iter__ "
          f"{rates['seed iter']:.6g} k-mers/s, BlindNtHash.roll "
          f"{rates['blind']:.6g}/s; BlindSeedNtHash.roll "
          f"{rates['blind seed']:.6g}/s (one run); the whole 2**25 walk "
          f"{t_full:.3f} s, roll() across a boundary "
          f"{len(expect) / t_roll:.6g}/s [{card}]")

    # each tile's kernel and device->host copy
    for ti in range(len(bounds) + 1):
        lo = ti * tile
        hi = min(lo + tile, n_win)
        chunk = torch.from_numpy(codes[lo:hi + k - 1]).to(dev)
        t_k = timeit(lambda x: kmer_kernel.hash_sequence(
            x, k, h, emit_fwd_rev=True), chunk, calls=3).seconds_per_call
        outs, ok = kmer_kernel.hash_sequence(chunk, k, h, emit_fwd_rev=True)
        torch.cuda.synchronize()
        t_c = host_median(lambda: (api._host(outs, hi - lo),
                                   ok[:hi - lo].cpu()), runs=1)
        print(f"[time] facade tile {ti}: {hi - lo} windows, kernel "
              f"{t_k * 1e3:.4f} ms, device->host {t_c * 1e3:.4f} ms "
              f"({(hi - lo) * (8 * (h + 2) + 1) / t_c / 1e9:.4f} GB/s) "
              f"[{card}]")
        del chunk, outs, ok
    torch.cuda.empty_cache()
    return launches


def phase_threshold(rng, dev, card: str) -> int:
    """Where the kernel engine starts to win on a tile: the oracle against
    ``api._kernel_tile`` (host->device, the launch, the stack and the
    device->host copies) at 2**4 .. 2**16 windows, k=32, h=1 (the CLI's
    default), medians of 3 and 5 host timings."""
    k = K
    codes = rng.integers(0, 4, size=(1 << 16) + k - 1, dtype=np.uint8)
    win = None
    for e in range(4, 17):
        w = 1 << e
        chunk = codes[:w + k - 1]
        t_o = host_median(lambda: oracle.hash_all_windows(chunk, k, 1))
        t_k = host_median(lambda: api._kernel_tile(chunk, k, 1, dev), runs=5)
        if t_k < t_o and win is None:
            win = w
        elif t_k >= t_o:
            win = None
        print(f"[threshold] {w} windows, k={k}, h=1: oracle "
              f"{t_o * 1e3:.4f} ms, kernel tile {t_k * 1e3:.4f} ms [{card}]")
    require(win is not None, "the kernel never wins")
    print(f"[threshold] the kernel wins from {win} windows on; "
          f"api.AUTO_DEVICE_THRESHOLD = {api.AUTO_DEVICE_THRESHOLD} [{card}]")
    return win


def blind_bytes(steps: int, walks: int, k: int, nseeds: int, h: int) -> int:
    """Bytes roll_many must move: the fed int32 codes, the window read and
    written, every step's hashes written, (fwd, rev) read and written."""
    return (4 * steps * walks + 8 * walks * k + 8 * steps * walks * nseeds * h
            + 32 * walks * nseeds)


def phase_blind(rng, gen, dev, card: str) -> tuple[dict, dict, dict]:
    """The blind-roll kernel against the step loop at B in {1, 31, 33, 4097},
    T in {0 .. 257}, k in {1, 5, 32, 97}, h in {1, 4}, and for the BASELINE
    seeds and SEEDS18; then the DBG probe at 2**20 walks (k=32, 64 steps:
    peek4 -> Bloom contains -> argmax -> roll_select, the filter at 2**30
    bits, h=4, filled with a 2**25-base genome), the walks' chosen bases
    replayed through roll_many (one launch) and its plain version against
    the walked state; the seed kernel on 2**18 walks fed the genome against
    its plain version and the one-sequence entry; timings."""
    errs = dict.fromkeys(BLIND_KERNELS, 0.0)
    cases = 0
    for seeds in (None, SEEDS, SEEDS18):
        for k in ((1, 5, 32, 97) if seeds is None else (len(seeds[0]),)):
            for walks in (1, 31, 33, 4097):
                for steps in sorted({1, k - 1, k, k + 1, 257}):
                    w = torch.from_numpy(rng.integers(-1, 6, size=(walks, k))
                                         .astype(np.int32)).to(dev)
                    ch = torch.from_numpy(rng.integers(0, 6, size=(steps, walks))
                                          .astype(np.int32)).to(dev)
                    for h in (1, 4):
                        if seeds is None:
                            st = blind_scan.init_state(w)
                            a, ha = blind_scan.roll_many(st, ch, h)
                            b, hb = blind_scan.roll_many_plain(st, ch, h)
                            name = BLIND_KERNELS[0]
                        else:
                            st = blind_seed_scan.init_state(w, seeds)
                            a, ha = blind_seed_scan.roll_many(st, ch, seeds, h)
                            b, hb = blind_seed_scan.roll_many_plain(
                                st, ch, seeds, h)
                            name = BLIND_KERNELS[1]
                        same_outputs(errs, name, [ha, *a], [hb, *b],
                                     f"{name} B={walks} T={steps} k={k} h={h}")
                        regs = in_registers(st, ch, seeds or ("1" * k,), h)
                        same_outputs(errs, name, regs,
                                     [hb, b.fwd.reshape(walks, -1),
                                      b.rev.reshape(walks, -1), b.window],
                                     f"{name}, registers kernel forced, "
                                     f"B={walks} T={steps} k={k} h={h}")
                        cases += 1
    print(f"[blind] {cases} cases of roll_many (csrc/blind.cu) == the step "
          "loop, by the staged kernel (the rule) and by the registers kernel "
          "forced: every hash and the final state, codes outside 0-3 in the "
          "windows and the stream")

    # the DBG probe
    k, h, walks, steps = K, DBG_H, BLIND_WALKS, BLIND_STEPS
    genome = torch.randint(0, 4, (DBG_GENOME,), dtype=torch.uint8,
                           device=dev, generator=gen)
    ghash, gvalid = kmer_kernel.hash_sequence(genome, k, h)
    bf = bloom.insert(bloom.BloomFilter.zeros(DBG_WIDTH, dev),
                      torch.stack(ghash, -1), gvalid, DBG_WIDTH)
    del ghash, gvalid
    starts = torch.randint(0, DBG_GENOME - k - steps, (walks,), device=dev,
                           generator=gen)
    windows = genome[starts[:, None] + torch.arange(k, device=dev)]
    state0 = blind_scan.init_state(windows)
    state = state0
    choices = torch.empty((steps, walks), dtype=torch.int32, device=dev)
    parts = dict.fromkeys(("peek4", "contains", "argmax", "roll_select"), 0.0)
    on_genome = torch.zeros((), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        probes = blind_scan.peek4(state, h)
        ev[1].record()
        hit = bloom.contains(bf, probes, DBG_WIDTH)
        ev[2].record()
        choice = torch.argmax(hit.to(torch.int8), dim=1).to(torch.int32)
        ev[3].record()
        state = blind_scan.roll_select(state, choice)
        ev[4].record()
        choices[t] = choice
        on_genome += (choice == genome[starts + k + t]).sum()
        torch.cuda.synchronize()
        for i, name in enumerate(parts):
            parts[name] += ev[i].elapsed_time(ev[i + 1])
    t_walk = time.perf_counter() - t0
    reset_blind_launches()
    replay, rhash = blind_scan.roll_many(state0, choices, h)
    launches = {BLIND_KERNELS[0]: blind_scan.LAUNCHES}
    plain, phash = blind_scan.roll_many_plain(state0, choices, h)
    same_outputs(errs, BLIND_KERNELS[0], [rhash, *replay], [phash, *plain],
                 "the DBG walks replayed: kernel vs plain")
    require(all(torch.equal(x, y) for x, y in zip(replay, state))
            and torch.equal(rhash[-1], blind_scan.hashes_of(state, h)),
            "the DBG walks replayed through roll_many != the walked state")
    frac = int(on_genome) / (walks * steps)
    print(f"[dbg] {walks} walks x {steps} steps, k={k}, Bloom 2**{DBG_WIDTH} "
          f"bits, h={h}, genome {DBG_GENOME} bases: {frac:.6f} of the chosen "
          f"bases are the genome's; the walked state == roll_many over the "
          f"chosen bases (kernel) == its plain version; launches {launches}")
    per = {name: ms / steps for name, ms in parts.items()}
    t_sel = timeit(lambda c: blind_scan.roll_select(state0, c), choices[0],
                   calls=5).seconds_per_call
    t_back = timeit(lambda c: blind_scan.roll_back_select(state0, c),
                    choices[0], calls=5).seconds_per_call
    print(f"[time] DBG step at {walks} walks: {t_walk / steps * 1e3:.4f} ms "
          f"a step (host clock); device ms a step: "
          + ", ".join(f"{n} {v:.4f}" for n, v in per.items())
          + f"; roll_select alone {t_sel * 1e3:.4f} ms, roll_back_select "
          f"{t_back * 1e3:.4f} ms (plain tensor ops: the [B, k] window "
          f"shifted, {8 * walks * k / 1e6:.1f} MB moved) [{card}]")
    del bf
    torch.cuda.empty_cache()
    times = {}
    t = in_turns({
        "kernel": lambda c: blind_scan.roll_many(state0, c, h),
        "registers": lambda c: in_registers(state0, c, ("1" * k,), h),
        "plain": lambda c: blind_scan.roll_many_plain(state0, c, h)},
        choices, rounds=2)
    nbytes = blind_bytes(steps, walks, k, 1, h)
    times[BLIND_KERNELS[0]] = (t["kernel"], t["plain"], nbytes)
    print(f"[time] roll_many B={walks} T={steps} k={k} h={h}: kernel "
          f"{t['kernel'] * 1e3:.4f} ms (staged), registers kernel "
          f"{t['registers'] * 1e3:.4f} ms, bound {bound_ms(nbytes):.4f} ms "
          f"({nbytes / 1e9:.4f} GB), plain step loop "
          f"{t['plain'] * 1e3:.4f} ms, in turns [{card}]")
    del state, state0, replay, plain, rhash, phash, choices
    torch.cuda.empty_cache()

    # spaced seeds: 2**18 walks fed the genome's own bases
    seeds, sh, ks = SEEDS, SEED_H, len(SEEDS[0])
    starts = torch.randint(0, DBG_GENOME - ks - steps, (BLIND_SEED_WALKS,),
                           device=dev, generator=gen)
    sw = genome[starts[:, None] + torch.arange(ks, device=dev)]
    fed = genome[starts[None, :] + ks
                 + torch.arange(steps, device=dev)[:, None]].to(torch.int32)
    sst = blind_seed_scan.init_state(sw, seeds)
    reset_blind_launches()
    a, ha = blind_seed_scan.roll_many(sst, fed, seeds, sh)
    launches[BLIND_KERNELS[1]] = blind_seed_scan.LAUNCHES
    b, hb = blind_seed_scan.roll_many_plain(sst, fed, seeds, sh)
    same_outputs(errs, BLIND_KERNELS[1], [ha, *a], [hb, *b],
                 "seed roll_many over the genome: kernel vs plain")
    seq, _ = sk.hash_seeds_sequence(genome, seeds, sh)
    at = starts[None, :] + 1 + torch.arange(steps, device=dev)[:, None]
    want = torch.stack([s[at] for s in seq], -1)
    require(torch.equal(ha, want), "seed roll_many over the genome != "
            "the one-sequence entry at the same windows")
    print(f"[blind] {BLIND_SEED_WALKS} seed walks ({seeds}, h={sh}) fed "
          f"{steps} genome bases: kernel == plain == hash_seeds_sequence at "
          f"the same windows; launches {launches[BLIND_KERNELS[1]]}")
    del seq, want, a, b, ha, hb
    t = in_turns({
        "kernel": lambda c: blind_seed_scan.roll_many(sst, c, seeds, sh),
        "registers": lambda c: in_registers(sst, c, seeds, sh),
        "plain": lambda c: blind_seed_scan.roll_many_plain(sst, c, seeds,
                                                           sh)},
        fed, rounds=2)
    nbytes = blind_bytes(steps, BLIND_SEED_WALKS, ks, len(seeds), sh)
    times[BLIND_KERNELS[1]] = (t["kernel"], t["plain"], nbytes)
    print(f"[time] seed roll_many B={BLIND_SEED_WALKS} T={steps} {seeds} "
          f"h={sh}: kernel {t['kernel'] * 1e3:.4f} ms (staged), registers "
          f"kernel {t['registers'] * 1e3:.4f} ms, bound "
          f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e9:.4f} GB), plain step "
          f"loop {t['plain'] * 1e3:.4f} ms, in turns [{card}]")
    del genome, sst, fed
    torch.cuda.empty_cache()
    return errs, launches, times


def in_registers(state, chars, seeds, h):
    """The blind roll by the kernel with a thread's values in registers
    (the first design; the route for seed sets too large to stage), forced:
    [hashes, fwd [B, S], rev [B, S], window]."""
    return list(blind_kernel.launch(chars, state.window, state.fwd,
                                    state.rev, seeds, h, warps=0))


def reset_blind_launches() -> None:
    blind_scan.LAUNCHES = blind_seed_scan.LAUNCHES = 0


# ------------------------------- the binned routes (A2, C1; phase 31) ----

#: (width_log2, rows) of phase 31's edge shapes: the histogram's binned
#: widths (up to the most ranges one pass takes: 4 rows at 2**25, one at
#: 2**27) and the presence words' (up to 2**31).
BIN_HIST_EDGES = ((16, 4), (20, 4), (21, 4), (24, 4), (25, 4), (27, 1))
BIN_WORD_EDGES = ((21, 1), (21, 3), (25, 1), (30, 1), (31, 1))
#: (kernel, width_log2, rows) with no binned route, which a forced binned
#: route refuses: the private widths and too many ranges for one pass.
BIN_REFUSED = (("A2", 15, 4), ("A2", 26, 4), ("A2", 30, 1), ("C1", 16, 1),
               ("C1", 20, 1), ("C1", 21, 4096))
#: (width_log2, rows) of the clustered route's checks and timings: 4 rows
#: at 2**26..2**28 (ranges of 2**16..2**18 counters) and one row at 2**28.
BIN_CLUSTERED = ((26, 4), (27, 4), (28, 4), (28, 1))
#: (width_log2, rows) where a forced clustered route is refused: the private
#: widths, the binned route's, past 2**18-counter ranges.
CLUSTERED_REFUSED = ((15, 4), (25, 4), (26, 2), (29, 4), (30, 4))
#: (kernel, width_log2, rows) of the sweep that sets BINNED_MIN_ENTRIES and
#: BINNED_MIN_WORD_ENTRIES: every width the rule bins at the path's rows
#: (A2 with 4 rows, binned to 2**25 and clustered to 2**28; C1 with one),
#: and the ends of the other row counts.
BIN_SWEEP = (tuple(("A2", wl, 4) for wl in range(16, 29))
             + (("A2", 16, 1), ("A2", 22, 1), ("A2", 27, 1), ("A2", 28, 1),
                ("A2", 30, 1))
             + tuple(("C1", wl, 1) for wl in range(21, 32))
             + (("C1", 21, 4), ("C1", 26, 4)))
#: The count-min cell's genome: E. coli K-12 MG1655's length.
GENOME = 4_641_652


@contextlib.contextmanager
def direct_rule():
    """The route rules without a binned route, as they were before it:
    above the private widths every update is one direct atomic."""
    saved = hist_kernel.binned_counts_grid, hist_kernel.binned_words_grid
    hist_kernel.binned_counts_grid = hist_kernel.binned_words_grid = (
        lambda *a, **k: (0, 0))
    try:
        yield
    finally:
        hist_kernel.binned_counts_grid, hist_kernel.binned_words_grid = saved


def binned_route(rows: int, wl: int) -> str:
    """The histogram's binned route at these shapes, to force it: "binned"
    (ranges of 2**15) or "clustered" (2**16..2**18)."""
    rl = hist_kernel.counts_range_log2(rows, wl)
    return "binned" if rl == hist_kernel.COUNTS_RANGE_LOG2 else "clustered"


def genome_reads(gen, n: int, dev, genome=None) -> torch.Tensor:
    """uint8 [n, L] codes of n reads from ``genome`` (by default a random
    one of ``GENOME`` bases), at uniform starts on either strand, with 0.25%
    substitutions: the count-min cell's kind of traffic, where a k-mer
    recurs ~6 times a batch of 2**18 reads (``make_codes``'s reads share no
    k-mer)."""
    if genome is None:
        genome = torch.randint(0, 4, (GENOME,), generator=gen, device=dev,
                               dtype=torch.uint8)
    start = torch.randint(0, genome.shape[0] - L + 1, (n, 1), generator=gen,
                          device=dev)
    reads = genome[start + torch.arange(L, device=dev)]
    minus = torch.rand(n, generator=gen, device=dev) < 0.5
    reads = torch.where(minus[:, None], (3 - reads).flip(1), reads)
    sub = torch.rand((n, L), generator=gen, device=dev) < 0.0025
    shift = torch.randint(1, 4, (n, L), generator=gen, device=dev,
                          dtype=torch.uint8)
    return torch.where(sub, (reads + shift) % 4, reads)


def bins_err(idx, weight, wl: int, rl: int, per: int = 4096) -> float:
    """``bin_ranges`` against ``bin_ranges_plain``: the largest difference
    of the counts, the starts, the range pass's block prefix, each range's
    cursor against the next range's start, and each range's offsets
    compared as multisets (the order inside a range is free; both sorted by
    range, then offset). 0 when all are equal."""
    got = hist_kernel.bin_ranges(idx, weight, wl, rl, per)
    want = hist_kernel.bin_ranges_plain(idx, weight, wl, rl, per)
    def diff(a, b):
        return 0.0 if torch.equal(a, b) else max_abs_err(a, b)

    nranges = got.counts.numel()
    meta = torch.empty(0, dtype=torch.int64, device=idx.device).set_(
        got.counts.untyped_storage())
    cursors = meta[2 * nranges + 1:3 * nranges + 1]
    err = max([diff(a, b) for a, b in zip(got[:3], want[:3])]
              + [diff(cursors, want.starts[1:])])
    if err:
        return err
    total = int(want.starts[-1])
    rid = torch.repeat_interleave(
        torch.arange(want.counts.numel(), device=idx.device), want.counts)

    def grouped(stage):
        return torch.sort((rid << rl)
                          | (stage[:total].long() & ((1 << rl) - 1))).values

    return diff(grouped(got.stage), grouped(want.stage))


def edge_streams(gen, rows: int, wl: int, rl: int, dev) -> list:
    """(label, idx [rows, n]) of the edge shapes at 2**wl with ranges of
    2**rl: ragged n (fewer entries than ranges at the widest), a row that
    starts off a 16-byte boundary, every entry in the last range, every
    entry one value, sentinel-only rows, one entry in eight one value."""
    width = 1 << wl
    top = min(width + 3, (1 << 31) - 1)

    def rand(n, lo=-3, hi=top):
        return torch.randint(lo, hi, (rows, n), generator=gen, device=dev,
                             dtype=torch.int32)

    hot = rand(300_001)
    hot[:, ::8] = 777
    return ([(f"n={n}", rand(n)) for n in (1, 7, 1000, 8193, 100_003)]
            + [("a view one int past a 16-byte boundary",
                rand(100_004)[:, 1:]),
               ("every entry in the last range",
                rand(65_537, width - (1 << rl), min(width, (1 << 31) - 1))),
               ("every entry one value",
                torch.full((rows, 50_001), 12345, device=dev,
                           dtype=torch.int32)),
               ("sentinel-only rows",
                torch.full((rows, 50_001), width if wl < 31 else -1,
                           device=dev, dtype=torch.int32)),
               ("one entry in eight one value", hot)])


def phase_binned_checks(codes: np.ndarray, gen, dev) -> dict:
    """Phase 31, checks: the binned route of A2 and of C1, each forced,
    against the plain version and the direct route with ``torch.equal`` on
    whole tables: on the path's own batch-0 buckets at 2**20 ([4, n]) and
    stream at 2**30, and at the edge shapes (``edge_streams``) at every
    binned width of ``BIN_HIST_EDGES`` / ``BIN_WORD_EDGES``, with a gate of
    0 and 1 into an ``out`` that accumulates and, for C1, weights; one C1
    compare below a fill of 0.5 at least. ``bin_ranges`` against its plain
    version on the same inputs. Forced binned routes refused where there is
    none. Returns the largest difference of each new kernel (0 when
    equal)."""
    errs = dict.fromkeys(("bin_ranges_counts", "histogram_ranges",
                          "bin_ranges_words", "bloom_ranges"), 0.0)
    fills = []
    counted = {"A2": 0, "A2 clustered": 0, "C1": 0, "bins": 0}

    def clone(t):
        return None if t is None else t.clone()

    def hist_same(idx, wl, what, gate=None, out=None):
        got = hist_by(binned_route(idx.shape[0], wl), idx, None, wl, gate,
                      clone(out))
        want = histogram_rows_plain(idx, None, wl, gate=gate, out=clone(out))
        direct = hist_by("direct", idx, None, wl, gate, clone(out))
        torch.cuda.synchronize()
        errs["histogram_ranges"] = max(errs["histogram_ranges"],
                                       max_abs_err(got, want))
        require(torch.equal(got, want) and torch.equal(direct, want),
                f"binned histogram != plain != direct: {what}")
        counted["A2" if hist_kernel.counts_range_log2(idx.shape[0], wl) == 15
                else "A2 clustered"] += 1

    def words_same(idx, weight, wl, what, gate=None, out=None):
        got = words_by("binned", idx, weight, wl, gate, clone(out))
        want = hist_kernel._words_plain(idx, weight, wl, gate, clone(out))
        direct = words_by("direct", idx, weight, wl, gate, clone(out))
        torch.cuda.synchronize()
        errs["bloom_ranges"] = max(errs["bloom_ranges"],
                                   max_abs_err(got, want))
        require(torch.equal(got, want) and torch.equal(direct, want),
                f"binned words != plain != direct: {what}")
        fills.append((fill_of(want), what))
        counted["C1"] += 1

    def bins_same(idx, weight, wl, rl, what):
        name = ("bin_ranges_words" if rl == hist_kernel.WORDS_RANGE_LOG2
                else "bin_ranges_counts")
        err = bins_err(idx, weight, wl, rl)
        errs[name] = max(errs[name], err)
        require(err == 0, f"bin_ranges != plain by {err}: {what}")
        counted["bins"] += 1

    def gated(same, idx, wl, cols, *w):
        base = torch.randint(-(1 << 31), (1 << 31) - 1, (idx.shape[0], cols),
                             generator=gen, device=dev, dtype=torch.int32)
        for g in (0, 1):
            gate = torch.full((1,), g, dtype=torch.int32, device=dev)
            same(idx, *w, wl, f"gate {g}, out accumulating, [{idx.shape[0]}, "
                 f"{idx.shape[1]}] at 2**{wl}", gate, base)

    # the path's own shapes: batch 0's [4, n] buckets at 2**20 and its
    # buckets as one stream at 2**30
    tm = prepare_codes(torch.from_numpy(codes[:BATCH]).to(dev))
    bucks = hist_kernel.rows_view(hash_kmers_tm(tm, K, H, emit_buckets=WIDE))
    hist_same(bucks, WIDE, f"batch 0's [{H}, n] buckets at 2**{WIDE}")
    gated(hist_same, bucks, WIDE, 1 << WIDE)
    bins_same(bucks, None, WIDE, hist_kernel.COUNTS_RANGE_LOG2,
              f"batch 0's buckets at 2**{WIDE}")
    del bucks
    stream = hist_kernel.rows_view(hash_kmers_tm(
        tm, K, H, emit_buckets=30)).reshape(1, -1)
    words_same(stream, None, 30, "batch 0's stream at 2**30")
    bins_same(stream, None, 30, hist_kernel.WORDS_RANGE_LOG2,
              "batch 0's stream at 2**30")
    del stream, tm
    torch.cuda.empty_cache()
    for wl, rows in BIN_HIST_EDGES:
        for what, idx in edge_streams(gen, rows, wl, 15, dev):
            hist_same(idx, wl, f"{what}, [{rows}, n] at 2**{wl}")
            bins_same(idx, None, wl, 15, f"{what}, [{rows}, n] at 2**{wl}")
        gated(hist_same, edge_streams(gen, rows, wl, 15, dev)[4][1], wl,
              1 << wl)
        torch.cuda.empty_cache()
    # the clustered route: the count-min cell's batch at 4 x 2**28 by the
    # rule, then the edge shapes forced, at every clustered width
    cell = hist_kernel.rows_view(hash_kmers_tm(
        prepare_codes(genome_reads(gen, BATCH, dev)), K, H, emit_buckets=28))
    require(hist_kernel._counts_route(H, cell.shape[1], 28, False, None)[0]
            == "clustered", "the rule gives the 4 x 2**28 batch no "
            "clustered route")
    got = histogram_rows(cell, None, 28)
    require(torch.equal(got, histogram_rows_plain(cell, None, 28)),
            "the rule's clustered histogram of a genomic batch at 4 x 2**28 "
            "!= plain")
    counted["A2 clustered"] += 1
    del got, cell
    torch.cuda.empty_cache()
    for wl, rows in BIN_CLUSTERED:
        rl = hist_kernel.counts_range_log2(rows, wl)
        for what, idx in edge_streams(gen, rows, wl, rl, dev):
            hist_same(idx, wl, f"{what}, [{rows}, n] at 2**{wl}")
            bins_same(idx, None, wl, rl, f"{what}, [{rows}, n] at 2**{wl}")
            torch.cuda.empty_cache()
        gated(hist_same, edge_streams(gen, rows, wl, rl, dev)[4][1], wl,
              1 << wl)
        torch.cuda.empty_cache()
    for wl, rows in BIN_WORD_EDGES:
        streams = edge_streams(gen, rows, wl, 20, dev)
        for what, idx in streams:
            words_same(idx, None, wl, f"{what}, [{rows}, n] at 2**{wl}")
            bins_same(idx, None, wl, 20, f"{what}, [{rows}, n] at 2**{wl}")
            if rows == 1:
                w = torch.randint(-1, 2, (idx.shape[1],), generator=gen,
                                  device=dev, dtype=torch.int32)
                words_same(idx, w, wl, f"{what}, weighted, at 2**{wl}")
                bins_same(idx, w, wl, 20, f"{what}, weighted, at 2**{wl}")
        gated(words_same, streams[4][1], wl, (1 << wl) // 32, None)
        big = torch.randint(0, (1 << 31) - 1 if wl == 31 else 1 << wl,
                            (rows, GRID_STRIDE_N), generator=gen, device=dev,
                            dtype=torch.int32)
        words_same(big, None, wl, f"[{rows}, {GRID_STRIDE_N}] at 2**{wl}")
        del streams, big
        torch.cuda.empty_cache()
    for kernel, wl, rows in BIN_REFUSED:
        idx = torch.zeros((rows, 8), dtype=torch.int32, device=dev)
        try:
            (hist_by if kernel == "A2" else words_by)("binned", idx, None, wl)
        except ValueError:
            continue
        raise AssertionError(f"a binned {kernel} at 2**{wl} x {rows} rows "
                             "was not refused")
    for wl, rows in CLUSTERED_REFUSED:
        idx = torch.zeros((rows, 8), dtype=torch.int32, device=dev)
        try:
            hist_by("clustered", idx, None, wl)
        except ValueError:
            continue
        raise AssertionError(f"a clustered A2 at 2**{wl} x {rows} rows was "
                             "not refused")
    low = min(fills)
    require(low[0] < 0.5, f"every C1 compare was saturated: {low}")
    print(f"[binned] exact (torch.equal, whole tables): A2 binned == plain "
          f"== direct in {counted['A2']} compares, A2 clustered in "
          f"{counted['A2 clustered']} (widths {list(BIN_CLUSTERED)}), C1 in "
          f"{counted['C1']} "
          f"(lowest fill {low[0]:.6f}: {low[1]}; highest "
          f"{max(fills)[0]:.6f}), bin_ranges == plain (counts, starts, "
          f"blocks; each range's offsets as a multiset) in "
          f"{counted['bins']}; widths A2 {[w for w, _ in BIN_HIST_EDGES]}, C1 "
          f"{[w for w, _ in BIN_WORD_EDGES]}; refused where there is none: "
          f"{list(BIN_REFUSED)}, clustered {list(CLUSTERED_REFUSED)}")
    return errs


def prepared_in_turns(prepare, fns: dict, rounds: int = 2) -> dict:
    """``time_prepared`` of each function in turns (A B B A), mean of the
    rounds' medians: for kernels that OR or add into a table that
    ``prepare`` zeroes, untimed, before each call."""
    names = list(fns)
    got = {name: [] for name in names}
    for i in range(rounds):
        for name in (names if i % 2 == 0 else names[::-1]):
            got[name].append(time_prepared(prepare, fns[name]))
    return {name: statistics.mean(v) for name, v in got.items()}


def time_clustered(codes: np.ndarray, gen, dev, tag: str) -> None:
    """Phase 31, the clustered route: at each ``BIN_CLUSTERED`` shape, on
    batch 0's buckets of the 1M reads and of a genomic batch
    (``genome_reads``), the route and direct atomics into one accumulating
    table in turns, the binning pass and the range pass alone, the plain
    version and the bound (every index read once, every touched counter
    read and written once); then phase 23's two skewed streams at 4 x
    2**28."""
    batches = {"reads": torch.from_numpy(codes[:BATCH]).to(dev),
               "genomic": genome_reads(gen, BATCH, dev)}
    for wl, rows in BIN_CLUSTERED:
        rl = hist_kernel.counts_range_log2(rows, wl)
        out = torch.zeros((rows, 1 << wl), dtype=torch.int32, device=dev)
        for label, reads in batches.items():
            idx = hist_kernel.rows_view(hash_kmers_tm(
                prepare_codes(reads), K, H, emit_buckets=wl)).reshape(rows, -1)
            n = idx.shape[1]
            per, blocks = hist_kernel.binned_counts_grid(rows, n, wl)
            require(per > 0 and binned_route(rows, wl) == "clustered",
                    f"no clustered route at [{rows}, {n}] x 2**{wl}")
            routes = in_turns({r: (lambda x, r=r: hist_by(r, x, None, wl,
                                                          out=out))
                               for r in ("clustered", "direct")}, idx)
            bins = hist_kernel.bin_ranges(idx, None, wl, rl, per)
            t_bin = timeit(lambda x: hist_kernel.bin_ranges(x, None, wl, rl,
                                                            per),
                           idx).seconds_per_call
            t_ranges = time_prepared(lambda: bins, lambda b: (
                hist_kernel._ranges_launch("histogram", b, blocks, out,
                                           None)))
            t_plain = timeit(lambda x: histogram_rows_plain(x, None, wl),
                             idx).seconds_per_call
            valid = idx[(idx >= 0) & (idx < (1 << wl))].long()
            rid = torch.arange(rows, device=dev)[:, None].expand(rows, n)
            touched = torch.unique(
                (rid[(idx >= 0) & (idx < (1 << wl))] << wl) | valid).numel()
            nbytes = idx.numel() * 4 + touched * 8
            print(f"[time] clustered A2, [{rows}, {n}] at 2**{wl} (ranges "
                  f"of 2**{rl}, {blocks} blocks of {per} entries), batch 0 "
                  f"of the {label}, {touched} counters touched: clustered "
                  f"{routes['clustered'] * 1e3:.4f} ms, direct "
                  f"{routes['direct'] * 1e3:.4f} ms, in turns; binning "
                  f"{t_bin * 1e3:.4f} ms, range pass {t_ranges * 1e3:.4f} ms; "
                  f"plain {t_plain * 1e3:.4f} ms; bound "
                  f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e9:.4f} GB) {tag}")
            del idx, bins, valid, rid
            torch.cuda.empty_cache()
        del out
        torch.cuda.empty_cache()
    bucks = hist_kernel.rows_view(hash_kmers_tm(
        prepare_codes(batches["reads"]), K, H, emit_buckets=28))
    n = bucks.shape[1]
    for label, idx in (("(a) every entry one value",
                        torch.full_like(bucks, 12345)),
                       ("(b) one eighth of the entries one value",
                        bucks.clone().index_fill_(
                            1, torch.arange(0, n, 8, device=dev), 12345))):
        got = in_turns({r: (lambda x, r=r: hist_by(r, x, None, 28))
                        for r in ("clustered", "direct")}, idx)
        require(torch.equal(hist_by("clustered", idx, None, 28),
                            hist_by("direct", idx, None, 28)),
                f"skewed stream {label} at 2**28: clustered != direct")
        print(f"[time] skewed stream at 2**28, batch 0's [{H}, {n}] buckets, "
              f"{label}: clustered {got['clustered'] * 1e3:.4f} ms, direct "
              f"{got['direct'] * 1e3:.4f} ms, in turns (results equal) {tag}")
        del idx
        torch.cuda.empty_cache()
    del bucks, batches
    torch.cuda.empty_cache()


#: Kernels the binning pass may launch (whole words; the device's memsets
#: aside): the benchmark's roofline readers find its time by these names.
BIN_KERNELS = re.compile(r"\bbin_(count|scan|scatter)_kernel\b")
#: A2's binned route at 2**20 over the 1M reads, as the path launches it,
#: before the whole-sector scatter (this script's phase 31 on an NVIDIA
#: H100 80GB HBM3 at 700 W); that width bins by the other scatter body.
A2_BINNED_BEFORE_MS = 2.4763


def time_cell_scatter(gen, dev, tag: str) -> None:
    """Phase 31, the binning pass at the benchmark cells' shapes: one
    genomic batch of 2**18 reads (``genome_reads``) hashed at k=32 into 4
    hashes, as the count-min cell's [4, n] buckets at 2**28 (ranges of 2**18)
    and the Bloom cell's one stream at 2**30 (ranges of 2**20). Each pass
    against its plain version (exact), then 10 passes under the profiler:
    every one by the "sectors" scatter, no kernel but the three named ones,
    and each kernel's device time a batch; the scatter beside its byte bound
    (every index read once, every valid update staged once) and its share
    of it."""
    tm = prepare_codes(genome_reads(gen, BATCH, dev))
    for label, wl, rl, rows in (("count-min cell", 28, 18, H),
                                ("Bloom cell", 30, 20, 1)):
        idx = hist_kernel.rows_view(hash_kmers_tm(
            tm, K, H, emit_buckets=wl)).reshape(rows, -1)
        n = idx.shape[1]
        grid = (hist_kernel.binned_counts_grid if rl < 20
                else hist_kernel.binned_words_grid)
        per = grid(rows, n, wl)[0]
        require(per > 0, f"no binned route at [{rows}, {n}] x 2**{wl}")
        require(hist_kernel.scatter_body(wl, rl) == "sectors",
                f"the rule gives [{rows}, n] at 2**{wl} no sectors scatter")
        err = bins_err(idx, None, wl, rl, per)
        require(err == 0, f"bin_ranges != plain by {err} at the {label}'s "
                "shape")
        valid = int(((idx >= 0) & (idx < (1 << wl))).sum())
        passes = 10
        before = dict(hist_kernel.SCATTER_ROUTE_LAUNCHES)
        tr = trace_device(lambda: [hist_kernel.bin_ranges(idx, None, wl, rl,
                                                          per)
                                   for _ in range(passes)], device=dev)
        took = {k: v - before[k]
                for k, v in hist_kernel.SCATTER_ROUTE_LAUNCHES.items()}
        require(took == {"sectors": passes, "runs": 0},
                f"{label}: scatters by body {took}, want {passes} sectors")
        others = [name for name in tr.by_name
                  if not BIN_KERNELS.search(name) and "Memset" not in name
                  and not name.startswith("nthash.")]  # the span's own row
        require(not others, f"the binning pass launched {others}")
        per_kernel = {k: sum(t for name, (t, _) in tr.by_name.items()
                             if re.search(rf"\bbin_{k}_kernel\b", name))
                      / passes * 1e3 for k in ("count", "scan", "scatter")}
        nbytes = idx.numel() * 4 + valid * 4
        bound = bound_ms(nbytes)
        print(f"[time] binning pass at the {label}'s shape, [{rows}, {n}] at "
              f"2**{wl} (ranges of 2**{rl}), one genomic batch of {BATCH} "
              f"reads, device time a batch over {passes} traced passes: "
              f"bin_scatter_kernel {per_kernel['scatter']:.4f} ms (sectors "
              f"body), bound {bound:.4f} ms ({nbytes / 1e9:.4f} GB), "
              f"{100 * bound / per_kernel['scatter']:.1f}% of it; "
              f"bin_count_kernel {per_kernel['count']:.4f} ms, "
              f"bin_scan_kernel {per_kernel['scan']:.4f} ms {tag}")
        del idx
        torch.cuda.empty_cache()
    del tm
    torch.cuda.empty_cache()


def phase_binned_timings(codes: np.ndarray, gen, dev, card: str) -> dict:
    """Phase 31, timings in one call, in turns, each line with the card's
    name and power limit: over the 1M reads (four batches), A2 at 2**20 as
    the path launches it ([4, n] a batch) and C1 at 2**30 (one stream a
    batch): the binned route, direct atomics, the binning and the range
    pass alone, their plain versions, the byte bounds and the yardsticks
    (``torch.bincount``, ``scatter_pack``; ``torch.sort`` of the flat
    buckets for the binning pass); phase 23's two skewed streams; the
    fused step at 2**20 and the Bloom step at 2**30 by the rule and by the
    rule without a binned route; the sweep of updates a call that sets
    ``BINNED_MIN_ENTRIES`` and ``BINNED_MIN_WORD_ENTRIES``. Returns
    [kernel s, plain s, library s or None, bytes] per new kernel, for the
    kernels line."""
    tag = f"[{card}]"
    res = {}
    time_cell_scatter(gen, dev, tag)

    def add(name, k_s, p_s, lib_s, nbytes):
        row = res.setdefault(name, [0.0, 0.0, 0.0, 0])
        for i, v in enumerate((k_s, p_s, lib_s, nbytes)):
            row[i] += v

    # A2 at 2**20, one [4, n] launch a batch, into the sketch's rows
    width = 1 << WIDE
    routes = dict.fromkeys(("binned", "direct"), 0.0)
    plain_route, route_bytes = 0.0, 0
    rows_out = torch.zeros((H, width), dtype=torch.int32, device=dev)
    for idx in path_buckets(codes, WIDE, dev):
        n = idx.shape[1]
        per, blocks = hist_kernel.binned_counts_grid(H, n, WIDE)
        require(per > 0, f"the rule gives the 2**{WIDE} path no binned route")
        for r, v in in_turns({r: (lambda x, r=r: hist_by(r, x, None, WIDE,
                                                          out=rows_out))
                              for r in routes}, idx).items():
            routes[r] += v
        bins = hist_kernel.bin_ranges(idx, None, WIDE, 15, per)
        plain_bins = hist_kernel.bin_ranges_plain(idx, None, WIDE, 15, per)
        valid = int(plain_bins.starts[-1])
        flat = (idx.long() + torch.arange(H, device=dev)[:, None]
                * (width + 1)).reshape(-1)
        add("bin_ranges_counts",
            timeit(lambda x: hist_kernel.bin_ranges(x, None, WIDE, 15, per),
                   idx).seconds_per_call,
            timeit(lambda x: hist_kernel.bin_ranges_plain(x, None, WIDE, 15,
                                                          per),
                   idx).seconds_per_call,
            timeit(lambda x: torch.sort(x), flat).seconds_per_call,
            idx.numel() * 4 + valid * 2)
        add("histogram_ranges",
            time_prepared(lambda: bins, lambda b: hist_kernel._ranges_launch(
                "histogram", b, blocks, rows_out, None)),
            time_prepared(lambda: plain_bins,
                          lambda b: hist_kernel.histogram_ranges_plain(
                              b, H, WIDE, out=rows_out)),
            timeit(lambda x: torch.bincount(x, minlength=H * (width + 1)),
                   flat).seconds_per_call,
            valid * 2 + H * width * 4)
        plain_route += timeit(lambda x: histogram_rows_plain(x, None, WIDE),
                              idx).seconds_per_call
        route_bytes += idx.numel() * 4 + H * width * 4
        del idx, bins, plain_bins, flat
        torch.cuda.empty_cache()
    del rows_out
    print(f"[time] A2 at 2**{WIDE} as the path launches it ([{H}, n] a "
          f"batch, into the sketch's rows), over {N_READS} reads: binned "
          f"{routes['binned'] * 1e3:.4f} ms ({A2_BINNED_BEFORE_MS} ms before "
          f"the whole-sector scatter), direct atomics (the old route) "
          f"{routes['direct'] * 1e3:.4f} ms, in turns; of the binned route "
          f"the binning pass {res['bin_ranges_counts'][0] * 1e3:.4f} ms and "
          f"the range pass {res['histogram_ranges'][0] * 1e3:.4f} ms; plain "
          f"{plain_route * 1e3:.4f} ms, torch.bincount "
          f"{res['histogram_ranges'][2] * 1e3:.4f} ms, bound "
          f"{bound_ms(route_bytes):.4f} ms ({route_bytes / 1e9:.4f} GB) {tag}")
    for name in ("bin_ranges_counts", "histogram_ranges"):
        k_s, p_s, lib_s, nbytes = res[name]
        print(f"[time] {name} at 2**{WIDE} over {N_READS} reads: kernel "
              f"{k_s * 1e3:.4f} ms, plain {p_s * 1e3:.4f} ms, library "
              f"({'torch.sort' if name.startswith('bin') else 'torch.bincount'})"
              f" {lib_s * 1e3:.4f} ms, bound {bound_ms(nbytes):.4f} ms "
              f"({nbytes / 1e9:.4f} GB) {tag}")

    # C1 at 2**30, one stream a batch, into words zeroed before each call
    wl = 30
    words = torch.zeros((1, (1 << wl) // 32), dtype=torch.int32, device=dev)
    routes = dict.fromkeys(("binned", "direct"), 0.0)
    extra = {"plain": 0.0, "scatter_pack": 0.0, "bytes": 0}
    for tm in bloom_tms(codes, dev):
        stream = hist_kernel.rows_view(hash_kmers_tm(
            tm, K, H, emit_buckets=wl)).reshape(1, -1)
        del tm
        n = stream.shape[1]
        per, blocks = hist_kernel.binned_words_grid(1, n, wl)
        require(per > 0, "the rule gives the 2**30 Bloom path no binned route")

        def zeroed(x=stream):
            words.zero_()
            return x

        for r, v in prepared_in_turns(zeroed, {
                r: (lambda x, r=r: words_by(r, x, None, wl, out=words))
                for r in routes}).items():
            routes[r] += v
        bins = hist_kernel.bin_ranges(stream, None, wl, 20, per)
        plain_bins = hist_kernel.bin_ranges_plain(stream, None, wl, 20, per)
        valid = int(plain_bins.starts[-1])
        flat = torch.where(stream[0] >= 0, stream[0].long(), 1 << wl)
        add("bin_ranges_words",
            timeit(lambda x: hist_kernel.bin_ranges(x, None, wl, 20, per),
                   stream).seconds_per_call,
            timeit(lambda x: hist_kernel.bin_ranges_plain(x, None, wl, 20,
                                                          per),
                   stream).seconds_per_call,
            timeit(lambda x: torch.sort(x), flat).seconds_per_call,
            n * 4 + valid * 4)
        add("bloom_ranges",
            time_prepared(lambda: (words.zero_(), bins)[1],
                          lambda b: hist_kernel._ranges_launch(
                              "bloom", b, blocks, words, None)),
            time_prepared(lambda: (words.zero_(), plain_bins)[1],
                          lambda b: hist_kernel.bloom_ranges_plain(
                              b, 1, wl, out=words)),
            0.0, valid * 4 + words.numel() * 4)
        extra["plain"] += timeit(lambda x: hist_kernel.bloom_words_plain(
            x, None, wl), stream).seconds_per_call
        extra["scatter_pack"] += timeit(lambda x: scatter_pack(x, wl),
                                        flat).seconds_per_call
        extra["bytes"] += n * 4 + words.numel() * 4
        del stream, bins, plain_bins, flat
        torch.cuda.empty_cache()
    print(f"[time] C1 at 2**{wl} as the Bloom path launches it (one stream "
          f"a batch, into words zeroed untimed before each call), over "
          f"{N_READS} reads: binned {routes['binned'] * 1e3:.4f} ms, direct "
          f"atomics (the old route) {routes['direct'] * 1e3:.4f} ms, in "
          f"turns; of the binned route the binning pass "
          f"{res['bin_ranges_words'][0] * 1e3:.4f} ms and the range pass "
          f"{res['bloom_ranges'][0] * 1e3:.4f} ms; plain "
          f"{extra['plain'] * 1e3:.4f} ms, scatter yardstick "
          f"{extra['scatter_pack'] * 1e3:.4f} ms, bound "
          f"{bound_ms(extra['bytes']):.4f} ms ({extra['bytes'] / 1e9:.4f} "
          f"GB) {tag}")
    for name in ("bin_ranges_words", "bloom_ranges"):
        k_s, p_s, lib_s, nbytes = res[name]
        lib = (f", library (torch.sort) {lib_s * 1e3:.4f} ms"
               if name.startswith("bin") else "")
        print(f"[time] {name} at 2**{wl} over {N_READS} reads: kernel "
              f"{k_s * 1e3:.4f} ms, plain {p_s * 1e3:.4f} ms{lib}, bound "
              f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e9:.4f} GB) {tag}")
    res["bloom_ranges"][2] = None
    del words
    torch.cuda.empty_cache()

    # phase 23's skewed streams at 2**20, binned against direct
    bucks = path_buckets(codes[:BATCH], WIDE, dev)[0]
    n = bucks.shape[1]
    for label, idx in (("(a) every entry one value",
                        torch.full_like(bucks, 12345)),
                       ("(b) one eighth of the entries one value",
                        bucks.clone().index_fill_(
                            1, torch.arange(0, n, 8, device=dev), 12345))):
        got = in_turns({r: (lambda x, r=r: hist_by(r, x, None, WIDE))
                        for r in ("binned", "direct")}, idx)
        require(torch.equal(hist_by("binned", idx, None, WIDE),
                            hist_by("direct", idx, None, WIDE)),
                f"skewed stream {label}: binned != direct")
        print(f"[time] skewed stream at 2**{WIDE}, batch 0's [{H}, {n}] "
              f"buckets, {label}: binned {got['binned'] * 1e3:.4f} ms, direct "
              f"{got['direct'] * 1e3:.4f} ms, in turns (results equal) {tag}")
        del idx
    del bucks
    torch.cuda.empty_cache()

    # the steps by the rule and by the rule without a binned route
    tm = prepare_codes(torch.from_numpy(codes[:BATCH]).to(dev))
    sk = cms.CountMinSketch.zeros(H, WIDE, dev)

    def direct_step(x):
        with direct_rule():
            fused_count_step(x, sk, K)

    steps = in_turns({"binned": lambda x: fused_count_step(x, sk, K),
                      "direct": direct_step}, tm)
    print(f"[time] fused_count_step k={K} h={H} 2**{WIDE}, one batch of "
          f"{BATCH} reads x {L} bp: by the rule (binned) "
          f"{steps['binned'] * 1e3:.4f} ms, by the rule without a binned "
          f"route (direct) {steps['direct'] * 1e3:.4f} ms, in turns {tag}")
    del tm, sk
    tms = bloom_tms(codes, dev)

    def bloom_step():
        bf = bloom.BloomFilter.zeros(30, device=dev)
        for t in tms:
            bloom.insert_from_buckets(
                bf, kmer_kernel.hash_kmers_tm_auto(t, K, H, emit_buckets=30),
                emitted_width_log2=30)

    def direct_bloom_step():
        with direct_rule():
            bloom_step()

    steps = in_turns({"binned": bloom_step, "direct": direct_bloom_step},
                     device=dev)
    print(f"[time] Bloom step at 2**30 (hash_kmers_tm_auto buckets + "
          f"insert_from_buckets), {N_READS} reads in {len(tms)} batches: by "
          f"the rule (binned) {steps['binned'] * 1e3:.4f} ms, by the rule "
          f"without a binned route (direct) {steps['direct'] * 1e3:.4f} ms, "
          f"in turns {tag}")
    del tms
    torch.cuda.empty_cache()

    time_clustered(codes, gen, dev, tag)

    # the rule's constants: updates a call from which binned beats direct,
    # at every width where the rule bins
    lost = []
    for kernel, wl, rows in BIN_SWEEP:
        cols = (1 << wl) if kernel == "A2" else (1 << wl) // 32
        table = torch.zeros((rows, cols), dtype=torch.int32, device=dev)
        by = hist_by if kernel == "A2" else words_by
        grid = (hist_kernel.binned_counts_grid if kernel == "A2"
                else hist_kernel.binned_words_grid)
        route = binned_route(rows, wl) if kernel == "A2" else "binned"
        rl = (hist_kernel.counts_range_log2(rows, wl) if kernel == "A2"
              else hist_kernel.WORDS_RANGE_LOG2)
        cells = []
        for total in (1 << 22, 1 << 23, 1 << 24, 1 << 25):
            x = torch.randint(0, min(1 << wl, (1 << 31) - 1),
                              (rows, total // rows), generator=gen,
                              device=dev, dtype=torch.int32)
            got = prepared_in_turns(
                lambda x=x: (table.zero_(), x)[1],
                {r: (lambda y, r=r: by(r, y, None, wl, out=table))
                 for r in (route, "direct")})
            rule = route if grid(rows, total // rows, wl)[0] else "direct"
            if rule == route and got[route] >= got["direct"]:
                lost.append(f"{kernel} [{rows}, n] at 2**{wl}, 2**"
                            f"{total.bit_length() - 1}")
            cells.append(f"2**{total.bit_length() - 1}: "
                         f"{got[route] * 1e3:.4f} / "
                         f"{got['direct'] * 1e3:.4f} ({rule})")
            del x
        print(f"[time] sweep, {kernel} [{rows}, n] at 2**{wl} (ranges "
              f"{hist_kernel.binned_ranges(rows, wl, rl)} of 2**{rl}), "
              f"updates a call: {route} / direct ms, in turns (the rule's "
              f"route): {'; '.join(cells)} {tag}")
        del table
        torch.cuda.empty_cache()
    print(f"[time] sweep: {len(BIN_SWEEP)} shapes x 4 sizes; where the rule "
          f"bins (binned or clustered), it lost at {lost or 'none'} {tag}")
    return res


# ---------------------------------------------- screening (phase 32) ----

#: The screening cell's configuration (portbench/configs/
#: ecoli_screen_seeds_k32.json): four spaced seeds of k=32 with 26 care
#: positions each, 4 hashes a seed, a 2**28-bit filter of the genome.
SCREEN_SEEDS = ("11101111110111011011101111110111",
                "11110111011110111101111011101111",
                "11111011111011100111011111011111",
                "11011110111101111110111101111011")
SCREEN_H, SCREEN_WL = 4, 28
#: Genome windows a row of the filter's build, as the screening cell's.
SCREEN_ROW = 256
SCREEN_N_RATE = 0.001


def phase_screen(gen, dev, card: str) -> dict:
    """Phase 32: screening at the cell's shape. The filter of a genome of
    ``GENOME`` bases, built as the cell builds it (rows of ``SCREEN_ROW``
    windows through B1 to buckets at 2**28, then ``insert_from_buckets``),
    against the plain hash -> plain insert, and with no false negative:
    the genome's own windows all hit under every seed. One batch of 2**18
    reads of that genome (0.25% substitutions, 0.1% N) through
    ``screen_reads``, with its launches (one B1, one probe); B1's buckets
    against ``hash_seeds_tm_plain`` and the probe's counts against
    ``probe_counts_plain`` on them, exactly. Timings of both kernels, their
    plain versions and byte bounds, and of ``screen_reads`` whole."""
    tag = f"[{card}]"
    errs = {"seed_hash_screen": 0.0, "bloom_probe": 0.0}
    s, wl = len(SCREEN_SEEDS), SCREEN_WL
    args = (SCREEN_SEEDS, SCREEN_H)
    genome = torch.randint(0, 4, (GENOME,), generator=gen, device=dev,
                           dtype=torch.uint8)
    rows = prepare_codes(kmer_kernel.sequence_rows(genome, K, SCREEN_ROW))
    reset_launches()
    sk.LAUNCHES = sk.LONG_LAUNCHES = 0
    bf = bloom.BloomFilter.zeros(wl, device=dev)
    bloom.insert_from_buckets(
        bf, sk.hash_seeds_tm_auto(rows, *args, emit_buckets=wl),
        emitted_width_log2=wl)
    build = {"seed_hash": sk.LAUNCHES, "seed_hash_long": sk.LONG_LAUNCHES,
             **hist_kernel.BLOOM_LAUNCHES,
             "bin_ranges_words": hist_kernel.BIN_LAUNCHES["bloom"],
             "bloom_ranges": hist_kernel.RANGE_LAUNCHES["bloom"]}
    want = torch.zeros_like(bf.words)
    for b in sk.hash_seeds_tm_plain(rows, *args, emit_buckets=wl):
        hist_kernel.bloom_words_plain(b, None, wl, out=want)
    require(torch.equal(bf.words, want),
            "the screening filter != plain hash -> plain insert")
    del want
    own = bloom.screen_reads(bf, rows, *args)
    windows = GENOME - K + 1
    require(bool((own.sum(1) == windows).all()),
            f"a false negative: the genome's {windows} windows hit "
            f"{own.sum(1).tolist()} times by seed")
    fill = fill_of(bf.words)
    print(f"[screen] filter of {GENOME} bases at 2**{wl}, {s} seeds x "
          f"{SCREEN_H} hashes: == plain hash -> plain insert, fill "
          f"{fill:.6f}; every genome window hits under every seed; build "
          f"launches {build}")
    del rows, own

    reads = genome_reads(gen, BATCH, dev, genome)
    reads = reads.masked_fill(torch.rand(reads.shape, generator=gen,
                                         device=dev) < SCREEN_N_RATE, 4)
    tm = prepare_codes(reads)
    del genome, reads
    sk.LAUNCHES = sk.LONG_LAUNCHES = probe_kernel.LAUNCHES = 0
    sk.ROUTE_LAUNCHES.update({"staged": 0, "global": 0})
    counts = bloom.screen_reads(bf, tm, *args)
    torch.cuda.synchronize()
    launches = {"seed_hash": sk.LAUNCHES, "seed_hash_long": sk.LONG_LAUNCHES,
                "staged": sk.ROUTE_LAUNCHES["staged"],
                "bloom_probe": probe_kernel.LAUNCHES}
    require(launches == {"seed_hash": 1, "seed_hash_long": 0, "staged": 1,
                         "bloom_probe": 1},
            f"screen_reads must launch B1 (staged) once and the probe once "
            f"a batch: {launches}")
    buckets = sk.hash_seeds_tm(tm, *args, emit_buckets=wl)
    same_outputs(errs, "seed_hash_screen", buckets,
                 sk.hash_seeds_tm_plain(tm, *args, emit_buckets=wl),
                 f"B1 buckets at 2**{wl}, [{L}, {BATCH}]")
    same_outputs(errs, "bloom_probe", [counts],
                 [probe_kernel.probe_counts_plain(buckets, bf.words, s,
                                                  SCREEN_H, wl)],
                 f"probe counts at 2**{wl}, [{s}, {BATCH}]")
    w = L - K + 1
    valid = int((buckets[0] < (1 << wl)).sum())
    share = [round(int(c) / valid, 6) for c in counts.sum(1)]
    print(f"[screen] one batch of {BATCH} genome reads x {L} bp "
          f"({SCREEN_N_RATE:.1%} N): launches {launches}; B1's "
          f"{s * SCREEN_H} bucket planes [{w}, {BATCH}] == plain, the probe's "
          f"counts == plain; hits a valid window by seed {share} "
          f"({valid} valid windows of {w * BATCH})")
    del counts

    acc = torch.zeros((s, BATCH), dtype=torch.int32, device=dev)
    times = {
        "seed_hash_screen": (
            timeit(lambda c: sk.hash_seeds_tm(c, *args, emit_buckets=wl),
                   tm).seconds_per_call,
            timeit(lambda c: sk.hash_seeds_tm_plain(c, *args,
                                                    emit_buckets=wl),
                   tm, calls=3).seconds_per_call,
            4 * L * BATCH + 4 * w * BATCH * s * SCREEN_H),
        "bloom_probe": (
            timeit(lambda b: probe_kernel.probe_counts(
                b, bf.words, s, SCREEN_H, wl, out=acc), buckets,
                device=dev).seconds_per_call,
            timeit(lambda b: probe_kernel.probe_counts_plain(
                b, bf.words, s, SCREEN_H, wl), buckets, calls=3,
                device=dev).seconds_per_call,
            4 * w * BATCH * s * SCREEN_H + 2 * 4 * s * BATCH
            + bf.words.numel() * 4),
    }
    del buckets
    torch.cuda.empty_cache()
    t_screen = timeit(lambda c: bloom.screen_reads(bf, c, *args, out=acc),
                      tm).seconds_per_call
    for name, (k_s, p_s, nbytes) in times.items():
        print(f"[time] {name} one batch [{L}, {BATCH}], {s} seeds x "
              f"{SCREEN_H} hashes at 2**{wl}: kernel {k_s * 1e3:.4f} ms, "
              f"plain {p_s * 1e3:.4f} ms, bound {bound_ms(nbytes):.4f} ms "
              f"({nbytes / 1e9:.4f} GB) {tag}")
    print(f"[time] screen_reads one batch: {t_screen * 1e3:.4f} ms, "
          f"{BATCH * L / t_screen:.6e} bases/s {tag}")
    return {"launches": launches, "errs": errs, "times": times}


# ------------------------------------------------- multi-GPU (phase 30) ----

#: Phase 18's filters that phase 30 unions across ranks.
DIST_BLOOM_WIDTHS = (20, 30)
#: The gloo groups that share the one card, and the sequence they hash.
DIST_WORLDS = (2, 4)
DIST_SP_LEN = 1 << 24
#: Modules whose ``*_plain`` functions phase 30 watches.
PLAIN_HOMES = (kmer_kernel, sk, hist_kernel, unpack_kernel, pk, sp)


@contextlib.contextmanager
def plain_guard():
    """Record every call of a plain version with a CUDA tensor argument
    while the block runs: the wrappers launch their kernels on the card, so
    a plain version there is a route that skipped its kernel."""
    calls, saved = [], []
    for mod in PLAIN_HOMES:
        for name, fn in list(vars(mod).items()):
            if not (name.endswith("_plain") and callable(fn)):
                continue

            def watched(*a, _fn=fn, _name=name, **kw):
                if any(isinstance(x, torch.Tensor) and x.is_cuda
                       for x in (*a, *kw.values())):
                    calls.append(_name)
                return _fn(*a, **kw)

            saved.append((mod, name, fn))
            setattr(mod, name, watched)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def reset_dist_launches() -> None:
    kmer_kernel.LAUNCHES = kmer_kernel.LONG_LAUNCHES = 0
    kmer_kernel.SEQUENCE_LAUNCHES = sk.SEQUENCE_LAUNCHES = 0
    reset_hist_launches()
    for name in hist_kernel.BLOOM_LAUNCHES:
        hist_kernel.BLOOM_LAUNCHES[name] = 0


def dist_launches() -> dict:
    return {"A1": kmer_kernel.LAUNCHES + kmer_kernel.LONG_LAUNCHES,
            "A2": hist_kernel.LAUNCHES,
            "C1": hist_kernel.BLOOM_LAUNCHES["bloom_words"],
            "sequence": kmer_kernel.SEQUENCE_LAUNCHES + sk.SEQUENCE_LAUNCHES}


def dist_count_and_filter(codes: np.ndarray, reads, dev):
    """This rank's blocks of the 1M reads, in batches of 2**18:
    ``dp.fused_count`` at 2**20 into one sketch, and a Bloom filter at
    2**20 of the same blocks (one C1 launch a batch) united across the
    ranks by ``union_across``."""
    sketch = cms.CountMinSketch.zeros(H, WIDE, dev)
    bf = bloom.BloomFilter.zeros(WIDE, dev)
    for s in range(0, codes.shape[0], BATCH):
        block = dp.shard_reads(torch.from_numpy(codes[s:s + BATCH]),
                               reads).to(dev)
        dp.fused_count(block, sketch, K, reads)
        bloom.insert_from_buckets(bf, kmer_kernel.hash_kmers_tm_auto(
            prepare_codes(block), K, H, emit_buckets=WIDE),
            emitted_width_log2=WIDE)
    return sketch, bloom.union_across(bf.words, reads)


def rank_worker(rank: int, world: int, tmp: Path) -> None:
    """One rank of a gloo group on the one card (CUDA tensors): its blocks
    of the 1M reads counted and filtered (phase 30's references: phase 9's
    sketch, phase 18's 2**20 filter) and its chunk of a 2**24-base
    sequence hashed (the one-device result); raises on any difference, on
    a plain version on the card, or on a kernel that never launched."""
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    mesh.initialize_distributed(
        "cuda", backend="gloo", rank=rank, world_size=world,
        store=dist.FileStore(str(tmp / f"gloo{world}.store"), world),
        timeout=datetime.timedelta(seconds=120))
    try:
        reads = mesh.device_mesh()
        seq_mesh = mesh.device_mesh(axis=mesh.SEQ_AXIS)
        codes = np.load(tmp / "dist_codes.npy")
        seq = torch.from_numpy(np.load(tmp / "dist_seq.npy")).to(dev)
        with plain_guard() as plain:
            reset_dist_launches()
            sketch, words = dist_count_and_filter(codes, reads, dev)
            chunk = sp.shard_sequence(seq, seq_mesh, k=K)
            hashes, valid = sp.hash_long_sequence(chunk, K, 1, seq_mesh)
            launches = dist_launches()
        c = chunk.shape[0]
        refs = {name: torch.from_numpy(np.load(tmp / f"dist_{name}.npy"))
                .to(dev) for name in ("sketch", "words", "hashes", "valid")}
        errs = {
            "dp.fused_count vs phase 9": max_abs_err(sketch.rows,
                                                      refs["sketch"]),
            "union_across 2**20 vs phase 18": max_abs_err(words,
                                                          refs["words"]),
            "sp hashes vs one device": max_abs_err(
                hashes[0], refs["hashes"][rank * c:(rank + 1) * c]),
            "sp valid vs one device": max_abs_err(
                valid, refs["valid"][rank * c:(rank + 1) * c])}
        print(f"[dist] gloo rank {rank}/{world} on one card: {errs}; "
              f"launches {launches}; plain versions on the card "
              f"{sorted(set(plain))}; {time.perf_counter() - t0:.3f} s",
              flush=True)
        require(not any(errs.values()), f"rank {rank}/{world}: {errs}")
        require(not plain, f"rank {rank}/{world}: plain versions ran on "
                f"the card: {sorted(set(plain))}")
        require(all(v > 0 for v in launches.values()),
                f"rank {rank}/{world}: a kernel never launched: {launches}")
    finally:
        dist.destroy_process_group()


def run_rank_groups(tmp: Path) -> None:
    """Start the gloo groups of DIST_WORLDS ranks together, every rank a
    process of this script on the one card, after the kernels are built;
    wait for all, print each rank's line, fail if any rank failed."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [(world, subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), str(world), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)) for world in DIST_WORLDS for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for _, p in procs]
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (world, p), out in zip(procs, outs):
        print(out.rstrip() if p.returncode == 0 else
              f"[dist] a rank of {world} failed (exit {p.returncode}):\n{out}")
    require(all(p.returncode == 0 for _, p in procs),
            "a rank of a gloo group failed")


def phase_distributed(rng, codes: np.ndarray, path: Path, tmp, wide_ref,
                      filters: dict, seq_keep: dict, dev, card: str) -> None:
    """Phase 30: the distributed paths. A real NCCL group of world size 1
    (a FileStore in the run's temporary directory, no port): ``count_file``
    at ``PipelineConfig(n_devices=1)`` over the 1M reads against phase 9's
    sketch; ``dp.fused_count`` and ``hash_and_sketch(time_major=True)`` on
    one 2**18 batch against ``fused_count_step`` and the one-device step;
    the 1M reads by ``dp.fused_count`` and their 2**20 filter through
    ``union_across`` against phases 9 and 18; ``union_across`` of phase
    18's 2**30 filter; ``sp.hash_long_sequence`` (2**27 bases) and
    ``_seeds`` (2**25) over the mesh against phase 16. No plain version may
    run on the card, and every kernel of the path must launch. Then gloo
    groups of 2 and 4 ranks on the one card (CUDA tensors), each rank a
    process; times: the all-reduce of the 2**20 sketch, the dp step per
    2**18 batch beside ``fused_count_step`` in turns, ``union_across`` at
    2**30. Ends by destroying the group."""
    tag = f"[{card}]"
    tmp = Path(tmp)
    errs = {}

    def same(name, got, want):
        torch.cuda.synchronize()
        errs[name] = max(errs.get(name, 0.0), max_abs_err(got, want))
        require(torch.equal(got, want), f"phase 30: {name}: max_abs_err "
                f"{errs[name]}")

    mesh.initialize_distributed(
        "cuda", store=dist.FileStore(str(tmp / "nccl.store"), 1), rank=0,
        world_size=1)
    try:
        require(dist.get_backend() == "nccl", "phase 30: not an NCCL group")
        reads = mesh.device_mesh(1)
        seq_mesh = mesh.device_mesh(1, mesh.SEQ_AXIS)
        zeros = (lambda: cms.CountMinSketch.zeros(H, WIDE, dev))
        with plain_guard() as plain:
            reset_dist_launches()
            pipe = ReadHashingPipeline(PipelineConfig(n_devices=1), device=dev)
            require(pipe.mesh is not None and pipe.n_devices == 1,
                    "phase 30: the pipeline formed no mesh")
            require(pipe.count_file(path) == N_READS, "phase 30: reads")
            same("count_file (NCCL, world 1) vs phase 9", pipe.sketch.rows,
                 wide_ref)
            path_launches = dist_launches()
            del pipe
            batch = torch.from_numpy(codes[:BATCH]).to(dev)
            same("dp.fused_count vs fused_count_step, one 2**18 batch",
                 dp.fused_count(dp.shard_reads(batch, reads), zeros(), K,
                                reads).rows,
                 fused_count_step(prepare_codes(batch), zeros(), K).rows)
            got = dp.hash_and_sketch(batch, zeros(), K, H, WIDE, reads,
                                     time_major=True)
            want = dp.hash_and_sketch(batch, zeros(), K, H, WIDE, None,
                                      time_major=True)
            for i in range(H):
                same("hash_and_sketch hashes vs the one-device step",
                     got[0][i], want[0][i])
            same("hash_and_sketch valid vs the one-device step", got[1],
                 want[1])
            same("hash_and_sketch sketch vs the one-device step",
                 got[2].rows, want[2].rows)
            del got, want
            sketch, words = dist_count_and_filter(codes, reads, dev)
            same("dp.fused_count over the 1M reads vs phase 9", sketch.rows,
                 wide_ref)
            same("union_across of the 2**20 filter vs phase 18", words,
                 filters[20])
            same("union_across at 2**30 vs phase 18",
                 bloom.union_across(filters[30], reads), filters[30])
            del sketch, words
            for name, (seq, want_h, want_v) in seq_keep.items():
                k = K if name == "kmer_sequence" else len(SEEDS[0])
                chunk = sp.shard_sequence(seq, seq_mesh, k=k)
                got_h, got_v = (
                    sp.hash_long_sequence(chunk, k, 1, seq_mesh)
                    if name == "kmer_sequence" else
                    sp.hash_long_sequence_seeds(chunk, SEEDS, 1, seq_mesh))
                same(f"sp {name} over the mesh vs phase 16", got_h[0],
                     want_h[0])
                same(f"sp {name} valid vs phase 16", got_v, want_v)
                del got_h, got_v
            launches = dist_launches()
        require(not plain, "phase 30: plain versions ran on the card: "
                f"{sorted(set(plain))}")
        require(all(v > 0 for v in launches.values()),
                f"phase 30: a kernel never launched: {launches}")
        print(f"[dist] NCCL world 1, {N_READS} reads k={K} h={H} 2**{WIDE}: "
              f"count_file == phase 9 (launches {path_launches}); every "
              f"comparison exact: {errs}; launches in the phase {launches}; "
              "no plain version on the card")
        # the gloo groups on the one card: their inputs and references
        seq = rng.integers(0, 5, size=DIST_SP_LEN, dtype=np.uint8)
        hashes, valid = sp.hash_long_sequence(torch.from_numpy(seq).to(dev),
                                              K, 1)
        for name, arr in (("codes", codes), ("seq", seq),
                          ("sketch", wide_ref), ("words", filters[20]),
                          ("hashes", hashes[0]), ("valid", valid)):
            np.save(tmp / f"dist_{name}.npy", arr if isinstance(
                arr, np.ndarray) else arr.cpu().numpy())
        del hashes, valid
        t0 = time.perf_counter()
        run_rank_groups(tmp)
        print(f"[dist] gloo groups of {DIST_WORLDS} ranks on the one card "
              f"(CUDA tensors; gloo took every all-reduce and all-gather on "
              f"them, so none was staged through the host): every rank == "
              f"the one-device results; {time.perf_counter() - t0:.3f} s")
        # times on the card, over the NCCL group of one
        buf = torch.zeros((H, 1 << WIDE), dtype=torch.int32, device=dev)
        t_ar = timeit(lambda x: mesh.all_reduce_sum(x, reads),
                      buf).seconds_per_call
        sk_t = zeros()
        t = in_turns({
            "dp.fused_count": lambda b: dp.fused_count(b, sk_t, K, reads),
            "fused_count_step": lambda b: fused_count_step(
                prepare_codes(b), sk_t, K)}, batch)
        t_union = timeit(lambda w: bloom.union_across(w, reads),
                         filters[30]).seconds_per_call
        print(f"[time] NCCL world 1: all_reduce of the {H} x 2**{WIDE} int32 "
              f"sketch ({buf.numel() * 4 / 1e6:.1f} MB) {t_ar * 1e3:.4f} ms; "
              f"per 2**18-read batch at 2**{WIDE}: dp.fused_count "
              f"{t['dp.fused_count'] * 1e3:.4f} ms, fused_count_step "
              f"{t['fused_count_step'] * 1e3:.4f} ms (in turns); "
              f"union_across at 2**30 ({filters[30].numel() * 4 / 1e6:.1f} "
              f"MB of words) {t_union * 1e3:.4f} ms {tag}")
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank", nargs=3, metavar=("RANK", "WORLD", "DIR"),
                    help="run one rank of phase 30's gloo groups (the "
                    "script starts them itself)")
    args = ap.parse_args()
    if args.rank:
        rank_worker(int(args.rank[0]), int(args.rank[1]), Path(args.rank[2]))
        return
    rng = np.random.default_rng(args.seed)

    t_start = time.perf_counter()

    def run(label, fn, *a):
        """Run one phase and print its wall time, so a slower run shows
        which phase grew."""
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"[phase] {label}: {time.perf_counter() - t0:.3f} s")
        return out

    smi, card = run("1 environment", phase_env)
    dev = torch.device("cuda", 0)
    run("2 build", phase_build)
    run("3 goldens", phase_golden, dev)
    codes = make_codes(rng, N_READS)
    k_err, h_err = run("4 kernels vs plain", phase_kernels_vs_plain, rng,
                       codes, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    h_err = max(h_err, run("22 histogram routes vs plain",
                           phase_hist_route_checks, codes, gen, dev))
    part_errs = run("8 partition widths", phase_partition_widths, rng, dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "reads.fq"
        write_fastq(path, codes)
        pipe, launches = run("5 path at 2**14", phase_main_path, codes,
                             path, dev)
        refs = {WLOG: pipe.sketch.rows.clone()}   # == the plain count
        times = run("6 timings at 2**14", phase_timings, codes, path, pipe,
                    dev, smi)
        run("7 trace at 2**14", phase_trace, path, pipe, dev, smi)
        del pipe
        torch.cuda.empty_cache()
        pipe, part_launches, batches = run("9 path at 2**20",
                                           phase_main_wide, codes, path, dev,
                                           part_errs)
        refs[WIDE] = pipe.sketch.rows.clone()    # == the plain count
        wide = run("10 timings at 2**20", phase_wide_timings, codes, path,
                   pipe, batches, dev, smi, part_errs)
        del pipe, batches
        torch.cuda.empty_cache()
        errs = run("11 edge shapes", phase_edges, gen, dev)
        run("12 seed goldens", phase_seed_goldens, dev)
        seed_errs, seeds = run("13 seeds", phase_seeds, codes, gen, dev, smi)
        long_errs, long_launches, t_long = run(
            "14 long reads", phase_long_count, rng, Path(tmp), dev, smi)
        run("15 crossover", phase_crossover, gen, dev, smi)
        seq_errs, sp_launches, seq_times, seq_keep = run(
            "16 sequences", phase_sp, rng, dev, smi)
        bloom_errs = run("17 Bloom edge shapes", phase_bloom_edges, gen, dev)
        bloom_launches, filters = run("18 Bloom path", phase_bloom_path,
                                      codes, dev, bloom_errs)
        bloom_times = run("19 Bloom timings", phase_bloom_timings, codes, dev,
                          smi)
        new_errs = run("20 redesigned kernels vs plain",
                       phase_redesign_checks, codes, gen, dev)
        run("21 redesigned kernels' timings", phase_redesign_timings, codes,
            gen, dev, smi)
        run("23 histogram routes' timings", phase_hist_route_timings, codes,
            gen, dev, smi)
        unpack = run("24 unpack vs plain", phase_unpack, rng, gen, codes, dev,
                     smi)
        unpack["launches"] = run("25 count_file routes", phase_routes, codes,
                                 path, Path(tmp) / "long.fq", refs, dev, smi)
        wide_ref = refs[WIDE]
        del refs
        torch.cuda.empty_cache()
        fr_errs, fr_times = run("26 sequence entries with fwd/rev",
                                phase_fwd_rev, rng, dev, smi)
        fr_launches = run("27 the facade", phase_facade, rng, dev, smi)
        run("28 the facade's threshold", phase_threshold, rng, dev, smi)
        blind_errs, blind_launches, blind_times = run(
            "29 blind scans", phase_blind, rng, gen, dev, smi)
        binned_errs = run("31 binned routes vs plain", phase_binned_checks,
                          codes, gen, dev)
        binned = run("31 binned routes' timings", phase_binned_timings, codes,
                     gen, dev, smi)
        screen = run("32 screening", phase_screen, gen, dev, smi)
        run("30 multi-GPU", phase_distributed, rng, codes, path, tmp,
            wide_ref, filters, seq_keep, dev, smi)
        del codes, wide_ref, filters, seq_keep
    bloom_errs["bloom_words_rows"] = max(bloom_errs["bloom_words_rows"],
                                         new_errs["bloom_words_rows"])
    for name in ("sort_tiles", "merge_phase"):
        part_errs[name] = max(part_errs[name], new_errs[name])
    print(f"[phase] all: {time.perf_counter() - t_start:.3f} s")
    for more in (seed_errs, long_errs):
        for name, e in more.items():
            errs[name] = max(errs[name], e)

    w = L - K + 1
    t_kmer = times[f"kmer_hash k={K} h={H} buckets 2**{WLOG} {N_READS}x{L}"]
    t_hist = times["histogram"]
    kmer_bytes = (L + H * w) * N_READS * 4
    hist_bytes = times["histogram bytes"]
    kernels = [
        {"name": "kmer_hash", "route": "cuda",
         "source": "nthash_tpu_torch/csrc/kmer_hash.cu",
         "replaces": "nthash_tpu/ops/kmer_pallas.py:72",
         "launches": launches["kmer_hash"], "max_abs_err": k_err,
         "ms": t_kmer[0] * 1e3, "plain_ms": t_kmer[1] * 1e3,
         "bound_ms": bound_ms(kmer_bytes), "bound_by": "bytes",
         "library_ms": None},
        {"name": "histogram", "route": "cuda",
         "source": "nthash_tpu_torch/csrc/histogram.cu",
         "replaces": "nthash_tpu/ops/hist_pallas.py:133",
         "launches": launches["histogram"], "max_abs_err": h_err,
         "ms": t_hist[0] * 1e3, "plain_ms": t_hist[1] * 1e3,
         "bound_ms": bound_ms(hist_bytes), "bound_by": "bytes",
         "library_ms": times["library histogram"] * 1e3},
    ]
    replaces = {"sort_tiles": "nthash_tpu/ops/part_pallas.py:255",
                "merge_phase": "nthash_tpu/ops/part_pallas.py:283",
                "partition_bounds": "nthash_tpu/ops/part_pallas.py:255",
                "windows": "nthash_tpu/ops/part_pallas.py:385"}
    for name in PART_KERNELS:
        k_s, p_s, lib_s, nbytes = wide[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nthash_tpu_torch/csrc/partition.cu",
            "replaces": replaces[name], "launches": part_launches[name],
            "max_abs_err": part_errs[name], "ms": k_s * 1e3,
            "plain_ms": p_s * 1e3, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes",
            "library_ms": None if lib_s is None else lib_s * 1e3})
    slice3 = {
        "kmer_hash_long": ("nthash_tpu_torch/csrc/kmer_hash.cu",
                           "nthash_tpu/ops/kmer_pallas.py:230",
                           long_launches["kmer_hash_long"], t_long),
        "seed_hash": ("nthash_tpu_torch/csrc/seed_hash.cu",
                      "nthash_tpu/ops/seed_pallas.py:105",
                      seeds["launches"]["seed_hash"],
                      seeds["times"]["seed_hash"]),
        "seed_hash_long": ("nthash_tpu_torch/csrc/seed_hash.cu",
                           "nthash_tpu/ops/seed_pallas.py:264",
                           seeds["launches"]["seed_hash_long"],
                           seeds["times"]["seed_hash_long"]),
    }
    for name, (source, replaces, n, (k_s, p_s, nbytes)) in slice3.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": errs[name],
            "ms": k_s * 1e3, "plain_ms": p_s * 1e3,
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": None})
    slice4 = {
        "bloom_words": ("nthash_tpu/ops/hist_pallas.py:157",
                        "bloom_words at 2**17 (one launch a batch"),
        "bloom_words_rows": ("nthash_tpu/ops/hist_pallas.py:296",
                             "bloom_words_rows at 2**20 (128 rows at 2**13)"),
    }
    for name, (replaces, row) in slice4.items():
        k_s, p_s, _, nbytes = next(v for key, v in bloom_times.items()
                                   if key.startswith(row))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nthash_tpu_torch/csrc/bloom.cu", "replaces": replaces,
            "launches": bloom_launches[name], "max_abs_err": bloom_errs[name],
            "ms": k_s * 1e3, "plain_ms": p_s * 1e3,
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": None})
    for name, replaces in (("kmer_sequence", "nthash_tpu/ops/kmer_pallas.py:72"),
                           ("seed_sequence", "nthash_tpu/ops/seed_pallas.py:105")):
        k_s, p_s, nbytes = seq_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"nthash_tpu_torch/csrc/{name.split('_')[0]}_hash.cu",
            "replaces": replaces, "launches": sp_launches[name],
            "max_abs_err": seq_errs[name], "ms": k_s * 1e3,
            "plain_ms": p_s * 1e3, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes", "library_ms": None})
    kernels.append({
        "name": "unpack_codes", "route": "cuda",
        "source": "nthash_tpu_torch/csrc/unpack.cu",
        "replaces": "nthash_tpu/parallel/dp.py:86",
        "launches": unpack["launches"], "max_abs_err": unpack["err"],
        "ms": unpack["ms"], "plain_ms": unpack["plain_ms"],
        "bound_ms": unpack["bound_ms"], "bound_by": "bytes",
        "library_ms": None})
    for name, source, replaces, n, err, (k_s, p_s, nbytes) in (
            ("kmer_sequence_fwd_rev", "nthash_tpu_torch/csrc/kmer_hash.cu",
             "nthash_tpu/ops/kmer_pallas.py:72", fr_launches["kmer"],
             fr_errs["kmer_sequence_fwd_rev"],
             fr_times["kmer_sequence_fwd_rev"]),
            ("seed_sequence_fwd_rev", "nthash_tpu_torch/csrc/seed_hash.cu",
             "nthash_tpu/ops/seed_pallas.py:105", fr_launches["seed"],
             fr_errs["seed_sequence_fwd_rev"],
             fr_times["seed_sequence_fwd_rev"]),
            ("blind_roll_many", "nthash_tpu_torch/csrc/blind.cu",
             "nthash_tpu/ops/blind_scan.py:99",
             blind_launches["blind_roll_many"],
             blind_errs["blind_roll_many"], blind_times["blind_roll_many"]),
            ("blind_seed_roll_many", "nthash_tpu_torch/csrc/blind.cu",
             "nthash_tpu/ops/blind_seed_scan.py:141",
             blind_launches["blind_seed_roll_many"],
             blind_errs["blind_seed_roll_many"],
             blind_times["blind_seed_roll_many"])):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": k_s * 1e3, "plain_ms": p_s * 1e3,
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": None})
    for name, source, replaces, n in (
            ("bin_ranges_counts", "nthash_tpu_torch/csrc/bin.cuh",
             "nthash_tpu/ops/hist_pallas.py:133",
             part_launches["bin_ranges_counts"]),
            ("histogram_ranges", "nthash_tpu_torch/csrc/histogram.cu",
             "nthash_tpu/ops/hist_pallas.py:133",
             part_launches["histogram_ranges"]),
            ("bin_ranges_words", "nthash_tpu_torch/csrc/bin.cuh",
             "nthash_tpu/ops/hist_pallas.py:157",
             bloom_launches["bin_ranges_words"]),
            ("bloom_ranges", "nthash_tpu_torch/csrc/bloom.cu",
             "nthash_tpu/ops/hist_pallas.py:157",
             bloom_launches["bloom_ranges"])):
        k_s, p_s, lib_s, nbytes = binned[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": binned_errs[name], "ms": k_s * 1e3,
            "plain_ms": p_s * 1e3, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes",
            "library_ms": None if lib_s is None else lib_s * 1e3})
    for name, replaces in (
            ("seed_hash_screen", "nthash_tpu/ops/seed_pallas.py:105"),
            ("bloom_probe", "nthash_tpu/models/bloom.py:162")):
        k_s, p_s, nbytes = screen["times"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("nthash_tpu_torch/csrc/seed_hash.cu"
                       if name.startswith("seed") else
                       "nthash_tpu_torch/csrc/probe.cu"),
            "replaces": replaces,
            "launches": screen["launches"][name.removesuffix("_screen")],
            "max_abs_err": screen["errs"][name], "ms": k_s * 1e3,
            "plain_ms": p_s * 1e3, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes", "library_ms": None})
    print(f"[sp] launches on the one-sequence path: {sp_launches}")
    for row in kernels:
        if "_sequence" in row["name"]:
            print(f"[share] {row['name']}: {row['ms']:.4f} ms against a bound "
                  f"of {row['bound_ms']:.4f} ms: {row['bound_ms'] / row['ms']:.4f} "
                  f"of its bound [{smi}]")
    require(all(k["launches"] > 0 for k in kernels),
            "a kernel of the kernels line never launched: "
            f"{[(k['name'], k['launches']) for k in kernels]}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
