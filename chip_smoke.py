"""The port's kernel table on one GPU: each kernel of PERF.md section 6 alone.

    python3 chip_smoke.py [--seed N]

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and nvcc; it
imports nothing of JAX. It prints the card's name and power limit, then one
line a path (``PATHS``): an entry of the package run at its default shape
with every launch counter set to 0 just before (``count_file`` over 1M
reads at 2**14 and 2**20, the Bloom path at 2**17 and 2**30, the
partitioned routes at 2**20, the count-min, screening and host screening
cells' steps),
its output against the plain chain and the launches of the kernels it
covers. Then one line a kernel (``ROWS``, at the shapes the table records):
the kernel, its plain PyTorch version and its library call where the table
has one, each timed alone with CUDA events, in turns (kernel, plain,
library, library, plain, kernel; a part's median of 5 or 3 calls after a
warm-up, the mean of the two rounds, summed over the parts of a row); the
least time its bytes take at the card's memory rate
(``portbench/core/bounds.py``); the largest difference of its output from
the plain version's on the same inputs (``max_abs_err``); its launches,
those of the path that covers it, else of one call with the counters at 0.
The line before the last is ``{"kernels": [...]}`` (28 entries), the last
``{"ok": ..., "device": ...}``; the exit code is 1 where an error is not 0
or a kernel never launched. The checks of each kernel's edges live in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from functools import cache, cached_property, reduce
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from nthash_tpu_torch.io.stream import pack_codes, packed_shapes
from nthash_tpu_torch.models import bloom
from nthash_tpu_torch.models.pipeline import (
    PipelineConfig,
    ReadHashingPipeline,
    fused_count_step,
)
from nthash_tpu_torch.models.sketch import CountMinSketch
from nthash_tpu_torch.ops import (
    blind_scan,
    blind_seed_scan,
    hist_kernel,
    kmer_kernel,
    probe_kernel,
    unpack_kernel,
)
from nthash_tpu_torch.ops import part_kernel as pk
from nthash_tpu_torch.ops import seed_kernel as sk
from nthash_tpu_torch.ops.kmer_kernel import (
    hash_kmers_tm,
    hash_kmers_tm_plain,
    prepare_codes,
)
from nthash_tpu_torch.parallel import sp
from nthash_tpu_torch.u64 import to_numpy_u64
from portbench.core.bounds import hbm_bytes_per_s

K, H, L = 32, 4, 150
N_READS, BATCH = 1_000_000, 1 << 18
N_RATE = 0.01                       # N bases in the random reads
WLOG, WIDE = 14, 20                 # the sketch's widths: 2**14, PipelineConfig()'s
LONG_L, LONG_READS = 10_000, 16_384
SEEDS, SEED_H = ("10101", "11011"), 3          # BASELINE.json's spaced seeds
SP_LEN, SP_SEED_LEN = 1 << 27, 1 << 25
WALKS, SEED_WALKS, STEPS = 1 << 20, 1 << 18, 64
#: The screening cell's configuration (portbench/configs/
#: ecoli_screen_seeds_k32.json): four spaced seeds of k=32, 4 hashes a
#: seed, a 2**28-bit filter of a genome of E. coli K-12 MG1655's length.
SCREEN_SEEDS = ("11101111110111011011101111110111",
                "11110111011110111101111011101111",
                "11111011111011100111011111011111",
                "11011110111101111110111101111011")
SCREEN_H, SCREEN_WL, GENOME = 4, 28, 4_641_652
#: The host screening cell's width (portbench/configs/
#: grch38_screen_seeds_k32.json): 2**37 bits, 16 GiB of words.
HOST_WL = 37
CMS_WL = 28                         # the count-min cell's width: 4 x 2**28


@dataclass
class Part:
    """One timed call of a row: the kernel and its plain version on
    ``args()`` (made untimed before each call; ``fresh()`` makes the error
    check's where ``args`` reuses state that the calls accumulate into), the
    library call on inputs of its own."""

    kernel: Callable
    plain: Callable
    library: Callable | None = None
    args: Callable[[], tuple] = tuple
    fresh: Callable[[], tuple] | None = None


@dataclass
class Case:
    """A row's calls (one part, or one a batch of the 1M reads), the bytes
    they must move, how two outputs differ (0 when equal), and what the
    row reports beside its times (read after them)."""

    parts: list[Part]
    nbytes: int
    diff: Callable | None = None
    notes: Callable[[], dict] | None = None


def max_abs_err(a, b) -> float:
    """Largest |a - b| over tensors or nested sequences of them; int64
    tensors are compared as the uint64 they hold."""
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        if torch.equal(a, b):
            return 0.0
        if a.dtype == torch.int64:
            x, y = to_numpy_u64(a), to_numpy_u64(b)
            return float(np.where(x > y, x - y, y - x).max(initial=0))
        return float((a.long() - b.long()).abs().max())
    if len(a) != len(b):
        return float("inf")
    return max((max_abs_err(x, y) for x, y in zip(a, b)), default=0.0)


def bins_err(got, want) -> float:
    """A binning pass (``hist_kernel.Bins``) against the plain one: counts,
    starts and blocks, and each range's staged offsets as a multiset (the
    order inside a range is free; ``hist_kernel.staged`` reads a paged
    stage in range order)."""
    rl = want.range_log2
    rid = torch.repeat_interleave(
        torch.arange(want.counts.numel(), device=want.counts.device),
        want.counts)
    return max(max_abs_err(list(got[:3]), list(want[:3])), max_abs_err(*(
        torch.sort((rid << rl) | (hist_kernel.staged(b).long()
                                  & ((1 << rl) - 1))).values
        for b in (got, want))))


def kernel_ms(fns, calls: int = 5) -> dict:
    """Device ms of each kernel that the calls ``fns`` run, summed over
    them, a call's mean over ``calls`` rounds after a warm-up, from
    ``torch.profiler``'s device rows: ``{"<name>_ms": ms}``, <name> the
    kernel's name without namespace, template or arguments."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        m = re.search(r"(\w+_kernel)[<(]", e.key)
        us = getattr(e, "self_device_time_total", 0)
        if m and us:
            key = f"{m.group(1)}_ms"
            out[key] = out.get(key, 0.0) + us / 1e3 / calls
    return out


def time_ms(fn, args, calls: int) -> float:
    """Median ms of ``fn(*args())`` over ``calls`` calls after a warm-up,
    each call between two CUDA events, ``args()`` outside them."""
    fn(*args())
    events = []
    for _ in range(calls):
        a = args()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*a)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def in_turns(part: Part, rounds: int = 2) -> dict:
    """ms of the part's kernel, plain version and library call, in turns
    (A B C, then C B A, ...): the mean over the rounds."""
    fns = {"kernel": (part.kernel, part.args, 5),
           "plain": (part.plain, part.args, 3)}
    if part.library:
        fns["library"] = (part.library, tuple, 5)
    got = {name: [] for name in fns}
    for i in range(rounds):
        for name in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            # no empty_cache() here: allocations the timed calls make
            # anew after one read ~15% slower on short kernels
            got[name].append(time_ms(*fns[name]))
    return {name: statistics.mean(v) for name, v in got.items()}


def make_codes(rng, n: int, length: int) -> np.ndarray:
    codes = rng.integers(0, 4, size=(n, length), dtype=np.uint8)
    codes[rng.random((n, length)) < N_RATE] = 4
    return codes


class Inputs:
    """The rows' and paths' inputs on the card, each made once from the
    seed; ``tmp`` holds the reads' FASTQ file."""

    def __init__(self, seed: int, dev, tmp: Path):
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.dev = dev
        self.tmp = tmp
        self.codes = make_codes(self.rng, N_READS, L)

    @cached_property
    def tm(self):
        """The 1M reads' time-major codes, [L, N]."""
        return prepare_codes(torch.from_numpy(self.codes).to(self.dev))

    @cached_property
    def tms(self):
        """The 1M reads in batches of 2**18, as the main path feeds them."""
        return [prepare_codes(torch.from_numpy(self.codes[s:s + BATCH])
                              .to(self.dev))
                for s in range(0, N_READS, BATCH)]

    @cached_property
    def fastq(self) -> Path:
        """The 1M reads as a FASTQ file, a record a read."""
        rec = np.empty((N_READS, 2 * L + 7), dtype=np.uint8)
        rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
        rec[:, 3:3 + L] = np.frombuffer(b"ACGTN", np.uint8)[self.codes]
        rec[:, 3 + L:6 + L] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, 6 + L:-1] = ord("I")
        rec[:, -1] = ord("\n")
        path = self.tmp / "reads.fq"
        path.write_bytes(rec.tobytes())
        return path

    def buckets(self, wl: int) -> list:
        """A batch's buckets at 2**wl as the one [H, n] view the hash
        kernel writes, a batch."""
        return [hist_kernel.rows_view(hash_kmers_tm(tm, K, H, emit_buckets=wl))
                for tm in self.tms]

    @cache
    def plain_count(self, wl: int):
        """The plain hash -> count of the 1M reads at 2**wl, int64."""
        want = torch.zeros((H, 1 << wl), dtype=torch.int64, device=self.dev)
        for tm in self.tms:
            for r, b in enumerate(hash_kmers_tm_plain(tm, K, H,
                                                      emit_buckets=wl)):
                want[r] += hist_kernel.histogram_rows_plain(
                    b.reshape(1, -1), None, wl)[0]
        return want

    @cache
    def plain_words(self, wl: int):
        """The plain hash -> Bloom words of the 1M reads at 2**wl."""
        want = torch.zeros((1 << wl) // 32, dtype=torch.int32, device=self.dev)
        for tm in self.tms:
            for b in hash_kmers_tm_plain(tm, K, H, emit_buckets=wl):
                hist_kernel.bloom_words_plain(b, None, wl, out=want)
        return want

    def sequence(self, n: int):
        return torch.from_numpy(self.rng.integers(0, 4, size=n,
                                                  dtype=np.uint8)).to(self.dev)

    def randint(self, hi: int, shape, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=self.gen,
                             device=self.dev, dtype=dtype)

    @cached_property
    def genome(self):
        """A random genome of E. coli K-12 MG1655's length."""
        return self.randint(4, (GENOME,), torch.uint8)

    @cached_property
    def genome_tm(self):
        """The cells' kind of batch: 2**18 reads of the genome from both
        strands (0.25% substitutions, 0.1% N), time-major."""
        genome = self.genome
        start = self.randint(GENOME - L + 1, (BATCH, 1), torch.int64)
        reads = genome[start + torch.arange(L, device=self.dev)]
        minus = torch.rand(BATCH, generator=self.gen, device=self.dev) < 0.5
        reads = torch.where(minus[:, None], (3 - reads).flip(1), reads)
        noise = torch.rand((2, BATCH, L), generator=self.gen, device=self.dev)
        reads = torch.where(noise[0] < 0.0025,
                            (reads + self.randint(3, (BATCH, L), torch.uint8)
                             + 1) % 4, reads).masked_fill(noise[1] < 0.001, 4)
        return prepare_codes(reads)

    @cached_property
    def genome_rows(self):
        """The genome cut into rows of 256 windows, as the screening cell
        hashes it into its filter."""
        return prepare_codes(kmer_kernel.sequence_rows(self.genome, K, 256))

    @cached_property
    def screen(self):
        """The screening cell's filter at 2**28 under the four seeds (B1
        over the genome's rows, then ``insert_from_buckets``) and the
        batch's buckets."""
        bf = bloom.insert_from_buckets(
            bloom.BloomFilter.zeros(SCREEN_WL, device=self.dev),
            sk.hash_seeds_tm_auto(self.genome_rows, SCREEN_SEEDS, SCREEN_H,
                                  emit_buckets=SCREEN_WL),
            emitted_width_log2=SCREEN_WL)
        return bf, sk.hash_seeds_tm(self.genome_tm, SCREEN_SEEDS, SCREEN_H,
                                    emit_buckets=SCREEN_WL)


    @cached_property
    def host(self):
        """A filter at the host screening cell's 2**37 bits of the genome
        under the four seeds (``insert_sequence_seeds``: B1's wide buckets,
        then C1's wide route) and the batch's int64 buckets at that
        width. The genome is E. coli's length, so the filter is far
        emptier than the cell's and a batch probes fewer distinct sectors
        of it (PERF.md section 6)."""
        bf = bloom.insert_sequence_seeds(
            bloom.BloomFilter.zeros(HOST_WL, device=self.dev), self.genome,
            SCREEN_SEEDS, SCREEN_H)
        return bf, sk.hash_seeds_tm(self.genome_tm, SCREEN_SEEDS, SCREEN_H,
                                    emit_buckets=HOST_WL)


def one(kernel, plain, nbytes, library=None, **kw) -> Case:
    return Case([Part(kernel, plain, library, **kw)], nbytes)


# ---------------------------------------------------------------- rows ----

def row_kmer_hash(x: Inputs) -> Case:
    """A1, buckets at 2**14, over the 1M reads in one launch."""
    tm, w = x.tm, L - K + 1
    return one(lambda: hash_kmers_tm(tm, K, H, emit_buckets=WLOG),
               lambda: hash_kmers_tm_plain(tm, K, H, emit_buckets=WLOG),
               (L + H * w) * N_READS * 4)


def row_histogram(x: Inputs) -> Case:
    """A2 as the 2**14 path launches it: one [H, n] launch a batch;
    ``torch.bincount`` over row * (width + 1) + bucket (prepared untimed)."""
    parts, nbytes = [], 0
    for idx in x.buckets(WLOG):
        spare = (idx.long() + torch.arange(H, device=x.dev)[:, None]
                 * ((1 << WLOG) + 1)).reshape(-1)
        parts.append(Part(
            lambda i=idx: hist_kernel.histogram_rows(i, None, WLOG),
            lambda i=idx: hist_kernel.histogram_rows_plain(i, None, WLOG),
            lambda s=spare: torch.bincount(s, minlength=H * ((1 << WLOG) + 1))))
        nbytes += idx.numel() * 4 + H * (1 << WLOG) * 4
    return Case(parts, nbytes)


def plan_chunks(x: Inputs) -> list:
    """The 2**20 path's buckets of a batch, padded to the plan's chunks."""
    rows = pk.plan(WIDE)[2]
    return [pk._pad_chunks(idx, 1 << WIDE, rows * pk.LANES)
            for idx in x.buckets(WIDE)]


def row_sort_tiles(x: Inputs) -> Case:
    """The tile sort at the 2**20 plan; ``torch.sort`` of each chunk."""
    parts, nbytes = [], 0
    for c in plan_chunks(x):
        tile = pk.sort_tiles(c)[1]
        parts.append(Part(
            lambda c=c: pk.sort_tiles(c)[0],
            lambda c=c, t=tile: pk.sort_tiles_plain(c, t),
            lambda c=c: torch.sort(c.view(c.shape[0] * c.shape[1], -1), -1)))
        nbytes += 2 * c.numel() * 4
    return Case(parts, nbytes)


def row_merge_phase(x: Inputs) -> Case:
    """Every merge round after the tile sort, on a copy of the tiles made
    untimed."""
    parts, nbytes = [], 0
    for c in plan_chunks(x):
        tiles, tile = pk.sort_tiles(c)
        rounds = [1 << j for j in range((2 * tile).bit_length() - 1,
                                        (c.shape[2] * pk.LANES).bit_length())]

        def merges(t, tile=tile, rounds=rounds):
            for k in rounds:
                pk.merge_phase(t, tile, k)
            return t

        parts.append(Part(
            merges, lambda t, rounds=rounds: reduce(pk.merge_phase_plain,
                                                    rounds, t),
            args=lambda t=tiles: (t.clone(),)))
        nbytes += 2 * c.numel() * 4 * len(rounds)
    return Case(parts, nbytes)


def sorted_plan(x: Inputs) -> tuple[list, tuple]:
    plan = pk.plan(WIDE)
    return [pk._sorted(c) for c in plan_chunks(x)], plan


def row_partition_bounds(x: Inputs) -> Case:
    """The partition table and flags; ``torch.searchsorted`` of each
    partition's first bucket in the chunks' row maxima (prepared)."""
    srts, (p_log2, sub_log2, rows, cap) = sorted_plan(x)
    parts, nbytes = [], 0
    for s in srts:
        r, g = s.shape[:2]
        lastq = (s[..., pk.LANES - 1] >> sub_log2).reshape(r * g, rows)
        queries = torch.arange(1 << p_log2, dtype=torch.int32, device=x.dev)
        queries = queries.expand(r * g, -1).contiguous()
        parts.append(Part(
            lambda s=s: pk.partition_bounds(s, sub_log2, p_log2, cap),
            lambda s=s: pk.partition_bounds_plain(s, sub_log2, p_log2, cap),
            lambda a=lastq.contiguous(), q=queries: torch.searchsorted(
                a, q, side="left")))
        nbytes += (r * g * rows + r * g * (1 << p_log2) + 2) * 4
    return Case(parts, nbytes)


def row_windows(x: Inputs) -> Case:
    """Each partition's window of the sorted chunks, by the kernel's table."""
    srts, (p_log2, sub_log2, rows, cap) = sorted_plan(x)
    parts, nbytes = [], 0
    for s in srts:
        fb = pk.partition_bounds(s, sub_log2, p_log2, cap)[0]
        parts.append(Part(
            lambda s=s, fb=fb: pk.windows(s, fb, p_log2, sub_log2, cap),
            lambda s=s, fb=fb: pk.partition_windows_plain(
                s, fb, p_log2, sub_log2, cap_rows=cap)))
        r, g = s.shape[:2]
        nbytes += s.numel() * 4 + r * (1 << p_log2) * g * cap * pk.LANES * 4
    return Case(parts, nbytes)


def row_kmer_hash_long(x: Inputs) -> Case:
    """B2 at [10000, 16384], hashes, h=1."""
    tm = prepare_codes(torch.from_numpy(make_codes(x.rng, LONG_READS, LONG_L))
                       .to(x.dev))
    return one(lambda: kmer_kernel.hash_kmers_tm_long(tm, K, 1),
               lambda: kmer_kernel.hash_kmers_tm_long_plain(tm, K, 1),
               4 * LONG_L * LONG_READS + 8 * (LONG_L - K + 1) * LONG_READS)


def row_seed_hash(x: Inputs) -> Case:
    """B1 (the staged kernel) at the BASELINE seeds, h=3, over the 1M reads."""
    tm = x.tm
    return one(lambda: sk.hash_seeds_tm(tm, SEEDS, SEED_H),
               lambda: sk.hash_seeds_tm_plain(tm, SEEDS, SEED_H),
               4 * L * N_READS + 8 * (L - 4) * N_READS * len(SEEDS) * SEED_H)


def row_seed_hash_long(x: Inputs) -> Case:
    """B3 at [10000, 16384], the BASELINE seeds, h=1; int32 codes made on
    the card with ~1% N."""
    tm = x.randint(4, (LONG_L, LONG_READS)).masked_fill_(
        torch.rand((LONG_L, LONG_READS), generator=x.gen, device=x.dev)
        < N_RATE, 4)
    return one(lambda: sk.hash_seeds_tm_long(tm, SEEDS, 1),
               lambda: sk.hash_seeds_tm_long_plain(tm, SEEDS, 1),
               4 * LONG_L * LONG_READS
               + 8 * (LONG_L - 4) * LONG_READS * len(SEEDS))


def words_case(streams: list, nwords: int, call, plain) -> Case:
    """A presence-word kernel a batch, OR-ing into one set of words that
    the timed calls share; the error check starts from zeroed words."""
    words = torch.zeros(nwords, dtype=torch.int32, device=streams[0].device)
    fresh = (lambda: (torch.zeros_like(words),))
    return Case([Part(lambda w, s=s: call(s, w), lambda w, s=s: plain(s, w),
                      args=lambda: (words,), fresh=fresh) for s in streams],
                sum(4 * s.numel() + 4 * nwords for s in streams))


def row_bloom_words(x: Inputs) -> Case:
    """C1 as the 2**17 Bloom path launches it: one launch a batch over the
    hash kernel's [H, n] view."""
    return words_case(
        [idx.reshape(-1) for idx in x.buckets(17)], 1 << 12,
        lambda s, w: hist_kernel.bloom_words(s, None, 17, out=w),
        lambda s, w: hist_kernel.bloom_words_plain(s, None, 17, out=w))


def row_bloom_words_rows(x: Inputs) -> Case:
    """C2 on the 2**20 plan's windows: 128 rows at 2**13 a batch."""
    p_log2, sub_log2, rows, cap = pk.plan(WIDE)
    flats = [pk._partition(idx.reshape(1, -1), WIDE, p_log2, sub_log2, rows,
                           cap)[0].reshape(1 << p_log2, -1)
             for idx in x.buckets(WIDE)]
    return words_case(
        flats, 1 << (WIDE - 5),
        lambda f, w: hist_kernel.bloom_words_rows(
            f, sub_log2, out=w.view(1 << p_log2, -1)),
        lambda f, w: hist_kernel.bloom_words_rows_plain(
            f, sub_log2, out=w.view(1 << p_log2, -1)))


def sequence_case(fn, plain, n: int, nbytes_a_base: int, x: Inputs) -> Case:
    seq = x.sequence(n)
    return one(lambda: fn(seq), lambda: plain(seq), n * nbytes_a_base)


def row_kmer_sequence(x: Inputs) -> Case:
    """``sp.hash_long_sequence`` over 2**27 bases, k=32, h=1: one launch of
    kmer_hash.cu's one-sequence entry."""
    return sequence_case(lambda s: sp.hash_long_sequence(s, K, 1),
                         lambda s: sp.hash_long_sequence(s, K, 1,
                                                         engine="torch"),
                         SP_LEN, 10, x)


def row_seed_sequence(x: Inputs) -> Case:
    """``sp.hash_long_sequence_seeds`` over 2**25 bases, BASELINE seeds,
    h=1."""
    return sequence_case(
        lambda s: sp.hash_long_sequence_seeds(s, SEEDS, 1),
        lambda s: sp.hash_long_sequence_seeds(s, SEEDS, 1, engine="torch"),
        SP_SEED_LEN, 18, x)


def row_unpack_codes(x: Inputs) -> Case:
    """The 2-bit planes of a batch of the 1M reads (``pack_codes``) to
    [L, B] int32 codes."""
    parts, nbytes = [], 0
    for s in range(0, N_READS, BATCH):
        a, b = (torch.from_numpy(t).to(x.dev)
                for t in pack_codes(x.codes[s:s + BATCH]))
        parts.append(Part(
            lambda a=a, b=b: unpack_kernel.unpack_codes_tm(a, b, L),
            lambda a=a, b=b: unpack_kernel.unpack_codes_tm_plain(a, b, L)))
        planes = packed_shapes((a.shape[0], L))
        nbytes += a.shape[0] * (planes[0][1] + planes[1][1] + 4 * L)
    return Case(parts, nbytes)


def row_kmer_sequence_fwd_rev(x: Inputs) -> Case:
    """The one-sequence entry's fwd/rev instance (the facade's tiles), 2**27
    bases, k=32, h=1."""
    return sequence_case(
        lambda s: kmer_kernel.hash_sequence(s, K, 1, emit_fwd_rev=True),
        lambda s: kmer_kernel.hash_sequence_plain(s, K, 1, emit_fwd_rev=True),
        SP_LEN, 26, x)


def row_seed_sequence_fwd_rev(x: Inputs) -> Case:
    """The seed entry's fwd/rev instance, 2**25 bases, BASELINE seeds, h=1."""
    return sequence_case(
        lambda s: sk.hash_seeds_sequence(s, SEEDS, 1, emit_fwd_rev=True),
        lambda s: sk.hash_seeds_sequence_plain(s, SEEDS, 1,
                                               emit_fwd_rev=True),
        SP_SEED_LEN, 50, x)


def blind_bytes(walks: int, k: int, nseeds: int, h: int) -> int:
    """The fed int32 codes, the window read and written, every step's
    hashes written, (fwd, rev) read and written."""
    return (4 * STEPS * walks + 8 * walks * k
            + 8 * STEPS * walks * nseeds * h + 32 * walks * nseeds)


def row_blind_roll_many(x: Inputs) -> Case:
    """``roll_many`` over 2**20 walks of 64 steps, k=32, h=4 (the DBG
    probe's replay)."""
    state = blind_scan.init_state(x.randint(4, (WALKS, K), torch.uint8))
    chars = x.randint(4, (STEPS, WALKS))
    return one(lambda: blind_scan.roll_many(state, chars, H),
               lambda: blind_scan.roll_many_plain(state, chars, H),
               blind_bytes(WALKS, K, 1, H))


def row_blind_seed_roll_many(x: Inputs) -> Case:
    """The seed scan's ``roll_many`` over 2**18 walks of 64 steps, BASELINE
    seeds, h=3."""
    k = len(SEEDS[0])
    state = blind_seed_scan.init_state(x.randint(4, (SEED_WALKS, k),
                                                 torch.uint8), SEEDS)
    chars = x.randint(4, (STEPS, SEED_WALKS))
    return one(lambda: blind_seed_scan.roll_many(state, chars, SEEDS, SEED_H),
               lambda: blind_seed_scan.roll_many_plain(state, chars, SEEDS,
                                                       SEED_H),
               blind_bytes(SEED_WALKS, k, len(SEEDS), SEED_H))


def binned(x: Inputs, wl: int) -> list:
    """(idx, per, blocks, kernel's Bins, plain Bins, valid) a batch, as the
    rule bins A2 at 2**20 ([H, n]) or C1 at 2**30 (one stream)."""
    out = []
    for idx in x.buckets(wl):
        rl = hist_kernel.COUNTS_RANGE_LOG2 if wl == WIDE else \
            hist_kernel.WORDS_RANGE_LOG2
        idx = idx if wl == WIDE else idx.reshape(1, -1)
        grid = (hist_kernel.binned_counts_grid if wl == WIDE
                else hist_kernel.binned_words_grid)
        per, blocks = grid(*idx.shape, wl)
        plain = hist_kernel.bin_ranges_plain(idx, None, wl, rl, per)
        out.append((idx, rl, per, blocks,
                    hist_kernel.bin_ranges(idx, None, wl, rl, per), plain,
                    int(plain.starts[-1])))
    return out


def bins_case(x: Inputs, wl: int, sort_key, stage_bytes: int) -> Case:
    """The binning pass a batch; ``torch.sort`` of the flat buckets. Beside
    it each of its kernels' device ms over the batches (:func:`kernel_ms`:
    the scatter alone, and the count where the body runs one)."""
    parts, nbytes = [], 0
    for idx, rl, per, _, _, _, valid in binned(x, wl):
        parts.append(Part(
            lambda i=idx, rl=rl, per=per: hist_kernel.bin_ranges(
                i, None, wl, rl, per),
            lambda i=idx, rl=rl, per=per: hist_kernel.bin_ranges_plain(
                i, None, wl, rl, per),
            lambda f=sort_key(idx): torch.sort(f)))
        nbytes += idx.numel() * 4 + valid * stage_bytes
    return Case(parts, nbytes, bins_err,
                lambda: kernel_ms([p.kernel for p in parts]))


def row_bin_ranges_counts(x: Inputs) -> Case:
    """A2's binning pass at 2**20 (ranges of 2**15, an int16 stage)."""
    return bins_case(x, WIDE, lambda i: (i.long() + torch.arange(
        H, device=x.dev)[:, None] * ((1 << WIDE) + 1)).reshape(-1), 2)


def row_bin_ranges_words(x: Inputs) -> Case:
    """C1's binning pass at 2**30 (ranges of 2**20, an int32 stage)."""
    return bins_case(x, 30, lambda i: torch.where(
        i[0] >= 0, i[0].long(), 1 << 30), 4)


def row_histogram_ranges(x: Inputs) -> Case:
    """A2's range pass at 2**20 over the kernel's bins, adding into the
    sketch's rows; ``torch.bincount`` of the flat buckets."""
    rows_out = torch.zeros((H, 1 << WIDE), dtype=torch.int32, device=x.dev)
    parts, nbytes = [], 0
    for idx, _, _, blocks, bins, plain, valid in binned(x, WIDE):
        flat = (idx.long() + torch.arange(H, device=x.dev)[:, None]
                * ((1 << WIDE) + 1)).reshape(-1)
        parts.append(Part(
            lambda o, b=bins, n=blocks: (hist_kernel._ranges_launch(
                "histogram", b, n, o, None), o)[1],
            lambda o, b=plain: hist_kernel.histogram_ranges_plain(
                b, H, WIDE, out=o),
            lambda f=flat: torch.bincount(f, minlength=H * ((1 << WIDE) + 1)),
            args=lambda: (rows_out,),
            fresh=lambda: (torch.zeros_like(rows_out),)))
        nbytes += valid * 2 + H * (1 << WIDE) * 4
    return Case(parts, nbytes)


def row_bloom_ranges(x: Inputs) -> Case:
    """C1's range pass at 2**30 over the kernel's bins, into words zeroed
    untimed before each call."""
    words = torch.zeros((1, (1 << 30) // 32), dtype=torch.int32,
                        device=x.dev)
    parts, nbytes = [], 0
    for _, _, _, blocks, bins, plain, valid in binned(x, 30):
        parts.append(Part(
            lambda w, b=bins, n=blocks: (hist_kernel._ranges_launch(
                "bloom", b, n, w, None), w)[1],
            lambda w, b=plain: hist_kernel.bloom_ranges_plain(b, 1, 30, out=w),
            args=lambda: (words.zero_(),),
            fresh=lambda: (torch.zeros_like(words),)))
        nbytes += valid * 4 + words.numel() * 4
    return Case(parts, nbytes)


def row_seed_hash_screen(x: Inputs) -> Case:
    """B1 at the screening cell's shape: one batch [150, 2**18], four seeds
    x 4 hashes to buckets at 2**28."""
    tm = x.genome_tm
    planes = len(SCREEN_SEEDS) * SCREEN_H
    return one(lambda: sk.hash_seeds_tm(tm, SCREEN_SEEDS, SCREEN_H,
                                        emit_buckets=SCREEN_WL),
               lambda: sk.hash_seeds_tm_plain(tm, SCREEN_SEEDS, SCREEN_H,
                                              emit_buckets=SCREEN_WL),
               4 * L * BATCH + 4 * (L - K + 1) * BATCH * planes)


def row_bloom_probe(x: Inputs) -> Case:
    """The probe over that batch's buckets against the 2**28-bit filter,
    adding into one count tensor."""
    bf, buckets = x.screen
    s = len(SCREEN_SEEDS)
    acc = torch.zeros((s, BATCH), dtype=torch.int32, device=x.dev)
    return one(lambda o: probe_kernel.probe_counts(
                   buckets, bf.words, s, SCREEN_H, SCREEN_WL, out=o),
               lambda o: o.add_(probe_kernel.probe_counts_plain(
                   buckets, bf.words, s, SCREEN_H, SCREEN_WL)),
               4 * (L - K + 1) * BATCH * s * SCREEN_H + 2 * 4 * s * BATCH
               + bf.words.numel() * 4,
               args=lambda: (acc,), fresh=lambda: (torch.zeros_like(acc),))


def row_bloom_words_wide(x: Inputs) -> Case:
    """C1's wide route as the host screening cell's build launches it: one
    chunk of ``insert_sequence_seeds`` (as many windows of a random sequence
    as 2 GiB of int64 buckets hold under four seeds x 4 hashes) into a
    2**37-bit filter (16 GiB), by direct atomics, OR-ing into one set of
    words that the timed calls share (made after the error check, so that
    at most two filters live at once). Bytes: the buckets read once, and
    each distinct 32-byte sector of the filter they touch read and written
    once."""
    n = bloom.BUILD_CHUNK_BYTES // (8 * len(SCREEN_SEEDS) * SCREEN_H)
    rows = prepare_codes(kmer_kernel.sequence_rows(
        x.sequence(n + K - 1), K, bloom.SEQUENCE_ROW))
    idx = hist_kernel.rows_view(sk.hash_seeds_tm_auto(
        rows, SCREEN_SEEDS, SCREEN_H, emit_buckets=HOST_WL))
    assert idx is not None, "B1's planes are views of one output"
    del rows
    seen = torch.zeros((1 << HOST_WL) // 256, dtype=torch.bool, device=x.dev)
    for b in idx:
        seen[hist_kernel.word_index(b[b < (1 << HOST_WL)]) >> 3] = True
    sectors = int(seen.sum())
    del seen
    nwords = (1 << HOST_WL) // 32
    shared = []

    def timed():
        if not shared:
            shared.append(torch.zeros(nwords, dtype=torch.int32,
                                      device=x.dev))
        return (shared[0],)

    return one(lambda w: hist_kernel.bloom_words(idx, None, HOST_WL, out=w),
               lambda w: hist_kernel.bloom_words_plain(idx, None, HOST_WL,
                                                       out=w),
               8 * idx.numel() + 64 * sectors, args=timed,
               fresh=lambda: (torch.zeros(nwords, dtype=torch.int32,
                                          device=x.dev),))


def row_seed_hash_wide(x: Inputs) -> Case:
    """B1's wide buckets at the host screening cell's shape: one batch
    [150, 2**18], four seeds x 4 hashes to int64 buckets at 2**37."""
    tm = x.genome_tm
    planes = len(SCREEN_SEEDS) * SCREEN_H
    return one(lambda: sk.hash_seeds_tm(tm, SCREEN_SEEDS, SCREEN_H,
                                        emit_buckets=HOST_WL),
               lambda: sk.hash_seeds_tm_plain(tm, SCREEN_SEEDS, SCREEN_H,
                                              emit_buckets=HOST_WL),
               4 * L * BATCH + 8 * (L - K + 1) * BATCH * planes)


def row_bloom_probe_wide(x: Inputs) -> Case:
    """The wide probe over that batch's int64 buckets against the 2**37-bit
    filter (16 GiB, in device memory), adding into one count tensor. Bytes:
    the buckets read once, each distinct 32-byte sector of the filter the
    batch probes read once, the counts read and written once."""
    bf, buckets = x.host
    s = len(SCREEN_SEEDS)
    seen = torch.zeros((1 << HOST_WL) // 256, dtype=torch.bool, device=x.dev)
    for b in buckets:
        seen[hist_kernel.word_index(b[b < (1 << HOST_WL)]) >> 3] = True
    sectors = int(seen.sum())
    del seen
    acc = torch.zeros((s, BATCH), dtype=torch.int32, device=x.dev)
    return one(lambda o: probe_kernel.probe_counts(
                   buckets, bf.words, s, SCREEN_H, HOST_WL, out=o),
               lambda o: o.add_(probe_kernel.probe_counts_plain(
                   buckets, bf.words, s, SCREEN_H, HOST_WL)),
               8 * (L - K + 1) * BATCH * s * SCREEN_H + 32 * sectors
               + 2 * 4 * s * BATCH,
               args=lambda: (acc,), fresh=lambda: (torch.zeros_like(acc),))


def split_ranges(idx, wl: int) -> dict:
    """The clustered route's split of idx [R, n] at 2**wl: its owner blocks
    a chunk and the share of ranges that the binning pass cut into more
    than one chunk."""
    rl = hist_kernel.counts_range_log2(idx.shape[0], wl)
    bins = hist_kernel.bin_ranges(idx, None, wl, rl,
                                  hist_kernel.CLUSTERED_RANGE_ENTRIES)
    return {"owners": hist_kernel.range_owners(rl),
            "split_share": float((bins.counts > bins.per).double().mean())}


def row_histogram_ranges_clustered(x: Inputs) -> Case:
    """A2 at 4 x 2**28 by the rule's clustered route (binning, then the
    range pass) over one genomic batch of 2**18 reads, as
    ``cms_short_resident`` counts it, adding into the sketch's rows;
    ``torch.bincount`` of the flat buckets. Bytes: the buckets read once,
    each touched counter read and written once. Beside it the range pass's
    owners a chunk and its share of split ranges (:func:`split_ranges`)."""
    wl = CMS_WL
    idx = hist_kernel.rows_view(hash_kmers_tm(x.genome_tm, K, H,
                                              emit_buckets=wl))
    rows_out = torch.zeros((H, 1 << wl), dtype=torch.int32, device=x.dev)
    flat = (idx.long() + torch.arange(H, device=x.dev)[:, None]
            * ((1 << wl) + 1)).reshape(-1)
    touched = torch.unique(flat[((idx >= 0) & (idx < (1 << wl)))
                                .reshape(-1)]).numel()
    case = one(lambda o: hist_kernel.histogram_rows(idx, None, wl, out=o),
               lambda o: hist_kernel.histogram_rows_plain(idx, None, wl,
                                                          out=o),
               idx.numel() * 4 + touched * 8,
               lambda: torch.bincount(flat, minlength=H * ((1 << wl) + 1)),
               args=lambda: (rows_out,),
               fresh=lambda: (torch.zeros_like(rows_out),))
    case.notes = lambda: {**split_ranges(idx, wl), **kernel_ms(
        [lambda: hist_kernel.histogram_rows(idx, None, wl, out=rows_out)])}
    return case


#: The kernel table: (name, CUDA source, the TPU kernel or JAX function it
#: replaces, its launch counter, the row's inputs and calls).
ROWS = (
    ("kmer_hash", "kmer_hash.cu", "ops/kmer_pallas.py:72",
     lambda: kmer_kernel.LAUNCHES, row_kmer_hash),
    ("histogram", "histogram.cu", "ops/hist_pallas.py:133",
     lambda: hist_kernel.LAUNCHES, row_histogram),
    ("sort_tiles", "partition.cu", "ops/part_pallas.py:255",
     lambda: pk.LAUNCHES["sort_tiles"], row_sort_tiles),
    ("merge_phase", "partition.cu", "ops/part_pallas.py:283",
     lambda: pk.LAUNCHES["merge_phase"], row_merge_phase),
    ("partition_bounds", "partition.cu", "ops/part_pallas.py:255",
     lambda: pk.LAUNCHES["partition_bounds"], row_partition_bounds),
    ("windows", "partition.cu", "ops/part_pallas.py:385",
     lambda: pk.LAUNCHES["windows"], row_windows),
    ("kmer_hash_long", "kmer_hash.cu", "ops/kmer_pallas.py:230",
     lambda: kmer_kernel.LONG_LAUNCHES, row_kmer_hash_long),
    ("seed_hash", "seed_hash.cu", "ops/seed_pallas.py:105",
     lambda: sk.LAUNCHES, row_seed_hash),
    ("seed_hash_long", "seed_hash.cu", "ops/seed_pallas.py:264",
     lambda: sk.LONG_LAUNCHES, row_seed_hash_long),
    ("bloom_words", "bloom.cu", "ops/hist_pallas.py:157",
     lambda: hist_kernel.BLOOM_LAUNCHES["bloom_words"], row_bloom_words),
    ("bloom_words_rows", "bloom.cu", "ops/hist_pallas.py:296",
     lambda: hist_kernel.BLOOM_LAUNCHES["bloom_words_rows"],
     row_bloom_words_rows),
    ("kmer_sequence", "kmer_hash.cu", "ops/kmer_pallas.py:72",
     lambda: kmer_kernel.SEQUENCE_LAUNCHES, row_kmer_sequence),
    ("seed_sequence", "seed_hash.cu", "ops/seed_pallas.py:105",
     lambda: sk.SEQUENCE_LAUNCHES, row_seed_sequence),
    ("unpack_codes", "unpack.cu", "parallel/dp.py:86",
     lambda: unpack_kernel.LAUNCHES, row_unpack_codes),
    ("kmer_sequence_fwd_rev", "kmer_hash.cu", "ops/kmer_pallas.py:72",
     lambda: kmer_kernel.FWD_REV_LAUNCHES, row_kmer_sequence_fwd_rev),
    ("seed_sequence_fwd_rev", "seed_hash.cu", "ops/seed_pallas.py:105",
     lambda: sk.FWD_REV_LAUNCHES, row_seed_sequence_fwd_rev),
    ("blind_roll_many", "blind.cu", "ops/blind_scan.py:99",
     lambda: blind_scan.LAUNCHES, row_blind_roll_many),
    ("blind_seed_roll_many", "blind.cu", "ops/blind_seed_scan.py:141",
     lambda: blind_seed_scan.LAUNCHES, row_blind_seed_roll_many),
    ("bin_ranges_counts", "bin.cuh", "ops/hist_pallas.py:133",
     lambda: hist_kernel.BIN_LAUNCHES["histogram"], row_bin_ranges_counts),
    ("histogram_ranges", "histogram.cu", "ops/hist_pallas.py:133",
     lambda: hist_kernel.RANGE_LAUNCHES["histogram"], row_histogram_ranges),
    ("bin_ranges_words", "bin.cuh", "ops/hist_pallas.py:157",
     lambda: hist_kernel.BIN_LAUNCHES["bloom"], row_bin_ranges_words),
    ("bloom_ranges", "bloom.cu", "ops/hist_pallas.py:157",
     lambda: hist_kernel.RANGE_LAUNCHES["bloom"], row_bloom_ranges),
    ("seed_hash_screen", "seed_hash.cu", "ops/seed_pallas.py:105",
     lambda: sk.LAUNCHES, row_seed_hash_screen),
    ("bloom_probe", "probe.cu", "models/bloom.py:162",
     lambda: probe_kernel.LAUNCHES, row_bloom_probe),
    ("histogram_ranges_clustered", "histogram.cu", "ops/hist_pallas.py:133",
     lambda: hist_kernel.ROUTE_LAUNCHES["clustered"],
     row_histogram_ranges_clustered),
    ("bloom_words_wide", "bloom.cu", "ops/hist_pallas.py:157",
     lambda: hist_kernel.ROUTE_LAUNCHES["wide_words"], row_bloom_words_wide),
    ("seed_hash_wide", "seed_hash.cu", "ops/seed_pallas.py:105",
     lambda: sk.ROUTE_LAUNCHES["wide"], row_seed_hash_wide),
    ("bloom_probe_wide", "probe.cu", "models/bloom.py:162",
     lambda: probe_kernel.ROUTE_LAUNCHES["wide"], row_bloom_probe_wide),
)


# --------------------------------------------------------------- paths ----

def reset_launches() -> None:
    """Set every launch counter of the kernel modules to 0."""
    for module in (kmer_kernel, hist_kernel, pk, sk, unpack_kernel,
                   blind_scan, blind_seed_scan, probe_kernel):
        for name, value in list(vars(module).items()):
            if name.endswith("LAUNCHES"):
                if isinstance(value, dict):
                    value.update(dict.fromkeys(value, 0))
                else:
                    setattr(module, name, 0)


def count_file(x: Inputs, wl: int):
    """``count_file`` over the 1M reads at 2**wl in batches of 2**18."""
    pipe = ReadHashingPipeline(PipelineConfig(sketch_width_log2=wl),
                               device=x.dev)
    assert pipe.count_file(x.fastq, batch_size=BATCH) == N_READS
    return pipe.sketch.rows.long()


def bloom_path(x: Inputs, wl: int):
    """The Bloom path over the 1M reads at 2**wl: the hash kernel's
    buckets into ``insert_from_buckets``, a batch."""
    bf = bloom.BloomFilter.zeros(wl, device=x.dev)
    for tm in x.tms:
        bloom.insert_from_buckets(bf, kmer_kernel.hash_kmers_tm_auto(
            tm, K, H, emit_buckets=wl), emitted_width_log2=wl)
    return bf.words


def partitioned_counts(x: Inputs):
    out = torch.zeros((H, 1 << WIDE), dtype=torch.int32, device=x.dev)
    for idx in x.buckets(WIDE):
        pk.partitioned_histogram_rows(idx, WIDE, out=out)
    return out.long()


def partitioned_words(x: Inputs):
    out = torch.zeros((1 << WIDE) // 32, dtype=torch.int32, device=x.dev)
    for idx in x.buckets(WIDE):
        pk.partitioned_bloom_words(idx.reshape(-1), WIDE, out=out)
    return out


def count_min_step(x: Inputs):
    """``fused_count_step`` of the genomic batch into a 4 x 2**28 sketch
    (zeroed)."""
    sketch = CountMinSketch.zeros(H, CMS_WL, x.dev)
    fused_count_step(x.genome_tm, sketch, K)
    return sketch.rows


def count_min_plain(x: Inputs):
    want = torch.zeros((H, 1 << CMS_WL), dtype=torch.int32, device=x.dev)
    for r, b in enumerate(hash_kmers_tm_plain(x.genome_tm, K, H,
                                              emit_buckets=CMS_WL)):
        hist_kernel.histogram_rows_plain(b.reshape(1, -1), None, CMS_WL,
                                         out=want[r:r + 1])
    return want


def screen_step(x: Inputs):
    """The screening cell's filter, and ``screen_reads`` of its batch."""
    bf = x.screen[0]
    return bf.words, bloom.screen_reads(bf, x.genome_tm, SCREEN_SEEDS,
                                        SCREEN_H)


def screen_plain(x: Inputs):
    words = torch.zeros_like(x.screen[0].words)
    for b in sk.hash_seeds_tm_plain(x.genome_rows, SCREEN_SEEDS, SCREEN_H,
                                    emit_buckets=SCREEN_WL):
        hist_kernel.bloom_words_plain(b, None, SCREEN_WL, out=words)
    return words, probe_kernel.probe_counts_plain(
        sk.hash_seeds_tm_plain(x.genome_tm, SCREEN_SEEDS, SCREEN_H,
                               emit_buckets=SCREEN_WL),
        words, len(SCREEN_SEEDS), SCREEN_H, SCREEN_WL)


def host_screen_step(x: Inputs):
    """``screen_reads`` of the batch against the host screening cell's
    2**37-bit filter."""
    return bloom.screen_reads(x.host[0], x.genome_tm, SCREEN_SEEDS, SCREEN_H)


def host_screen_plain(x: Inputs):
    return probe_kernel.probe_counts_plain(
        sk.hash_seeds_tm_plain(x.genome_tm, SCREEN_SEEDS, SCREEN_H,
                               emit_buckets=HOST_WL),
        x.host[0].words, len(SCREEN_SEEDS), SCREEN_H, HOST_WL)


#: Entries run at their default shapes, each with the counters at 0: (what,
#: the rows whose launches it gives, the entry, its plain chain).
PATHS = (
    ("count_file, 1M reads at 2**14", ("kmer_hash", "histogram"),
     lambda x: count_file(x, WLOG), lambda x: x.plain_count(WLOG)),
    ("count_file, 1M reads at PipelineConfig()'s 2**20",
     ("bin_ranges_counts", "histogram_ranges"),
     lambda x: count_file(x, WIDE), lambda x: x.plain_count(WIDE)),
    ("partitioned_histogram_rows at 2**20, off the default paths",
     ("sort_tiles", "merge_phase", "partition_bounds", "windows"),
     partitioned_counts, lambda x: x.plain_count(WIDE)),
    ("the Bloom path, 1M reads at 2**17", ("bloom_words",),
     lambda x: bloom_path(x, 17), lambda x: x.plain_words(17)),
    ("the Bloom path, 1M reads at 2**30",
     ("bin_ranges_words", "bloom_ranges"),
     lambda x: bloom_path(x, 30), lambda x: x.plain_words(30)),
    ("partitioned_bloom_words at 2**20, off the default paths",
     ("bloom_words_rows",), partitioned_words, lambda x: x.plain_words(WIDE)),
    ("cms_short_resident's step: fused_count_step of one genomic batch at "
     "4 x 2**28", ("histogram_ranges_clustered",), count_min_step,
     count_min_plain),
    ("screen_short_resident's step: screen_reads of one batch against its "
     "filter (built before the reset)", ("seed_hash_screen", "bloom_probe"),
     screen_step, screen_plain),
    ("host_screen_short_resident's step: screen_reads of one batch against "
     "a 2**37-bit filter (built before the reset by C1's wide route, "
     "which the bloom_words_wide row checks)",
     ("seed_hash_wide", "bloom_probe_wide"),
     host_screen_step, host_screen_plain),
)


def run_path(run, plain, names, counters: dict, x: Inputs):
    """The path's error against its plain chain and the launches of the
    kernels ``names``, counted from 0."""
    reset_launches()
    got = run(x)
    torch.cuda.synchronize()
    launches = {name: counters[name]() for name in names}
    err = max_abs_err(got, plain(x))
    torch.cuda.empty_cache()
    return err, launches


# ---------------------------------------------------------------- table ----

def tensors(x) -> list:
    """The tensors in a tensor or in nested tuples and lists of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in tensors(y)]
    return []


def measure(name, source, replaces, counter, make, x: Inputs,
            rate: float) -> dict:
    """One entry of the table: the row's error and launches (counted from
    0) from one call of each part, then its times and its bound at
    ``rate`` bytes/s."""
    case = make(x)
    diff = case.diff or max_abs_err
    err, launches = 0.0, 0
    for part in case.parts:
        reset_launches()
        got = part.kernel(*(part.fresh or part.args)())
        launches += counter()
        want = part.plain(*(part.fresh or part.args)())
        torch.cuda.synchronize()
        shared = ({t.untyped_storage().data_ptr() for t in tensors(got)}
                  & {t.untyped_storage().data_ptr() for t in tensors(want)})
        assert not shared - {0}, f"{name}: kernel and plain share an output"
        err = max(err, diff(got, want))
        del got, want
    ms = dict.fromkeys(("kernel", "plain", "library"), 0.0)
    for part in case.parts:
        for key, v in in_turns(part).items():
            ms[key] += v
    bound = case.nbytes / rate * 1e3
    notes = case.notes() if case.notes else {}
    del case
    torch.cuda.empty_cache()
    return {"name": name, "route": "cuda",
            "source": f"nthash_tpu_torch/csrc/{source}",
            "replaces": f"nthash_tpu/{replaces}", "launches": launches,
            "max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": ms["library"] or None, **notes}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernel table needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    card = torch.cuda.get_device_name(0)
    rate = hbm_bytes_per_s(card)
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"bounds at {rate:.4g} bytes/s", flush=True)
    counters = {entry[0]: entry[3] for entry in ROWS}
    with tempfile.TemporaryDirectory() as tmp:
        x = Inputs(args.seed, torch.device("cuda", 0), Path(tmp))
        kernels = [measure(*entry, x, rate) for entry in ROWS]
        path_errs, path_launches = [], {}
        x.screen    # the screening cells' set-ups, before any count is reset
        x.host
        for what, names, run, plain in PATHS:
            err, launches = run_path(run, plain, names, counters, x)
            print(f"[path] {what}: max_abs_err {err:g}; launches {launches}",
                  flush=True)
            path_errs.append(err)
            path_launches.update(launches)
    for row in kernels:
        row["launches"] = path_launches.get(row["name"], row["launches"])
        lib = "" if row["library_ms"] is None else \
            f", library {row['library_ms']:.4f}"
        split = "" if "owners" not in row else \
            (f"; {row['owners']} owners a chunk, split ranges "
             f"{row['split_share']:.4%}")
        split += "".join(f"; {k} {v:.4f}" for k, v in row.items()
                         if k.endswith("_kernel_ms"))
        print(f"[kernel] {row['name']}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f}{lib}, bound {row['bound_ms']:.4f} "
              f"({row['bound_ms'] / row['ms']:.1%} of it); launches "
              f"{row['launches']}, max_abs_err {row['max_abs_err']:g}{split} "
              f"[{smi}]", flush=True)
    ok = (all(r["max_abs_err"] == 0 and r["launches"] > 0 for r in kernels)
          and not any(path_errs))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": ok, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
        "power": smi}}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
