"""Read screening with spaced seeds against a Bloom filter on the CPU:
``ops/probe_kernel`` and ``models/bloom.screen_reads`` /
``hits_from_buckets`` against the benchmark's plain reference
(``portbench/reference/screen.py`` over ``portbench/core/seed_ref.py``)
and against the JAX package's spaced-seed hashes and ``contains``.

Genomes and reads are made with numpy from a seed: reads are windows of
the genome with substitutions and N calls, so most windows hit and some do
not. Every comparison is of integers, with tolerance 0. The CUDA kernel is
held to the plain version on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nthash_tpu.models import bloom as jbloom
from nthash_tpu.ops import seed_jnp
from nthash_tpu.u64 import U64
from nthash_tpu_torch.models import bloom
from nthash_tpu_torch.ops import probe_kernel, seed_kernel
from nthash_tpu_torch.ops.kmer_kernel import prepare_codes, sequence_rows
from portbench.core import nthash_ref, seed_ref
from portbench.reference import screen as ref_screen

#: The benchmark configuration's four patterns (26 care positions each).
CELL_SEEDS = ("11101111110111011011101111110111",
              "11110111011110111101111011101111",
              "11111011111011100111011111011111",
              "11011110111101111110111101111011")
CASES = {
    "cell": (CELL_SEEDS, 4, 16),
    "baseline": (("10101", "11011"), 3, 12),
    "one_seed": (("11100111",), 1, 14),
}


def genome_and_reads(seed, size=700, n=48, length=60, sub=0.02, n_rate=0.01):
    """uint8 genome [size] (0-3) and reads [n, length] drawn from it, with
    substitutions and N (4) calls."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size, dtype=np.uint8)
    starts = rng.integers(0, size - length + 1, n)
    reads = genome[starts[:, None] + np.arange(length)]
    sub_at = rng.random(reads.shape) < sub
    reads = np.where(sub_at, (reads + rng.integers(1, 4, reads.shape)) % 4,
                     reads).astype(np.uint8)
    reads[rng.random(reads.shape) < n_rate] = 4
    return torch.from_numpy(genome), torch.from_numpy(reads)


def port_filter(genome, seeds, h, wl, span=64):
    """The port's filter of the genome's windows: its rows hashed by the
    seed kernels' CPU route to buckets, inserted by insert_from_buckets."""
    bf = bloom.BloomFilter.zeros(wl, device="cpu")
    rows = prepare_codes(sequence_rows(genome, len(seeds[0]), span))
    return bloom.insert_from_buckets(
        bf, seed_kernel.hash_seeds_tm_auto(rows, seeds, h, emit_buckets=wl),
        emitted_width_log2=wl)


def ref_words(genome, seeds, h, wl):
    bk = seed_ref.window_buckets(genome[None], seeds, h, wl)
    present = torch.zeros(1 << wl, dtype=torch.bool)
    present[bk[bk >= 0]] = True
    return nthash_ref.pack_words(present)


def cfg_of(seeds, h, wl):
    return {"seeds": seeds, "num_hashes": h, "width_log2": wl}


@pytest.mark.parametrize("case", CASES)
def test_screen_reads_vs_reference(case):
    """The filter built through the seed kernels equals the reference's;
    ``screen_reads`` counts what the reference counts, windows with N
    included."""
    seeds, h, wl = CASES[case]
    genome, reads = genome_and_reads(len(case))
    bf = port_filter(genome, seeds, h, wl)
    want_words = ref_words(genome, seeds, h, wl)
    assert torch.equal(bf.words, want_words)
    got = bloom.screen_reads(bf, prepare_codes(reads), seeds, h)
    want = ref_screen.hits(reads, want_words, cfg_of(seeds, h, wl))
    assert got.dtype == torch.int32 and torch.equal(got, want)
    windows = reads.shape[1] - len(seeds[0]) + 1
    # most windows hit, and the substitutions and Ns make some miss
    assert 0 < int(got.sum()) < len(seeds) * reads.shape[0] * windows


def test_reads_shorter_than_k():
    """A batch shorter than k has no window and adds nothing; a short read
    padded with N in a longer batch counts only its own windows."""
    seeds, h, wl = CASES["cell"]
    genome, reads = genome_and_reads(3, length=40, sub=0.0, n_rate=0.0)
    bf = port_filter(genome, seeds, h, wl)
    out = torch.full((4, reads.shape[0]), 5, dtype=torch.int32)
    short = prepare_codes(reads[:, :31])
    assert bloom.screen_reads(bf, short, seeds, h, out=out) is out
    assert bool((out == 5).all())
    padded = reads.clone()
    padded[0, 33:] = 4        # two windows left
    padded[1, 20:] = 4        # none left
    got = bloom.screen_reads(bf, prepare_codes(padded), seeds, h)
    want = ref_screen.hits(padded, ref_words(genome, seeds, h, wl),
                           cfg_of(seeds, h, wl))
    assert torch.equal(got, want)
    assert got[:, 0].tolist() == [2] * 4 and got[:, 1].tolist() == [0] * 4


def test_sentinel_and_out_of_range_buckets_miss():
    """A full filter: every in-range bucket hits, the sentinel, -1 and
    anything past the width never do, in any plane of a seed."""
    wl, s, h = 12, 2, 3
    words = torch.full(((1 << wl) // 32,), -1, dtype=torch.int32)
    rng = np.random.default_rng(5)
    planes = torch.from_numpy(rng.integers(0, 1 << wl, (s * h, 9, 7))
                              .astype(np.int32))
    planes[0, 0, :] = 1 << wl              # seed 0, window 0: sentinel
    planes[4, 1, 2] = -1                   # seed 1, window 1, read 2
    planes[5, 2, 3] = (1 << wl) + 5        # seed 1, window 2, read 3
    got = probe_kernel.probe_counts(planes, words, s, h, wl)
    want = torch.full((s, 7), 9, dtype=torch.int32)
    want[0] -= 1
    want[1, 2] -= 1
    want[1, 3] -= 1
    assert torch.equal(got, want)
    assert torch.equal(probe_kernel.probe_counts_plain(planes, words, s, h,
                                                       wl), want)


def test_out_accumulates_into_a_slice():
    """``out=`` adds in place, pass after pass, into a column slice of a
    wider count tensor, leaving the other columns as they were."""
    seeds, h, wl = CASES["baseline"]
    genome, reads = genome_and_reads(7)
    bf = port_filter(genome, seeds, h, wl)
    tm = prepare_codes(reads)
    one = bloom.screen_reads(bf, tm, seeds, h)
    counts = torch.full((2, 100), 3, dtype=torch.int32)
    view = counts[:, 10:10 + reads.shape[0]]
    for _ in range(3):
        assert bloom.screen_reads(bf, tm, seeds, h, out=view) is view
    assert torch.equal(view, 3 + 3 * one)
    rest = torch.cat([counts[:, :10], counts[:, 10 + reads.shape[0]:]], 1)
    assert bool((rest == 3).all())
    buckets = seed_kernel.hash_seeds_tm_auto(tm, seeds, h, emit_buckets=wl)
    twice = bloom.hits_from_buckets(bf, buckets, num_seeds=2, num_hashes=h,
                                    emitted_width_log2=wl, out=one.clone())
    assert torch.equal(twice, 2 * one)
    stacked = torch.stack(buckets)
    assert torch.equal(bloom.hits_from_buckets(
        bf, stacked, num_seeds=2, num_hashes=h, emitted_width_log2=wl), one)


@pytest.mark.parametrize("case", ["baseline", "one_seed"])
def test_counts_and_filter_vs_jax(case):
    """The port's filter is the JAX package's ``insert`` of its spaced-seed
    hashes of the genome, word for word, and its counts are those of
    ``contains`` over the JAX hashes of the reads, valid windows only.
    (The cell's 32-base seeds take the JAX package seconds to compile; the
    tests above hold them to the reference.)"""
    seeds, h, wl = CASES[case]
    genome, reads = genome_and_reads(11 + len(case), size=400, n=24)
    g = seed_jnp.hash_kmers_seeds(jnp.asarray(genome.numpy()[None]), seeds, h)
    jbf = jbloom.insert(jbloom.BloomFilter.zeros(wl), g.hashes, g.valid, wl,
                        ingestion="scatter")
    bf = port_filter(genome, seeds, h, wl)
    assert np.array_equal(bf.to_numpy(), np.asarray(jbf.words))
    r = seed_jnp.hash_kmers_seeds(jnp.asarray(reads.numpy()), seeds, h)
    want = []
    for s in range(len(seeds)):
        part = U64(r.hashes.hi[..., s * h:(s + 1) * h],
                   r.hashes.lo[..., s * h:(s + 1) * h])
        hit = jbloom.contains(jbf, part, wl) & r.valid
        want.append(np.asarray(hit).sum(1))
    got = bloom.screen_reads(bf, prepare_codes(reads), seeds, h)
    assert np.array_equal(got.numpy(), np.stack(want))


def test_cpu_route_launches_no_kernel():
    seeds, h, wl = CASES["one_seed"]
    genome, reads = genome_and_reads(2)
    bf = port_filter(genome, seeds, h, wl)
    before = probe_kernel.LAUNCHES, seed_kernel.LAUNCHES
    bloom.screen_reads(bf, prepare_codes(reads), seeds, h)
    assert (probe_kernel.LAUNCHES, seed_kernel.LAUNCHES) == before


def _planes(s=2, h=2, w=5, r=3, dtype=torch.int32):
    return torch.zeros((s * h, w, r), dtype=dtype)


@pytest.mark.parametrize("call, match", [
    (lambda bf: bloom.hits_from_buckets(
        bf, _planes(), num_seeds=2, num_hashes=2, emitted_width_log2=13),
     "emitted at width"),
    (lambda bf: bloom.hits_from_buckets(
        bf, _planes(), num_seeds=3, num_hashes=2, emitted_width_log2=12),
     "bucket planes are not"),
    (lambda bf: bloom.hits_from_buckets(
        bf, _planes(h=3), num_seeds=2, num_hashes=2, emitted_width_log2=12),
     "bucket planes are not"),
    (lambda bf: bloom.hits_from_buckets(
        bf, _planes(dtype=torch.int16), num_seeds=2, num_hashes=2,
        emitted_width_log2=12), "int32"),
    (lambda bf: probe_kernel.probe_counts(_planes(), bf.words, 2, 2, 13),
     "words must be"),
    (lambda bf: probe_kernel.probe_counts(
        _planes(), bf.words.to(torch.int64), 2, 2, 12), "words must be"),
    (lambda bf: probe_kernel.probe_counts(_planes(), bf.words, 2, 2, 39),
     "width_log2"),
    (lambda bf: probe_kernel.probe_counts(
        [torch.zeros((5, 3), dtype=torch.int32)] * 3
        + [torch.zeros((5, 4), dtype=torch.int32)], bf.words, 2, 2, 12),
     "one shape"),
    (lambda bf: probe_kernel.probe_counts(
        _planes(), bf.words, 2, 2, 12,
        out=torch.zeros((2, 4), dtype=torch.int32)), "out must be"),
    (lambda bf: probe_kernel.probe_counts(
        _planes(), bf.words, 2, 2, 12,
        out=torch.zeros((3, 2), dtype=torch.int32).T), "out must be"),
    (lambda bf: probe_kernel.probe_counts(_planes()[0], bf.words, 2, 2, 12),
     r"\[S \* h, W, R\]"),
])
def test_rejects(call, match):
    bf = bloom.BloomFilter.zeros(12, device="cpu")
    with pytest.raises(ValueError, match=match):
        call(bf)
