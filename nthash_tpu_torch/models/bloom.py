"""Packed Bloom filter over k-mer hashes: 1 bit per bucket, 32 per word.

Counterpart of ``nthash_tpu/models/bloom.py``. ntHash exists to feed Bloom
filters (reference ``include/nthash/nthash.hpp:56-58``); the filter here is
byte for byte the JAX package's: the same words in the same bucket -> (word,
bit) layout (``ops/hist_kernel.word_index`` / ``bit_index``). The words are
an int32 tensor holding the uint32 bit patterns, because PyTorch's CPU
uint32 has neither ``>>`` nor ``index_put_``; :meth:`BloomFilter.from_numpy`
and :meth:`BloomFilter.to_numpy` carry them to and from the JAX package's
``np.asarray(bf.words)``.

Insertion is a scatter-OR: one ``bloom_words`` call (``csrc/bloom.cu``)
at every width, 2**12..2**38. Up to 2**20 each block ORs its share of the
updates into private words in shared memory and merges them into the
filter once; above that, for batches large enough to pay, a binning pass
groups the updates by range of 2**20 bits and each range's words are set in
shared memory and merged once, else the updates go to the filter's words
directly (``ops/hist_kernel.private_words_grid`` and ``binned_words_grid``
pick). From 2**31 bits up (to 2**38, 32 GiB: a whole human reference's
spaced-seed filter) a bucket, or the sentinel, no longer fits an int32,
and the filter takes the wide routes: the seed kernels' int64 buckets
(past 2**30), ``bloom_words``' direct atomics with 64-bit word offsets
(past 2**31) and the probe's ``bloom_probe_wide_kernel`` (past 2**30). The
JAX package stops at 2**31. The
JAX package routes 2**19..2**30 through the sort-partitioned words and
2**31 through an int8 scatter presence, because a TPU core can neither hold
a wide filter in VMEM nor scatter; ``ops/part_kernel.py``'s
``partitioned_bloom_words`` stays as that contract's counterpart, off this
path.

``insert`` and ``insert_from_buckets`` OR into ``bf.words`` in place and
return the same filter; ``merge`` returns a new one. ``contains`` is a
gather and a bit test in plain PyTorch. Screening reads, as BioBloom
Tools' categorizer does with multiple spaced seeds, is ``screen_reads``:
the seed kernels emit buckets at the filter's width and
``hits_from_buckets`` counts, per seed and read, the windows whose bits
are all set (``ops/probe_kernel.py``, ``csrc/probe.cu`` on the card).
``insert_sequence_seeds`` builds such a filter from one sequence of any
length, a reference genome, in chunks of bounded size.
``union_across`` ORs the ranks' words of a process group together: one
all-gather, then an OR-fold over the ranks, as in the JAX package (NCCL
has no bitwise all-reduce).

False-positive tuning: m = 2**width_log2 bits, optimal h ~= (m/n) ln 2.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import seed_kernel
from ..ops.hist_kernel import (
    BLOOM_MAX_WIDTH_LOG2,
    BLOOM_MIN_WIDTH_LOG2,
    MAX_WIDTH_LOG2,
    PACK,
    WIDE_MAX_WIDTH_LOG2,
    bit_index,
    bloom_words,
    rows_view,
    word_index,
)
from ..ops.kmer_kernel import prepare_codes, sequence_codes, sequence_rows
from ..ops.probe_kernel import probe_counts
from ..ops.seed_torch import check_seeds
from ..parallel.mesh import all_gather
from ..utils.profiling import span

#: Windows a row of :func:`insert_sequence_seeds`: one segment of B1 a row.
SEQUENCE_ROW = 256
#: Bytes of one chunk's bucket planes in :func:`insert_sequence_seeds`.
BUILD_CHUNK_BYTES = 1 << 31


def check_width(width_log2: int) -> None:
    """Raise ValueError for a width outside [2**12, 2**38]."""
    if not BLOOM_MIN_WIDTH_LOG2 <= width_log2 <= WIDE_MAX_WIDTH_LOG2:
        raise ValueError(
            f"width_log2 ({width_log2}) must be in "
            f"[{BLOOM_MIN_WIDTH_LOG2}, {WIDE_MAX_WIDTH_LOG2}]")


class BloomFilter(NamedTuple):
    """words[w]: 32 bucket-presence bits per word (1 bit per bucket)."""

    words: torch.Tensor  # [width / 32] int32, the bits of uint32 words

    @staticmethod
    def zeros(width_log2: int, device="cuda") -> "BloomFilter":
        """An empty filter of 2**width_log2 bits (12..38), on the card
        unless the caller names another device."""
        check_width(width_log2)
        return BloomFilter(torch.zeros((1 << width_log2) // PACK,
                                       dtype=torch.int32, device=device))

    @staticmethod
    def from_numpy(words, device) -> "BloomFilter":
        """A filter from uint32 words [width / 32], e.g. the JAX package's
        ``np.asarray(bf.words)``."""
        arr = np.asarray(words)
        if arr.dtype != np.uint32 or arr.ndim != 1:
            raise TypeError(
                f"words must be 1-D uint32, got {arr.dtype} {arr.shape}")
        check_width((arr.size * PACK).bit_length() - 1)
        if arr.size & (arr.size - 1):
            raise ValueError(f"{arr.size} words is not a power-of-two width")
        return BloomFilter(torch.from_numpy(arr.view(np.int32).copy())
                           .to(device))

    def to_numpy(self) -> np.ndarray:
        """The words as host uint32 (the JAX package's layout)."""
        return self.words.cpu().numpy().view(np.uint32)

    @property
    def width(self) -> int:
        return self.words.shape[0] * PACK


def _indices(hashes: torch.Tensor, width_log2: int) -> torch.Tensor:
    """Bucket per int64 hash: the low ``width_log2`` bits, int32 up to
    2**31 bits, int64 past it (``bloom_words``' wide route)."""
    b = hashes & ((1 << width_log2) - 1)
    return b if width_log2 > BLOOM_MAX_WIDTH_LOG2 else b.to(torch.int32)


def pack_presence(presence: torch.Tensor) -> torch.Tensor:
    """[width] {0, 1} -> int32 words [width / 32] in the word_index /
    bit_index layout: bucket b = q * 4096 + s * 128 + j -> bit s of word
    q * 128 + j. Dense, for tests and references: it reads every bucket,
    one bit plane at a time, so its transients are word-sized."""
    width = presence.shape[0]
    p = (presence != 0).reshape(width // 4096, 32, 128)
    words = torch.zeros((width // 4096, 128), dtype=torch.int32,
                        device=presence.device)
    for s in range(32):  # int32 << 31 is bit 31, the sign bit
        words |= p[:, s].to(torch.int32) << s
    return words.reshape(-1)


def insert(bf: BloomFilter, hashes: torch.Tensor, valid: torch.Tensor,
           width_log2: int) -> BloomFilter:
    """Set the bit of every valid window's every hash, in place.

    hashes: int64 [..., H] (H = hash functions per k-mer); valid: bool of
    ``hashes.shape[:-1]``. One ``bloom_words`` launch at every width, the
    validity as its weight. The JAX package's ``ingestion`` choice (MXU
    tiles, partitions or an int8 scatter transient) works around the TPU's
    lack of a scatter-OR; this card has one (atomic ORs, in shared or device
    memory as the shapes decide), so there is nothing to choose. Returns
    ``bf``, its words updated.
    """
    check_width(width_log2)
    if bf.width != 1 << width_log2:
        raise ValueError(
            f"filter width {bf.width} != 2**{width_log2}")
    idx = _indices(hashes, width_log2).reshape(-1)
    keep = valid.reshape(-1, 1).expand(-1, hashes.shape[-1]).reshape(-1)
    bloom_words(idx, keep.to(torch.int32), width_log2, out=bf.words)
    return bf


def emitted_width(bf: BloomFilter, emitted_width_log2: int | None) -> int:
    """The filter's width_log2; a ValueError if the buckets' emitted width
    (None: not given) is another."""
    width_log2 = bf.width.bit_length() - 1
    if emitted_width_log2 is not None and emitted_width_log2 != width_log2:
        raise ValueError(
            f"buckets were emitted at width 2**{emitted_width_log2} but the "
            f"filter width is 2**{width_log2}")
    return width_log2


def insert_from_buckets(bf: BloomFilter, buckets, *,
                        emitted_width_log2: int | None = None) -> BloomFilter:
    """Ingest pre-bucketed indices from the fused hash kernels, in place.

    buckets: int32 tensors (any shapes) from ``hash_kmers_tm(...,
    emit_buckets=width_log2)`` at the filter's width (2**12..2**30: the hash
    kernels emit at most 2**30 as int32), or the int64 wide buckets of
    ``seed_kernel.hash_seeds_tm`` (to 2**38), which take ``bloom_words``'
    wide route. Invalid windows carry the out-of-range sentinel and are
    dropped. Pass ``emitted_width_log2`` (the
    ``emit_buckets`` value used) to guard against width drift: buckets
    emitted at a smaller width would insert their sentinel as a real bit of
    the wider filter.

    The hash kernel's tensors are consecutive views of one output, and then
    one ``bloom_words`` launch takes them all through a view of it
    (``ops.hist_kernel.rows_view``); other tensors take one launch each.
    Neither copies the buckets. Returns ``bf``, its words updated.
    """
    width_log2 = emitted_width(bf, emitted_width_log2)
    wide = buckets[0].dtype == torch.int64
    if width_log2 > MAX_WIDTH_LOG2 and not wide:
        raise ValueError(
            f"int32 buckets are emitted at widths up to 2**{MAX_WIDTH_LOG2}; "
            f"the filter is 2**{width_log2}: its buckets are int64")
    stream = rows_view(buckets)
    for b in (buckets if stream is None else (stream,)):
        bloom_words(b, None, width_log2, out=bf.words)
    return bf


def contains(bf: BloomFilter, hashes: torch.Tensor,
             width_log2: int) -> torch.Tensor:
    """Membership: all H bits set. hashes: int64 [..., H]; returns bool of
    ``hashes.shape[:-1]``."""
    b = _indices(hashes, width_log2)
    got = bf.words[word_index(b).to(torch.int64)]
    # int32 ``>>`` is arithmetic: a word with bit 31 set shifts in ones,
    # so the bit is masked after the shift
    return (((got >> bit_index(b)) & 1) != 0).all(dim=-1)


def insert_sequence_seeds(bf: BloomFilter, codes: torch.Tensor, seeds,
                          num_hashes_per_seed: int) -> BloomFilter:
    """Insert every window of one sequence under spaced seeds, in place.

    codes: [C] base codes, any length (a chromosome, or a whole reference
    joined), as ``kmer_kernel.sequence_codes`` takes them: 0-3, anything
    else invalid. The windows go in chunks of as many rows of
    ``SEQUENCE_ROW`` windows (``kmer_kernel.sequence_rows``) as
    ``BUILD_CHUNK_BYTES`` of bucket planes hold, at least one, each chunk
    hashed under every seed to buckets at the filter's width by
    ``seed_kernel.hash_seeds_tm_auto`` (B1) and inserted by
    :func:`insert_from_buckets` (C1), so that a chunk's transients stay
    near that size whatever C is. A window holding an invalid base sets
    nothing; one that straddles two chunks is hashed in the later. The
    route follows from the width (the wide buckets past 2**30). Runs inside
    the span ``nthash.build``. Returns ``bf``, its words updated.
    """
    seeds = tuple(seeds)
    k = check_seeds(seeds)
    width_log2 = bf.width.bit_length() - 1
    row_bytes = (seed_kernel.bucket_dtype(width_log2).itemsize
                 * len(seeds) * num_hashes_per_seed * SEQUENCE_ROW)
    chunk = max(1, BUILD_CHUNK_BYTES // row_bytes) * SEQUENCE_ROW
    with span("nthash.build"):
        codes = sequence_codes(codes)
        for s in range(0, codes.shape[0] - k + 1, chunk):
            rows = prepare_codes(sequence_rows(codes[s:s + chunk + k - 1], k,
                                               SEQUENCE_ROW))
            insert_from_buckets(bf, seed_kernel.hash_seeds_tm_auto(
                rows, seeds, num_hashes_per_seed, emit_buckets=width_log2),
                emitted_width_log2=width_log2)
    return bf


def hits_from_buckets(bf: BloomFilter, buckets, *, num_seeds: int,
                      num_hashes: int, emitted_width_log2: int,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Per seed, the windows of each read whose every bucket's bit is set.

    buckets: int32 [S * h, W, R] (int64 past 2**30 bits, the wide probe),
    or that list of [W, R] views, from
    ``seed_kernel.hash_seeds_tm(..., emit_buckets=width_log2)`` in its
    seed-major order (``num_seeds`` S, ``num_hashes`` h a seed), read
    where they lie. ``emitted_width_log2`` must be the filter's width:
    buckets emitted narrower would probe their sentinel as a real bit.
    A window holding an invalid base carries the sentinel and counts for no
    seed. ``out``: int32 [S, R] added into in place (each row's reads
    adjacent; the rows may be a slice of a wider tensor), else a new one.
    Returns ``out``; the probe kernel (``ops/probe_kernel.probe_counts``)
    on the card, its plain version on the CPU.
    """
    return probe_counts(buckets, bf.words, num_seeds, num_hashes,
                        emitted_width(bf, emitted_width_log2), out=out)


def screen_reads(bf: BloomFilter, codes_tm: torch.Tensor, seeds,
                 num_hashes_per_seed: int,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Screen time-major reads against the filter under spaced seeds.

    Every window of codes_tm [L, R] (``ops/kmer_kernel.prepare_codes``) is
    hashed under each of ``seeds`` (``num_hashes_per_seed`` hashes a seed)
    to buckets at the filter's width by
    ``seed_kernel.hash_seeds_tm_auto``, then probed by
    :func:`hits_from_buckets`. Returns int32 [S, R], added into ``out``:
    per seed, the windows of each read whose bits are all set. Reads
    shorter than k (L < k) have no window and add nothing. A read's score
    (its hits over its windows) and the threshold it is held to are the
    caller's. Filters past 2**30 bits take the wide buckets and probe.
    """
    seeds = tuple(seeds)
    k = check_seeds(seeds)
    width_log2 = bf.width.bit_length() - 1
    if out is None:
        out = torch.zeros((len(seeds), codes_tm.shape[1]), dtype=torch.int32,
                          device=bf.words.device)
    if codes_tm.shape[0] < k:
        return out
    buckets = seed_kernel.hash_seeds_tm_auto(
        codes_tm, seeds, num_hashes_per_seed, emit_buckets=width_log2)
    return hits_from_buckets(bf, buckets, num_seeds=len(seeds),
                             num_hashes=num_hashes_per_seed,
                             emitted_width_log2=width_log2, out=out)


def merge(a: BloomFilter, b: BloomFilter) -> BloomFilter:
    """Union (bitwise OR), as a new filter."""
    return BloomFilter(a.words | b.words)


def union_across(words: torch.Tensor, mesh_or_group) -> torch.Tensor:
    """Union of every rank's words over a ``DeviceMesh`` or process group:
    one all-gather, then an OR-fold over the rank axis (OR is not linear,
    so no sum applies to packed words; the gather moves width / 32 words a
    rank). Returns a new tensor of ``words``' shape, the same on every
    rank."""
    gathered = all_gather(words, mesh_or_group)      # [ranks, *shape]
    out = gathered[0]
    for other in gathered[1:]:
        out |= other
    return out


def count_set_bits(bf: BloomFilter) -> torch.Tensor:
    """Total set bits, a 0-d int64 tensor. PyTorch has no popcount: a SWAR
    popcount of each word, widened to int64 so bit 31 counts once."""
    x = bf.words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum()


def fill_ratio(bf: BloomFilter) -> torch.Tensor:
    """Fraction of set bits, a 0-d float64 tensor (false-positive rate ~=
    ratio**H)."""
    return count_set_bits(bf).to(torch.float64) / bf.width
