"""Plain reference of host read screening with spaced seeds against a Bloom
filter of a whole host genome, as BioBloom Tools removes human reads before
pathogen or microbiome analysis.

The definition is ``reference/screen.py``'s, whose state, counts and pass
this file takes as they are: the filter holds every window
of the genome ``core/reads.make_genome`` draws for the run's seed; under
each seed, each of its ``num_hashes`` hashes (``core/seed_ref``) sets the
bit of its low ``width_log2`` bits, in the filter's word layout
(``nthash_ref.word_of``, bit ``(b >> 7) & 31``). A read's count under a seed
is the number of its valid windows whose ``num_hashes`` buckets under that
seed all have their bit set.

At the configuration's 2^37 bits (16 GiB of words) no presence map of the
width fits beside the filter, so the words are built block by block of the
genome's windows (:func:`set_bits`): each block's bits are stored into
their words with ``index_put_`` (a word that two buckets of one block share
keeps one of the two stores), and the stores are repeated for the buckets
whose bit does not show yet, until every bucket's bit shows. A store only
adds bits of the block's buckets to what the word held, so the words end
with exactly the genome's bits. Words past 2^31 take int64 offsets
throughout.

The state compared is both parts: the counts [S, reads], to which the
driver adds every pass, the warm-up's too, so after p passes they must be p
times one pass's (``hits_off``, limit 0); and the filter the program built
in set-up (``filter_words_off``, limit 0). The control queries the 64-bit
filter with 32-bit hashes (``bits=32``).

This file imports nothing of the program: it is the yardstick's own copy.
"""

from __future__ import annotations

import torch

from portbench.core import nthash_ref as ref
from portbench.core import reads, seed_ref
from portbench.reference.screen import BLOCK, THRESHOLD, State, add_pass

#: The configuration's keys at the size the CPU tests run
#: (``tests/small.py``): the narrowest filter whose buckets the width alone
#: makes int64 (256 MiB of words), so that the test size runs the cell's
#: routes; the genome's bits fill almost none of it, so a wrong bucket
#: misses.
SMALL = {"width_log2": 31}
#: Genome windows a block of the filter's build: 16 int64 buckets a
#: window, 512 MiB a block.
GENOME_BLOCK = 1 << 22
#: Words a slice of the comparisons and the popcount.
SLICE = 1 << 26
#: Words a 32-byte sector of the filter.
SECTOR_WORDS = 8


def _buckets(codes, cfg, bits=64) -> torch.Tensor:
    return seed_ref.window_buckets(codes, cfg["seeds"], cfg["num_hashes"],
                                   cfg["width_log2"], bits)


def set_bits(words: torch.Tensor, buckets: torch.Tensor) -> None:
    """Set the bit of every bucket (int64, >= 0) in ``words``, in place."""
    word = ref.word_of(buckets)
    mask = torch.ones_like(buckets) << ((buckets >> 7) & 31)
    mask = (mask - ((mask >> 31) << 32)).to(torch.int32)   # uint32 bits
    while word.numel():
        words.index_put_((word,), words[word] | mask)
        missing = (words[word] & mask) == 0
        word, mask = word[missing], mask[missing]


def genome_words(ctx) -> torch.Tensor:
    """The filter of the genome's windows under every seed, at 64 bits."""
    cfg = ctx.config
    genome, _ = reads.make_genome(cfg, ctx.seed, ctx.device)
    k = len(cfg["seeds"][0])
    words = torch.zeros((1 << cfg["width_log2"]) // ref.PACK,
                        dtype=torch.int32, device=ctx.device)
    for s in range(0, genome.shape[0] - k + 1, GENOME_BLOCK):
        bk = _buckets(genome[s:s + GENOME_BLOCK + k - 1][None], cfg)
        set_bits(words, bk[bk >= 0])
    return words


def zeros(ctx) -> State:
    cfg = ctx.config
    return State(torch.zeros((len(cfg["seeds"]), cfg["reads"]),
                             dtype=torch.int32, device=ctx.device),
                 genome_words(ctx))


def expected(ctx) -> State:
    return add_pass(ctx, zeros(ctx))


def words_off(a: torch.Tensor, b: torch.Tensor) -> int:
    """Words that differ, a slice at a time."""
    return sum(int((x != y).sum()) for x, y in zip(a.split(SLICE),
                                                   b.split(SLICE)))


def compare(ctx, state, one_pass: State, passes: int) -> dict:
    counts, words = state
    return {
        "hits_off": {"value": int((counts != passes * one_pass.counts).sum()),
                     "limit": 0},
        "filter_words_off": {"value": words_off(words, one_pass.words),
                             "limit": 0},
    }


def set_bit_count(words: torch.Tensor) -> int:
    """Set bits of the words, a slice at a time (a SWAR popcount)."""
    total = 0
    for part in words.split(SLICE):
        x = part.to(torch.int64) & 0xFFFFFFFF
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        total += int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())
    return total


def describe(ctx, state) -> str:
    counts, words = state
    cfg = ctx.config
    windows = max(0, cfg["read_length"] - cfg["k"] + 1)
    share = counts.to(torch.float64) / max(1, (ctx.passes + 1) * windows)
    ones = set_bit_count(words)
    width = words.numel() * ref.PACK
    return (f"hits a window by seed {share.mean(1).tolist()} over {windows} "
            f"windows a read; host reads at score >= {THRESHOLD} (best "
            f"seed) {int((share.max(0).values >= THRESHOLD).sum())} of "
            f"{counts.shape[1]}; filter of {width} bits: {ones} set, fill "
            f"ratio {ones / width}")


def distinct_touched(ctx) -> int:
    """Distinct 32-byte filter sectors (8 words) each batch of one pass
    probes (those of every bucket of its valid windows, under every seed),
    summed over the batches."""
    cfg = ctx.config
    seen = torch.zeros((1 << cfg["width_log2"]) // ref.PACK // SECTOR_WORDS,
                       dtype=torch.bool, device=ctx.device)
    total = 0
    for batch in ctx.batches():
        seen.zero_()
        for part in ref.blocks(batch, BLOCK):
            bk = _buckets(part, cfg)
            seen[ref.word_of(bk[bk >= 0]) // SECTOR_WORDS] = True
        total += int(seen.sum())
    return total
