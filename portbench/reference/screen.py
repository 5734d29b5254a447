"""Plain reference of read screening with spaced seeds against a Bloom
filter of the reads' genome, as BioBloom Tools' categorizer screens reads.

The filter holds every window of the genome ``core/reads.make_genome``
draws for the run's seed: under each seed, each of its ``num_hashes``
hashes (``core/seed_ref``) sets the bit of its low ``width_log2`` bits, in
the filter's word layout (``nthash_ref.pack_words``). A read's count under
a seed is the number of its valid windows whose ``num_hashes`` buckets
under that seed all have their bit set.

The state compared is both parts: the counts [S, reads], to which the
driver adds every pass, the warm-up's too, so after p passes they must be p
times one pass's (``hits_off``, the entries that differ, limit 0); and the
filter the program built in set-up (``filter_words_off``, the words that
differ from the reference's, limit 0). The control queries the 64-bit
filter with 32-bit hashes (``bits=32``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.core import nthash_ref as ref
from portbench.core import reads, seed_ref

#: The configuration's keys at the size the CPU tests run
#: (``tests/small.py``): the genome's bits fill a sixth of the filter, so a
#: wrong bucket misses.
SMALL = {"width_log2": 18}
#: Reads, or genome windows, a block of the reference's work.
BLOCK = 1 << 15
#: The categorizer's default score threshold (``describe`` only).
THRESHOLD = 0.15


class State(NamedTuple):
    counts: torch.Tensor    # int32 [S, reads]
    words: torch.Tensor     # int32 [2**width_log2 / 32]


def _buckets(codes, cfg, bits=64) -> torch.Tensor:
    return seed_ref.window_buckets(codes, cfg["seeds"], cfg["num_hashes"],
                                   cfg["width_log2"], bits)


def genome_words(ctx) -> torch.Tensor:
    """The filter of the genome's windows under every seed, at 64 bits."""
    cfg = ctx.config
    genome, _ = reads.make_genome(cfg, ctx.seed, ctx.device)
    k = len(cfg["seeds"][0])
    present = torch.zeros(1 << cfg["width_log2"], dtype=torch.bool,
                          device=ctx.device)
    for s in range(0, genome.shape[0] - k + 1, BLOCK * 32):
        bk = _buckets(genome[s:s + BLOCK * 32 + k - 1][None], cfg)
        present[bk[bk >= 0]] = True
    return ref.pack_words(present)


def zeros(ctx) -> State:
    cfg = ctx.config
    return State(torch.zeros((len(cfg["seeds"]), cfg["reads"]),
                             dtype=torch.int32, device=ctx.device),
                 genome_words(ctx))


def hits(codes: torch.Tensor, words: torch.Tensor, cfg: dict,
         bits: int = 64) -> torch.Tensor:
    """int32 [S, b]: per seed, the windows of each read whose buckets'
    bits are all set in ``words``."""
    bk = _buckets(codes, cfg, bits)
    got = words[ref.word_of(bk.clamp(min=0))].to(torch.int64)
    bit = ((got >> ((bk >> 7) & 31)) & 1) != 0
    return ((bk >= 0) & bit).all(dim=1).sum(-1, dtype=torch.int32)


def add_pass(ctx, state: State, bits: int = 64) -> State:
    """Add one pass's counts, queried with ``bits``-bit hashes, into
    ``state``."""
    for s in range(0, ctx.codes.shape[0], BLOCK):
        part = ctx.codes[s:s + BLOCK]
        state.counts[:, s:s + part.shape[0]] += hits(part, state.words,
                                                     ctx.config, bits)
    return state


def expected(ctx) -> State:
    return add_pass(ctx, zeros(ctx))


def compare(ctx, state, one_pass: State, passes: int) -> dict:
    counts, words = state
    return {
        "hits_off": {"value": int((counts != passes * one_pass.counts).sum()),
                     "limit": 0},
        "filter_words_off": {"value": int((words != one_pass.words).sum()),
                             "limit": 0},
    }


def describe(ctx, state) -> str:
    counts, words = state
    cfg = ctx.config
    windows = max(0, cfg["read_length"] - cfg["k"] + 1)
    share = counts.to(torch.float64) / max(1, (ctx.passes + 1) * windows)
    x = words.to(torch.int64) & 0xFFFFFFFF
    ones = sum(int(((x >> s) & 1).sum()) for s in range(ref.PACK))
    return (f"hits a window by seed {share.mean(1).tolist()} over {windows} "
            f"windows a read; reads at score >= {THRESHOLD} (best seed) "
            f"{int((share.max(0).values >= THRESHOLD).sum())} of "
            f"{counts.shape[1]}; filter of {words.numel() * ref.PACK} bits: "
            f"{ones} set, fill ratio {ones / (words.numel() * ref.PACK)}")


def distinct_touched(ctx) -> int:
    """Filter words each batch of one pass probes (those of every bucket of
    its valid windows, under every seed), summed over the batches."""
    cfg = ctx.config
    seen = torch.zeros((1 << cfg["width_log2"]) // ref.PACK,
                       dtype=torch.bool, device=ctx.device)
    total = 0
    for batch in ctx.batches():
        seen.zero_()
        for part in ref.blocks(batch, BLOCK):
            bk = _buckets(part, cfg)
            seen[ref.word_of(bk[bk >= 0])] = True
        total += int(seen.sum())
    return total
