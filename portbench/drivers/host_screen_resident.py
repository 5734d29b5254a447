"""Host read screening with spaced seeds against a Bloom filter of a whole
host genome that stays on the card, as BioBloom Tools removes human reads
from a clinical run before pathogen or microbiome analysis.

Set-up makes the filter at the configuration's width first (2^37 bits, 16
GiB of words), so that a program without filters past 2^31 bits fails at
once, then builds it as BioBloomMaker builds one before any categorizer
run: the genome the reads come from (``core/reads.make_genome``) through
``bloom.insert_sequence_seeds``, which hashes it under the seeds in chunks
of bounded size (B1's wide buckets, then C1's wide route). A pass is the
categorizer's work: each time-major batch through ``bloom.screen_reads``
into its slice of one [seeds, reads] count tensor, which every pass adds
into, so that after p passes the counts are p times one pass's and a fault
in any pass shows. The width alone picks the wide routes (int64 buckets),
at the cell's size and at the test size (2^31 bits) alike."""

from __future__ import annotations

import torch

from nthash_tpu_torch.models import bloom
from nthash_tpu_torch.ops.kmer_kernel import prepare_codes
from portbench.core import reads


class Driver:
    def __init__(self, ctx):
        # looked up first: a program without them fails before any set-up
        self.screen = bloom.screen_reads
        build = bloom.insert_sequence_seeds
        cfg = ctx.config
        self.seeds, self.h = tuple(cfg["seeds"]), cfg["num_hashes"]
        self.bf = bloom.BloomFilter.zeros(cfg["width_log2"], device=ctx.device)
        genome, _ = reads.make_genome(cfg, ctx.seed, ctx.device)
        build(self.bf, genome, self.seeds, self.h)
        del genome
        self.tms = [prepare_codes(b) for b in ctx.batches()]
        self.counts = torch.zeros((len(self.seeds), cfg["reads"]),
                                  dtype=torch.int32, device=ctx.device)

    def one_pass(self) -> None:
        start = 0
        for tm in self.tms:
            end = start + tm.shape[1]
            self.screen(self.bf, tm, self.seeds, self.h,
                        out=self.counts[:, start:end])
            start = end

    def state(self):
        return self.counts, self.bf.words

    def close(self) -> None:
        self.tms = self.bf = self.counts = None
