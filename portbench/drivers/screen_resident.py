"""Spaced-seed read screening against a Bloom filter that stays on the
card, as BioBloom Tools' categorizer screens reads with multiple spaced
seeds.

Set-up builds the filter once, as BioBloomMaker builds it before any
categorizer run: the genome the reads come from (``core/reads.make_genome``)
cut into rows of ``GENOME_ROW`` windows (``kmer_kernel.sequence_rows``),
hashed under the seeds to buckets at the filter's width
(``seed_kernel.hash_seeds_tm_auto``) and inserted by
``bloom.insert_from_buckets``. A pass is the categorizer's work: each
time-major batch through ``bloom.screen_reads`` into its slice of one
[seeds, reads] count tensor, which every pass adds into, so that after p
passes the counts are p times one pass's and a fault in any pass shows."""

from __future__ import annotations

import torch

from nthash_tpu_torch.models import bloom
from nthash_tpu_torch.ops import seed_kernel
from nthash_tpu_torch.ops.kmer_kernel import prepare_codes, sequence_rows
from portbench.core import reads

#: Genome windows a row of the set-up build: one segment of B1 a row.
GENOME_ROW = 256


class Driver:
    def __init__(self, ctx):
        # looked up first: a program without it fails before any set-up
        self.screen = bloom.screen_reads
        cfg = ctx.config
        self.seeds, self.h = tuple(cfg["seeds"]), cfg["num_hashes"]
        wl = cfg["width_log2"]
        self.bf = bloom.BloomFilter.zeros(wl, device=ctx.device)
        genome, _ = reads.make_genome(cfg, ctx.seed, ctx.device)
        rows = prepare_codes(sequence_rows(genome, cfg["k"], GENOME_ROW))
        del genome
        bloom.insert_from_buckets(
            self.bf, seed_kernel.hash_seeds_tm_auto(rows, self.seeds, self.h,
                                                    emit_buckets=wl),
            emitted_width_log2=wl)
        del rows
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
