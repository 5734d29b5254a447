"""Packed Bloom filter from reads already on the card: a pass builds the
filter anew, from empty: per time-major batch, the hash kernel emits
buckets at the filter's width and ``insert_from_buckets`` sets their bits.
Setting a bit twice changes nothing, so a filter kept across passes would
already hold every bit after the warm-up, and no later pass could show a
fault; built from empty, the words after the window are the last pass's own
work."""

from __future__ import annotations

from nthash_tpu_torch.models import bloom
from nthash_tpu_torch.ops.kmer_kernel import hash_kmers_tm_auto, prepare_codes


class Driver:
    def __init__(self, ctx):
        cfg = ctx.config
        self.k, self.h, self.wl = cfg["k"], cfg["num_hashes"], cfg["width_log2"]
        self.tms = [prepare_codes(b) for b in ctx.batches()]
        self.bf = bloom.BloomFilter.zeros(self.wl, device=ctx.device)

    def one_pass(self) -> None:
        self.bf.words.zero_()
        for tm in self.tms:
            bloom.insert_from_buckets(
                self.bf, hash_kmers_tm_auto(tm, self.k, self.h,
                                            emit_buckets=self.wl),
                emitted_width_log2=self.wl)

    def state(self):
        return self.bf.words

    def close(self) -> None:
        self.tms = self.bf = None
