"""Count-min sketch from reads already on the card: ``fused_count_step``
over the cell's time-major batches, in order, a pass at a time (a GPU
pipeline's path; no parse, no copy)."""

from __future__ import annotations

from nthash_tpu_torch.models.pipeline import fused_count_step
from nthash_tpu_torch.models.sketch import CountMinSketch
from nthash_tpu_torch.ops.kmer_kernel import prepare_codes


class Driver:
    def __init__(self, ctx):
        cfg = ctx.config
        self.k = cfg["k"]
        self.tms = [prepare_codes(b) for b in ctx.batches()]
        self.sketch = CountMinSketch.zeros(cfg["num_hashes"],
                                           cfg["width_log2"], ctx.device)

    def one_pass(self) -> None:
        for tm in self.tms:
            fused_count_step(tm, self.sketch, self.k)

    def state(self):
        return self.sketch.rows

    def close(self) -> None:
        self.tms = self.sketch = None
