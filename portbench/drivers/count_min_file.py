"""Count-min sketch from a FASTQ on disk: back-to-back
``ReadHashingPipeline.count_file`` calls over the cell's file, the
production streaming path (parse, pinned copies, the fused hash->count
step and, under a process group, the all-reduce of each batch's counts)."""

from __future__ import annotations

from nthash_tpu_torch.models.pipeline import PipelineConfig, ReadHashingPipeline


class Driver:
    def __init__(self, ctx):
        cfg = ctx.config
        self.pipe = ReadHashingPipeline(PipelineConfig(
            k=cfg["k"], num_hashes=cfg["num_hashes"],
            sketch_width_log2=cfg["width_log2"]), device=ctx.device)
        self.path = ctx.fastq
        self.batch = ctx.traffic["batch_size"]
        self.threads = ctx.traffic["threads"]

    def one_pass(self) -> int:
        """One call over the whole file; the reads it streamed."""
        return self.pipe.count_file(self.path, batch_size=self.batch,
                                    threads=self.threads)

    def state(self):
        return self.pipe.sketch.rows

    def close(self) -> None:
        self.pipe = None
