"""The streaming model: reads -> k-mer hashes -> count-min sketch, on one GPU.

Counterpart of ``nthash_tpu/models/pipeline.py`` together with the
single-device part of ``nthash_tpu/parallel/dp.py`` (``fused_count``,
``hash_and_sketch``): with one device there is no shard_map and no psum, so
the per-shard step is the whole step. Multi-GPU, the parallel parse and the
packed host->device format are later work and raise NotImplementedError.

The sketch is updated in place: every step adds its counts into
``pipeline.sketch.rows`` (``rows += counts``) instead of building a new
tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..ops.kmer_kernel import hash_kmers_tm_auto, prepare_codes
from ..ops.kmer_torch import window_valid_tm
from . import sketch as cms


@dataclass
class PipelineConfig:
    k: int = 32
    num_hashes: int = 4
    sketch_width_log2: int = 20
    n_devices: int | None = None  # only one device (None or 1) for now
    #: Selects nothing: kept only so the field list matches the JAX
    #: PipelineConfig. The device of the codes decides the route (the CUDA
    #: kernel for a GPU tensor, its plain version for a CPU one). Any value
    #: but "auto" raises, so a JAX config asking for "pallas" or "jnp" is
    #: not silently ignored.
    engine: str = "auto"
    #: Hash output layout of :meth:`ReadHashingPipeline.step`: True returns
    #: per-hash [W, B] tensors (the kernel's own layout), False one
    #: [B, W, H] stack.
    time_major: bool = True
    #: The JAX package's 2-bit host->device wire format; not ported yet.
    pack_h2d: bool = False


def fused_count_step(codes_tm: torch.Tensor, sketch: cms.CountMinSketch,
                     k: int) -> cms.CountMinSketch:
    """The fast hash->count step: bucket emission in the hash kernel feeding
    the row histogram, no 64-bit hash ever written to device memory. The
    hash goes through ``hash_kmers_tm_auto``, as in the JAX package's
    ``fused_count``: long reads in few numbers take the segmented kernel.

    codes_tm: [L, R] int32 time-major codes (``prepare_codes``); one sketch
    row per nte64 hash. Adds into ``sketch.rows`` in place and returns
    ``sketch``.
    """
    num_rows, width = sketch.rows.shape
    width_log2 = width.bit_length() - 1
    cms.check_width(width_log2)
    buckets = hash_kmers_tm_auto(codes_tm, k, num_rows,
                                 emit_buckets=width_log2)
    return cms.update_from_buckets(sketch, buckets,
                                   emitted_width_log2=width_log2)


class ReadHashingPipeline:
    """Stateful wrapper around the hash+sketch step on one device.

    >>> pipe = ReadHashingPipeline(PipelineConfig(k=32, num_hashes=4,
    ...                                           sketch_width_log2=14))
    >>> hashes, valid = pipe.step(codes_batch)   # per-hash [W, B] hashes
    >>> counts = pipe.query(hashes)              # count-min estimates
    """

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 device="cuda"):
        if config.n_devices not in (None, 1):
            raise NotImplementedError(
                f"n_devices={config.n_devices}: multi-GPU is not ported yet "
                "(ROADMAP)")
        if config.pack_h2d:
            raise NotImplementedError("pack_h2d is not ported yet (ROADMAP)")
        if config.engine != "auto":
            raise ValueError(f"unknown engine {config.engine!r}")
        cms.check_width(config.sketch_width_log2)
        self.config = config
        self.device = torch.device(device)
        self.sketch = cms.CountMinSketch.zeros(
            config.num_hashes, config.sketch_width_log2, self.device)

    def _to_device(self, codes) -> torch.Tensor:
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(codes)
        return codes.to(self.device)

    def step(self, codes):
        """Hash one [B, L] batch and fold its valid k-mers into the sketch.

        Returns (hashes, valid): with the default time-major config, a list
        of ``num_hashes`` int64 [W, B] tensors plus valid [W, B]; with
        ``time_major=False``, one int64 [B, W, H] tensor plus valid [B, W].
        """
        cfg = self.config
        codes = self._to_device(codes)
        wlog = cfg.sketch_width_log2
        tm = prepare_codes(codes)
        hashes = hash_kmers_tm_auto(tm, cfg.k, cfg.num_hashes)  # H x [W, B]
        valid = window_valid_tm(tm, cfg.k)
        sentinel = 1 << wlog
        cms.update_from_buckets(self.sketch, [
            torch.where(valid, cms.buckets(h, wlog), sentinel) for h in hashes
        ], emitted_width_log2=wlog)
        if cfg.time_major:
            return hashes, valid
        return torch.stack(hashes, dim=-1).transpose(0, 1), valid.T

    def query(self, hashes) -> torch.Tensor:
        """Count-min multiplicity estimates for window hashes in either
        :meth:`step` layout (a per-hash list or one stacked tensor)."""
        wlog = self.config.sketch_width_log2
        if isinstance(hashes, torch.Tensor):
            return cms.query(self.sketch, hashes, wlog)
        return cms.query_rows(self.sketch, hashes, wlog)

    def run_file(self, path, batch_size: int = 65536,
                 read_length: int | None = None, prefetch: int = 2,
                 threads: int = 1) -> int:
        """Stream a FASTA/FASTQ file through :meth:`step` (full hashes plus
        the sketch update). Parsing runs in a background thread; valid-k-mer
        counts stay on the device until one sync at the end. Returns the
        total number of valid k-mers hashed."""
        from ..io.stream import Prefetcher, stream_code_batches

        _serial_only(threads)
        counts = []
        with Prefetcher(stream_code_batches(path, batch_size, read_length),
                        depth=prefetch) as pf:
            for batch, _ in pf:
                _, valid = self.step(batch)
                counts.append(valid.sum(dtype=torch.int64))
        return int(torch.stack(counts).sum()) if counts else 0

    def count_file(self, path, batch_size: int = 1 << 18,
                   read_length: int | None = None, prefetch: int = 2,
                   checkpoint_path=None, checkpoint_every: int = 0,
                   threads: int = 1) -> int:
        """Stream a file through :func:`fused_count_step` (bucket emission
        in the hash kernel, row histograms; no 64-bit hash reaches device
        memory): the production streaming configuration.

        Parsing runs in a background thread and nothing synchronises per
        batch, so parse, host->device copy and kernels overlap.

        ``checkpoint_path`` + ``checkpoint_every`` (batches) persist the
        sketch and the file offset just past the last counted record, in
        the JAX package's checkpoint format and run context, so either
        package resumes the other's stream. A rerun with the same
        parameters seeks to that offset and produces a sketch identical to
        an uninterrupted run. Checkpointing needs the native parser.

        Returns the number of reads streamed, including a resumed prefix.
        """
        from ..io.stream import Prefetcher, stream_code_batches
        from ..utils import checkpoint

        with_ckpt = checkpoint_path is not None
        if with_ckpt and threads > 1:
            raise ValueError(
                "checkpointing requires the deterministic serial parse "
                "(threads=1); parallel shard order is nondeterministic"
            )
        _serial_only(threads)
        cfg = self.config
        total = 0
        start_offset = 0
        src = Path(path)
        ctx = {
            "input": f"{src.name}:{src.stat().st_size}",
            "batch_size": int(batch_size),
            "k": int(cfg.k),
            "num_hashes": int(cfg.num_hashes),
            "sketch_width_log2": int(cfg.sketch_width_log2),
        }
        if with_ckpt and Path(checkpoint_path).exists():
            state = checkpoint.load(checkpoint_path, {
                "rows": self.sketch.rows,
                "reads": np.int64(0),
                "offset": np.int64(0),
            }, expect_context=ctx)
            self.sketch = cms.CountMinSketch(state["rows"])
            total = int(state["reads"])
            start_offset = int(state["offset"])

        def save_ckpt(offset):
            checkpoint.save(checkpoint_path, {
                "rows": self.sketch.rows,
                "reads": np.int64(total),
                "offset": np.int64(offset),
            }, context=ctx)

        batches = stream_code_batches(
            path, batch_size, read_length,
            start_offset=start_offset, with_offsets=with_ckpt)
        done = 0
        offset = start_offset
        with Prefetcher(batches, depth=prefetch) as pf:
            for item in pf:
                batch, n = item[0], item[1]
                codes = prepare_codes(self._to_device(batch))
                fused_count_step(codes, self.sketch, cfg.k)
                total += n
                done += 1
                if with_ckpt:
                    offset = item[2]
                    if checkpoint_every and done % checkpoint_every == 0:
                        save_ckpt(offset)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if with_ckpt:
            save_ckpt(offset)
        return total


def _serial_only(threads: int) -> None:
    if threads > 1:
        raise NotImplementedError(
            "threads > 1 (the byte-range parallel parse) is not ported yet "
            "(ROADMAP)")
