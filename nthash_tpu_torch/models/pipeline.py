"""The streaming model: reads -> k-mer hashes -> merged count-min sketch.

Counterpart of ``nthash_tpu/models/pipeline.py``. Read batches stream
data-parallel over the GPUs of a process group, one process a GPU: every
rank streams the same file, takes its block of each batch
(``parallel/dp.shard_reads``), hashes it, and the batch's counts merge into
every rank's sketch with one all-reduce (``parallel/dp.py``). Without a
process group the pipeline runs on its one device with no collective.

A file streams by one of four routes: one parse thread or ``threads``
byte-range shards (``io/stream.py``), each carrying codes or, with
``pack_h2d``, the 2-bit wire format. On a CUDA device every route copies
its batches to the card from pinned host buffers, asynchronously, on a side
stream (``io/pinned.py``); on the CPU nothing is copied or pinned.

The sketch is updated in place: every step adds its counts into
``pipeline.sketch.rows`` (``rows += counts``) instead of building a new
tensor.

While a ``torch.profiler`` runs, the consumer's work on batch n of a stream
is named on its timeline (``utils/profiling.span``): ``nthash.stream.wait#n``
(waiting for the parse; the last one, past the last batch, for the end of
the stream), ``nthash.copy#n`` (the host side of the copy) and
``nthash.step#n`` (hash, count and merge), and ``nthash.checkpoint`` a
checkpoint written. The serial parse numbers its batches alike
(``nthash.parse#n``, ``io/stream.py``), so one batch's spans share n.
"""

from __future__ import annotations

import threading
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..io.pinned import PinnedBuffers
from ..ops.kmer_kernel import hash_kmers_tm_auto
from ..parallel import dp
from ..parallel.mesh import all_reduce_sum, device_mesh, size_and_rank
from ..utils.profiling import numbered, span
from . import sketch as cms


@dataclass
class PipelineConfig:
    k: int = 32
    num_hashes: int = 4
    sketch_width_log2: int = 20
    #: Devices to shard the reads over: None means the world size of the
    #: process group (1 without one); any other value than the world size
    #: raises ValueError.
    n_devices: int | None = None
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
    #: count_file only: pack each batch on the host to 2 bits a base plus
    #: an N bitmap (``io/stream.py::pack_codes``, in the parse threads) and
    #: unpack it on the card (``ops/unpack_kernel.py``): 2.63x fewer bytes
    #: over the host->device link at 150 bp, and the same sketch. Off by
    #: default, as in the JAX package.
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


def _reused_per_thread():
    """An ``alloc`` that gives each thread one array it fills again: for
    batches packed before their thread parses the next."""
    local = threading.local()

    def alloc(shape):
        buf = getattr(local, "buf", None)
        if buf is None or buf.shape != shape:
            buf = local.buf = np.empty(shape, np.uint8)
        return buf

    return alloc


class ReadHashingPipeline:
    """Stateful wrapper around the distributed hash+sketch step.

    Under a process group (``parallel/mesh.initialize_distributed``) it
    shards every batch over a mesh of the whole group (``self.mesh``) and
    every rank holds the merged sketch; without one, ``self.mesh`` is None
    and the one device does all the work.

    >>> pipe = ReadHashingPipeline(PipelineConfig(k=32, num_hashes=4,
    ...                                           sketch_width_log2=14))
    >>> hashes, valid = pipe.step(codes_batch)   # per-hash [W, B] hashes
    >>> counts = pipe.query(hashes)              # count-min estimates
    """

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 device="cuda"):
        if config.engine != "auto":
            raise ValueError(f"unknown engine {config.engine!r}")
        cms.check_width(config.sketch_width_log2)
        self.config = config
        self.device = torch.device(device)
        if dist.is_initialized():
            self.mesh = device_mesh(config.n_devices,
                                    device_type=self.device.type)
        elif config.n_devices in (None, 1):
            self.mesh = None
        else:
            raise ValueError(
                f"n_devices={config.n_devices}: no process group, so one "
                "device; start one process per device and call "
                "parallel.mesh.initialize_distributed")
        self.sketch = cms.CountMinSketch.zeros(
            config.num_hashes, config.sketch_width_log2, self.device)

    @property
    def n_devices(self) -> int:
        """Devices the reads are sharded over (the world size, or 1)."""
        return 1 if self.mesh is None else self.mesh.size()

    def _pool(self, threads: int, prefetch: int):
        """Pinned buffers for one stream on a CUDA device (None elsewhere):
        one a parse thread fills, the prefetch queue's and two more, so the
        copy in flight and the consumer's batch do not stall the parse."""
        if self.device.type != "cuda":
            return None
        return PinnedBuffers(self.device, max(1, threads) + prefetch + 2)

    @staticmethod
    def _host_batches(path, batch_size, read_length, threads, pool, pack,
                      start_offset=0, with_offsets=False):
        """The stream of host items: (codes, n, ...) or, with ``pack``,
        ((packed, nmask, L), n, ...), in ``pool``'s pinned buffers where
        there is a pool. The parser writes codes straight into a pinned
        buffer; packed, it refills one array per thread and ``pack_codes``
        writes the planes into a pinned buffer, in the thread that parsed
        them (each shard's worker when ``threads > 1``)."""
        from ..io.stream import (
            packed_batches, stream_code_batches, stream_code_batches_parallel,
        )

        stage = None
        if pack:
            alloc = _reused_per_thread()
            planes = None if pool is None else pool.arrays

            def stage(item):
                (packed,) = packed_batches([item], planes)
                return packed
        elif pool is not None:
            def alloc(shape):
                return pool.arrays(shape)[0]
        else:
            alloc = None
        if threads > 1:
            return stream_code_batches_parallel(
                path, batch_size, read_length, threads=threads, alloc=alloc,
                stage=stage)
        src = stream_code_batches(
            path, batch_size, read_length, start_offset=start_offset,
            with_offsets=with_offsets, alloc=alloc)
        return src if stage is None else (stage(item) for item in src)

    def _to_device(self, pool, *arrays,
                   n: int | None = None) -> tuple[torch.Tensor, ...]:
        """Host arrays of item ``n`` -> uint8 tensors on the device: one
        asynchronous copy from ``pool``'s pinned buffer, or none at all on
        the CPU; inside the span ``nthash.copy#n``."""
        with span("nthash.copy", n):
            if pool is None:
                return tuple(torch.from_numpy(a).to(self.device)
                             for a in arrays)
            return pool.to_device(*arrays)

    def step(self, codes):
        """Hash this rank's block of one [B, L] batch (B divisible by the
        mesh's size) and fold the whole batch's valid k-mers into the
        sketch.

        Returns (hashes, valid) of this rank's b = B / n reads: with the
        default time-major config, a list of ``num_hashes`` int64 [W, b]
        tensors plus valid [W, b]; with ``time_major=False``, one int64
        [b, W, H] tensor plus valid [b, W].
        """
        cfg = self.config
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(codes)
        codes = dp.shard_reads(codes, self.mesh).to(self.device)
        # "kernel": the config's engine selects nothing (see PipelineConfig)
        hashes, valid, _ = dp.hash_and_sketch(
            codes, self.sketch, cfg.k, cfg.num_hashes, cfg.sketch_width_log2,
            self.mesh, "kernel", time_major=cfg.time_major)
        return hashes, valid

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
        the sketch update). Parsing runs in a background thread, or in
        ``threads`` byte-range shard threads
        (``io/stream.stream_code_batches_parallel``, which needs the native
        parser); valid-k-mer counts stay on the device until one sync at the
        end. Under a process group every rank streams the whole file and
        hashes its block of each batch (``batch_size`` rounded up to a
        multiple of the world size); the total is the whole file's.
        Returns the total number of valid k-mers hashed."""
        from ..io.stream import Prefetcher

        batch_size += (-batch_size) % self.n_devices
        pool = self._pool(threads, prefetch)
        src = self._host_batches(path, batch_size, read_length, threads,
                                 pool, pack=False)
        counts = []
        with Prefetcher(src, depth=prefetch) as pf, pool or nullcontext():
            for n, (batch, _) in numbered(iter(pf), "nthash.stream.wait"):
                (codes,) = self._to_device(pool, batch, n=n)
                with span("nthash.step", n):
                    _, valid = self.step(codes)
                counts.append(valid.sum(dtype=torch.int64))
        total = (torch.stack(counts).sum() if counts
                 else torch.zeros((), dtype=torch.int64, device=self.device))
        if self.mesh is not None:
            all_reduce_sum(total, self.mesh)
        return int(total)

    def count_file(self, path, batch_size: int = 1 << 18,
                   read_length: int | None = None, prefetch: int = 2,
                   checkpoint_path=None, checkpoint_every: int = 0,
                   threads: int = 1) -> int:
        """Stream a file through :func:`fused_count_step` (bucket emission
        in the hash kernel, row histograms; no 64-bit hash reaches device
        memory): the production streaming configuration.

        Parsing runs in a background thread (or ``threads`` byte-range
        shard threads: batch order is then nondeterministic, and the sketch
        order-invariant) and nothing synchronises per batch, so parse,
        host->device copy and kernels overlap. ``pack_h2d`` ships the 2-bit
        wire format and unpacks it on the device
        (``parallel/dp.fused_count_packed``).

        ``checkpoint_path`` + ``checkpoint_every`` (batches) persist the
        sketch and the file offset just past the last counted record, in
        the JAX package's checkpoint format and run context, so either
        package resumes the other's stream. A rerun with the same
        parameters seeks to that offset and produces a sketch identical to
        an uninterrupted run. Checkpointing needs the native parser.

        Under a process group every rank streams the whole file, copies
        each batch to its device and counts its block (``batch_size``
        rounded up to a multiple of the world size, as in the JAX package);
        the counts merge into every rank's sketch. The checkpoint holds the merged sketch: rank 0 writes
        it, every rank resumes from it, and no rank returns before the last
        one is written.

        Returns the number of reads streamed, including a resumed prefix.
        """
        from ..io.stream import Prefetcher
        from ..utils import checkpoint

        with_ckpt = checkpoint_path is not None
        if with_ckpt and threads > 1:
            raise ValueError(
                "checkpointing requires the deterministic serial parse "
                "(threads=1); parallel shard order is nondeterministic"
            )
        cfg = self.config
        batch_size += (-batch_size) % self.n_devices
        writes = self.mesh is None or size_and_rank(self.mesh)[1] == 0
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
            if not writes:
                return
            with span("nthash.checkpoint"):
                checkpoint.save(checkpoint_path, {
                    "rows": self.sketch.rows,
                    "reads": np.int64(total),
                    "offset": np.int64(offset),
                }, context=ctx)

        pool = self._pool(threads, prefetch)
        src_it = self._host_batches(
            path, batch_size, read_length, threads, pool, cfg.pack_h2d,
            start_offset=start_offset, with_offsets=with_ckpt)
        offset = start_offset
        with Prefetcher(src_it, depth=prefetch) as pf, pool or nullcontext():
            for n, item in numbered(iter(pf), "nthash.stream.wait"):
                batch, reads = item[0], item[1]
                if cfg.pack_h2d:
                    packed, nmask, length = batch
                    packed, nmask = self._to_device(pool, packed, nmask, n=n)
                    with span("nthash.step", n):
                        dp.fused_count_packed(
                            dp.shard_reads(packed, self.mesh),
                            dp.shard_reads(nmask, self.mesh), self.sketch,
                            cfg.k, length, self.mesh)
                else:
                    (codes,) = self._to_device(pool, batch, n=n)
                    with span("nthash.step", n):
                        dp.fused_count(dp.shard_reads(codes, self.mesh),
                                       self.sketch, cfg.k, self.mesh)
                total += reads
                if with_ckpt:
                    offset = item[2]
                    if checkpoint_every and (n + 1) % checkpoint_every == 0:
                        save_ckpt(offset)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if with_ckpt:
            save_ckpt(offset)
            if self.mesh is not None:
                dist.barrier(group=self.mesh.get_group())
        return total
