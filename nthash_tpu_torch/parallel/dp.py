"""Data-parallel read sharding: every rank hashes its block of a batch.

Counterpart of ``nthash_tpu/parallel/dp.py``. There a [B, L] batch is
sharded over the "reads" mesh axis with ``shard_map``, each device hashes
its shard and the per-device count-min sketches merge with one ``psum``.
Here one process a GPU takes its contiguous block of rows
(:func:`shard_reads`), hashes it on its device, and the batch's counts merge
with one ``all_reduce`` over the mesh's group.

The merge follows the JAX step, ``rows + psum(counts)``: each batch is
counted into a zeroed buffer, the buffer is all-reduced and then added to
the sketch's rows. Reducing the rows themselves would multiply the earlier
batches' counts by the world size. int32 counts wrap, as ``psum`` does.

Every function takes ``mesh=None`` for one device without a process group:
it then counts straight into the sketch, with no buffer and no collective,
the one-device route of ``models/pipeline.py``.

``unpack_codes_tm`` and ``unpack_codes`` invert ``io/stream.py::pack_codes``
on the device (``ops/unpack_kernel.py``) for :func:`fused_count_packed`.
"""

from __future__ import annotations

import torch

from ..models import sketch as cms
from ..ops.kmer_kernel import hash_kmers_tm_auto, prepare_codes
from ..ops.kmer_torch import hash_kmers, window_valid_tm
from ..ops.unpack_kernel import unpack_codes_tm
from ..utils.profiling import span
from .mesh import all_reduce_sum, size_and_rank

ENGINES = ("kernel", "torch")


def resolve_engine(engine: str = "auto", device=None) -> str:
    """'auto' -> "kernel" (the wrappers of ``ops/*_kernel.py``: the CUDA
    kernels for a GPU tensor, their plain versions for a CPU one), or
    "torch" (the batch-major reference engines of ``ops/*_torch.py``).
    "auto" takes "kernel" on a CUDA device and "torch" elsewhere, as the
    JAX package takes its Pallas kernel on a TPU only."""
    if engine == "auto":
        return "kernel" if torch.device(device or "cpu").type == "cuda" \
            else "torch"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: one of {ENGINES}")
    return engine


def shard_reads(codes: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous block of the [B, L] batch's rows (a view).
    B must divide by the mesh's size, as a ``NamedSharding`` requires;
    ``mesh=None`` (one device) returns the whole batch."""
    if mesh is None:
        return codes
    n, r = size_and_rank(mesh)
    if codes.shape[0] % n:
        raise ValueError(
            f"a batch of {codes.shape[0]} reads does not divide over the "
            f"{n}-rank reads mesh")
    b = codes.shape[0] // n
    return codes[r * b:(r + 1) * b]


def _counted(sketch: cms.CountMinSketch, mesh, count) -> cms.CountMinSketch:
    """Run ``count(target)``, which adds one batch's counts into a sketch:
    into ``sketch`` itself on one device; else into a zeroed buffer that
    is all-reduced over the mesh and then added to ``sketch.rows``.
    Returns ``sketch``, updated in place."""
    if mesh is None:
        count(sketch)
        return sketch
    counts = cms.CountMinSketch(torch.zeros_like(sketch.rows))
    count(counts)
    return _merge(sketch, counts.rows, mesh)


def _merge(sketch: cms.CountMinSketch, counts: torch.Tensor,
           mesh) -> cms.CountMinSketch:
    """``sketch.rows += sum of counts over the mesh``, in place, inside the
    span ``nthash.allreduce``."""
    with span("nthash.allreduce"):
        sketch.rows.add_(all_reduce_sum(counts, mesh))
    return sketch


def fused_count(codes: torch.Tensor, sketch: cms.CountMinSketch, k: int,
                mesh=None) -> cms.CountMinSketch:
    """Distributed fused counting: this rank's block of reads through
    ``fused_count_step`` (bucket emission in the hash kernel feeding the row
    histogram; no 64-bit hash reaches device memory), the counts merged
    over the mesh.

    codes: this rank's [b, L] uint8 reads (:func:`shard_reads`); one sketch
    row per nte64 hash. Adds the merged counts into ``sketch.rows`` in
    place on every rank and returns ``sketch``.
    """
    from ..models.pipeline import fused_count_step

    tm = prepare_codes(codes)
    return _counted(sketch, mesh, lambda s: fused_count_step(tm, s, k))


def unpack_codes(packed: torch.Tensor, nmask: torch.Tensor,
                 length: int) -> torch.Tensor:
    """Batch-major inverse of ``pack_codes``: -> [B, length] uint8. The
    counting path uses :func:`unpack_codes_tm`, the kernels' layout."""
    return unpack_codes_tm(packed, nmask, length).T.to(torch.uint8)


def fused_count_packed(packed: torch.Tensor, nmask: torch.Tensor,
                       sketch: cms.CountMinSketch, k: int, length: int,
                       mesh=None) -> cms.CountMinSketch:
    """:func:`fused_count` over a ``pack_codes``-compressed block: the wire
    carries 2 bits a base and 1 N bit a base, unpacked on the device
    straight into the hash kernel's layout. ``packed`` and ``nmask`` are
    this rank's rows (:func:`shard_reads` of each). Adds into
    ``sketch.rows`` in place and returns ``sketch``."""
    from ..models.pipeline import fused_count_step

    tm = unpack_codes_tm(packed, nmask, length)
    return _counted(sketch, mesh, lambda s: fused_count_step(tm, s, k))


def hash_and_sketch(codes: torch.Tensor, sketch: cms.CountMinSketch, k: int,
                    num_hashes: int, width_log2: int, mesh=None,
                    engine: str = "auto", time_major: bool = False):
    """One full distributed step: hash this rank's block, count its valid
    windows, merge the counts over the mesh into the sketch.

    codes: this rank's [b, L] reads (:func:`shard_reads`). ``engine``:
    "auto", "kernel" or "torch" (:func:`resolve_engine`).

    Returns (hashes, valid, sketch), the hashes and validity of this rank's
    block: one int64 [b, W, H] tensor and valid [b, W] by default; with
    ``time_major`` a list of ``num_hashes`` int64 [W, b] tensors and valid
    [W, b], the kernel's own layout. ``sketch.rows`` gains the merged
    counts in place on every rank.
    """
    cms.check_width(width_log2)
    if resolve_engine(engine, codes.device) == "kernel":
        tm = prepare_codes(codes)
        hashes = hash_kmers_tm_auto(tm, k, num_hashes)   # H x [W, b]
        valid = window_valid_tm(tm, k)
        sentinel = 1 << width_log2
        _counted(sketch, mesh, lambda s: cms.update_from_buckets(s, [
            torch.where(valid, cms.buckets(h, width_log2), sentinel)
            for h in hashes], emitted_width_log2=width_log2))
        if time_major:
            return hashes, valid, sketch
        return torch.stack(hashes, dim=-1).transpose(0, 1), valid.T, sketch
    res = hash_kmers(codes, k, num_hashes)             # [b, W, H], [b, W]
    _counted(sketch, mesh,
             lambda s: cms.update(s, res.hashes, res.valid, width_log2))
    if time_major:
        return ([res.hashes[..., i].T for i in range(num_hashes)],
                res.valid.T, sketch)
    return res.hashes, res.valid, sketch
