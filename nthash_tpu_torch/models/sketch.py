"""Count-min sketch over k-mer hashes.

Counterpart of ``nthash_tpu/models/sketch.py``. Row r of the sketch counts
the low ``width_log2`` bits of the r-th nte64 hash of every valid window, at
widths 2**10..2**30, through the exact row histogram of
``ops/hist_kernel.py`` at every width (the CUDA kernels on a CUDA sketch:
private counters in shared memory up to 2**15; above that, for batches
large enough to pay, the updates binned by range of 2**15 counters and each
range counted in shared memory, else direct atomics into the rows; its
plain version on a CPU one). Other widths raise
:class:`ValueError`. The JAX package routes its wide sketches through the
sort-partitioned histogram because a TPU core can neither hold a wide row
in VMEM nor scatter; this card can, and ``ops/part_kernel.py``'s
``partitioned_histogram_rows`` stays beside it as that contract's
counterpart, off this path. The JAX ``resolve_ingestion`` choice of MXU,
partitioned or scatter has no counterpart.

``update`` and ``update_from_buckets`` add into ``sketch.rows`` in place and
return the same sketch; ``merge`` returns a new one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.hist_kernel import (
    MAX_WIDTH_LOG2,
    MIN_WIDTH_LOG2,
    histogram_rows,
    rows_view,
)


def check_width(width_log2: int) -> None:
    """Raise ValueError for a width outside [2**10, 2**30]."""
    if not MIN_WIDTH_LOG2 <= width_log2 <= MAX_WIDTH_LOG2:
        raise ValueError(
            f"width_log2 ({width_log2}) must be in "
            f"[{MIN_WIDTH_LOG2}, {MAX_WIDTH_LOG2}]")


class CountMinSketch(NamedTuple):
    """rows[r, b]: count of (hash_r mod width) == b. width = 2**width_log2."""

    rows: torch.Tensor  # [num_rows, width] int32

    @staticmethod
    def zeros(num_rows: int, width_log2: int, device) -> "CountMinSketch":
        return CountMinSketch(
            torch.zeros((num_rows, 1 << width_log2), dtype=torch.int32,
                        device=device))

    @staticmethod
    def from_numpy(rows, device) -> "CountMinSketch":
        """A sketch from [num_rows, width] int32 rows, e.g. the JAX package's
        ``np.asarray(sketch.rows)``."""
        arr = np.asarray(rows)
        if arr.dtype != np.int32 or arr.ndim != 2:
            raise TypeError(
                f"rows must be 2-D int32, got {arr.dtype} {arr.shape}")
        return CountMinSketch(torch.from_numpy(arr.copy()).to(device))

    def to_numpy(self) -> np.ndarray:
        """The rows as a host int32 array (the JAX package's layout)."""
        return self.rows.cpu().numpy()

    @property
    def width(self) -> int:
        return self.rows.shape[1]


def buckets(hashes: torch.Tensor, width_log2: int) -> torch.Tensor:
    """Bucket index per int64 hash: the low ``width_log2`` bits, int32."""
    return (hashes & ((1 << width_log2) - 1)).to(torch.int32)


def update(sketch: CountMinSketch, hashes: torch.Tensor, valid: torch.Tensor,
           width_log2: int) -> CountMinSketch:
    """Count every valid window's hashes into the sketch, in place.

    hashes: int64 [..., num_rows] (last axis = hash index); valid: bool of
    ``hashes.shape[:-1]``, counted as a 0/1 weight shared by the rows.
    """
    check_width(width_log2)
    num_rows = sketch.rows.shape[0]
    idx = buckets(hashes, width_log2).reshape(-1, num_rows).T
    w = valid.reshape(-1).to(torch.int32)
    histogram_rows(idx.contiguous(), w, width_log2, out=sketch.rows)
    return sketch


def update_from_buckets(sketch: CountMinSketch, buckets, *,
                        emitted_width_log2: int | None = None) -> CountMinSketch:
    """Count pre-bucketed indices from the fused hash kernel, in place.

    buckets: ``num_rows`` int32 tensors (any matching shape), as produced by
    ``hash_kmers_tm(..., emit_buckets=width_log2)``; row r of the sketch
    counts tensor r. Invalid windows carry the out-of-range sentinel
    ``width`` and are dropped by the histogram.

    Pass ``emitted_width_log2`` (the ``emit_buckets`` value used at the hash
    kernel) to guard against width drift: buckets emitted at a smaller width
    would count their sentinel as a real bucket of the wider sketch.

    The hash kernel's tensors are consecutive views of one output, and then
    one histogram launch counts all rows through a view of it
    (``ops.hist_kernel.rows_view``); other tensors take one launch each.
    Neither copies the buckets.
    """
    num_rows, width = sketch.rows.shape
    if len(buckets) != num_rows:
        raise ValueError(
            f"got {len(buckets)} bucket arrays for {num_rows} sketch rows")
    width_log2 = width.bit_length() - 1
    if emitted_width_log2 is not None and emitted_width_log2 != width_log2:
        raise ValueError(
            f"buckets were emitted at width 2**{emitted_width_log2} but the "
            f"sketch width is 2**{width_log2}")
    check_width(width_log2)
    rows = rows_view(buckets)
    if rows is not None:
        histogram_rows(rows, None, width_log2, out=sketch.rows)
        return sketch
    for r, b in enumerate(buckets):
        histogram_rows(b.reshape(1, -1), None, width_log2,
                       out=sketch.rows[r:r + 1])
    return sketch


def query(sketch: CountMinSketch, hashes: torch.Tensor,
          width_log2: int) -> torch.Tensor:
    """Count-min estimate: min over rows of the bucket counts.
    hashes: int64 [..., num_rows]; returns int32 [...]."""
    idx = buckets(hashes, width_log2).to(torch.int64)
    per_row = [sketch.rows[r][idx[..., r]] for r in range(sketch.rows.shape[0])]
    return torch.stack(per_row, dim=-1).amin(dim=-1)


def query_rows(sketch: CountMinSketch, hashes, width_log2: int) -> torch.Tensor:
    """Count-min estimate for the time-major layout: ``hashes`` is a list of
    ``num_rows`` int64 tensors (any common shape, e.g. [W, B]); returns
    estimates of that shape."""
    num_rows = sketch.rows.shape[0]
    if len(hashes) != num_rows:
        raise ValueError(
            f"got {len(hashes)} hash arrays for {num_rows} sketch rows")
    est = None
    for r, h in enumerate(hashes):
        got = sketch.rows[r][buckets(h, width_log2).to(torch.int64)]
        est = got if est is None else torch.minimum(est, got)
    return est


def merge(a: CountMinSketch, b: CountMinSketch) -> CountMinSketch:
    """Sketches are linear: merging is elementwise addition (a new sketch)."""
    return CountMinSketch(a.rows + b.rows)
