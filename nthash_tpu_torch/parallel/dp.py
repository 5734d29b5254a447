"""The one-device part of ``nthash_tpu/parallel/dp.py``: the packed step.

``unpack_codes_tm`` and ``unpack_codes`` invert ``io/stream.py::pack_codes``
on the device (``ops/unpack_kernel.py``), and :func:`fused_count_packed`
counts a packed batch: unpack, then the fused hash->count step.

On one device there is no ``shard_map`` and no ``psum``, and no read
padding: the port's kernels take any number of reads. ``shard_reads``,
``fused_count``, ``hash_and_sketch`` and a ``mesh`` argument wait for
multi-GPU (ROADMAP §1, item 5).
"""

from __future__ import annotations

import torch

from ..models import sketch as cms
from ..ops.unpack_kernel import unpack_codes_tm


def unpack_codes(packed: torch.Tensor, nmask: torch.Tensor,
                 length: int) -> torch.Tensor:
    """Batch-major inverse of ``pack_codes``: -> [B, length] uint8. The
    counting path uses :func:`unpack_codes_tm`, the kernels' layout."""
    return unpack_codes_tm(packed, nmask, length).T.to(torch.uint8)


def fused_count_packed(packed: torch.Tensor, nmask: torch.Tensor,
                       sketch: cms.CountMinSketch, k: int,
                       length: int) -> cms.CountMinSketch:
    """``fused_count_step`` over a ``pack_codes``-compressed batch: the wire
    carries 2 bits a base and 1 N bit a base, unpacked on the device
    straight into the hash kernel's layout. Adds into ``sketch.rows`` in
    place and returns ``sketch``."""
    from ..models.pipeline import fused_count_step

    return fused_count_step(unpack_codes_tm(packed, nmask, length), sketch, k)
