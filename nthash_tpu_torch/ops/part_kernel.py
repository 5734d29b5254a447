"""Sort-partitioned exact histograms and presence words at widths
2**19..2**30.

Counterpart of ``nthash_tpu/ops/part_pallas.py``, all of it:
``partitioned_histogram_rows`` for the count-min sketch and
``partitioned_bloom_words`` for the Bloom filter. The update stream is cut
into chunks; each chunk is sorted, so the updates of each of its P partitions
(the top ``log2(P)`` bits of the bucket) form one run; a table gives each
partition's first row; a fixed ``cap``-row window per partition is copied out
and rebased to [0, width / P); and every window is counted (row histogram) or
packed (presence-word rows) at the narrow sub-width. A window that cannot hold
its partition (heavy skew) sets a flag on the device, and then one full-width
launch over the raw indices counts or packs instead. Both are exact; the flag
only picks which one writes.

The kernels are ``csrc/partition.cu``: ``sort_tiles`` (A3a/A3b),
``merge_phase`` (A3c), ``partition_bounds`` (the partition table plus the
window check) and ``windows`` (A3d); the per-partition step and the fallback
are ``ops/hist_kernel.py``'s kernels (``csrc/histogram.cu``,
``csrc/bloom.cu``). Each function that routes does so by device:
a CUDA tensor goes through the kernels, a CPU tensor through the plain
versions beside them (``*_plain``), anything else raises. Nothing waits on the
host: the overflow flag gates the two last launches on the device.

On this card no default path partitions: the sketch and the Bloom filter
count straight into their rows at every width, which wins at every width
(``PERF.md``). These functions stay as the counterparts of the JAX
package's partitioned contract, tested and driven on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .hist_kernel import bloom_words, bloom_words_rows, histogram_rows

LANES = 128
CAP_ROWS = 3  # window rows when a test overrides chunk_rows below the plan
MIN_ROWS = 64  # fewest rows in a chunk (8192 updates)
PART_MIN_WIDTH_LOG2 = 19
PART_MAX_WIDTH_LOG2 = 30
#: Widest sub-histogram: the plans keep every sub-width at or below it, so the
#: JAX package's recursion for wider ones (part_pallas.py:573-580) never runs
#: and is not ported; a plan that breaks this raises.
MAX_SUB_LOG2 = 18

#: (p_log2, m) per width: 2**p_log2 partitions per chunk, m expected rows per
#: partition per chunk, windows of m + 2 rows. These are the JAX package's
#: plans, tuned for its TPU; retuning them for this card is later work.
_PLANS = {
    19: (6, 4), 20: (7, 4), 21: (7, 4), 22: (8, 4), 23: (9, 4),
    24: (10, 4), 25: (11, 2), 26: (12, 2), 27: (12, 2),
    28: (13, 2), 29: (13, 2), 30: (13, 2),
}

#: The merge's span kernel holds 2**11..2**15 ints a block (the tile
#: network's spans).
MERGE_MIN_SPAN = 1 << 11
MERGE_MAX_SPAN = 1 << 15
#: Most strides one grouped pass through device memory runs (64 ints a
#: thread in registers at six).
MERGE_MAX_GROUP = 6
MAX_CHUNK = 1 << 30

#: Kernel launches made through this module in this process, by kernel.
#: ``merge_phase`` counts one per merge round (its grouped passes through
#: device memory are further launches of the same round).
LAUNCHES = {"sort_tiles": 0, "merge_phase": 0, "partition_bounds": 0,
            "windows": 0}


def plan(width_log2: int) -> tuple[int, int, int, int]:
    """(p_log2, sub_log2, chunk_rows, cap_rows) for a width in [19, 30]:
    2**p_log2 partitions per chunk of ``chunk_rows * 128`` updates, each
    copied into a ``cap_rows``-row window."""
    if not PART_MIN_WIDTH_LOG2 <= width_log2 <= PART_MAX_WIDTH_LOG2:
        raise ValueError(
            f"width_log2 ({width_log2}) must be in "
            f"[{PART_MIN_WIDTH_LOG2}, {PART_MAX_WIDTH_LOG2}]")
    p_log2, m = _PLANS[width_log2]
    chunk_rows = max(MIN_ROWS, m << p_log2)
    return p_log2, width_log2 - p_log2, chunk_rows, (chunk_rows >> p_log2) + 2


def _pad_chunks(idx: torch.Tensor, width: int, chunk: int) -> torch.Tensor:
    """[R, N] -> [R, G, rows, 128], entries outside [0, width] set to the
    sentinel ``width`` (it sorts last and lands outside every window's
    range), padded with it to G whole chunks; G >= 8 rounds up to a multiple
    of 8, as the JAX package does, so the shapes match it."""
    r, n = idx.shape
    idx = torch.where((idx < 0) | (idx > width), width, idx)
    g = -(-n // chunk)
    if g >= 8:
        g += (-g) % 8
    pad = g * chunk - n
    if pad:
        idx = torch.nn.functional.pad(idx, (0, pad), value=width)
    return idx.reshape(r, g, chunk // LANES, LANES)


def _check_chunks(x: torch.Tensor) -> tuple[int, int, int]:
    if x.dtype != torch.int32 or x.dim() != 4 or x.shape[-1] != LANES:
        raise ValueError(
            f"chunks must be int32 [R, G, rows, {LANES}], got {x.dtype} "
            f"{tuple(x.shape)}")
    r, g, rows, _ = x.shape
    if rows & (rows - 1):
        raise ValueError(f"rows per chunk ({rows}) must be a power of two")
    return r, g, rows


def _route(x: torch.Tensor) -> bool:
    """True for the kernels (a CUDA tensor), False for the plain versions (a
    CPU tensor); raises for any other device."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no partition route for device {x.device}")


def _plain_flags(fb, p_log2, sorted_idx, sub_log2, cap_rows):
    """int32 [2]: (any window misses part of its partition, none does)."""
    lastq = sorted_idx[..., LANES - 1] >> sub_log2            # [R, G, rows]
    below_p = (lastq < (1 << p_log2)).sum(dim=-1, dtype=torch.int32)
    end = torch.cat([fb[..., 1:], below_p[..., None]], dim=-1)
    over = (end - fb + 1 > cap_rows).any()
    return torch.stack([over, ~over]).to(torch.int32)


# ---------------------------------------------------------------- plain ----


def sort_chunks_plain(idx: torch.Tensor, sub_log2: int, p_log2: int = 0):
    """Plain version of :func:`sort_chunks`: ``torch.sort`` per chunk and
    ``torch.searchsorted`` over the row maxima."""
    _check_chunks(idx)
    srt = _sort_plain(idx)
    return srt, _table_plain(srt, sub_log2, p_log2)


def _sort_plain(chunks):
    """Each chunk sorted ascending by ``torch.sort``."""
    r, g = chunks.shape[:2]
    return chunks.reshape(r, g, -1).sort(dim=-1).values.reshape(chunks.shape)


def _table_plain(srt, sub_log2, p_log2):
    """fb [R, G, P] of sorted chunks by ``torch.searchsorted``."""
    r, g = srt.shape[:2]
    lastq = (srt[..., LANES - 1] >> sub_log2).contiguous()
    queries = torch.arange(1 << p_log2, dtype=torch.int32,
                           device=srt.device).expand(r, g, -1).contiguous()
    return torch.searchsorted(lastq, queries, side="left").to(torch.int32)


def sort_tiles_plain(chunks: torch.Tensor, tile: int) -> torch.Tensor:
    """Plain version of :func:`sort_tiles`: each run of ``tile`` ints sorted
    ascending, then reversed where its index inside the chunk is odd (only
    when the chunk spans several tiles)."""
    per_chunk = chunks.shape[2] * LANES // tile
    srt = chunks.reshape(-1, per_chunk, tile).sort(dim=-1).values
    if per_chunk > 1:
        srt[:, 1::2] = srt[:, 1::2].flip(-1)
    return srt.reshape(chunks.shape)


def merge_phase_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of :func:`merge_phase` (out of place): round ``k`` of
    the bitonic network, stride by stride, as min/max over pair views; a
    block of 2j pairs sorts ascending where bit k of its chunk index is
    clear."""
    chunk = x.shape[2] * LANES
    y = x.reshape(-1)
    j = k // 2
    while j >= 1:
        v = y.view(-1, 2, j)
        lo = torch.minimum(v[:, 0], v[:, 1])
        hi = torch.maximum(v[:, 0], v[:, 1])
        start = torch.arange(v.shape[0], device=x.device) * (2 * j)
        asc = ((start & (chunk - 1) & k) == 0)[:, None]
        y = torch.stack([torch.where(asc, lo, hi), torch.where(asc, hi, lo)],
                        dim=1).reshape(-1)
        j //= 2
    return y.reshape(x.shape)


def partition_bounds_plain(sorted_idx, sub_log2: int, p_log2: int,
                           cap_rows: int):
    """Plain version of :func:`partition_bounds`: (fb [R, G, P], flags)."""
    fb = _table_plain(sorted_idx, sub_log2, p_log2)
    return fb, _plain_flags(fb, p_log2, sorted_idx, sub_log2, cap_rows)


def check_overflow_plain(fb, p_log2, sorted_idx, sub_log2,
                         cap_rows: int = CAP_ROWS) -> torch.Tensor:
    """Plain version of :func:`check_overflow`."""
    return _plain_flags(fb, p_log2, sorted_idx, sub_log2, cap_rows)[0] != 0


def partition_windows_plain(sorted_idx, fb, p_log2: int, sub_log2: int, *,
                            cap_rows: int = CAP_ROWS) -> torch.Tensor:
    """Plain version of :func:`partition_windows`: index arithmetic and
    ``gather``."""
    r, g, rows = _check_chunks(sorted_idx)
    p = 1 << p_log2
    dev = sorted_idx.device
    start = fb[..., :p].clamp(max=rows - cap_rows).to(torch.int64)
    row = start[..., None] + torch.arange(cap_rows, device=dev)  # [R,G,P,cap]
    elem = row[..., None] * LANES + torch.arange(LANES, device=dev)
    got = torch.gather(sorted_idx.reshape(r, g, -1), 2,
                       elem.reshape(r, g, -1)).reshape(r, g, p, cap_rows, LANES)
    base = (torch.arange(p, dtype=torch.int32, device=dev) << sub_log2)
    return (got - base[:, None, None]).permute(0, 2, 1, 3, 4).contiguous()


# -------------------------------------------------------------- kernels ----


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("partition")
    if lib.nthash_sort_tiles.argtypes is None:
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        for fn, args in (
            (lib.nthash_sort_max_tile, []),
            (lib.nthash_sort_tiles, [i, vp, vp, ll, ll, i, vp]),
            (lib.nthash_merge_strides, [i, vp, ll, ll, ll, ll, i, vp]),
            (lib.nthash_merge_span, [i, vp, ll, ll, ll, i, i, vp]),
            (lib.nthash_partition_bounds, [i, vp, ll, i, i, i, i, vp, vp, vp]),
            (lib.nthash_windows, [i, vp, vp, ll, i, i, i, i, i, vp, vp]),
        ):
            fn.restype = ctypes.c_int
            fn.argtypes = args
    return lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def sort_tiles(chunks: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Kernel A3a/A3b: a new tensor holding ``chunks`` with every tile of
    ``min(chunk, max tile)`` ints sorted (in its parity's direction when the
    chunk spans several tiles), by a bitonic network held in registers (64
    ints a thread, warp shuffles, shared memory only to transpose). Returns
    (tiles, tile size)."""
    lib = _lib()
    dev = chunks.device
    chunk = chunks.shape[2] * LANES
    tile = min(chunk, lib.nthash_sort_max_tile())
    out = torch.empty_like(chunks)
    if chunks.numel():
        cuda_build.check(lib, lib.nthash_sort_tiles(
            dev.index, chunks.data_ptr(), out.data_ptr(), chunks.numel(),
            chunk, tile, _stream(dev)), "sort_tiles launch")
        LAUNCHES["sort_tiles"] += 1
    return out, tile


def merge_plan(chunk: int, k: int) -> tuple[tuple[tuple[int, int], ...],
                                            int, int]:
    """The launches of bitonic merge round ``k`` over chunks of ``chunk``
    ints (powers of two, 2 <= k <= chunk <= 2**30): (passes, span, cluster).

    Each pass (j, g) runs strides j, j/2, ..., j >> (g - 1) in one pass
    through device memory (at most ``MERGE_MAX_GROUP`` strides, split
    evenly, the highest first); then one launch of the tile network over
    spans of ``span`` ints runs every stride below min(k, span) inside each
    span, after stride ``span`` across the two blocks of a thread-block
    cluster where ``cluster`` is 2. Every stride k/2 .. 1 runs once, in
    descending order.

    The cluster takes one stride, and only where that saves a pass (the
    strides of a span and more number one more than a multiple of
    ``MERGE_MAX_GROUP``): on the card a stride exchanged between two
    blocks' shared memory costs more than half of what a whole grouped pass
    costs, and each further stride in a cluster of 4 or 8 as much again
    (0.86 against 1.44 ms per 1M reads at the 2**30 plan on the card;
    CHANGES.md, readings behind the comments).
    """
    if not (_pow2(chunk) and _pow2(k) and 2 <= k <= chunk <= MAX_CHUNK):
        raise ValueError(
            f"merge round {k} of chunks of {chunk}: need powers of two with "
            f"2 <= k <= chunk <= 2**30")
    span = min(max(k, MERGE_MIN_SPAN), MERGE_MAX_SPAN)
    wide = max(0, (k // span).bit_length() - 1)  # strides of a span and more
    cluster = 2 if wide % MERGE_MAX_GROUP == 1 else 1
    strides = [(k // 2) >> i for i in range(wide - (cluster > 1))]
    passes = []
    left = -(-len(strides) // MERGE_MAX_GROUP)
    i = 0
    while left:
        g = -(-(len(strides) - i) // left)
        passes.append((strides[i], g))
        i += g
        left -= 1
    return tuple(passes), span, cluster


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def merge_phase(x: torch.Tensor, tile: int, k: int) -> None:
    """Kernel A3c: bitonic merge round ``k`` of every chunk of ``x`` in
    place (``2 * tile <= k <= chunk``; every tile-sized run sorted in
    alternating directions up to round k / 2). The launches are
    :func:`merge_plan`'s: a grouped pass through device memory for every
    six strides of 2**15 and more, then one pass of the tile network over
    each tile (after stride 2**15 across a cluster of two tiles where that
    saves a pass). Raises for a tensor that is not a contiguous, 16-byte
    aligned int32 [R, G, rows, 128]."""
    lib = _lib()
    _, _, rows = _check_chunks(x)
    chunk = rows * LANES
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("merge_phase needs a contiguous, 16-byte aligned "
                         "tensor")
    if not (_pow2(tile) and LANES <= tile and 2 * tile <= k):
        raise ValueError(f"merge round {k} after tiles of {tile}: need a "
                         f"power-of-two tile of at least {LANES} and "
                         "2 * tile <= k")
    passes, span, cluster = merge_plan(chunk, k)
    if not x.numel():
        return
    dev = x.device
    stream = _stream(dev)
    for j, g in passes:
        cuda_build.check(lib, lib.nthash_merge_strides(
            dev.index, x.data_ptr(), x.numel(), chunk, k, j >> (g - 1), g,
            stream), "merge_phase launch")
    cuda_build.check(lib, lib.nthash_merge_span(
        dev.index, x.data_ptr(), x.numel(), chunk, k, span, cluster, stream),
        "merge_phase launch")
    LAUNCHES["merge_phase"] += 1


def partition_bounds(sorted_idx: torch.Tensor, sub_log2: int, p_log2: int,
                     cap_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel for the partition table and the window check: (fb int32
    [R, G, P], flags int32 [2] = (overflow, no overflow)) on the device,
    views of one buffer; the kernel sets the flags, so the host writes
    nothing."""
    lib = _lib()
    r, g, rows = _check_chunks(sorted_idx)
    dev = sorted_idx.device
    p = 1 << p_log2
    n = r * g * p
    out = torch.empty(n + 2, dtype=torch.int32, device=dev)
    cuda_build.check(lib, lib.nthash_partition_bounds(
        dev.index, sorted_idx.data_ptr(), r * g, rows, sub_log2, p, cap_rows,
        out.data_ptr(), out.data_ptr() + 4 * n, _stream(dev)),
        "partition_bounds launch")
    if r * g:
        LAUNCHES["partition_bounds"] += 1
    return out[:n].view(r, g, p), out[n:]


def windows(sorted_idx: torch.Tensor, fb: torch.Tensor, p_log2: int,
            sub_log2: int, cap_rows: int) -> torch.Tensor:
    """Kernel A3d: the rebased windows [R, P, G, cap_rows, 128]."""
    lib = _lib()
    r, g, rows = _check_chunks(sorted_idx)
    dev = sorted_idx.device
    p = 1 << p_log2
    fb = fb.contiguous()
    out = torch.empty((r, p, g, cap_rows, LANES), dtype=torch.int32,
                      device=dev)
    if out.numel():
        cuda_build.check(lib, lib.nthash_windows(
            dev.index, sorted_idx.data_ptr(), fb.data_ptr(), r, g, p, rows,
            cap_rows, sub_log2, out.data_ptr(), _stream(dev)),
            "windows launch")
        LAUNCHES["windows"] += 1
    return out


def _sorted(chunks: torch.Tensor) -> torch.Tensor:
    """Every chunk sorted ascending by the kernels: tile sorts, then one
    merge round per doubling up to the chunk."""
    srt, tile = sort_tiles(chunks.contiguous())
    k = 2 * tile
    while k <= chunks.shape[2] * LANES:
        merge_phase(srt, tile, k)
        k *= 2
    return srt


# -------------------------------------------------------------- routing ----


def sort_chunks(idx: torch.Tensor, sub_log2: int, p_log2: int = 0):
    """Sort each [rows, 128] chunk of [R, G, rows, 128] ascending and build
    its partition table.

    Returns (sorted [R, G, rows, 128], fb int32 [R, G, P]) where fb[r, g, p]
    is the number of rows of chunk (r, g) whose last entry, shifted right by
    ``sub_log2``, is below p: the first row that can hold partition p. (The
    JAX package's table is [R, G, 1, max(128, P)]; its entries past P mean
    nothing.)
    """
    _check_chunks(idx)
    if not _route(idx):
        return sort_chunks_plain(idx, sub_log2, p_log2)
    srt = _sorted(idx)
    return srt, partition_bounds(srt, sub_log2, p_log2, CAP_ROWS)[0]


def check_overflow(fb: torch.Tensor, p_log2: int, sorted_idx: torch.Tensor,
                   sub_log2: int, cap_rows: int = CAP_ROWS) -> torch.Tensor:
    """0-d bool tensor, on the device: does any ``cap_rows`` window miss part
    of its partition? Partition p spans rows fb[p] .. end[p], where end[p] is
    fb[p + 1], and for the last partition the rows below P (not all rows:
    trailing pad sentinels must not trip it). On the card the
    ``partition_bounds`` kernel recomputes the table beside the check."""
    if _route(sorted_idx):
        return partition_bounds(sorted_idx, sub_log2, p_log2, cap_rows)[1][0] != 0
    return check_overflow_plain(fb, p_log2, sorted_idx, sub_log2, cap_rows)


def partition_windows(sorted_idx: torch.Tensor, fb: torch.Tensor,
                      p_log2: int, sub_log2: int, *,
                      cap_rows: int = CAP_ROWS) -> torch.Tensor:
    """Sorted chunks + table (from :func:`sort_chunks`) -> windows int32
    [R, P, G, cap_rows, 128]: ``out[r, p, g, c, l] = sorted[r, g,
    min(fb[r, g, p], rows - cap_rows) + c, l] - (p << sub_log2)``. Entries of
    other partitions and the sentinel fall outside [0, 2**sub_log2)."""
    _, _, rows = _check_chunks(sorted_idx)
    if not 1 <= cap_rows <= rows:
        raise ValueError(f"cap_rows ({cap_rows}) must be in [1, {rows}]")
    if _route(sorted_idx):
        return windows(sorted_idx, fb, p_log2, sub_log2, cap_rows)
    return partition_windows_plain(sorted_idx, fb, p_log2, sub_log2,
                                   cap_rows=cap_rows)


def _plan_for(width_log2: int, chunk_rows: int | None,
              cap_rows: int | None) -> tuple[int, int, int, int]:
    """(p_log2, sub_log2, chunk_rows, cap_rows): the plan with the tests'
    overrides applied."""
    p_log2, sub_log2, rows, cap = plan(width_log2)
    if sub_log2 > MAX_SUB_LOG2:
        raise ValueError(
            f"plan for width 2**{width_log2} gives sub-width 2**{sub_log2} "
            f"above 2**{MAX_SUB_LOG2}; the port does not recurse")
    if chunk_rows is not None:
        rows, cap = chunk_rows, min(3, chunk_rows)
    if cap_rows is not None:
        cap = cap_rows
    return p_log2, sub_log2, rows, cap


def _check_idx(idx: torch.Tensor) -> None:
    if idx.dtype != torch.int32 or idx.dim() < 1:
        raise TypeError(f"idx must be an int32 [R, ...] tensor, got {idx.dtype}")


def _check_out(out: torch.Tensor, shape: tuple, idx: torch.Tensor) -> None:
    if (out.dtype != torch.int32 or out.device != idx.device
            or tuple(out.shape) != shape or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous int32 {list(shape)} tensor on the "
            "idx's device")


def _partition(idx: torch.Tensor, width_log2: int, p_log2: int, sub_log2: int,
               rows: int, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """idx [R, N] -> (windows [R, P, G, cap, 128], flags int32 [2] =
    (overflow, no overflow)) by the kernels on a CUDA tensor, by the plain
    versions on a CPU one."""
    on_card = _route(idx)
    chunks = _pad_chunks(idx, 1 << width_log2, rows * LANES)
    srt = _sorted(chunks) if on_card else _sort_plain(chunks)
    fb, flags = (partition_bounds if on_card else partition_bounds_plain)(
        srt, sub_log2, p_log2, cap)
    return partition_windows(srt, fb, p_log2, sub_log2, cap_rows=cap), flags


def partitioned_histogram_rows(
    idx: torch.Tensor,
    width_log2: int,
    *,
    chunk_rows: int | None = None,
    cap_rows: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """R exact histograms at widths 2**19..2**30 by sort-partitioning.

    Args:
      idx: [R, ...] int32 bucket indices; entries outside
        [0, 2**width_log2) are dropped (encode invalid updates as ``width``).
      width_log2: in [19, 30].
      chunk_rows: test override of the rows per chunk (a power of two);
        windows are then ``min(3, chunk_rows)`` rows unless ``cap_rows``.
      cap_rows: test override of the rows per window.
      out: optional contiguous int32 [R, 2**width_log2] to add into.

    Returns:
      int32 [R, 2**width_log2] equal to ``np.bincount`` per row, under any
      skew: where a window overflows, the full-width histogram of ``idx``
      counts instead of the windows, chosen on the device.
    """
    p_log2, sub_log2, rows, cap = _plan_for(width_log2, chunk_rows, cap_rows)
    _check_idx(idx)
    r = idx.shape[0]
    idx = idx.reshape(r, -1)
    width = 1 << width_log2
    if out is None:
        out = torch.zeros((r, width), dtype=torch.int32, device=idx.device)
    else:
        _check_out(out, (r, width), idx)
    wins, flags = _partition(idx, width_log2, p_log2, sub_log2, rows, cap)
    # the windows count where every window held its partition (flags[1]),
    # the raw indices at full width where one did not (flags[0])
    histogram_rows(wins.reshape(r << p_log2, -1), None, sub_log2,
                   gate=flags[1:], out=out.view(r << p_log2, 1 << sub_log2))
    histogram_rows(idx, None, width_log2, gate=flags[:1], out=out)
    return out


def partitioned_histogram(idx: torch.Tensor, width_log2: int) -> torch.Tensor:
    """Single-row convenience wrapper over partitioned_histogram_rows."""
    return partitioned_histogram_rows(idx.reshape(1, -1), width_log2)[0]


def partitioned_bloom_words(
    idx: torch.Tensor,
    width_log2: int,
    *,
    chunk_rows: int | None = None,
    cap_rows: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Bit-packed presence at widths 2**19..2**30 by sort-partitioning.

    The updates are partitioned as in :func:`partitioned_histogram_rows`;
    then one presence-word row per partition is packed at the sub-width
    (``bloom_words_rows``, gated on "no window overflowed"), straight into
    its slice of the full-width words: each 4,096-bucket block packs on its
    own and every sub-width is at least 2**13, so the per-partition words
    concatenate into the full-width layout. Where a window overflowed, one
    full-width ``bloom_words`` over the raw indices sets the bits instead,
    chosen on the device.

    Args:
      idx: int32 bucket indices, any shape; entries outside
        [0, 2**width_log2) are dropped.
      width_log2: in [19, 30].
      chunk_rows, cap_rows: test overrides, as in
        :func:`partitioned_histogram_rows`.
      out: optional contiguous int32 [2**width_log2 / 32] to OR into.

    Returns:
      int32 [2**width_log2 / 32], the JAX package's uint32 words bit for bit
      (``out`` itself when given).
    """
    p_log2, sub_log2, rows, cap = _plan_for(width_log2, chunk_rows, cap_rows)
    _check_idx(idx)
    idx = idx.reshape(1, -1)
    nwords = 1 << (width_log2 - 5)
    if out is None:
        out = torch.zeros(nwords, dtype=torch.int32, device=idx.device)
    else:
        _check_out(out, (nwords,), idx)
    wins, flags = _partition(idx, width_log2, p_log2, sub_log2, rows, cap)
    bloom_words_rows(wins.reshape(1 << p_log2, -1), sub_log2, gate=flags[1:],
                     out=out.view(1 << p_log2, -1))
    bloom_words(idx, None, width_log2, gate=flags[:1], out=out)
    return out
