"""Exact int32 row histograms and packed presence words: the CUDA kernels
and their plain versions.

Counterpart of ``nthash_tpu/ops/hist_pallas.py``, with each function named
for what it computes rather than for the TPU's matrix unit:

- :func:`histogram_rows` is ``mxu_histogram_rows`` and :func:`histogram` is
  ``mxu_histogram``; the kernel is ``csrc/histogram.cu`` (replaces the
  Pallas ``_hist_kernel``). It has four routes: private counters in
  shared memory; binned (the updates grouped by range of 2**15 counters,
  then each range counted in shared memory); clustered (where those ranges
  are more than one pass takes: ranges of 2**16..2**18 counters, each
  2**15-counter slice of a range counted densely in 16-bit halves in a
  block's shared memory); or direct atomics. :func:`private_counts_grid` and
  :func:`binned_counts_grid` pick one from the shapes alone;
- :func:`bloom_words` is ``mxu_bloom_words`` and :func:`bloom_words_rows` is
  ``mxu_bloom_words_rows``; the kernel is ``csrc/bloom.cu`` (replaces
  ``_bloom_kernel`` and ``_bloom_rows_kernel``), in the same
  :func:`word_index` / :func:`bit_index` layout. It has three routes,
  private words in shared memory, binned (ranges of 2**20 buckets) or
  direct atomics, and :func:`private_words_grid` and
  :func:`binned_words_grid` pick one from the shapes alone; int64 buckets,
  which filters past 2**31 bits (to 2**38) take, go a fourth, direct
  atomics with 64-bit word offsets.

The binned and clustered routes share one binning pass, ``csrc/bin.cuh``
(:func:`bin_ranges`), whose scatter has two bodies (:func:`scatter_body`:
whole 32-byte sectors of the stage into pages each range takes as it fills,
with no count first, where a row has more than 256 ranges and their carries
fit; else a count by range, then a run a range a tile); its plain version
:func:`bin_ranges_plain` and the range passes' :func:`histogram_ranges_plain`
(both histogram routes) and :func:`bloom_ranges_plain` compose to
:func:`histogram_rows_plain` and :func:`bloom_words_plain`.

Each source note says what bounds its kernel on the H100.

The TPU version builds one-hot operands and counts on the MXU, splitting
weights into 8-bit digit planes so bf16 products stay exact; its
``weight_bits`` chose how many planes to pay for. Here every update is one
integer atomic add (in shared or device memory), exact for any int32
weight, so ``weight_bits`` is gone.

The range reaches 2**30, past the TPU kernel's 2**26: on this card the
count-min sketch counts straight into its rows at every width, and the
sort-partitioned path (``ops/part_kernel.py``) falls back to one full-width
histogram under skew. Two arguments serve that path: ``out`` accumulates
into an existing tensor (the sketch's rows), and ``gate`` (one device int32)
lets the device, not the host, decide whether a launch counts anything. The
presence words take the same two arguments, ``out`` OR-ing into the
filter's words; their direct range reaches 2**31 for the same reason and
for the widest filter.

Packed words are int32 tensors holding the JAX package's uint32 bit
patterns: PyTorch's CPU uint32 has neither ``>>`` nor ``index_put_``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.profiling import span
from . import cuda_build

MIN_WIDTH_LOG2 = 10
MAX_WIDTH_LOG2 = 30
#: The widest filter, and buckets, of the wide routes (int64 buckets):
#: 2**38 bits, 32 GiB of words.
WIDE_MAX_WIDTH_LOG2 = 38

#: Kernel launches made by :func:`histogram_rows` in this process, and the
#: same launches by route; "wide_words" counts :func:`bloom_words`'s wide
#: route (int64 buckets, filters past 2**31 bits).
LAUNCHES = 0
ROUTE_LAUNCHES = {"private": 0, "direct": 0, "binned": 0, "clustered": 0,
                  "wide_words": 0}
#: Widest row whose counters a block keeps in shared memory: 2**15 int32
#: counters are 128 KB of the 227 KB a block may use.
PRIVATE_COUNTS_MAX_WIDTH_LOG2 = 15
#: A block of the private-counter route covers at least this many entries
#: per counter of its row, so that its merge (up to one atomic a counter)
#: stays a small part. On the card private counters tie with direct atomics
#: at 1 entry a counter a block and win at every swept width from 2 (an
#: NVIDIA H100 80GB HBM3 at 700 W; CHANGES.md, readings behind the
#: comments).
PRIVATE_MIN_ENTRIES_PER_COUNTER = 2
#: Threads either kernel's private route spreads over all rows: 1,024 on
#: each of the H100's 132 multiprocessors.
PRIVATE_TARGET_THREADS = 132 * 1024

#: The binned routes (``csrc/bin.cuh``): log2 of the buckets one range
#: holds, 2**15 counters (128 KB of int32) or 2**20 bits (2**15 words, 128
#: KB), each range's table in one block's shared memory.
COUNTS_RANGE_LOG2 = 15
WORDS_RANGE_LOG2 = 20
#: The histogram's clustered route: where the rows hold more than
#: ``BINNED_MAX_RANGES`` ranges of 2**15 counters, ranges of up to 2**18
#: counters (4 rows at 2**28 in 4,096 ranges). Its range pass takes a range
#: in chunks of at most ``CLUSTERED_RANGE_ENTRIES`` staged entries, each
#: counted by :func:`range_owners` blocks, one a slice of
#: 2**``CLUSTERED_SLICE_LOG2`` counters, densely in shared memory as 2**14
#: words of two uint16 halves (64 KB, two blocks a multiprocessor). A chunk
#: of at most 2**16 - 1 entries never wraps a half; 2**16 - 8 keeps a
#: chunk's 16-byte loads whole. On the card this beat slices of 2**16
#: counters in 128 KB (4 owners at 2**18) and of 2**15 int32 counters
#: (csrc/histogram.cu has the readings).
CLUSTERED_MAX_RANGE_LOG2 = 18
CLUSTERED_SLICE_LOG2 = 15
CLUSTERED_RANGE_ENTRIES = (1 << 16) - 8
#: Most ranges (all rows together) one binning pass takes: its blocks keep
#: a count, a rank and a base per range of their row in shared memory.
BINNED_MAX_RANGES = 4096
#: The binned routes pay where a call brings at least this many updates
#: (the histogram's, then the presence words'): below it the passes' fixed
#: costs (five launches, a block a range, the scratch) outweigh what they
#: save. A sweep of 2**22..2**25 updates at every width the rule bins (A2
#: with 4 rows at 2**16..2**28 and one row at 2**16, 2**22, 2**27, 2**28,
#: 2**30; C1 with one row at 2**21..2**31 and 4 rows at 2**21, 2**26) on an
#: NVIDIA H100 80GB HBM3 at 700 W (CHANGES.md, readings behind the
#: comments): A2 binned and clustered win from 2**24 at every width and C1
#: from 2**25 (from fewer where the table is past the L2). Each constant is
#: the least that wins at every swept width.
#: With at most ``BINNED_MAX_RANGES`` ranges that is at least 4,096 updates
#: a range.
BINNED_MIN_ENTRIES = 1 << 24
BINNED_MIN_WORD_ENTRIES = 1 << 25
#: Staged entries one block of a range pass covers at most, and at least.
BINNED_RANGE_ENTRIES = 1 << 17
BINNED_MIN_RANGE_ENTRIES = 1 << 14
#: Launches of the binning pass and of the range pass that follows it, by
#: the library that ran them (``histogram``: A2's binned and clustered
#: routes, ``bloom``: C1 and C2).
BIN_LAUNCHES = {"histogram": 0, "bloom": 0}
RANGE_LAUNCHES = {"histogram": 0, "bloom": 0}
#: The binning pass's scatter has two bodies, chosen by ``scatter_body``
#: as ``csrc/bin.cuh`` chooses them: "sectors" (a persistent block a
#: multiprocessor that carries each range's remainder from tile to tile and
#: writes only whole 32-byte sectors of the stage, into pages
#: (:func:`page_entries`) that each range takes from a pool as it fills: no
#: count first) and "runs" (a block a tile, each range's run at its cursor,
#: after a count by range). Launches of each in this process.
SCATTER_ROUTE_LAUNCHES = {"sectors": 0, "runs": 0}
#: Binning passes that ran ``bin_count_kernel`` (the "runs" body), by
#: library as ``BIN_LAUNCHES``.
BIN_COUNT_LAUNCHES = {"histogram": 0, "bloom": 0}
#: The "sectors" body takes more than this many ranges a row (fewer: each
#: tile's runs are long and one histogram a warp pays) ...
SCATTER_GROUPED_MAX_BINS = 256
#: ... and at most this many carried entries (ranges a row times the
#: entries of a 32-byte sector) in its shared memory.
SCATTER_MAX_CARRIED = 8192
SECTOR_BYTES = 32
#: Entries of a "sectors" tile (1,024 threads of 16): the most one claim of
#: a range holds.
SECTOR_TILE_ENTRIES = 1024 * 16

PACK = 32  # buckets per packed word
BLOOM_MIN_WIDTH_LOG2 = 12  # the layout tiles the width in 4,096-bucket blocks
BLOOM_ROWS_MAX_WIDTH_LOG2 = 26
BLOOM_MAX_WIDTH_LOG2 = 31
#: Kernel launches of ``csrc/bloom.cu`` in this process, by entry point;
#: ``RANGE_LAUNCHES["bloom"]`` of them took the binned route.
BLOOM_LAUNCHES = {"bloom_words": 0, "bloom_words_rows": 0}
#: Widest row whose words a block keeps in shared memory: 2**20 / 32 words
#: are 128 KB of the 227 KB a block may use.
PRIVATE_MAX_WIDTH_LOG2 = 20
#: A block of the private route covers at least this many entries per word
#: of its row, so that its merge (up to one atomic a word) stays a small
#: part. On the card private words tie with direct atomics at 1 to 4 entries
#: a word and win from there (an NVIDIA H100 80GB HBM3 at 700 W;
#: CHANGES.md, readings behind the comments).
PRIVATE_MIN_ENTRIES_PER_WORD = 4


def _rows_and_weight(idx, weight, width_log2, lo=MIN_WIDTH_LOG2,
                     hi=MAX_WIDTH_LOG2, dtype=torch.int32):
    """Validate; return (idx [R, N], weight None | [N] | [R, N])."""
    if not lo <= width_log2 <= hi:
        raise ValueError(f"width_log2 ({width_log2}) must be in [{lo}, {hi}]")
    if idx.dtype != dtype or idx.dim() < 1:
        name = str(dtype).removeprefix("torch.")
        raise TypeError(f"idx must be an {name} [R, ...] tensor, got "
                        f"{idx.dtype}")
    rows = idx.shape[0]
    idx = idx.reshape(rows, -1)
    n = idx.shape[1]
    if weight is None:
        return idx, None
    if weight.dtype != torch.int32:
        raise TypeError(f"weight must be int32, got {weight.dtype}")
    if weight.device != idx.device:
        raise ValueError(f"weight on {weight.device}, idx on {idx.device}")
    if weight.numel() == n:
        return idx, weight.reshape(n)
    if weight.numel() == rows * n:
        return idx, weight.reshape(rows, n)
    raise ValueError(
        f"weight has {weight.numel()} entries; expected {n} (shared) or "
        f"{rows * n} (per row)")


def _check_extras(idx, cols, gate, out):
    """Validate ``gate`` and ``out`` (int32 [R, cols]) against idx [R, N]."""
    if gate is not None and (gate.dtype != torch.int32 or gate.numel() != 1
                             or gate.device != idx.device):
        raise ValueError("gate must be one int32 element on the idx's device")
    if out is not None and (
            out.dtype != torch.int32 or out.device != idx.device
            or tuple(out.shape) != (idx.shape[0], cols)
            or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous int32 [{idx.shape[0]}, {cols}] tensor "
            "on the idx's device")


def rows_view(tensors) -> torch.Tensor | None:
    """The tensors as one [R, N] view where they are consecutive, equally
    sized, contiguous pieces of one storage (the hash kernel's single
    output, unbound), else None. A view, never a copy."""
    first = tensors[0]
    n = first.numel()
    for r, t in enumerate(tensors):
        if (t.dtype != first.dtype or t.device != first.device
                or t.numel() != n or not t.is_contiguous()
                or t.untyped_storage().data_ptr()
                != first.untyped_storage().data_ptr()
                or t.storage_offset() != first.storage_offset() + r * n):
            return None
    return first.as_strided((len(tensors), n), (n, 1))


def histogram_rows_plain(idx: torch.Tensor, weight: torch.Tensor | None,
                         width_log2: int, *, gate: torch.Tensor | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`histogram_rows`, on any device:
    out-of-range entries masked out, ``index_add_`` (in int64 with weights,
    then wrapped to int32 mod 2**32; in int32 without, where a count cannot
    wrap), the gate applied as a 0/1 factor so nothing waits on it."""
    idx, weight = _rows_and_weight(idx, weight, width_log2)
    _check_extras(idx, 1 << width_log2, gate, out)
    rows, n = idx.shape
    width = 1 << width_log2
    dev = idx.device
    keep = (idx >= 0) & (idx < width)
    flat = (idx.to(torch.int64)
            + torch.arange(rows, device=dev)[:, None] * width)[keep]
    if weight is None:
        # straight into ``out`` where given: at width 2**30 a second
        # full-width buffer would be another 4 GiB per row
        counts = (out.view(-1) if out is not None else
                  torch.zeros(rows * width, dtype=torch.int32, device=dev))
        w = torch.ones(flat.shape, dtype=torch.int32, device=dev)
        if gate is not None:
            w = w * (gate.reshape(()) != 0)
        counts.index_add_(0, flat, w)
        return counts.view(rows, width)
    wide = torch.zeros(rows * width, dtype=torch.int64, device=dev)
    w = weight.to(torch.int64).expand(rows, n)[keep]
    if gate is not None:
        w = w * (gate.reshape(()) != 0)
    wide.index_add_(0, flat, w)
    counts = (torch.remainder(wide + (1 << 31), 1 << 32)
              - (1 << 31)).to(torch.int32).reshape(rows, width)
    if out is None:
        return counts
    return out.add_(counts)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("histogram")
    fn = lib.nthash_histogram_rows
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        _bind_binned(lib, "histogram")
    return lib


def _bind_binned(lib: ctypes.CDLL, name: str) -> None:
    """argtypes of a library's two binned entry points, ``nthash_<name>_bin``
    and ``nthash_<name>_ranges`` (the histogram's take the range's log2,
    the presence words' a weight)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = getattr(lib, f"nthash_{name}_bin")
    fn.restype = i
    fn.argtypes = ([i, p, ll, ll] + ([p, i] if name == "bloom" else [i, i])
                   + [ll, p, ll, p, ll, p, p])
    fn = getattr(lib, f"nthash_{name}_ranges")
    fn.restype = i
    fn.argtypes = ([i, p, p, i] + ([i] if name == "histogram" else [])
                   + [ll, ll, p, p, p])


def _private_count_threads(width_log2: int) -> int:
    return 1024 if width_log2 >= 14 else 512


def private_counts_grid(
        rows: int, n: int, width_log2: int,
        min_entries_per_counter: int = PRIVATE_MIN_ENTRIES_PER_COUNTER,
) -> tuple[int, int]:
    """The histogram kernel's route for idx [rows, n], from the shapes
    alone: (blocks per row, threads per block) for private counters in
    shared memory merged once per block, or (0, 0) for one global atomic add
    per update.

    Private counters pay where a row's counters fit a block's shared memory
    (up to 2**15) and a block can be given at least
    ``PRIVATE_MIN_ENTRIES_PER_COUNTER`` entries per counter. The rows then
    share about ``PRIVATE_TARGET_THREADS`` threads, in blocks of 512 (1,024
    from 2**14 up, where the counters leave room for one or two blocks per
    multiprocessor); the kernel deals the blocks out to the rows in turn, so
    the blocks in flight spread over all of them. Otherwise (rows too short
    to pay for a merge, sketches wider than 2**15) the updates go to the
    counters directly. ``min_entries_per_counter`` is the rule's own
    constant except where the smoke run measures it.
    """
    if rows < 1 or n < 1 or width_log2 > PRIVATE_COUNTS_MAX_WIDTH_LOG2:
        return 0, 0
    most = n // (min_entries_per_counter << width_log2)
    if most < 1:
        return 0, 0
    threads = _private_count_threads(width_log2)
    return max(1, min(most, -(-PRIVATE_TARGET_THREADS // (threads * rows)))), \
        threads


# ------------------------------------------------------- binned routes ----


class Bins(NamedTuple):
    """What a binning pass leaves for its range pass. Ranges are numbered
    row by row: range g = (r << (width_log2 - range_log2)) | (b >> range_log2)
    holds the updates b of row r in [g << range_log2, (g + 1) << range_log2)
    of the row-major table. On the kernel route ``counts``, ``starts``,
    ``blocks`` and ``pages`` are views of one int64 buffer (``counts`` at
    its start), as the kernels take it. Range g's entries in range order
    are ``starts[g]`` on in the stage, or, where ``pages`` is given, its
    c-th page of :func:`page_entries` entries is page ``pages[g, c] - 1``
    of the stage (:func:`staged`)."""

    counts: torch.Tensor  #: int64 [nranges], valid updates a range
    #: int64 [nranges + 1], exclusive scan of counts: each range's first
    #: entry in range order
    starts: torch.Tensor
    #: int64 [nranges + 1], scan of owners * ceil(counts / per)
    #: (:func:`range_owners`)
    blocks: torch.Tensor
    stage: torch.Tensor   #: offsets b & (2**range_log2 - 1), grouped by range
    per: int              #: staged entries a chunk of the range pass holds
    range_log2: int       #: log2 of the buckets one range holds
    #: int32 [nranges, most pages a range takes] (:func:`page_pool`): page
    #: + 1 of each page of each range, 0 past its last; None where the
    #: ranges lie one after another in the stage
    pages: torch.Tensor | None = None


def binned_ranges(rows: int, width_log2: int, range_log2: int) -> int:
    """Ranges of a binned route over ``rows`` rows at width 2**width_log2
    with ranges of 2**range_log2 buckets, or 0 where there is no binned
    route: a row no wider than one range (the private routes serve those
    widths) or more than ``BINNED_MAX_RANGES`` ranges for one pass."""
    if width_log2 <= range_log2 or rows < 1:
        return 0
    nranges = rows << (width_log2 - range_log2)
    return nranges if nranges <= BINNED_MAX_RANGES else 0


def range_owners(range_log2: int) -> int:
    """Blocks of the range pass that count one chunk of a range of
    2**range_log2 buckets: on the clustered route one a slice of
    2**``CLUSTERED_SLICE_LOG2`` counters (2, 4 or 8 at 2**16..2**18), else
    1 (the whole range in one block)."""
    if COUNTS_RANGE_LOG2 < range_log2 <= CLUSTERED_MAX_RANGE_LOG2:
        return 1 << (range_log2 - CLUSTERED_SLICE_LOG2)
    return 1


def _range_grid(total: int, nranges: int,
                range_log2: int) -> tuple[int, int]:
    """(entries a chunk of the range pass holds, blocks to launch) for
    ``total`` updates over ``nranges`` ranges of 2**range_log2 buckets.
    ``per`` is ``CLUSTERED_RANGE_ENTRIES`` on the clustered route; else it
    splits the updates over four blocks for each of the H100's 132
    multiprocessors, within [``BINNED_MIN_RANGE_ENTRIES``,
    ``BINNED_RANGE_ENTRIES``], rounded up to whole 32-byte sectors of an
    int16 stage (a page of the "sectors" body holds whole chunks of whole
    sectors). Range g
    takes ceil(count / per) chunks of :func:`range_owners` blocks each, so
    owners * (ceil(total / per) + nranges) blocks cover any split of
    ``total`` over the ranges; the blocks past the last range's return at
    once."""
    if COUNTS_RANGE_LOG2 < range_log2 <= CLUSTERED_MAX_RANGE_LOG2:
        per = CLUSTERED_RANGE_ENTRIES
    else:
        per = min(BINNED_RANGE_ENTRIES,
                  max(BINNED_MIN_RANGE_ENTRIES, total // (4 * 132)))
        per = -(-per // 16) * 16
    return per, range_owners(range_log2) * (-(-total // per) + nranges)


def _binned_grid(rows, n, width_log2, range_log2):
    nranges = binned_ranges(rows, width_log2, range_log2)
    least = (BINNED_MIN_WORD_ENTRIES if range_log2 == WORDS_RANGE_LOG2
             else BINNED_MIN_ENTRIES)
    if n < 1 or not nranges or rows * n < least:
        return 0, 0
    return _range_grid(rows * n, nranges, range_log2)


def counts_range_log2(rows: int, width_log2: int) -> int:
    """log2 of the counters one range of the histogram's binned routes
    holds for ``rows`` rows at width 2**width_log2: the least of 15 (the
    binned route, every counter of a range in a block's shared memory) and
    16..18 (the clustered route, a slice of 2**15 a block) whose ranges the
    binning pass takes (:func:`binned_ranges`), or 0 where none does (the
    private widths, and 4 rows past 2**28)."""
    for range_log2 in range(COUNTS_RANGE_LOG2, CLUSTERED_MAX_RANGE_LOG2 + 1):
        if binned_ranges(rows, width_log2, range_log2):
            return range_log2
    return 0


def binned_counts_grid(rows: int, n: int,
                       width_log2: int) -> tuple[int, int]:
    """The histogram's binned or clustered route for idx [rows, n], from
    the shapes alone: (entries a chunk of the range pass holds, blocks of
    the range pass), or (0, 0) where neither applies.

    One binning pass, its range read from the shapes
    (:func:`counts_range_log2`): ranges of 2**15 counters (the binned
    route: with 4 rows from 2**16 up to 2**25), else of 2**16..2**18
    counters, each chunk counted by one block a 2**15-counter slice (the
    clustered route: with 4 rows 2**26..2**28, with one 2**28..2**30).
    Either needs at least ``BINNED_MIN_ENTRIES`` updates a call (the sweep
    behind that constant: the clustered route too wins from 2**24 at every
    width it serves; CHANGES.md, readings behind the comments). Weighted
    counts never take it (:func:`histogram_rows`): the main path counts
    unweighted buckets, and staging a weight beside each offset would
    double the stage's bytes for the one caller that passes one
    (``models/sketch.update``'s 0/1 validity).
    """
    range_log2 = counts_range_log2(rows, width_log2)
    if not range_log2:
        return 0, 0
    return _binned_grid(rows, n, width_log2, range_log2)


def page_entries(per: int) -> int:
    """Entries of a page of the "sectors" body's pool for range-pass chunks
    of ``per`` entries: the fewest whole chunks that hold a tile
    (``SECTOR_TILE_ENTRIES``), so that one claim of a range touches at most
    two pages; ``per`` itself from 2**14 on, as on both routes' own
    chunks."""
    return -(-SECTOR_TILE_ENTRIES // per) * per


def page_pool(rows: int, n: int, nranges: int, per: int) -> tuple[int, int]:
    """(pages of the pool, most pages one range takes) for the "sectors"
    body's paged stage (:func:`scatter_body`) over idx [rows, n] in
    ``nranges`` ranges, chunks of ``per`` entries, pages of
    :func:`page_entries`. Each range takes ceil(count / page) pages
    (:func:`range_pages`), so k non-empty ranges leave less than a page
    each unfilled: n' <= rows * n valid updates take at most
    floor((n' - k) / page) + k pages, largest at n' = rows * n and k =
    min(nranges, rows * n). One range holds updates of one row only, at
    most ceil(n / page) pages. ``csrc/bin.cuh``'s scratch() sizes the same
    and refuses a shorter stage."""
    page = page_entries(per)
    total = rows * n
    k = min(nranges, total)
    return (total - k) // page + k, -(-n // page)


def range_pages(counts: torch.Tensor, per: int) -> torch.Tensor:
    """Pages each range takes for chunks of ``per`` entries:
    ceil(count / page), page = :func:`page_entries` (ceil(count / per)
    from 2**14 on)."""
    page = page_entries(per)
    return (counts + page - 1) // page


def bin_ranges_plain(idx: torch.Tensor, weight: torch.Tensor | None,
                     width_log2: int, range_log2: int,
                     per: int = BINNED_RANGE_ENTRIES) -> Bins:
    """Plain PyTorch version of :func:`bin_ranges`, on any device: the
    valid updates (in range, weight non-zero) ordered by range with a
    stable sort, so each range keeps its updates in row order (the kernel's
    order within a range is free); the stage is int16 for ranges of 2**15
    buckets, else int32, the ranges one after another."""
    idx, weight = _bin_args(idx, weight, width_log2, range_log2)
    rows = idx.shape[0]
    nbins = 1 << (width_log2 - range_log2)
    dev = idx.device
    b = idx.to(torch.int64)
    keep = (b >= 0) & (b < (1 << width_log2))
    if weight is not None:
        keep &= weight.reshape(1, -1) != 0
    rid = ((torch.arange(rows, device=dev)[:, None] * nbins)
           + (b >> range_log2))[keep]
    order = torch.sort(rid, stable=True).indices
    counts = torch.zeros(rows * nbins, dtype=torch.int64, device=dev)
    counts.index_add_(0, rid, torch.ones_like(rid))
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    stage = (b[keep] & ((1 << range_log2) - 1))[order]
    chunks = (counts + per - 1) // per
    return Bins(counts, torch.cat([zero, counts.cumsum(0)]),
                torch.cat([zero, (range_owners(range_log2) * chunks)
                           .cumsum(0)]),
                stage.to(_stage_dtype(range_log2)), per, range_log2)


def _stage_positions(bins: Bins) -> torch.Tensor:
    """int64 position in the paged stage of each entry of ``bins`` in range
    order."""
    g = _range_ids(bins)
    i = torch.arange(g.numel(), device=g.device) - bins.starts[g]
    page = page_entries(bins.per)
    return (bins.pages[g, i // page].to(torch.int64) - 1) * page + i % page


def staged(bins: Bins) -> torch.Tensor:
    """The staged offsets of ``bins`` in range order: range g's
    ``counts[g]`` entries from ``starts[g]`` on, read from its pages where
    the stage is paged."""
    if bins.pages is None:
        return bins.stage[:int(bins.starts[-1])]
    return bins.stage[_stage_positions(bins)]


def _stage_dtype(range_log2: int) -> torch.dtype:
    return torch.int16 if range_log2 <= COUNTS_RANGE_LOG2 else torch.int32


def scatter_body(width_log2: int, range_log2: int) -> str:
    """The scatter body ``csrc/bin.cuh`` runs for rows of 2**width_log2
    buckets in ranges of 2**range_log2: "sectors" where a row has more than
    ``SCATTER_GROUPED_MAX_BINS`` ranges and their carried entries (a sector
    of the stage's entries a range) fit ``SCATTER_MAX_CARRIED``, else
    "runs"."""
    nbins = 1 << (width_log2 - range_log2)
    sector = SECTOR_BYTES // _stage_dtype(range_log2).itemsize
    return ("sectors" if SCATTER_GROUPED_MAX_BINS < nbins
            and nbins * sector <= SCATTER_MAX_CARRIED else "runs")


def _bin_args(idx, weight, width_log2, range_log2):
    if not (COUNTS_RANGE_LOG2 <= range_log2 <= CLUSTERED_MAX_RANGE_LOG2
            or range_log2 == WORDS_RANGE_LOG2):
        raise ValueError(
            f"range_log2 must be in [{COUNTS_RANGE_LOG2}, "
            f"{CLUSTERED_MAX_RANGE_LOG2}] or {WORDS_RANGE_LOG2}, got "
            f"{range_log2}")
    idx, weight = _rows_and_weight(idx, weight, width_log2, MIN_WIDTH_LOG2,
                                   BLOOM_MAX_WIDTH_LOG2)
    if weight is not None and (idx.shape[0] != 1 or weight.dim() != 1):
        raise ValueError("a weight needs a single row of indices")
    if not binned_ranges(idx.shape[0], width_log2, range_log2):
        raise ValueError(
            f"no binned route for {idx.shape[0]} row(s) at width "
            f"2**{width_log2} with ranges of 2**{range_log2}: at most "
            f"{BINNED_MAX_RANGES} ranges, each narrower than a row")
    return idx, weight


def _bin_launch(idx, weight, width_log2, range_log2, per, gate) -> Bins:
    """Launch the binning pass on validated idx [R, N] (R * N > 0): scratch
    from ``torch.empty``, the stage sized for every update (by the
    "sectors" body a pool of :func:`page_pool` pages, the page table after
    meta's words; the library refuses scratch shorter than it needs);
    inside the span ``nthash.bin``."""
    rows, n = idx.shape
    nranges = binned_ranges(rows, width_log2, range_log2)
    dev = idx.device
    dtype = _stage_dtype(range_log2)
    body = scatter_body(width_log2, range_log2)
    pool = most = 0
    if body == "sectors":
        sector = SECTOR_BYTES // dtype.itemsize
        if per % sector:
            raise ValueError(f"per ({per}) must be a multiple of {sector}, "
                             "the entries of a 32-byte sector of the stage")
        pool, most = page_pool(rows, n, nranges, per)
    with span("nthash.bin"):
        # counts, starts, cursors, blocks, the scatter's claims, leftovers,
        # pages taken, blocks past its barrier, the page table's row
        # length; then the page table
        words = 6 * nranges + 5
        meta = torch.empty(words + -(-nranges * most // 2),
                           dtype=torch.int64, device=dev)
        stage = torch.empty(pool * page_entries(per) if pool else rows * n,
                            dtype=dtype, device=dev)
        name = "bloom" if range_log2 == WORDS_RANGE_LOG2 else "histogram"
        lib = _lib() if name == "histogram" else _bloom_lib()
        args = [dev.index, idx.contiguous().data_ptr(), rows, n]
        if name == "bloom":
            args += [None if weight is None
                     else weight.contiguous().data_ptr(), width_log2]
        else:
            args += [width_log2, range_log2]
        status = getattr(lib, f"nthash_{name}_bin")(
            *args, per, meta.data_ptr(), meta.numel(), stage.data_ptr(),
            stage.numel(), None if gate is None else gate.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(lib, status, f"{name} binning launch")
        BIN_LAUNCHES[name] += 1
        BIN_COUNT_LAUNCHES[name] += body == "runs"
        SCATTER_ROUTE_LAUNCHES[body] += 1
        pages = None if not most else (meta[words:].view(torch.int32)
                                       [:nranges * most].view(nranges, most))
        return Bins(meta[:nranges], meta[nranges:2 * nranges + 1],
                    meta[3 * nranges + 1:4 * nranges + 2], stage, per,
                    range_log2, pages)


def _ranges_launch(name: str, bins: Bins, blocks: int, out: torch.Tensor,
                   gate) -> None:
    """Launch the range pass of library ``name`` ("histogram" or "bloom")
    over a binning pass's ``bins`` (kernel route): ``blocks`` blocks of
    ``bins.per`` staged entries, added or OR-ed into ``out``; inside the
    span ``nthash.ranges``."""
    dev = out.device
    with span("nthash.ranges"):
        lib = _lib() if name == "histogram" else _bloom_lib()
        args = [dev.index, bins.stage.data_ptr(), bins.counts.data_ptr(),
                bins.counts.numel()]
        if name == "histogram":
            args.append(bins.range_log2)
        status = getattr(lib, f"nthash_{name}_ranges")(
            *args, bins.per, blocks, out.data_ptr(),
            None if gate is None else gate.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(lib, status, f"{name} range launch")
        RANGE_LAUNCHES[name] += 1


def bin_ranges(idx: torch.Tensor, weight: torch.Tensor | None,
               width_log2: int, range_log2: int,
               per: int = BINNED_RANGE_ENTRIES) -> Bins:
    """The binning pass of the binned routes: the valid updates of idx
    [R, ...] grouped by range of 2**range_log2 buckets, with no sort.

    ``range_log2`` is 15 (the histogram's binned route, an int16 stage),
    16..18 (its clustered route, int32), both launched from
    ``csrc/histogram.cu``, or 20 (the presence words', int32, from
    ``csrc/bloom.cu``); ``weight`` (int32 [N], one row only) drops the
    updates whose weight is 0. Returns :class:`Bins`; on the kernel route
    each range's entries lie in any order: by the "runs" body the stage has
    R * N entries, of which the first ``starts[-1]`` are written; by the
    "sectors" body it is a pool of :func:`page_pool` pages (``per`` a
    multiple of a 32-byte sector's entries), each range in the pages
    ``Bins.pages`` names (:func:`staged` reads them in range order).

    A CUDA tensor goes through ``csrc/bin.cuh``'s kernels by
    :func:`scatter_body`'s body, with no host sync: "runs" a count by range
    (``BIN_COUNT_LAUNCHES``), a scan and a scatter; "sectors" the scatter,
    then the scan. A CPU tensor goes through :func:`bin_ranges_plain`.
    """
    idx2, w = _bin_args(idx, weight, width_log2, range_log2)
    if idx2.is_cuda:
        if idx2.numel() == 0:  # nothing to bin: every range empty
            nranges = binned_ranges(idx2.shape[0], width_log2, range_log2)
            zeros = torch.zeros(2 * nranges + 2, dtype=torch.int64,
                                device=idx2.device)
            return Bins(zeros[:nranges], zeros[:nranges + 1],
                        zeros[nranges + 1:], torch.empty(
                            0, dtype=_stage_dtype(range_log2),
                            device=idx2.device), per, range_log2)
        return _bin_launch(idx2, w, width_log2, range_log2, per, None)
    if idx2.device.type == "cpu":
        return bin_ranges_plain(idx2, w, width_log2, range_log2, per)
    raise ValueError(f"no binning route for device {idx2.device}")


def _range_ids(bins: Bins) -> torch.Tensor:
    """int64 range id of each staged entry of ``bins``."""
    counts = bins.counts
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)


def _staged_buckets(bins: Bins) -> torch.Tensor:
    """Each staged update as its flat index row * width + b, int64."""
    off = staged(bins).to(torch.int64) & ((1 << bins.range_log2) - 1)
    return (_range_ids(bins) << bins.range_log2) | off


def histogram_ranges_plain(bins: Bins, rows: int, width_log2: int, *,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the binned and clustered histogram's range
    pass, block by block as the kernels split it, into ``out`` (int32
    [rows, 2**width_log2], zeroed when not given).

    Entry i in range order (:func:`staged`), of range g, lies in chunk
    (i - starts[g]) // per. Its
    block is blocks[g] + chunk * owners + the owner of its slice
    (:func:`range_owners`). A binned block counts its range in int32
    counters. A clustered block counts its 2**15-counter slice in 2**14
    uint32 words, counter c adding 1 << 16 * (c >> 14) to word c & 0x3fff,
    and reads each word's halves back. Each block then adds its non-zero
    counters into ``out``."""
    rl = bins.range_log2
    g = _range_ids(bins)
    o = staged(bins).to(torch.int64) & ((1 << rl) - 1)
    chunk = (torch.arange(o.numel(), device=o.device)
             - bins.starts[g]) // bins.per
    slice_log2 = min(rl, CLUSTERED_SLICE_LOG2)
    owner = o >> slice_log2
    block = bins.blocks[g] + chunk * range_owners(rl) + owner
    c = o & ((1 << slice_log2) - 1)
    # counter c of a clustered block is half c >> 14 of word c & 0x3fff
    halves = rl > COUNTS_RANGE_LOG2
    word_log2 = slice_log2 - 1 if halves else slice_log2
    key, inv = torch.unique(
        (block << slice_log2) | (c & ((1 << word_log2) - 1)),
        return_inverse=True)
    add = torch.ones_like(c) << (16 * (c >> word_log2))
    words = torch.zeros(key.shape, dtype=torch.int64, device=o.device)
    words = words.index_add_(0, inv, add) & 0xffffffff  # a uint32 word
    # the key's first counter in the table: its range's, owner's, word's
    first = torch.zeros_like(words).scatter_(
        0, inv, (g << rl) | (owner << slice_log2)) + (
        key & ((1 << word_log2) - 1))
    if halves:
        first = torch.cat([first, first + (1 << word_log2)])
        words = torch.cat([words & 0xffff, words >> 16])
    if out is None:
        out = torch.zeros((rows, 1 << width_log2), dtype=torch.int32,
                          device=o.device)
    nz = words != 0
    out.view(-1).index_add_(0, first[nz], words[nz].to(torch.int32))
    return out


def _binned_kind(range_log2: int) -> str:
    return "binned" if range_log2 == COUNTS_RANGE_LOG2 else "clustered"


def _counts_route(rows, n, width_log2, weighted, route):
    """(route, a, b) of :func:`_launch`: "private" with (blocks per row,
    threads), "binned" or "clustered" with :func:`binned_counts_grid`'s
    (per, blocks), or "direct"; the rule's, or the ``route`` forced (a
    forced private route takes the rule's grid at one entry per counter,
    and one block a row below that; a forced binned or clustered route
    takes its grid at any n, and there is none for weighted counts or where
    :func:`counts_range_log2` gives the other one or none)."""
    if route is None:
        blocks, threads = private_counts_grid(rows, n, width_log2)
        if blocks:
            return "private", blocks, threads
        per, grid = ((0, 0) if weighted else
                     binned_counts_grid(rows, n, width_log2))
        if not per:
            return "direct", 0, 0
        return _binned_kind(counts_range_log2(rows, width_log2)), per, grid
    if route == "direct":
        return "direct", 0, 0
    if route in ("binned", "clustered"):
        range_log2 = counts_range_log2(rows, width_log2)
        if weighted or not range_log2 or _binned_kind(range_log2) != route:
            raise ValueError(
                f"no {route} route for {'weighted ' if weighted else ''}"
                f"counts of {rows} row(s) at width 2**{width_log2}")
        return (route,) + _range_grid(
            rows * n, binned_ranges(rows, width_log2, range_log2), range_log2)
    if route != "private":
        raise ValueError("route must be 'direct', 'private', 'binned' or "
                         f"'clustered', got {route!r}")
    if width_log2 > PRIVATE_COUNTS_MAX_WIDTH_LOG2:
        raise ValueError(
            f"no private route at width 2**{width_log2}: the counters do "
            "not fit a block's shared memory")
    blocks, threads = private_counts_grid(rows, n, width_log2, 1)
    return ("private",) + ((blocks, threads) if blocks else (
        1, _private_count_threads(width_log2)))


def _launch(idx, weight, width_log2, gate, out, route=None):
    """Launch ``csrc/histogram.cu`` on validated idx [R, N]. ``route``
    ("direct", "private", "binned" or "clustered") overrides the rule's
    choice, for the tests and the smoke run."""
    global LAUNCHES
    rows, n = idx.shape
    kind, a, b = _counts_route(rows, n, width_log2, weight is not None, route)
    dev = idx.device
    if out is None:
        out = torch.zeros((rows, 1 << width_log2), dtype=torch.int32,
                          device=dev)
    if rows == 0 or n == 0:
        return out
    idx = idx.contiguous()
    if kind in ("binned", "clustered"):
        bins = _bin_launch(idx, None, width_log2,
                           counts_range_log2(rows, width_log2), a, gate)
        _ranges_launch("histogram", bins, b, out, gate)
    else:
        if weight is not None:
            weight = weight.contiguous()
        lib = _lib()
        status = lib.nthash_histogram_rows(
            dev.index, idx.data_ptr(), rows, n,
            None if weight is None else weight.data_ptr(),
            n if weight is not None and weight.dim() == 2 else 0,
            width_log2, out.data_ptr(), None if gate is None else
            gate.data_ptr(), a, b, torch.cuda.current_stream(dev).cuda_stream,
        )
        cuda_build.check(lib, status, "histogram launch")
    LAUNCHES += 1
    ROUTE_LAUNCHES[kind] += 1
    return out


def histogram_rows(idx: torch.Tensor, weight: torch.Tensor | None,
                   width_log2: int, *, gate: torch.Tensor | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """R independent weighted histograms in one kernel launch.

    Args:
      idx: [R, ...] int32 bucket indices; entries outside
        [0, 2**width_log2) are dropped (encode invalid updates as e.g.
        ``width``).
      weight: int32, either [...] shared across rows or [R, ...]; ``None``
        counts each update once. Sums wrap mod 2**32.
      width_log2: log2 of the histogram width, in [10, 30].
      gate: optional int32 tensor of one element on the same device; where
        it holds 0 nothing is counted. The device reads it, so a caller can
        choose between two launches without waiting on the host.
      out: optional contiguous int32 [R, 2**width_log2] to add the counts
        into (wrapping mod 2**32), instead of a new zeroed tensor.

    Returns:
      int32 [R, 2**width_log2], equal to ``np.bincount`` per row (``out``
      plus the counts when ``out`` is given).

    There is no ``weight_bits``: every int32 weight is exact.

    A CUDA tensor goes through the CUDA kernels (``csrc/histogram.cu``), by
    private counters, binned ranges (each range's counters, or each
    2**15-counter slice of it, in a block's shared memory) or direct
    atomics as :func:`private_counts_grid` and
    :func:`binned_counts_grid` pick; a CPU
    tensor through :func:`histogram_rows_plain`; either inside the span
    ``nthash.histogram`` (``utils/profiling.span``).
    """
    with span("nthash.histogram"):
        idx2, w = _rows_and_weight(idx, weight, width_log2)
        _check_extras(idx2, 1 << width_log2, gate, out)
        if idx2.is_cuda:
            return _launch(idx2, w, width_log2, gate, out)
        if idx2.device.type == "cpu":
            return histogram_rows_plain(idx, weight, width_log2, gate=gate,
                                        out=out)
    raise ValueError(f"no histogram route for device {idx2.device}")


def histogram(idx: torch.Tensor, weight: torch.Tensor | None,
              width_log2: int) -> torch.Tensor:
    """Flat weighted histogram of ``idx`` (any shape) -> int32 [width].

    See :func:`histogram_rows`; this is the single-row convenience.
    """
    return histogram_rows(
        idx.reshape(1, -1),
        None if weight is None else weight.reshape(1, -1),
        width_log2,
    )[0]


# ------------------------------------------------------ presence words ----


def word_index(bucket):
    """Packed-word bijection of the JAX package (``hist_pallas.py``): bucket
    b lives in word ``((b >> 12) << 7) | (b & 127)`` at bit
    :func:`bit_index` ``(b)``; ints, numpy arrays or tensors."""
    return ((bucket >> 12) << 7) | (bucket & 127)


def bit_index(bucket):
    """The bit of bucket b inside its word: ``(b >> 7) & 31``."""
    return (bucket >> 7) & 31


def _words_args(idx, weight, width_log2, hi, gate, out, dtype=torch.int32):
    """Validate; return (idx [R, N], weight None | [N])."""
    idx, weight = _rows_and_weight(idx, weight, width_log2,
                                   BLOOM_MIN_WIDTH_LOG2, hi, dtype)
    if weight is not None and idx.shape[0] != 1:
        raise ValueError("a weight needs a single row of indices")
    _check_extras(idx, (1 << width_log2) // PACK, gate, out)
    return idx, weight


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 tensor of the same bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _words_plain(idx, weight, width_log2, gate, out):
    """The plain presence words of validated idx [R, N], OR-ed into ``out``.
    Sparse: it holds the distinct in-range updates and their words, never a
    full-width presence (4 GiB as int32 at 2**30)."""
    rows = idx.shape[0]
    dev = idx.device
    if out is None:
        out = torch.zeros((rows, (1 << width_log2) // PACK), dtype=torch.int32,
                          device=dev)
    keep = idx >= 0
    if idx.dtype == torch.int64 or width_log2 < 31:
        # every non-negative int32 is in range at 2**31
        keep &= idx < (1 << width_log2)
    if weight is not None:
        keep &= weight.reshape(1, -1) != 0
    row = torch.arange(rows, device=dev)[:, None] << width_log2
    return _or_buckets(out, (idx.to(torch.int64) + row)[keep], gate)


def _or_buckets(out, buckets, gate):
    """OR the bits of int64 ``buckets`` (row * width + b, so that
    ``word_index`` of one is row * width / 32 + ``word_index(b)``) into the
    words ``out``, the gate as a 0/1 factor."""
    key = torch.unique(buckets)
    word, inv = torch.unique(word_index(key), return_inverse=True)
    # the distinct bits of one word sum to their OR
    bits = torch.zeros(word.shape, dtype=torch.int64,
                       device=key.device).index_add_(
        0, inv, torch.ones_like(key) << bit_index(key))
    if gate is not None:
        bits = bits * (gate.reshape(()) != 0)
    flat = out.view(-1)
    flat.index_put_((word,), flat[word] | _as_int32(bits))
    return out


def bloom_ranges_plain(bins: Bins, rows: int, width_log2: int, *,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the binned presence words' range pass: the
    bit of each staged offset set in its range's words, OR-ed into ``out``
    (int32 [rows, 2**width_log2 / 32], zeroed when not given)."""
    flat = _staged_buckets(bins)
    if out is None:
        out = torch.zeros((rows, (1 << width_log2) // PACK),
                          dtype=torch.int32, device=flat.device)
    return _or_buckets(out, flat, None)


def _bloom_lib() -> ctypes.CDLL:
    lib = cuda_build.load("bloom")
    fn = lib.nthash_bloom_words_rows
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        wide = lib.nthash_bloom_words_wide
        wide.restype = ctypes.c_int
        wide.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        _bind_binned(lib, "bloom")
    return lib


def _private_threads(width_log2: int) -> int:
    return 1024 if width_log2 >= 19 else 512


def private_words_grid(
        rows: int, n: int, width_log2: int,
        min_entries_per_word: int = PRIVATE_MIN_ENTRIES_PER_WORD,
) -> tuple[int, int]:
    """The presence-word kernel's route for idx [rows, n], from the shapes
    alone: (blocks per row, threads per block) for private words in shared
    memory merged once per block, or (0, 0) for one global atomic OR per
    update.

    Private words pay where a row's words fit a block's shared memory (up to
    2**20 buckets) and a block can be given at least
    ``PRIVATE_MIN_ENTRIES_PER_WORD`` entries per word. The rows then share
    about ``PRIVATE_TARGET_THREADS`` threads, in blocks of 512 (1,024 from
    2**19 up, where the words leave room for one block per multiprocessor).
    Otherwise (rows too short to pay for a merge, filters wider than 2**20)
    the updates go to the words directly. ``min_entries_per_word`` is the
    rule's own constant except where the smoke run measures it.
    """
    if rows < 1 or n < 1 or width_log2 > PRIVATE_MAX_WIDTH_LOG2:
        return 0, 0
    nwords = (1 << width_log2) // PACK
    most = n // (min_entries_per_word * nwords)
    if most < 1:
        return 0, 0
    threads = _private_threads(width_log2)
    return max(1, min(most, -(-PRIVATE_TARGET_THREADS // (threads * rows)))), \
        threads


def binned_words_grid(rows: int, n: int,
                      width_log2: int) -> tuple[int, int]:
    """The presence-word kernel's binned route for idx [rows, n], from the
    shapes alone: (entries a block of the range pass takes, blocks of the
    range pass), or (0, 0) where it does not apply.

    It applies above the private words' widths (from 2**21) where the rows'
    ranges of 2**20 buckets number at most ``BINNED_MAX_RANGES`` (one row
    up to 2**31) and the call brings at least ``BINNED_MIN_WORD_ENTRIES``
    updates. A weight
    (one row) only drops the updates whose weight is 0, in the binning
    pass.
    """
    return _binned_grid(rows, n, width_log2, WORDS_RANGE_LOG2)


def _words_route_of(rows, n, width_log2, route):
    """(route, a, b) of :func:`_words_launch`, as :func:`_counts_route`."""
    if route is None:
        blocks, threads = private_words_grid(rows, n, width_log2)
        if blocks:
            return "private", blocks, threads
        per, grid = binned_words_grid(rows, n, width_log2)
        return ("binned", per, grid) if per else ("direct", 0, 0)
    if route == "direct":
        return "direct", 0, 0
    if route == "binned":
        nranges = binned_ranges(rows, width_log2, WORDS_RANGE_LOG2)
        if not nranges:
            raise ValueError(f"no binned route for {rows} row(s) at width "
                             f"2**{width_log2}")
        return ("binned",) + _range_grid(rows * n, nranges, WORDS_RANGE_LOG2)
    if route != "private":
        raise ValueError("route must be 'direct', 'private' or 'binned', "
                         f"got {route!r}")
    if width_log2 > PRIVATE_MAX_WIDTH_LOG2:
        raise ValueError(
            f"no private route at width 2**{width_log2}: the words do "
            "not fit a block's shared memory")
    blocks, threads = private_words_grid(rows, n, width_log2, 1)
    return ("private",) + ((blocks, threads) if blocks else (
        1, _private_threads(width_log2)))


def _words_launch(idx, weight, width_log2, gate, out, name, route=None):
    """Launch ``csrc/bloom.cu``. ``route`` ("direct", "private" or
    "binned") overrides the rule's choice (:func:`_words_route_of`), for
    the tests and the smoke run; int64 idx take the wide route (direct
    atomics with 64-bit word offsets) whatever ``route`` says."""
    rows, n = idx.shape
    dev = idx.device
    kind, a, b = (("wide", 0, 0) if idx.dtype == torch.int64
                  else _words_route_of(rows, n, width_log2, route))
    if out is None:
        out = torch.zeros((rows, (1 << width_log2) // PACK), dtype=torch.int32,
                          device=dev)
    if rows == 0 or n == 0:
        return out
    idx = idx.contiguous()
    if weight is not None:
        weight = weight.contiguous()
    if kind == "binned":
        bins = _bin_launch(idx, weight, width_log2, WORDS_RANGE_LOG2, a, gate)
        _ranges_launch("bloom", bins, b, out, gate)
    else:
        lib = _bloom_lib()
        wptr = None if weight is None else weight.data_ptr()
        gptr = None if gate is None else gate.data_ptr()
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "wide":
            status = lib.nthash_bloom_words_wide(
                dev.index, idx.data_ptr(), rows, n, wptr, width_log2,
                out.data_ptr(), gptr, stream)
        else:
            status = lib.nthash_bloom_words_rows(
                dev.index, idx.data_ptr(), rows, n, wptr, width_log2,
                out.data_ptr(), gptr, a, b, stream)
        cuda_build.check(lib, status, f"{name} launch")
    ROUTE_LAUNCHES["wide_words"] += kind == "wide"
    BLOOM_LAUNCHES[name] += 1
    return out


def _words_route(idx, weight, width_log2, gate, out, name):
    """The presence words' launch or plain version, inside the span
    ``nthash.bloom``."""
    with span("nthash.bloom"):
        if idx.is_cuda:
            return _words_launch(idx, weight, width_log2, gate, out, name)
        if idx.device.type == "cpu":
            return _words_plain(idx, weight, width_log2, gate, out)
    raise ValueError(f"no presence-word route for device {idx.device}")


def _one_row(idx, weight, out):
    """idx, weight and out of the single-row entry points as rows of one."""
    if out is not None and out.dim() != 1:
        raise ValueError(f"out must be 1-D, got {tuple(out.shape)}")
    return (idx.reshape(1, -1), None if weight is None else weight.reshape(-1),
            None if out is None else out.unsqueeze(0))


def bloom_words_rows_plain(idx: torch.Tensor, width_log2: int, *,
                           gate: torch.Tensor | None = None,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`bloom_words_rows`, on any device: the
    distinct in-range buckets by ``torch.unique``, their bits summed per
    word (distinct bits add up to their OR), OR-ed into ``out``; the gate is
    a 0/1 factor so nothing waits on it."""
    idx, _ = _words_args(idx, None, width_log2, BLOOM_ROWS_MAX_WIDTH_LOG2,
                         gate, out)
    return _words_plain(idx, None, width_log2, gate, out)


def bloom_words_rows(idx: torch.Tensor, width_log2: int, *,
                     gate: torch.Tensor | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """R independent bit-packed presence maps in one kernel launch.

    Args:
      idx: [R, ...] int32 bucket indices; entries outside
        [0, 2**width_log2) are dropped.
      width_log2: in [12, 26], as the JAX package's ``mxu_bloom_words_rows``.
      gate: optional int32 tensor of one element on the same device; where
        it holds 0 nothing is set.
      out: optional contiguous int32 [R, 2**width_log2 / 32] to OR the bits
        into, in place, instead of a new zeroed tensor.

    Returns:
      int32 [R, 2**width_log2 / 32]: per row, the uint32 bit patterns of the
      JAX package's words in the :func:`word_index` / :func:`bit_index`
      layout (``out`` itself when given).

    A CUDA tensor goes through the CUDA kernel (``csrc/bloom.cu``), a CPU
    tensor through :func:`bloom_words_rows_plain`.
    """
    idx, _ = _words_args(idx, None, width_log2, BLOOM_ROWS_MAX_WIDTH_LOG2,
                         gate, out)
    return _words_route(idx, None, width_log2, gate, out, "bloom_words_rows")


def _bloom_words_args(idx, weight, width_log2, gate, out):
    """:func:`bloom_words`' arguments as rows of one, validated: int32 idx
    to 2**31 bits, int64 idx (the wide route) to 2**38."""
    wide = idx.dtype == torch.int64
    if not wide and width_log2 > BLOOM_MAX_WIDTH_LOG2:
        raise ValueError(f"a filter of 2**{width_log2} bits takes int64 idx, "
                         f"got {idx.dtype}")
    idx, weight, out2 = _one_row(idx, weight, out)
    idx, weight = _words_args(
        idx, weight, width_log2,
        WIDE_MAX_WIDTH_LOG2 if wide else BLOOM_MAX_WIDTH_LOG2, gate, out2,
        torch.int64 if wide else torch.int32)
    return idx, weight, out2


def bloom_words_plain(idx: torch.Tensor, weight: torch.Tensor | None,
                      width_log2: int, *, gate: torch.Tensor | None = None,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`bloom_words`, on any device."""
    idx, weight, out2 = _bloom_words_args(idx, weight, width_log2, gate, out)
    return _words_plain(idx, weight, width_log2, gate, out2)[0]


def bloom_words(idx: torch.Tensor, weight: torch.Tensor | None,
                width_log2: int, *, gate: torch.Tensor | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Bit-packed presence of ``idx`` (any shape) -> int32 [2**width_log2 / 32].

    The scatter-OR a Bloom filter needs. Entries outside [0, 2**width_log2)
    and, with a ``weight`` (int32, one per entry), entries whose weight is 0
    are dropped. ``width_log2`` is in [12, 31]: past the JAX kernel's 2**26,
    because on this card atomic ORs serve every width (into private words in
    shared memory up to 2**20, into each range's words in shared memory
    after a binning pass above that, or straight into the words:
    :func:`private_words_grid`, :func:`binned_words_grid`): the Bloom
    filter's every width, the partitioned path's skew fallback and the
    widest filter at 2**31.
    ``gate`` and ``out`` (contiguous int32 [2**width_log2 / 32], OR-ed into
    in place) are as in :func:`bloom_words_rows`.

    int64 ``idx``, which filters past 2**31 bits (to 2**38) take, go the
    wide route at any width: direct atomics with 64-bit word offsets
    (``ROUTE_LAUNCHES["wide_words"]``).

    A CUDA tensor goes through the CUDA kernel (``csrc/bloom.cu``), a CPU
    tensor through :func:`bloom_words_plain`.
    """
    idx, weight, out2 = _bloom_words_args(idx, weight, width_log2, gate, out)
    return _words_route(idx, weight, width_log2, gate, out2, "bloom_words")[0]
