"""The port's row histograms against the JAX package, exactly.

``histogram_rows_plain`` (what ``histogram_rows`` runs on a CPU tensor) is
held against ``mxu_histogram_rows`` in interpret mode at the widths
``tests/test_hist.py`` already runs, and against ``np.bincount`` with
two's-complement wrap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nthash_tpu.ops.hist_pallas import CHUNK, mxu_histogram, mxu_histogram_rows
from nthash_tpu_torch.ops import hist_kernel
from nthash_tpu_torch.ops.hist_kernel import (
    histogram,
    histogram_rows,
    histogram_rows_plain,
)


def _expect(idx, w, width):
    """np.bincount with uint32 modular wraparound (matches int32 counts)."""
    keep = (idx >= 0) & (idx < width)
    exp = np.bincount(idx[keep], weights=w[keep].astype(np.int64),
                      minlength=width)
    return (exp.astype(np.int64) % (1 << 32)).astype(np.uint32).view(np.int32)


def _inputs(rng, rows, n, wl):
    width = 1 << wl
    idx = rng.integers(0, width, size=(rows, n)).astype(np.int32)
    idx[:, rng.random(n) < 0.05] = -1
    idx[:, rng.random(n) < 0.05] = width
    w = rng.integers(-(2**31), 2**31, size=(rows, n), dtype=np.int64)
    return idx, w.astype(np.int32)


@pytest.mark.parametrize("weights", ["per_row", "shared", "none"])
@pytest.mark.parametrize("wl", [10, 12])
def test_rows_vs_pallas_interpret(rng, wl, weights):
    idx, w = _inputs(rng, 3, 2 * CHUNK + 17, wl)
    wj = {"per_row": w, "shared": w[0], "none": None}[weights]
    want = np.asarray(mxu_histogram_rows(
        jnp.asarray(idx), None if wj is None else jnp.asarray(wj), wl,
        interpret=True))
    got = histogram_rows_plain(
        torch.from_numpy(idx), None if wj is None else torch.from_numpy(wj), wl)
    assert got.dtype == torch.int32 and got.shape == (3, 1 << wl)
    assert np.array_equal(got.numpy(), want)


def test_flat_vs_pallas_interpret(rng):
    idx, w = _inputs(rng, 1, CHUNK + 3, 10)
    want = np.asarray(mxu_histogram(jnp.asarray(idx[0]), jnp.asarray(w[0]), 10,
                                    interpret=True))
    got = histogram(torch.from_numpy(idx[0]), torch.from_numpy(w[0]), 10)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("wl", [10, 14, 17, 20, 26])
def test_vs_bincount_full_range_weights(rng, wl):
    idx, w = _inputs(rng, 2, 5000, wl)
    got = histogram_rows(torch.from_numpy(idx), torch.from_numpy(w), wl)
    for r in range(2):
        assert np.array_equal(got[r].numpy(), _expect(idx[r], w[r], 1 << wl))


def test_wrap_mod_2_32():
    idx = np.zeros(6, np.int32)
    w = np.full(6, 2**31 - 1, np.int32)  # sum 6 * (2**31 - 1) wraps
    got = histogram(torch.from_numpy(idx), torch.from_numpy(w), 10)
    assert got[0].item() == int(_expect(idx, w, 1024)[0]) == -6
    assert got[1:].abs().sum().item() == 0


def test_counts_once_and_drops_out_of_range():
    width = 1 << 12
    idx = torch.tensor([0, 5, width, width + 7, -1, 5], dtype=torch.int32)
    got = histogram(idx, None, 12)
    assert got[0] == 1 and got[5] == 2 and got.sum() == 3


def test_cpu_route_launches_no_kernel(rng):
    before = hist_kernel.LAUNCHES, dict(hist_kernel.ROUTE_LAUNCHES)
    histogram_rows(torch.zeros((2, 8), dtype=torch.int32), None, 10)
    assert (hist_kernel.LAUNCHES, hist_kernel.ROUTE_LAUNCHES) == before


# ------------------------------------------- the route of the histogram ----


@pytest.mark.parametrize("rows,n,wl,want", [
    # one main-path batch at 2**14: 4 rows of 2**18 reads x 119 windows,
    # as one launch and as one launch a row
    (4, 31_195_136, 14, (33, 1024)),
    (1, 31_195_136, 14, (132, 1024)),
    # the 2**20 plan's sub-histograms: 512 rows at 2**13, one block a row
    (512, 368_640, 13, (1, 512)),
    # every width up to 2**15 where the rows are long enough
    (4, 1 << 20, 10, (66, 512)),
    (4, 1 << 20, 11, (66, 512)),
    (4, 1 << 20, 12, (66, 512)),
    (3, 300_001, 14, (9, 1024)),
    (4, 1 << 20, 15, (16, 1024)),
    # counters past a block's shared memory: direct atomics
    (4, 1 << 20, 16, (0, 0)),
    (4, 31_195_136, 18, (0, 0)),
    (4, 31_195_136, 20, (0, 0)),
    (1, 1 << 20, 30, (0, 0)),
    # a row with fewer entries than 2 a counter, and one just long enough
    (4, 2 * 1024 - 1, 10, (0, 0)),
    (4, 2 * 1024, 10, (1, 512)),
    (2, 2 * 32768 - 1, 15, (0, 0)),
    (2, 2 * 32768, 15, (1, 1024)),
    # empty rows
    (0, 100, 12, (0, 0)),
    (3, 0, 12, (0, 0)),
])
def test_private_counts_grid(rows, n, wl, want):
    """The histogram kernel's route is a pure function of the shapes."""
    assert hist_kernel.private_counts_grid(rows, n, wl) == want


@pytest.mark.parametrize("wl", [10, 12, 13, 14, 15, 16, 20])
@pytest.mark.parametrize("rows", [1, 4, 512])
@pytest.mark.parametrize("n", [1000, 100_000, 31_195_136])
def test_private_counts_grid_gives_every_block_enough(rows, n, wl):
    blocks, threads = hist_kernel.private_counts_grid(rows, n, wl)
    if blocks == 0:
        assert threads == 0
        assert (wl > hist_kernel.PRIVATE_COUNTS_MAX_WIDTH_LOG2
                or n < hist_kernel.PRIVATE_MIN_ENTRIES_PER_COUNTER << wl)
    else:
        assert wl <= 15 and 4 << wl <= 227 * 1024
        assert threads == (1024 if wl >= 14 else 512)
        assert n // blocks >= hist_kernel.PRIVATE_MIN_ENTRIES_PER_COUNTER << wl
        assert (blocks - 1) * rows * threads < hist_kernel.PRIVATE_TARGET_THREADS
        assert blocks * rows < 2 ** 31  # one grid axis


def test_forced_route_is_checked():
    """``route=`` takes "private", "binned" or "direct" (or None: the
    rule's); a forced private route needs the counters to fit shared
    memory. Checked before anything reaches the card."""
    idx = torch.zeros((1, 8), dtype=torch.int32)
    for bad in ("shared", "Private", ""):
        with pytest.raises(ValueError, match="route"):
            hist_kernel._launch(idx, None, 12, None, None, route=bad)
    for wl in (16, 20, 30):
        with pytest.raises(ValueError, match="shared memory"):
            hist_kernel._launch(idx, None, wl, None, None, route="private")
    # a forced private route lowers the rule to one entry per counter, and
    # to one block a row below that
    route = hist_kernel._counts_route
    assert route(4, 1000, 12, False, None) == ("direct", 0, 0)
    assert route(4, 1000, 12, False, "private") == ("private", 1, 512)
    assert route(4, 40_000, 12, False, "private") == ("private", 9, 512)
    assert route(4, 40_000, 12, False, "direct") == ("direct", 0, 0)
    assert route(4, 1 << 20, 12, False, None) == ("private", 66, 512)


def test_rows_view_is_a_view_or_none():
    out = torch.arange(3 * 5 * 7, dtype=torch.int32).reshape(3, 5, 7)
    parts = list(out.unbind(0))
    view = hist_kernel.rows_view(parts)
    assert view.shape == (3, 35) and view.data_ptr() == out.data_ptr()
    assert torch.equal(view, out.reshape(3, 35))
    # a later view of the same storage
    tail = hist_kernel.rows_view(parts[1:])
    assert tail.data_ptr() == parts[1].data_ptr()
    assert torch.equal(tail, out[1:].reshape(2, 35))
    for other in ([p.clone() for p in parts], parts[::-1], [parts[0], parts[2]],
                  [out[0, :, :6], out[1, :, :6]], [out[0], out[1].long()]):
        assert hist_kernel.rows_view(other) is None


def test_any_index_shape(rng):
    idx = rng.integers(0, 1024, size=(2, 7, 9)).astype(np.int32)
    got = histogram_rows(torch.from_numpy(idx), None, 10)
    for r in range(2):
        assert np.array_equal(got[r].numpy(),
                              np.bincount(idx[r].ravel(), minlength=1024))


@pytest.mark.parametrize("bad,err", [
    (dict(wl=9), ValueError),
    (dict(wl=31), ValueError),
    (dict(idx=torch.zeros((2, 8), dtype=torch.int64)), TypeError),
    (dict(weight=torch.ones(8, dtype=torch.int64)), TypeError),
    (dict(weight=torch.ones(5, dtype=torch.int32)), ValueError),
    (dict(idx=torch.zeros((2, 8), dtype=torch.int32, device="meta")),
     ValueError),
])
def test_rejects(bad, err):
    with pytest.raises(err):
        histogram_rows(bad.get("idx", torch.zeros((2, 8), dtype=torch.int32)),
                       bad.get("weight"), bad.get("wl", 10))


def _words_np(idx, width):
    """Reference presence words: a dense bool presence packed with numpy in
    the JAX package's word_index / bit_index layout, as uint32."""
    present = np.zeros(width, bool)
    present[idx[(idx >= 0) & (idx < width)]] = True
    p = present.reshape(width // 4096, 32, 128).astype(np.uint64)
    return (p << np.arange(32, dtype=np.uint64)[None, :, None]).sum(
        axis=1).astype(np.uint32).reshape(-1)


@pytest.mark.parametrize("wl", [12, 18, 20, 26])
def test_bloom_words_vs_numpy(rng, wl):
    """Past the JAX kernel's range too: the direct words serve every width
    up to 2**31 on the card."""
    width = 1 << wl
    idx = rng.integers(-5, width + 5, size=20_000).astype(np.int32)
    got = hist_kernel.bloom_words(torch.from_numpy(idx), None, wl)
    assert np.array_equal(got.numpy().view(np.uint32), _words_np(idx, width))


@pytest.mark.parametrize("rows", [1, 5])
def test_bloom_words_rows_vs_numpy(rng, rows):
    wl = 14
    idx = rng.integers(-5, (1 << wl) + 5, size=(rows, 3000)).astype(np.int32)
    got = hist_kernel.bloom_words_rows(torch.from_numpy(idx), wl)
    for r in range(rows):
        assert np.array_equal(got[r].numpy().view(np.uint32),
                              _words_np(idx[r], 1 << wl))


# ------------------------------------------------- the binned route ----


def _skewed(rng, rows, n, wl):
    """Buckets with -1, the sentinel, anything past the width, a hot bucket
    (every eighth entry) and the top counter of the last range."""
    width = 1 << wl
    idx = rng.integers(0, width, size=(rows, n)).astype(np.int64)
    idx[rng.random((rows, n)) < 0.05] = -1
    idx[rng.random((rows, n)) < 0.05] = width
    idx[rng.random((rows, n)) < 0.02] = width + 12345
    idx[:, ::8] = 12345 % width
    idx[:, 3::16] = width - 1
    return idx.astype(np.int32)


@pytest.mark.parametrize("rows,wl,n", [(1, 16, 3 * CHUNK + 5), (3, 16, 20_001),
                                       (4, 17, 9_999), (2, 20, 50_000),
                                       (1, 25, 4_097)])
def test_binned_pieces_compose_to_plain(rng, rows, wl, n):
    """The binning pass's plain version and the range pass's, composed,
    count what ``histogram_rows_plain`` counts (and ``bin_ranges`` on a CPU
    tensor is that plain version); at 2**16 also what the JAX
    ``mxu_histogram_rows`` counts, in interpret mode."""
    idx = _skewed(rng, rows, n, wl)
    t = torch.from_numpy(idx)
    want = histogram_rows_plain(t, None, wl)
    for per in (1, 1000, 1 << 17):
        bins = hist_kernel.bin_ranges(t, None, wl, 15, per)
        assert bins.stage.dtype == torch.int16
        got = hist_kernel.histogram_ranges_plain(bins, rows, wl)
        assert torch.equal(got, want)
    base = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(rows, 1 << wl),
                                         dtype=np.int64).astype(np.int32))
    got = hist_kernel.histogram_ranges_plain(bins, rows, wl, out=base.clone())
    assert torch.equal(got, histogram_rows_plain(t, None, wl, out=base.clone()))
    if wl == 16:
        jax = np.asarray(mxu_histogram_rows(jnp.asarray(idx), None, wl,
                                            interpret=True))
        assert np.array_equal(want.numpy(), jax)


@pytest.mark.parametrize("rows,wl,range_log2", [(4, 20, 15), (1, 16, 15),
                                                (3, 22, 20), (1, 31, 20),
                                                (4, 26, 16), (4, 27, 17),
                                                (4, 28, 18), (1, 30, 18)])
def test_bin_ranges_plain_groups_by_range(rng, rows, wl, range_log2):
    """Range g = (r << (wl - range_log2)) | (b >> range_log2) holds exactly
    the valid updates of its row and range, as offsets, in row order; the
    starts scan the counts and the blocks scan owners * ceil(count / per),
    one owner a range of the binned routes and one a 2**15-counter slice
    of the clustered route's."""
    n, per = 7_001, 300
    idx = _skewed(rng, rows, n, min(wl, 30))
    if wl == 31:
        idx[0, ::5] = rng.integers(1 << 30, (1 << 31) - 1, size=idx[0, ::5].size)
    bins = hist_kernel.bin_ranges_plain(torch.from_numpy(idx), None, wl,
                                        range_log2, per)
    nbins = 1 << (wl - range_log2)
    counts = bins.counts.numpy()
    starts = bins.starts.numpy()
    assert counts.shape == (rows * nbins,) and starts[0] == 0
    assert np.array_equal(np.diff(starts), counts)
    owners = 1 << max(0, range_log2 - 15) if range_log2 <= 18 else 1
    assert hist_kernel.range_owners(range_log2) == owners
    assert np.array_equal(np.diff(bins.blocks.numpy()),
                          owners * -(-counts // per))
    assert bins.per == per and bins.stage.shape == (starts[-1],)
    stage = bins.stage.numpy().astype(np.int64) & ((1 << range_log2) - 1)
    for r in range(rows):
        row = idx[r].astype(np.int64)
        row = row[(row >= 0) & (row < (1 << wl))]
        for b in range(nbins):
            g = r * nbins + b
            want = row[(row >> range_log2) == b] & ((1 << range_log2) - 1)
            assert np.array_equal(stage[starts[g]:starts[g + 1]], want)


@pytest.mark.parametrize("rows,n,wl,want", [
    # the 2**20 path: one [4, n] launch a 2**18-read batch, 128 ranges
    (4, 31_195_136, 20, (1 << 17, 952 + 128)),
    (4, 25_414_592, 20, (1 << 17, 776 + 128)),
    (4, 31_195_136, 25, (1 << 17, 952 + 4096)),
    (1, 124_780_544, 27, (1 << 17, 952 + 4096)),
    # past 4,096 ranges of 2**15: the clustered route, 4,096 ranges of
    # 2**16..2**18 counters, chunks of 2**16 - 8 entries, 2, 4 or 8
    # owner blocks a chunk
    (4, 31_195_136, 26, (65_528, 2 * (1905 + 4096))),
    (1, 124_780_544, 28, (65_528, 2 * (1905 + 4096))),
    (4, 31_195_136, 27, (65_528, 4 * (1905 + 4096))),
    (4, 31_195_136, 28, (65_528, 8 * (1905 + 4096))),
    (1, 124_780_544, 30, (65_528, 8 * (1905 + 4096))),
    # private widths and too many ranges even of 2**18: none
    (4, 31_195_136, 15, (0, 0)),
    (4, 31_195_136, 29, (0, 0)),
    (4, 31_195_136, 30, (0, 0)),
    # too few updates in all: 2**24 is the least
    (4, (1 << 22) - 1, 20, (0, 0)),
    (4, 1 << 22, 20, (31_776, 528 + 128)),
    (4, (1 << 22) - 1, 25, (0, 0)),
    (1, 1 << 24, 27, (31_776, 528 + 4096)),
    (4, (1 << 22) - 1, 28, (0, 0)),
    (4, 1 << 22, 28, (65_528, 8 * (257 + 4096))),
    (0, 100, 20, (0, 0)),
    (4, 0, 20, (0, 0)),
])
def test_binned_counts_grid(rows, n, wl, want):
    """The histogram's binned route is a pure function of the shapes:
    (entries a block of the range pass takes, its blocks), or (0, 0)."""
    assert hist_kernel.binned_counts_grid(rows, n, wl) == want


@pytest.mark.parametrize("wl", [10, 15, 16, 20, 24, 25, 26, 30])
@pytest.mark.parametrize("rows", [1, 4, 64])
@pytest.mark.parametrize("n", [1000, 1 << 20, 31_195_136])
def test_binned_counts_grid_bounds(rows, n, wl):
    per, blocks = hist_kernel.binned_counts_grid(rows, n, wl)
    rl = hist_kernel.counts_range_log2(rows, wl)
    nranges = hist_kernel.binned_ranges(rows, wl, rl) if rl else 0
    if per == 0:
        assert blocks == 0
        assert (wl <= 15 or nranges == 0
                or rows * n < hist_kernel.BINNED_MIN_ENTRIES)
    else:
        assert wl > 15 and 0 < nranges <= hist_kernel.BINNED_MAX_RANGES
        assert per % 8 == 0
        if rl == 15:
            assert (hist_kernel.BINNED_MIN_RANGE_ENTRIES <= per
                    <= hist_kernel.BINNED_RANGE_ENTRIES)
        else:  # a chunk's count never wraps a 16-bit half
            assert 15 < rl <= 18 and per == hist_kernel.CLUSTERED_RANGE_ENTRIES
            assert per < 1 << 16
        # every split of the updates over the ranges has its blocks
        owners = hist_kernel.range_owners(rl)
        assert owners == (1 << (rl - 15) if rl > 15 else 1)
        assert blocks >= owners * (-(-rows * n // per) + nranges - 1)
        assert blocks < 2 ** 31


def test_route_rule_picks_binned_only_unweighted():
    """Private up to 2**15; binned above where the shapes pay, unweighted
    only; direct otherwise."""
    route = hist_kernel._counts_route
    assert route(4, 31_195_136, 14, False, None)[0] == "private"
    assert route(4, 31_195_136, 20, False, None)[0] == "binned"
    assert route(4, 31_195_136, 20, True, None)[0] == "direct"
    assert route(4, 1000, 20, False, None)[0] == "direct"
    assert route(4, 31_195_136, 26, False, None)[0] == "clustered"
    # forced: any n where a binned route exists
    assert route(4, 1000, 20, False, "binned") == ("binned", 1 << 14, 129)


@pytest.mark.parametrize("rows,wl,weighted", [(1, 12, False), (4, 15, False),
                                              (4, 26, False), (1, 28, False),
                                              (4, 20, True)])
def test_binned_route_refused(rows, wl, weighted):
    """A forced binned route is refused where it has none (widths the
    private counters serve, too many ranges, weighted counts), before
    anything reaches the card."""
    idx = torch.zeros((rows, 8), dtype=torch.int32)
    w = torch.ones(8, dtype=torch.int32) if weighted else None
    with pytest.raises(ValueError, match="no binned route"):
        hist_kernel._launch(idx, w, wl, None, None, route="binned")
    if not weighted:
        with pytest.raises(ValueError, match="no binned route"):
            hist_kernel.bin_ranges(idx, None, wl, 15)


def test_bin_ranges_on_cpu_launches_nothing(rng):
    before = (dict(hist_kernel.BIN_LAUNCHES), dict(hist_kernel.ROUTE_LAUNCHES))
    idx = torch.from_numpy(_skewed(rng, 2, 1000, 18))
    bins = hist_kernel.bin_ranges(idx, None, 18, 15)
    plain = hist_kernel.bin_ranges_plain(idx, None, 18, 15)
    assert all(torch.equal(a, b) for a, b in zip(bins[:4], plain[:4]))
    assert histogram_rows(idx, None, 18).shape == (2, 1 << 18)
    assert (dict(hist_kernel.BIN_LAUNCHES),
            dict(hist_kernel.ROUTE_LAUNCHES)) == before
    with pytest.raises(ValueError, match="range_log2"):
        hist_kernel.bin_ranges(idx, None, 18, 19)


@pytest.mark.parametrize("wl,range_log2,body", [
    (20, 15, "runs"),      # 32 ranges a row: PipelineConfig()'s 2**20
    (23, 15, "runs"),      # 256: the most the grouped histograms take
    (24, 15, "sectors"),   # 512 with an int16 stage: 8192 carried entries
    (25, 15, "runs"),      # 1024 with an int16 stage: too many carried
    (26, 16, "sectors"),   # the clustered route's 1024 a row, int32
    (28, 18, "sectors"),   # the count-min cell, 4 x 2**28
    (29, 20, "sectors"),
    (30, 20, "sectors"),   # the Bloom cell's 2**30
    (31, 20, "runs"),      # 2048 ranges of an int32 stage
    (28, 16, "runs"),      # 4096
    (21, 20, "runs")])     # 2
def test_scatter_body_rule(wl, range_log2, body):
    """The binning pass's scatter body by the ranges a row and the stage's
    entry size, as ``csrc/bin.cuh`` picks it: whole sectors past the
    grouped histograms' 256 ranges, where a sector of carried entries a
    range fits its shared memory."""
    assert hist_kernel.scatter_body(wl, range_log2) == body


def test_scatter_route_launches_stay_zero_on_cpu(rng):
    """CPU tensors take the plain versions: no scatter body counts a
    launch, whatever the rule would pick on the card."""
    before = dict(hist_kernel.SCATTER_ROUTE_LAUNCHES)
    for rows, wl, range_log2 in ((4, 20, 15), (2, 24, 15), (1, 30, 20)):
        idx = torch.from_numpy(_skewed(rng, rows, 5000, wl))
        hist_kernel.bin_ranges(idx, None, wl, range_log2)
    histogram_rows(torch.from_numpy(_skewed(rng, 4, 5000, 24)), None, 24)
    hist_kernel.bloom_words(torch.from_numpy(_skewed(rng, 1, 5000, 30))[0],
                            None, 30)
    assert dict(hist_kernel.SCATTER_ROUTE_LAUNCHES) == before
    assert set(before) == {"sectors", "runs"}
    assert hist_kernel.BIN_COUNT_LAUNCHES == {"histogram": 0, "bloom": 0}


# ------------------------------------ the "sectors" body's page pool ----


@pytest.mark.parametrize("rows,n,nranges,per,want", [
    # the count-min cell: 4 x 2**28 in 4,096 ranges, pages of 2**16 - 8
    (4, 31_195_136, 4096, 65_528, ((124_780_544 - 4096) // 65_528 + 4096,
                                   477)),
    # the Bloom cell: one stream at 2**30 in 1,024 ranges, pages of 2**17
    (1, 124_780_544, 1024, 1 << 17, (951 + 1024, 952)),
    # fewer updates than ranges: each a page of its own at most
    (2, 3, 1024, 16, (6, 1)),
    (1, 1 << 14, 512, 1 << 14, (0 + 512, 1)),
    (1, (1 << 14) + 1, 512, 1 << 14, (0 + 512, 2)),
    (1, (1 << 14) + 512, 512, 1 << 14, (1 + 512, 2)),
    # chunks shorter than a tile: pages of 4 chunks of 4,096 or 4,104
    (1, 4096, 512, 4096, (0 + 512, 1)),
    (1, (1 << 14) + 1, 512, 4096, (0 + 512, 2)),
    (1, 16_416 + 512, 512, 4104, (1 + 512, 2)),
    (3, 0, 8, 16, (0, 0)),
])
def test_page_pool(rows, n, nranges, per, want):
    """The pool's pages and a range's most: floor((n' - k) / page) + k for
    all rows * n updates over k = min(nranges, rows * n) non-empty ranges,
    and ceil(n / page) for one range (the updates of one row), page =
    ``page_entries(per)``."""
    assert hist_kernel.page_pool(rows, n, nranges, per) == want


@pytest.mark.parametrize("per,want", [
    (8, 1 << 14), (16, 1 << 14), (4096, 1 << 14), (4104, 16_416),
    (10_000, 20_000), (1 << 14, 1 << 14), (65_528, 65_528),
    (1 << 17, 1 << 17)])
def test_page_entries(per, want):
    """A page holds the fewest whole chunks that hold a tile of 2**14
    entries, so a claim touches at most two pages and a chunk one."""
    assert hist_kernel.page_entries(per) == want
    assert want % per == 0 and want >= hist_kernel.SECTOR_TILE_ENTRIES
    assert want - per < hist_kernel.SECTOR_TILE_ENTRIES


@pytest.mark.parametrize("per", [8, 16, 4096, 1 << 14, 65_528, 1 << 17])
def test_range_pages(per):
    page = hist_kernel.page_entries(per)
    counts = torch.tensor([0, 1, page - 1, page, page + 1, 5 * page,
                           5 * page + 3])
    want = [0, 1, 1, 1, 2, 5, 6]
    assert hist_kernel.range_pages(counts, per).tolist() == want


def _pool_skew(rng, rows, n, wl, rl, case):
    """idx [rows, n] for the pool's worst splits: every update in one range,
    every range but one empty beside sentinels and out-of-range buckets,
    one update in each range and the rest in one, uniform."""
    width = 1 << wl
    last = width - (1 << rl)
    if case == "one range":
        idx = rng.integers(last, width, size=(rows, n))
    elif case == "one range among sentinels":
        idx = rng.integers(last, width, size=(rows, n))
        junk = rng.random((rows, n)) < 0.4
        idx[junk] = rng.choice([-1, width, width + 7, -(1 << 31)],
                               size=int(junk.sum()))
    elif case == "one each, the rest in one":
        idx = rng.integers(last, width, size=(rows, n))
        k = min(n, width >> rl)
        idx[:, :k] = (np.arange(k) << rl) + 3
    else:
        idx = rng.integers(0, width, size=(rows, n))
    return idx.astype(np.int32)


def _paged_at_random(rng, bins, rows, n):
    """``bins`` (contiguous) laid out as the "sectors" body leaves a stage:
    a pool of ``page_pool`` pages, each range's pages anywhere in it (the
    kernel takes them in the order its claims reach them: here at random),
    the rest of the pool unwritten."""
    per, nranges = bins.per, bins.counts.numel()
    page = hist_kernel.page_entries(per)
    pool, most = hist_kernel.page_pool(rows, n, nranges, per)
    need = hist_kernel.range_pages(bins.counts, per)
    taken = torch.from_numpy(rng.permutation(pool)[:int(need.sum())] + 1)
    table = torch.zeros((nranges, most), dtype=torch.int32)
    table[torch.arange(most)[None, :] < need[:, None]] = taken.to(torch.int32)
    pooled = torch.empty(pool * page, dtype=bins.stage.dtype)
    paged = bins._replace(stage=pooled, pages=table)
    pooled[hist_kernel._stage_positions(paged)] = bins.stage
    return paged


@pytest.mark.parametrize("case", ["one range", "one range among sentinels",
                                  "one each, the rest in one", "uniform"])
@pytest.mark.parametrize("rows,wl,rl,n,per", [
    (4, 24, 15, 20_011, 16), (4, 24, 15, 70_001, 4096),
    (2, 26, 16, 9_999, 8), (4, 28, 18, 33_333, 1000),
    (1, 30, 20, 50_021, 4096), (1, 29, 20, 1_023, 16)])
def test_paged_pool_holds_the_worst_skews(rng, rows, wl, rl, n, per, case):
    """The pool at the worst splits: range g takes ceil(count / page)
    pages, their sum fits ``page_pool``'s and no range needs more than its
    most; a stage paged as the kernel pages it (:func:`_paged_at_random`)
    reads back in range order (``staged``) as the contiguous one, and the
    range passes' plain versions count over it what
    ``histogram_rows_plain`` counts and set what ``bloom_words_plain``
    sets."""
    t = torch.from_numpy(_pool_skew(rng, rows, n, wl, rl, case))
    flat = hist_kernel.bin_ranges_plain(t, None, wl, rl, per)
    assert flat.pages is None
    need = hist_kernel.range_pages(flat.counts, per)
    pool, most = hist_kernel.page_pool(rows, n, flat.counts.numel(), per)
    assert int(need.sum()) <= pool and int(need.max()) <= most
    bins = _paged_at_random(rng, flat, rows, n)
    assert torch.equal(hist_kernel.staged(bins), flat.stage)
    if rl == hist_kernel.WORDS_RANGE_LOG2:
        want = hist_kernel._words_plain(t, None, wl, None, None)
        assert torch.equal(hist_kernel.bloom_ranges_plain(bins, rows, wl),
                           want)
    else:
        want = histogram_rows_plain(t, None, wl)
        assert torch.equal(
            hist_kernel.histogram_ranges_plain(bins, rows, wl), want)


@pytest.mark.parametrize("rows,n,wl,weighted,counted", [
    (4, 31_195_136, 28, False, False),  # the count-min cell: clustered
    (4, 31_195_136, 26, False, False),  # clustered, 1,024 ranges a row
    (4, 1 << 22, 24, False, False),     # binned, 512 ranges a row
    (4, 31_195_136, 20, False, True),   # PipelineConfig()'s 2**20: runs
    (4, 31_195_136, 25, False, True),   # 1,024 ranges of an int16 stage
    (1, 124_780_544, 27, False, True),  # 4,096 ranges of 2**15 in one row
])
def test_count_pass_runs_only_before_runs(rows, n, wl, weighted, counted):
    """The routes whose binning pass counts first (``BIN_COUNT_LAUNCHES``)
    are those whose scatter body is "runs": the binned and clustered
    routes with more than 256 ranges a row whose sector carries fit page
    their stage and count nothing first."""
    kind, per, _ = hist_kernel._counts_route(rows, n, wl, weighted, None)
    rl = hist_kernel.counts_range_log2(rows, wl)
    assert kind in ("binned", "clustered")
    assert (hist_kernel.scatter_body(wl, rl) == "runs") == counted
    if not counted:
        sector = hist_kernel.SECTOR_BYTES // (2 if rl == 15 else 4)
        assert per % sector == 0


@pytest.mark.parametrize("wl,rl,per", [(28, 18, 65_524), (24, 15, 4104),
                                       (30, 20, 100)])
def test_paged_chunks_hold_whole_sectors(wl, rl, per):
    """The "sectors" body's pages hold whole 32-byte sectors: a ``per``
    that is no multiple of a sector's entries is refused before anything
    reaches the card."""
    idx = torch.zeros((1, 8), dtype=torch.int32)
    assert hist_kernel.scatter_body(wl, rl) == "sectors"
    with pytest.raises(ValueError, match="multiple"):
        hist_kernel._bin_launch(idx, None, wl, rl, per, None)


# ------------------------------------------------ the clustered route ----


#: Counters a block of the clustered range pass owns, and its words (two
#: 16-bit halves each).
SLICE = 1 << hist_kernel.CLUSTERED_SLICE_LOG2
WORDS = SLICE >> 1


def _blocks_counted(bins, rows, wl):
    """The clustered range pass block by block, as the kernel runs it
    (numpy, one block at a time): block j's range g (the last with
    blocks[g] <= j), its chunk and owner, the chunk's offsets of that owner
    counted in ``WORDS`` uint32 words of two 16-bit halves, each non-zero
    half added to its counter."""
    rl, per = bins.range_log2, bins.per
    blocks, starts = bins.blocks.numpy(), bins.starts.numpy()
    stage = bins.stage.numpy().astype(np.int64) & ((1 << rl) - 1)
    owners = (1 << rl) // SLICE
    out = np.zeros(rows << wl, dtype=np.int64)
    for j in range(int(blocks[-1])):
        g = int(np.searchsorted(blocks, j, side="right")) - 1
        chunk, owner = divmod(j - int(blocks[g]), owners)
        lo = int(starts[g]) + chunk * per
        hi = min(lo + per, int(starts[g + 1]))
        assert lo < hi  # every block of the grid has entries
        o = stage[lo:hi]
        c = o[o // SLICE == owner] % SLICE
        words = np.zeros(WORDS, dtype=np.uint32)
        np.add.at(words, c % WORDS, (np.uint32(1) << (16 * (c // WORDS)))
                  .astype(np.uint32))
        base = (g << rl) + owner * SLICE
        out[base:base + WORDS] += words & 0xffff
        out[base + WORDS:base + SLICE] += words >> 16
    return out.reshape(rows, 1 << wl)


@pytest.mark.parametrize("rows,wl,range_log2", [(1, 17, 16), (3, 18, 16),
                                                (2, 19, 17), (4, 20, 17),
                                                (1, 20, 18), (2, 21, 18)])
def test_clustered_pieces_compose_to_plain(rng, rows, wl, range_log2):
    """The binning pass at ranges of 2**16..2**18 (an int32 stage) and the
    range pass's plain version, composed, count what
    ``histogram_rows_plain`` counts, into zeros and into an ``out`` that
    accumulates; every split of a range into chunks (``per``) alike; and
    the range pass block by block (each chunk's 2, 4 or 8 owners of a
    2**15-counter slice, in 16-bit halves) counts the same."""
    idx = _skewed(rng, rows, 30_001, wl)
    idx[:, 5::11] = (1 << wl) - (1 << range_log2) + 7  # the last range
    t = torch.from_numpy(idx)
    want = histogram_rows_plain(t, None, wl)
    for per in (8, 1000, hist_kernel.CLUSTERED_RANGE_ENTRIES):
        bins = hist_kernel.bin_ranges(t, None, wl, range_log2, per)
        assert bins.stage.dtype == torch.int32
        assert bins.range_log2 == range_log2
        assert bins.counts.numel() == rows << (wl - range_log2)
        assert torch.equal(hist_kernel.histogram_ranges_plain(bins, rows, wl),
                           want)
        if per > 8:
            assert np.array_equal(_blocks_counted(bins, rows, wl),
                                  want.numpy())
    base = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(rows, 1 << wl),
                                         dtype=np.int64).astype(np.int32))
    got = hist_kernel.histogram_ranges_plain(bins, rows, wl, out=base.clone())
    assert torch.equal(got, histogram_rows_plain(t, None, wl, out=base.clone()))


def _slice_cases(rng, rows, wl, rl, case):
    """idx [rows, n] for one of the clustered range pass's edges: every
    slice's and every half's first and last counter in every range; both
    halves of one word from every slice; one hot offset 70,000 times a
    row (past a 16-bit half and past a chunk) among uniform updates."""
    width, nranges = 1 << wl, 1 << (wl - rl)
    base = np.arange(nranges)[:, None] << rl
    if case == "slice edges":
        edges = np.array([e + s for s in range(0, 1 << rl, WORDS)
                          for e in (0, WORDS - 1)])
        idx = np.repeat((base + edges).reshape(-1), 3)
    elif case == "both halves":
        c = base + rng.integers(0, WORDS, size=(nranges, 50))
        slices = np.arange(0, 1 << rl, SLICE)
        idx = np.concatenate([(c[:, :, None] + slices + h).reshape(-1)
                              for h in (0, WORDS)])
    else:
        hot = np.full(70_000, (width >> 1) + WORDS + 3)
        idx = np.concatenate([hot, rng.integers(0, width, size=5_000)])
    idx = np.tile(rng.permutation(idx), (rows, 1))
    return idx.astype(np.int32)


@pytest.mark.parametrize("case", ["slice edges", "both halves", "hot"])
@pytest.mark.parametrize("range_log2", [16, 17, 18])
def test_clustered_slices_and_halves(rng, range_log2, case):
    """The clustered range pass's edges, composed with the binning pass's
    plain version, against ``histogram_rows_plain``: offsets on the edges
    of every owner's slice and of each half of a word, both halves of one
    word, and one offset counted 70,000 times a row, which takes two chunks
    and a count past 65,535. A chunk past 2**16 - 1 entries would wrap the
    hot counter's half into its neighbour's: the cap is what keeps it
    exact."""
    rows, wl = 2, range_log2 + 2
    t = torch.from_numpy(_slice_cases(rng, rows, wl, range_log2, case))
    want = histogram_rows_plain(t, None, wl)
    per = hist_kernel.CLUSTERED_RANGE_ENTRIES
    bins = hist_kernel.bin_ranges(t, None, wl, range_log2, per)
    assert torch.equal(hist_kernel.histogram_ranges_plain(bins, rows, wl),
                       want)
    assert np.array_equal(_blocks_counted(bins, rows, wl), want.numpy())
    if case == "hot":
        assert int(want.max()) == 70_000 and int(bins.counts.max()) > per
        over = hist_kernel.bin_ranges(t, None, wl, range_log2, 1 << 17)
        assert not torch.equal(
            hist_kernel.histogram_ranges_plain(over, rows, wl), want)


@pytest.mark.parametrize("rows,n,wl,weighted,kind,range_log2", [
    # one main-path batch at the clustered widths: 4,096 ranges each
    (4, 31_195_136, 26, False, "clustered", 16),
    (4, 31_195_136, 27, False, "clustered", 17),
    (4, 31_195_136, 28, False, "clustered", 18),
    (1, 124_780_544, 28, False, "clustered", 16),
    (1, 124_780_544, 29, False, "clustered", 17),
    (1, 124_780_544, 30, False, "clustered", 18),
    (16, 1 << 22, 26, False, "clustered", 18),
    # ranges of 2**15 where they number at most 4,096
    (4, 31_195_136, 25, False, "binned", 15),
    (2, 31_195_136, 26, False, "binned", 15),
    # past 2**18-counter ranges, weighted, too few updates: direct
    (4, 31_195_136, 29, False, "direct", 0),
    (4, 31_195_136, 30, False, "direct", 0),
    (4, 31_195_136, 28, True, "direct", 18),
    (1, 124_780_544, 30, True, "direct", 18),
    (4, (1 << 22) - 1, 28, False, "direct", 18),
    (1, (1 << 24) - 1, 30, False, "direct", 18),
])
def test_clustered_route_rule(rows, n, wl, weighted, kind, range_log2):
    """The rule reads the route and its range from the shapes: the least
    range of 2**15..2**18 counters that makes at most 4,096 ranges, the
    clustered route above 2**15; direct atomics for weighted counts, past
    2**18-counter ranges and under ``BINNED_MIN_ENTRIES`` updates."""
    assert hist_kernel.counts_range_log2(rows, wl) == range_log2
    got = hist_kernel._counts_route(rows, n, wl, weighted, None)
    assert got[0] == kind
    if kind == "clustered":
        assert got[1:] == hist_kernel.binned_counts_grid(rows, n, wl)
        assert got[1] == hist_kernel.CLUSTERED_RANGE_ENTRIES


@pytest.mark.parametrize("rows,wl,weighted", [(1, 12, False), (4, 15, False),
                                              (4, 25, False), (2, 26, False),
                                              (4, 29, False), (4, 30, False),
                                              (4, 28, True), (1, 30, True)])
def test_clustered_route_refused(rows, wl, weighted):
    """A forced clustered route is refused where it has none (the private
    widths, widths the 2**15-counter ranges serve, past 2**18-counter
    ranges, weighted counts), before anything reaches the card; where it
    has one, any n takes it."""
    idx = torch.zeros((rows, 8), dtype=torch.int32)
    w = torch.ones(8, dtype=torch.int32) if weighted else None
    with pytest.raises(ValueError, match="no clustered route"):
        hist_kernel._launch(idx, w, wl, None, None, route="clustered")
    route = hist_kernel._counts_route
    assert route(4, 1000, 28, False, "clustered") == (
        "clustered", (1 << 16) - 8, 8 * (1 + 4096))
