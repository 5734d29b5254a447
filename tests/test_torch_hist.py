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
    """``route=`` takes "private" or "direct" (or None: the rule's); a
    forced private route needs the counters to fit shared memory. Checked
    before anything reaches the card."""
    idx = torch.zeros((1, 8), dtype=torch.int32)
    for bad in ("shared", "Private", ""):
        with pytest.raises(ValueError, match="route"):
            hist_kernel._launch(idx, None, 12, None, None, route=bad)
    for wl in (16, 20, 30):
        with pytest.raises(ValueError, match="shared memory"):
            hist_kernel._launch(idx, None, wl, None, None, route="private")
    # a forced private route lowers the rule to one entry per counter, and
    # to one block a row below that
    assert hist_kernel._counts_grid(4, 1000, 12, None) == (0, 0)
    assert hist_kernel._counts_grid(4, 1000, 12, "private") == (1, 512)
    assert hist_kernel._counts_grid(4, 40_000, 12, "private") == (9, 512)
    assert hist_kernel._counts_grid(4, 40_000, 12, "direct") == (0, 0)
    assert hist_kernel._counts_grid(4, 1 << 20, 12, None) == (66, 512)


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
