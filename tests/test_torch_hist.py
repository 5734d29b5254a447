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
    before = hist_kernel.LAUNCHES
    histogram_rows(torch.zeros((2, 8), dtype=torch.int32), None, 10)
    assert hist_kernel.LAUNCHES == before


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
