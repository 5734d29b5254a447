"""The port's sort-partitioned histogram against the JAX package, exactly.

Inputs are made with numpy from a seed and given to both packages; every
comparison is of integers, with tolerance 0. The JAX Pallas kernels run in
interpret mode, as ``tests/test_part.py`` runs them; on the CPU the port's
functions run their plain versions (``*_plain``), which ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the CUDA kernels to on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nthash_tpu.ops import part_pallas as pp
from nthash_tpu_torch.ops import part_kernel as pk


def _counts_ok(got, idx, width):
    """got [R, width] equals np.bincount per row, compared sparsely (a dense
    int64 bincount at 2**30 would be 8 GiB)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    for r in range(idx.shape[0]):
        vals = idx[r][(idx[r] >= 0) & (idx[r] < width)].astype(np.int64)
        pos, cnt = np.unique(vals, return_counts=True)
        assert np.array_equal(got[r, pos], cnt.astype(np.int32))
        assert int(got[r].astype(np.int64).sum()) == len(vals)


@pytest.mark.parametrize("wl", range(19, 31))
def test_plan_matches_jax(wl):
    assert pk.plan(wl) == pp.plan(wl)


@pytest.mark.parametrize("wl", [18, 31])
def test_plan_raises_outside_range(wl):
    with pytest.raises(ValueError):
        pk.plan(wl)
    with pytest.raises(ValueError):
        pp.plan(wl)


@pytest.mark.parametrize("n,chunk", [
    (3 * 1024 - 5, 1024),    # G = 3 < 8: no rounding
    (9 * 1024 + 1, 1024),    # G = 10 -> 16
    (8 * 1024, 1024),        # G = 8 exactly
    (100, 8192),             # one mostly padded chunk
])
def test_pad_chunks_matches_jax(rng, n, chunk):
    width = 1 << 19
    idx = rng.integers(-width, 2 * width, size=(2, n)).astype(np.int32)
    idx[:, :4] = [-1, width, width + 1, 0]
    want = np.asarray(pp._pad_chunks(jnp.asarray(idx), width, chunk))
    got = pk._pad_chunks(torch.from_numpy(idx), width, chunk)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("sub_log2,p_log2,shape", [
    (13, 6, (2, 2, 8, 128)),     # the fused-table shapes at 2**19
    (15, 10, (2, 2, 64, 128)),   # the searchsorted shapes (P > 2**9)
])
def test_sort_chunks_matches_jax(rng, sub_log2, p_log2, shape):
    x = rng.integers(0, 1 << (sub_log2 + p_log2), size=shape, dtype=np.int32)
    srt, fb = pp.sort_chunks(jnp.asarray(x), sub_log2, p_log2, interpret=True)
    got_srt, got_fb = pk.sort_chunks(torch.from_numpy(x), sub_log2, p_log2)
    p = 1 << p_log2
    assert np.array_equal(got_srt.numpy(), np.asarray(srt))
    assert got_fb.shape == shape[:2] + (p,)
    assert np.array_equal(got_fb.numpy(), np.asarray(fb)[:, :, 0, :p])


def _sorted_both(idx, wl, rows=8):
    """(jax (srt, fb), port (srt, fb), p_log2, sub_log2) of padded chunks."""
    p_log2, sub_log2, *_ = pp.plan(wl)
    jchunks = pp._pad_chunks(jnp.asarray(idx), 1 << wl, rows * 128)
    j = pp.sort_chunks(jchunks, sub_log2, p_log2, interpret=True)
    t = pk.sort_chunks(
        pk._pad_chunks(torch.from_numpy(idx), 1 << wl, rows * 128),
        sub_log2, p_log2)
    return j, t, p_log2, sub_log2


def test_partition_windows_matches_jax(rng):
    wl = 19
    idx = rng.integers(0, 1 << wl, size=(2, 3 * 1024), dtype=np.int32)
    (jsrt, jfb), (srt, fb), p_log2, sub_log2 = _sorted_both(idx, wl)
    want = np.asarray(pp.partition_windows(jsrt, jfb, p_log2, sub_log2,
                                           interpret=True))
    got = pk.partition_windows(srt, fb, p_log2, sub_log2)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["uniform", "identical", "sentinel"])
def test_check_overflow_matches_jax(rng, kind):
    wl = 19
    if kind == "uniform":
        idx = rng.integers(0, 1 << wl, size=(2, 2048), dtype=np.int32)
    elif kind == "identical":
        idx = np.full((1, 4 * 1024), 7, np.int32)
    else:  # one real row of data per chunk, the rest pad sentinels
        idx = rng.integers(0, 1 << wl, size=(1, 130), dtype=np.int32)
    (jsrt, jfb), (srt, fb), p_log2, sub_log2 = _sorted_both(idx, wl)
    want = bool(pp.check_overflow(jfb, p_log2, jsrt, sub_log2))
    got = pk.check_overflow(fb, p_log2, srt, sub_log2)
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == want == (kind == "identical")


@pytest.mark.parametrize("wl", [19, 20, 22, 25, 30])
def test_partitioned_histogram_vs_bincount(rng, wl):
    width = 1 << wl
    rows = 1 if wl == 30 else 2  # one 4 GiB row at 2**30
    idx = rng.integers(-3, width + 3, size=(rows, 5000)).astype(np.int32)
    got = pk.partitioned_histogram_rows(torch.from_numpy(idx), wl,
                                        chunk_rows=8)
    assert got.dtype == torch.int32 and got.shape == (rows, width)
    _counts_ok(got, idx, width)


def test_partitioned_histogram_full_plan_2_20(rng):
    """The main path's plan: 65,536-update chunks, 128 partitions, 6-row
    windows, over more than 8 chunks (G rounds up to 16)."""
    wl = 20
    idx = rng.integers(0, (1 << wl) + 1, size=(2, 9 * 65536 + 11),
                       dtype=np.int32)
    got = pk.partitioned_histogram_rows(torch.from_numpy(idx), wl)
    _counts_ok(got, idx, 1 << wl)


@pytest.mark.parametrize("case", ["uniform", "identical"])
def test_partitioned_histogram_matches_jax(rng, case):
    wl = 20
    if case == "uniform":
        idx = rng.integers(0, (1 << wl) + 1, size=(2, 2048), dtype=np.int32)
    else:  # trips the overflow flag: the full-width fallback counts
        idx = np.full((1, 4096), 77, np.int32)
    # eager interpret mode: compiling the interpreted kernels under jit
    # takes longer than running them (tests/conftest.py does the same)
    with jax.disable_jit():
        want = np.asarray(pp.partitioned_histogram_rows(
            jnp.asarray(idx), wl, interpret=True, chunk_rows=8))
    got = pk.partitioned_histogram_rows(torch.from_numpy(idx), wl,
                                        chunk_rows=8)
    assert np.array_equal(got.numpy(), want)


def test_skew_fallback_drops_negatives(rng):
    wl = 19
    idx = np.full((1, 2048), 123, dtype=np.int32)
    idx[0, :300] = -rng.integers(1, 1 << wl, size=300, dtype=np.int32)
    got = pk.partitioned_histogram_rows(torch.from_numpy(idx), wl,
                                        chunk_rows=8)
    assert got[0, 123] == 2048 - 300 and int(got.sum()) == 2048 - 300


def test_accumulates_into_out(rng):
    wl = 19
    idx = rng.integers(0, 1 << wl, size=(2, 3000), dtype=np.int32)
    out = torch.ones((2, 1 << wl), dtype=torch.int32)
    res = pk.partitioned_histogram_rows(torch.from_numpy(idx), wl,
                                        chunk_rows=8, out=out)
    assert res is out
    _counts_ok(out - 1, idx, 1 << wl)
    single = pk.partitioned_histogram(torch.from_numpy(idx[0]), wl)
    assert torch.equal(single, out[0] - 1)


def test_sub_width_above_2_18_raises(monkeypatch):
    """The plans never give a sub-width above 2**18, so the JAX package's
    recursion is not ported; a plan that would need it raises."""
    monkeypatch.setitem(pk._PLANS, 28, (9, 1))
    with pytest.raises(ValueError, match="recurse"):
        pk.partitioned_histogram_rows(torch.zeros((1, 8), dtype=torch.int32),
                                      28)


def test_cpu_route_launches_no_kernel(rng):
    before = dict(pk.LAUNCHES)
    pk.partitioned_histogram_rows(
        torch.from_numpy(rng.integers(0, 1 << 19, size=(1, 500),
                                      dtype=np.int32)), 19, chunk_rows=8)
    assert pk.LAUNCHES == before


@pytest.mark.parametrize("bad", [
    dict(idx=torch.zeros((1, 8), dtype=torch.int64)),
    dict(out=torch.zeros((1, 1 << 19), dtype=torch.int64)),
    dict(out=torch.zeros((2, 1 << 19), dtype=torch.int32)),
    dict(idx=torch.zeros((1, 8), dtype=torch.int32, device="meta")),
])
def test_rejects(bad):
    with pytest.raises((TypeError, ValueError)):
        pk.partitioned_histogram_rows(
            bad.get("idx", torch.zeros((1, 8), dtype=torch.int32)), 19,
            out=bad.get("out"))


@pytest.mark.parametrize("rows,tile", [(8, 1024), (64, 1024), (64, 8192)])
def test_tile_sort_and_merge_rounds_compose_to_a_sort(rng, rows, tile):
    """The plain versions of the card's two sort kernels: tile sorts in
    alternating directions, then one merge round per doubling, give the
    sorted chunk."""
    x = torch.from_numpy(rng.integers(0, 1 << 20, size=(2, 3, rows, 128),
                                      dtype=np.int32))
    y = pk.sort_tiles_plain(x, tile)
    k = 2 * tile
    while k <= rows * 128:
        y = pk.merge_phase_plain(y, k)
        k *= 2
    want = x.reshape(2, 3, -1).sort(dim=-1).values.reshape(x.shape)
    assert torch.equal(y, want)


@pytest.mark.parametrize("kind", ["random21", "random31", "equal",
                                  "sentinel", "sorted", "reversed"])
@pytest.mark.parametrize("rows,tile", [(64, 8192), (128, 16384),
                                       (256, 32768), (512, 32768),
                                       (4, 128)])
def test_sort_tiles_plain_contract(rng, rows, tile, kind):
    """What the card's tile sort must return, at its tile sizes: every tile
    holds its own keys in ascending order, odd tiles of a multi-tile chunk
    in descending order; and the merge rounds finish the sort."""
    shape = (1, 2, rows, 128)
    n = int(np.prod(shape))
    x = {"random21": lambda: rng.integers(0, (1 << 20) + 1, size=n),
         "random31": lambda: rng.integers(0, (1 << 31) - 1, size=n),
         "equal": lambda: np.full(n, 77),
         "sentinel": lambda: np.full(n, 1 << 20),
         "sorted": lambda: np.sort(rng.integers(0, 1 << 20, size=n)),
         "reversed": lambda: np.sort(rng.integers(0, 1 << 20, size=n))[::-1],
         }[kind]().astype(np.int32).reshape(shape)
    y = pk.sort_tiles_plain(torch.from_numpy(x.copy()), tile)
    per_chunk = rows * 128 // tile
    got = y.numpy().reshape(-1, per_chunk, tile)
    want = np.sort(x.reshape(-1, per_chunk, tile), axis=-1)
    for j in range(per_chunk):
        desc = per_chunk > 1 and j % 2 == 1
        assert np.array_equal(got[:, j], want[:, j, ::-1] if desc
                              else want[:, j])
    k = 2 * tile
    while k <= rows * 128:
        y = pk.merge_phase_plain(y, k)
        k *= 2
    assert np.array_equal(y.numpy().reshape(2, -1),
                          np.sort(x.reshape(2, -1), axis=-1))


def test_partition_bounds_plain_matches_jax_table_and_flag(rng):
    wl = 19
    idx = np.full((1, 4 * 1024), 7, np.int32)
    (jsrt, jfb), (srt, _), p_log2, sub_log2 = _sorted_both(idx, wl)
    fb, flags = pk.partition_bounds_plain(srt, sub_log2, p_log2, pk.CAP_ROWS)
    assert np.array_equal(fb.numpy(), np.asarray(jfb)[:, :, 0, :1 << p_log2])
    assert flags.tolist() == [1, 0]


def _words_want(idx, width):
    """The JAX package's words for a stream: its pack_presence of the
    presence, as its scatter route and skew fallback build them."""
    from nthash_tpu.models import bloom as jbloom

    present = np.zeros(width, np.int8)
    flat = idx.reshape(-1)
    present[flat[(flat >= 0) & (flat < width)]] = 1
    return np.asarray(jbloom.pack_presence(jnp.asarray(present)))


def _bloom_stream(rng, kind, wl, n=5000):
    width = 1 << wl
    if kind == "uniform":
        return rng.integers(-3, width + 3, size=n).astype(np.int32)
    if kind == "identical":  # overflows every plan's window
        return np.full(4 * 4096, 77, np.int32)
    idx = np.full(n, width, np.int32)  # mostly sentinel: must not overflow
    idx[:130] = rng.integers(0, width, size=130)
    return idx


@pytest.mark.parametrize("kind", ["uniform", "identical", "sentinel"])
@pytest.mark.parametrize("chunk_rows", [8, None])
@pytest.mark.parametrize("wl", [19, 20])
def test_partitioned_bloom_words_vs_jax_scatter(rng, wl, chunk_rows, kind):
    idx = _bloom_stream(rng, kind, wl)
    got = pk.partitioned_bloom_words(torch.from_numpy(idx), wl,
                                     chunk_rows=chunk_rows)
    assert got.dtype == torch.int32 and got.shape == ((1 << wl) // 32,)
    assert np.array_equal(got.numpy().view(np.uint32),
                          _words_want(idx, 1 << wl))
    p_log2, sub_log2, rows, cap = pk._plan_for(wl, chunk_rows, None)
    _, flags = pk._partition(torch.from_numpy(idx).reshape(1, -1), wl,
                             p_log2, sub_log2, rows, cap)
    assert flags.tolist() == ([1, 0] if kind == "identical" else [0, 1])


@pytest.mark.parametrize("wl", [19, 20])
def test_partitioned_bloom_rows_step_matches_pallas(rng, wl):
    """The per-partition step: JAX's rows kernel (interpret mode) on the
    port's windows, which test_partition_windows_matches_jax pins equal to
    JAX's, gives the port's words."""
    from nthash_tpu.ops.hist_pallas import mxu_bloom_words_rows

    idx = rng.integers(0, (1 << wl) + 1, size=3000).astype(np.int32)
    p_log2, sub_log2, rows, cap = pk._plan_for(wl, 8, None)
    wins, flags = pk._partition(torch.from_numpy(idx).reshape(1, -1), wl,
                                p_log2, sub_log2, rows, cap)
    assert flags.tolist() == [0, 1]
    want = np.asarray(mxu_bloom_words_rows(
        jnp.asarray(wins.reshape(1 << p_log2, -1).numpy()), sub_log2,
        interpret=True)).reshape(-1)
    got = pk.partitioned_bloom_words(torch.from_numpy(idx), wl, chunk_rows=8)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_partitioned_bloom_words_2_30_sparse(rng):
    """The widest partitioned filter (8,192 partitions), checked at the set
    words and by the total popcount, as bench.py gates it."""
    from nthash_tpu.ops.hist_pallas import bit_index, word_index

    wl = 30
    idx = rng.integers(-3, (1 << wl) + 3, size=5000).astype(np.int32)
    got = pk.partitioned_bloom_words(torch.from_numpy(idx), wl, chunk_rows=8)
    b = idx[(idx >= 0) & (idx < (1 << wl))].astype(np.int64)
    want = {}
    for w, bit in zip(word_index(b), bit_index(b)):
        want[int(w)] = want.get(int(w), 0) | (1 << int(bit))
    words = got.numpy().view(np.uint32)
    pos = np.fromiter(want, np.int64)
    assert np.array_equal(words[pos], np.fromiter(want.values(), np.uint32))
    assert int(np.unpackbits(words.view(np.uint8)).sum()) == len(set(b.tolist()))


def test_partitioned_bloom_words_ors_into_out(rng):
    wl = 19
    idx = rng.integers(0, 1 << wl, size=3000).astype(np.int32)
    base = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31,
                                         size=(1 << wl) // 32).astype(np.int32))
    out = base.clone()
    res = pk.partitioned_bloom_words(torch.from_numpy(idx), wl, chunk_rows=8,
                                     out=out)
    assert res is out
    fresh = pk.partitioned_bloom_words(torch.from_numpy(idx), wl)
    assert torch.equal(out, base | fresh)


def test_partitioned_bloom_cpu_route_launches_no_kernel(rng):
    from nthash_tpu_torch.ops import hist_kernel

    before = (dict(pk.LAUNCHES), dict(hist_kernel.BLOOM_LAUNCHES))
    pk.partitioned_bloom_words(torch.from_numpy(
        rng.integers(0, 1 << 19, size=500, dtype=np.int32)), 19, chunk_rows=8)
    assert (pk.LAUNCHES, hist_kernel.BLOOM_LAUNCHES) == before


@pytest.mark.parametrize("bad", [
    dict(wl=18), dict(wl=31),
    dict(idx=torch.zeros(8, dtype=torch.int64)),
    dict(out=torch.zeros((1 << 19) // 32 + 1, dtype=torch.int32)),
    dict(out=torch.zeros((1, (1 << 19) // 32), dtype=torch.int32)),
    dict(idx=torch.zeros(8, dtype=torch.int32, device="meta")),
])
def test_partitioned_bloom_rejects(bad):
    with pytest.raises((TypeError, ValueError)):
        pk.partitioned_bloom_words(
            bad.get("idx", torch.zeros(8, dtype=torch.int32)),
            bad.get("wl", 19), out=bad.get("out"))
