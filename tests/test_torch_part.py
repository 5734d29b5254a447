"""The port's sort-partitioned histogram against the JAX package, exactly.

Inputs are made with numpy from a seed and given to both packages; every
comparison is of integers, with tolerance 0. The JAX Pallas kernels run in
interpret mode, as ``tests/test_part.py`` runs them; on the CPU the port's
functions run their plain versions (``*_plain``), which
``tests/test_torch_cuda.py`` holds the CUDA kernels to on the card.
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


# The card's redesigned merge and partition-table kernels, emulated in numpy
# as they index and exchange, against the plain versions (and, through
# them, the JAX package).

def _pairs(y, j, asc):
    """Stride j of a bitonic round on the flat array y in place; asc[i] is
    the direction of the block of 2j holding element i."""
    v = y.reshape(-1, 2, j)
    a = asc.reshape(-1, 2, j)[:, 0]
    lo, hi = np.minimum(v[:, 0], v[:, 1]), np.maximum(v[:, 0], v[:, 1])
    v[:, 0], v[:, 1] = np.where(a, lo, hi), np.where(a, hi, lo)


def _grouped_pass(y, chunk, k, j, g):
    """merge_strides_kernel over y: strides j 2**(g-1) .. j, a thread per w
    adjacent ints (4 up to g = 4, 2 at 5, 1 at 6) at each of the 2**g
    points of its hypercube. Also asserts that the threads touch every
    element exactly once."""
    w = 4 if g <= 4 else 2 if g == 5 else 1
    lj = j.bit_length() - 1
    q = np.arange((y.size >> g) // w, dtype=np.int64) * w
    base = ((q >> lj) << (lj + g)) | (q & (j - 1))
    asc = (base & (chunk - 1) & k) == 0
    idx = (base[:, None, None] + (np.arange(1 << g) * j)[None, :, None]
           + np.arange(w)[None, None, :])
    assert np.array_equal(np.sort(idx.reshape(-1)), np.arange(y.size))
    v = y[idx]
    for b in range(g - 1, -1, -1):
        for e in range(1 << g):
            if not e & (1 << b):
                lo = np.minimum(v[:, e], v[:, e | 1 << b])
                hi = np.maximum(v[:, e], v[:, e | 1 << b])
                v[:, e] = np.where(asc[:, None], lo, hi)
                v[:, e | 1 << b] = np.where(asc[:, None], hi, lo)
    y[idx] = v


def _span_pass(y, chunk, k, span, cluster):
    """The span kernel's part of round k: elements of descending blocks
    complemented; strides span * cluster / 2 .. span between the blocks of
    a cluster (of two partners, the lower does the pairs in the first half
    of the span and the upper the rest, each writing the smaller word to
    the lower block); the strides below min(k, span) ascending;
    complemented back."""
    desc = (np.arange(y.size) & (chunk - 1) & k) != 0
    z = np.where(desc, ~y, y)
    blocks = z.reshape(-1, cluster, span) if cluster > 1 else z[None, None]
    m = cluster // 2
    while m:
        new = blocks.copy()
        writes = np.zeros(blocks.shape, np.int8)
        for rank in range(cluster):   # the lower block takes the first half
            upper = bool(rank & m)
            half = slice(span // 2, span) if upper else slice(0, span // 2)
            a, b = blocks[:, rank, half], blocks[:, rank ^ m, half]
            lo, hi = np.minimum(a, b), np.maximum(a, b)
            new[:, rank, half] = hi if upper else lo
            new[:, rank ^ m, half] = lo if upper else hi
            writes[:, rank, half] += 1
            writes[:, rank ^ m, half] += 1
        assert (writes == 1).all()
        blocks = new
        m //= 2
    z = blocks.reshape(-1)
    up = np.ones(z.size, bool)
    j = min(k, span) // 2
    while j:
        _pairs(z, j, up)
        j //= 2
    y[:] = np.where(desc, ~z, z)


def _merge_emulated(x, k, plan=None):
    """Round k by the card's launches: merge_plan's grouped passes, then the
    span pass (or the launches of ``plan`` = (passes, span, cluster))."""
    chunk = x.shape[2] * 128
    passes, span, cluster = plan or pk.merge_plan(chunk, k)
    y = x.numpy().reshape(-1).copy()
    for j, g in passes:
        _grouped_pass(y, chunk, k, j >> (g - 1), g)
    _span_pass(y, chunk, k, span, cluster)
    return torch.from_numpy(y.reshape(x.shape))


def _strides(chunk, k):
    """Every stride of round k, in the order merge_plan's launches run them."""
    passes, span, cluster = pk.merge_plan(chunk, k)
    out = [j >> i for j, g in passes for i in range(g)]
    m = span * cluster // 2
    while m >= span and cluster > 1:
        out.append(m)
        m //= 2
    j = min(k, span) // 2
    while j:
        out.append(j)
        j //= 2
    return out


@pytest.mark.parametrize("chunk_log2", range(1, 31))
def test_merge_plan(chunk_log2):
    """The plan covers every stride of every round exactly once, highest
    first, within what the C entries accept; a cluster of two only where
    it saves a grouped pass."""
    chunk = 1 << chunk_log2
    for kl in range(1, chunk_log2 + 1):
        k = 1 << kl
        passes, span, cluster = pk.merge_plan(chunk, k)
        assert _strides(chunk, k) == [k >> i for i in range(1, kl + 1)]
        assert pk.MERGE_MIN_SPAN <= span <= pk.MERGE_MAX_SPAN
        assert cluster in (1, 2) and cluster * span <= max(k, span)
        assert cluster == 1 or span == pk.MERGE_MAX_SPAN
        strides = sum(g for _, g in passes)
        assert len(passes) == -(-strides // pk.MERGE_MAX_GROUP)
        for j, g in passes:
            assert 1 <= g <= pk.MERGE_MAX_GROUP and (j >> (g - 1)) >= 4
            assert 2 * j <= k
        wide = max(0, kl - 15)   # strides of 2**15 and more
        assert strides + (cluster > 1) == wide
        assert len(passes) == min(-(-wide // pk.MERGE_MAX_GROUP),
                                  -(-(wide - 1) // pk.MERGE_MAX_GROUP))


@pytest.mark.parametrize("wl,passes", [(20, [1]), (30, [1, 2, 2, 2, 2, 2])])
def test_merge_plan_passes_at_the_plans(wl, passes):
    """Passes a round over the array: the 2**20 plan's one round (two
    tiles a chunk) in one, the 2**30 plan's six (64 tiles) in eleven."""
    _, _, rows, _ = pk.plan(wl)
    chunk, tile = rows * 128, pk.MERGE_MAX_SPAN
    got = []
    k = 2 * tile
    while k <= chunk:
        got.append(len(pk.merge_plan(chunk, k)[0]) + 1)
        k *= 2
    assert got == passes


@pytest.mark.parametrize("chunk,k", [(0, 2), (8, 16), (12, 4), (8, 3),
                                     (1 << 31, 4)])
def test_merge_plan_rejects(chunk, k):
    with pytest.raises(ValueError):
        pk.merge_plan(chunk, k)


def _rounds_before(x, tile, k):
    """The state merge round k is given: tiles sorted in alternating
    directions, then rounds 2 tile .. k / 2 (plain)."""
    y = pk.sort_tiles_plain(x, tile)
    m = 2 * tile
    while m < k:
        y = pk.merge_phase_plain(y, m)
        m *= 2
    return y


_KINDS = ["random21", "random31", "equal", "sentinel", "sorted", "reversed"]


@pytest.mark.parametrize("rows,g,kind", [
    *((rows, g, kind) for rows, g in ((512, 2), (1024, 1), (2048, 1))
      for kind in _KINDS),
    (16384, 1, "random21"), (16384, 1, "equal"), (32768, 1, "random31")])
def test_merge_emulation_vs_plain(rng, rows, g, kind):
    """Every round of chunks of 2 to 128 tiles of 2**15 by the card's
    launches (a cluster of two, grouped passes of 2 to 6 strides), on the
    tile sort's hard inputs, equals merge_phase_plain."""
    shape = (1, g, rows, 128)
    n = int(np.prod(shape))
    x = {"random21": lambda: rng.integers(0, (1 << 20) + 1, size=n),
         "random31": lambda: rng.integers(0, (1 << 31) - 1, size=n),
         "equal": lambda: np.full(n, 77),
         "sentinel": lambda: np.full(n, 1 << 20),
         "sorted": lambda: np.sort(rng.integers(0, 1 << 20, size=n)),
         "reversed": lambda: np.sort(rng.integers(0, 1 << 20, size=n))[::-1],
         }[kind]().astype(np.int32).reshape(shape)
    x = torch.from_numpy(x)
    tile = pk.MERGE_MAX_SPAN
    y = pk.sort_tiles_plain(x, tile)
    k = 2 * tile
    while k <= rows * 128:
        want = pk.merge_phase_plain(y, k)
        assert torch.equal(_merge_emulated(y, k), want), k
        y = want
        k *= 2
    assert torch.equal(y, pk._sort_plain(x))


@pytest.mark.parametrize("tile,rows", [(128, 64), (1024, 64), (2048, 64),
                                       (4096, 256)])
def test_merge_emulation_small_tiles(rng, tile, rows):
    """Tiles below 2**15: every round in one span pass (spans of 2,048 ints
    and more hold several tiles, or several chunks), equal to plain."""
    x = torch.from_numpy(rng.integers(0, 1 << 20, size=(2, 3, rows, 128),
                                      dtype=np.int32))
    y = pk.sort_tiles_plain(x, tile)
    k = 2 * tile
    while k <= rows * 128:
        assert pk.merge_plan(rows * 128, k)[0] == ()
        want = pk.merge_phase_plain(y, k)
        assert torch.equal(_merge_emulated(y, k), want)
        y = want
        k *= 2
    assert torch.equal(y, pk._sort_plain(x))


@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 6])
def test_grouped_pass_any_split(rng, g):
    """A round split into grouped passes of g strides and a span pass with
    no cluster (the plan a cluster could be traded for) equals plain."""
    x = torch.from_numpy(rng.integers(0, 1 << 20, size=(1, 2, 1024, 128),
                                      dtype=np.int32))
    k = 1024 * 128
    y = _rounds_before(x, 512, k)
    strides = []
    j = k // 2
    while j >= 512:
        strides.append(j)
        j //= 2
    passes = tuple((strides[i], min(g, len(strides) - i))
                   for i in range(0, len(strides), g))
    got = _merge_emulated(y, k, (passes, 512, 1))
    assert torch.equal(got, pk.merge_phase_plain(y, k))


def test_merge_emulation_through_jax(rng):
    """Tile sorts of 2,048 and the card's merge rounds give the JAX
    package's sorted chunks (interpret mode)."""
    x = rng.integers(0, 1 << 25, size=(2, 2, 64, 128), dtype=np.int32)
    srt, _ = pp.sort_chunks(jnp.asarray(x), 15, 10, interpret=True)
    y = pk.sort_tiles_plain(torch.from_numpy(x), 2048)
    for k in (4096, 8192):
        y = _merge_emulated(y, k)
    assert np.array_equal(y.numpy(), np.asarray(srt))


BOUNDS_ROWS = 256   # rows a block of partition_bounds_kernel


def _bounds_emulated(srt, sub_log2, p_log2, cap):
    """partition_bounds_kernel over srt [R, G, rows, 128]: blocks of 256
    rows, each writing the entries its rows own (a search over its maxima)
    and checking runs of cap equal maxima in [0, P). Asserts that every
    entry is written exactly once."""
    r, g, rows, _ = srt.shape
    parts = 1 << p_log2
    qall = (srt[..., 127] >> sub_log2).reshape(-1).astype(np.int64)
    total = qall.size
    fb = np.zeros(r * g * parts, np.int64)
    writes = np.zeros(r * g * parts, np.int64)
    over = False
    for g0 in range(0, total, BOUNDS_ROWS):
        n = min(BOUNDS_ROWS, total - g0)
        q = qall[g0:g0 + n]
        rr = (g0 + np.arange(n)) % rows
        h = g0 + np.arange(n) + cap - 1
        ok = (q >= 0) & (q < parts) & (rr + cap - 1 < rows)
        if cap < 1:
            over = True
        elif ok.any():
            over |= bool((qall[h[ok]] == q[ok]).any())
        for c in range(g0 // rows, (g0 + n - 1) // rows + 1):
            c0, c1 = c * rows, (c + 1) * rows
            a, b = max(c0, g0) - g0, min(c1, g0 + n) - g0
            lo = 0 if c0 >= g0 else int(np.clip(qall[g0 - 1] + 1, 0, parts))
            hi = parts if c1 <= g0 + n else int(np.clip(q[b - 1] + 1, 0,
                                                        parts))
            p = np.arange(lo, hi)
            own = a + np.searchsorted(q[a:b], p, side="left")
            fb[c * parts + p] = g0 + own - c0
            writes[c * parts + p] += 1
    assert (writes == 1).all()
    return fb.reshape(r, g, parts), [int(over), int(not over)]


def _chunks_of(rng, kind, rows, p_log2, sub_log2, run=0, r=2, g=2,
               at=None):
    """Sorted chunks [r, g, rows, 128] whose row maxima follow ``kind``:
    each row's values share its maximum's partition (q), so sorting keeps
    every row's q."""
    parts = 1 << p_log2
    width = parts << sub_log2
    qs = np.empty((r * g, rows), np.int64)
    for i in range(r * g):
        if kind == "random":
            qs[i] = np.sort(rng.integers(0, parts + 1, size=rows))
        elif kind == "sentinel":
            qs[i] = parts
        elif kind == "equal":
            qs[i] = min(77 >> sub_log2, parts - 1)
        elif kind == "mostly_sentinel":
            qs[i] = parts
            qs[i, :1] = rng.integers(0, parts)
        elif kind == "empty":  # every third partition holds a row
            qs[i] = np.minimum(3 * np.arange(rows), parts)
        else:  # "run": one run of `run` equal maxima, the rest distinct
            s = min(rows, parts) // 8 if at is None else at
            base = np.arange(rows) * 2
            base[s:s + run] = base[s]
            base[s + run:] += 1
            qs[i] = np.minimum(base, parts)
    vals = (qs[..., None] << sub_log2) + rng.integers(
        0, 1 << sub_log2, size=(r * g, rows, 128))
    vals = np.where(qs[..., None] >= parts, width, vals)
    vals = np.sort(vals.reshape(r * g, -1), axis=-1)
    return torch.from_numpy(vals.astype(np.int32).reshape(r, g, rows, 128))


_BOUNDS_KINDS = ["random", "sentinel", "equal", "mostly_sentinel", "empty"]


@pytest.mark.parametrize("kind", _BOUNDS_KINDS)
@pytest.mark.parametrize("p_log2", [0, 6, 13])
@pytest.mark.parametrize("rows", [1, 2, 64, 512, 16384])
def test_bounds_emulation_vs_plain(rng, rows, p_log2, kind):
    """The row-owned table and the run-length check equal
    partition_bounds_plain, P > rows included."""
    sub_log2 = 4
    g = 1 if rows == 16384 else 2
    x = _chunks_of(rng, kind, rows, p_log2, sub_log2, g=g)
    for cap in (0, 1, 3, 6):
        fb, flags = pk.partition_bounds_plain(x, sub_log2, p_log2, cap)
        got_fb, got_flags = _bounds_emulated(x.numpy(), sub_log2, p_log2, cap)
        assert np.array_equal(got_fb, fb.numpy())
        assert got_flags == flags.tolist()


@pytest.mark.parametrize("cap", [3, 6])
@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("rows", [64, 512])
def test_bounds_emulation_runs_at_cap(rng, rows, cap, delta):
    """A run of cap - 1 equal maxima fits its window; cap and cap + 1 do
    not: the flag fires exactly as partition_bounds_plain's, with the run
    inside a block of 256 rows or across two."""
    for at in [None] + ([BOUNDS_ROWS - cap // 2] if rows > BOUNDS_ROWS
                        else []):
        x = _chunks_of(rng, "run", rows, 13, 4, run=cap + delta, at=at)
        fb, flags = pk.partition_bounds_plain(x, 4, 13, cap)
        assert flags.tolist() == ([0, 1] if delta < 0 else [1, 0])
        got_fb, got_flags = _bounds_emulated(x.numpy(), 4, 13, cap)
        assert np.array_equal(got_fb, fb.numpy())
        assert got_flags == flags.tolist()


@pytest.mark.parametrize("rows,p_log2,kind", [
    *((rows, p_log2, kind) for rows, p_log2 in ((1, 0), (2, 6), (64, 6),
                                                (64, 13))
      for kind in _BOUNDS_KINDS), (64, 6, "run"), (64, 13, "run")])
def test_bounds_plain_vs_jax_at_edges(rng, rows, p_log2, kind):
    """partition_bounds_plain, which the emulation and the card's kernel
    equal, against the JAX package's sort_chunks table and check_overflow
    (interpret mode) on the same chunks; runs of 3 equal maxima at caps 1
    and 3."""
    x = _chunks_of(rng, kind, rows, p_log2, 4, run=3)
    jsrt, jfb = pp.sort_chunks(jnp.asarray(x.numpy()), 4, p_log2,
                               interpret=True)
    assert np.array_equal(np.asarray(jsrt), x.numpy())
    for cap in (1, 3):
        fb, flags = pk.partition_bounds_plain(x, 4, p_log2, cap)
        assert np.array_equal(fb.numpy(),
                              np.asarray(jfb)[:, :, 0, :1 << p_log2])
        want = bool(pp.check_overflow(jfb, p_log2, jsrt, 4, cap))
        assert flags.tolist() == [int(want), int(not want)]
