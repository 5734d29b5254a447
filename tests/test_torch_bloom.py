"""The port's packed Bloom filter and presence words against the JAX package.

Inputs are made with numpy from a seed and go through both packages; every
comparison is of integers (the words' bit patterns), with tolerance 0. The
JAX Pallas kernels run in interpret mode, as ``tests/test_hist.py`` runs
them, at widths 2**12..2**13; the port's functions run their plain versions
on the CPU, which ``tests/test_torch_cuda.py`` holds the CUDA kernels to on
the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nthash_tpu.models import bloom as jbloom
from nthash_tpu.ops import hist_pallas as hp
from nthash_tpu.ops import kmer_jnp
from nthash_tpu.ops import kmer_pallas
from nthash_tpu_torch.models import bloom
from nthash_tpu_torch.ops import hist_kernel as hk
from nthash_tpu_torch.ops.kmer_kernel import hash_kmers_tm, prepare_codes
from nthash_tpu_torch.ops.kmer_torch import hash_kmers

K, H = 9, 3
CPU = torch.device("cpu")


def _words(t: torch.Tensor) -> np.ndarray:
    """int32 words -> the uint32 bit patterns the JAX package holds."""
    return t.numpy().view(np.uint32)


def _stream(rng, n, width):
    """int32 indices with -1, width and width + 10 among them."""
    idx = rng.integers(0, width, size=n).astype(np.int32)
    idx[rng.random(n) < 0.05] = -1
    idx[rng.random(n) < 0.05] = width
    idx[rng.random(n) < 0.05] = width + 10
    return idx


def _both_hashes(codes):
    """(port hashes int64 [B, W, H], valid; JAX U64 hashes, valid)."""
    t = hash_kmers(torch.from_numpy(codes), K, H)
    j = kmer_jnp.hash_kmers(jnp.asarray(codes), K, H)
    return t.hashes, t.valid, j.hashes, j.valid


def _jax_scatter(codes, wl):
    _, _, jh, jv = _both_hashes(codes)
    return np.asarray(jbloom.insert(jbloom.BloomFilter.zeros(wl), jh, jv, wl,
                                    ingestion="scatter").words)


# ------------------------------------------------------------- layout ----


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_word_and_bit_index_match_jax(rng, dtype):
    b = np.concatenate([
        [0, 1, 127, 128, 4095, 4096, 4097, (1 << 30) - 1, 1 << 30,
         (1 << 31) - 1],
        rng.integers(0, 1 << 31, size=5000)]).astype(np.int64)
    t = torch.from_numpy(b).to(dtype)
    assert np.array_equal(hk.word_index(t).numpy(), hp.word_index(b))
    assert np.array_equal(hk.bit_index(t).numpy(), hp.bit_index(b))
    assert hk.word_index(int(b[-1])) == int(hp.word_index(b[-1]))
    assert hk.word_index(t).max() < (1 << 26)  # 2**31 bits = 2**26 words


@pytest.mark.parametrize("wl", [12, 13, 15])
def test_pack_presence_matches_jax(rng, wl):
    presence = rng.random(1 << wl) < 0.3
    got = bloom.pack_presence(torch.from_numpy(presence))
    want = np.asarray(jbloom.pack_presence(jnp.asarray(presence)))
    assert got.dtype == torch.int32 and np.array_equal(_words(got), want)
    # and the presence words of the set buckets are the same words
    idx = np.flatnonzero(presence).astype(np.int32)
    assert torch.equal(hk.bloom_words_plain(torch.from_numpy(idx), None, wl),
                       got)


# ------------------------------------------------------ kernels' plain ----


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("wl", [12, 13])
def test_bloom_words_vs_pallas_interpret(rng, wl, weighted):
    width = 1 << wl
    idx = _stream(rng, 2 * hp.CHUNK, width)
    w = rng.integers(-3, 3, size=idx.size).astype(np.int32) if weighted \
        else None
    want = np.asarray(hp.mxu_bloom_words(
        jnp.asarray(idx), None if w is None else jnp.asarray(w), wl,
        interpret=True))
    tw = None if w is None else torch.from_numpy(w)
    for fn in (hk.bloom_words, hk.bloom_words_plain):
        got = fn(torch.from_numpy(idx), tw, wl)
        assert got.dtype == torch.int32 and got.shape == (width // 32,)
        assert np.array_equal(_words(got), want)


def test_bloom_words_all_invalid(rng):
    wl = 12
    width = 1 << wl
    idx = np.array([-1, width, width + 10, -(1 << 31), (1 << 31) - 1] * 40,
                   np.int32)
    w = np.ones(idx.size, np.int32)
    want = np.asarray(hp.mxu_bloom_words(jnp.asarray(idx), jnp.asarray(w), wl,
                                         interpret=True))
    got = hk.bloom_words(torch.from_numpy(idx), torch.from_numpy(w), wl)
    assert not want.any() and np.array_equal(_words(got), want)
    # a zero weight drops an in-range index
    some = torch.tensor([5, 6, 7], dtype=torch.int32)
    got = hk.bloom_words(some, torch.tensor([0, 1, 0], dtype=torch.int32), wl)
    assert int(bloom.count_set_bits(bloom.BloomFilter(got))) == 1


@pytest.mark.parametrize("wl", [12, 13])
def test_bloom_words_rows_vs_pallas_interpret(rng, wl):
    width = 1 << wl
    idx = np.stack([_stream(rng, 5000, width) for _ in range(3)])
    idx[2] = -1  # an empty row
    want = np.asarray(hp.mxu_bloom_words_rows(jnp.asarray(idx), wl,
                                              interpret=True))
    for fn in (hk.bloom_words_rows, hk.bloom_words_rows_plain):
        got = fn(torch.from_numpy(idx), wl)
        assert got.shape == (3, width // 32)
        assert np.array_equal(_words(got), want)


def test_gate_and_out(rng):
    wl = 12
    idx = torch.from_numpy(_stream(rng, 3000, 1 << wl))
    rows = torch.from_numpy(np.stack([_stream(rng, 3000, 1 << wl)
                                      for _ in range(3)]))
    base = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(3, 128))
                            .astype(np.int32))
    one = hk.bloom_words(idx, None, wl)
    many = hk.bloom_words_rows(rows, wl)
    for g in (0, 1):
        gate = torch.full((1,), g, dtype=torch.int32)
        out = base[0].clone()
        res = hk.bloom_words(idx, None, wl, gate=gate, out=out)
        assert res.data_ptr() == out.data_ptr()
        assert torch.equal(out, base[0] | one if g else base[0])
        out = base.clone()
        res = hk.bloom_words_rows(rows, wl, gate=gate, out=out)
        assert res is out
        assert torch.equal(out, base | many if g else base)


@pytest.mark.parametrize("rows,n,wl,want", [
    # the 2**20 plan's windows: 128 hot rows of 256 words
    (128, 1_462_272, 13, (3, 512)),
    # the 2**30 plan's windows: 8 entries per word, one block a row
    (8192, 32_768, 17, (1, 512)),
    # one batch's bucket tensor into a 2**17 filter, and into 2**18
    (1, 31_195_136, 17, (264, 512)),
    (1, 31_195_136, 18, (264, 512)),
    # 128 KB of words: one block of 1,024 threads per multiprocessor
    (1, 124_780_544, 20, (132, 1024)),
    (1, 124_780_544, 19, (132, 1024)),
    # words past a block's shared memory: direct atomics
    (1, 124_780_544, 21, (0, 0)),
    (1, 31_195_136, 26, (0, 0)),
    (1, 1 << 20, 31, (0, 0)),
    # a row with fewer entries than words, and one just long enough
    (4, 100, 13, (0, 0)),
    (4, 4 * 256 - 1, 13, (0, 0)),
    (4, 4 * 256, 13, (1, 512)),
    # empty rows
    (0, 100, 13, (0, 0)),
    (3, 0, 13, (0, 0)),
])
def test_private_words_grid(rows, n, wl, want):
    """The presence-word kernel's route is a pure function of the shapes."""
    assert hk.private_words_grid(rows, n, wl) == want


@pytest.mark.parametrize("wl", [12, 13, 17, 18, 20])
@pytest.mark.parametrize("rows", [1, 128, 8192])
@pytest.mark.parametrize("n", [255, 4096, 100_000, 31_195_136])
def test_private_words_grid_gives_every_block_enough(rows, n, wl):
    blocks, threads = hk.private_words_grid(rows, n, wl)
    nwords = (1 << wl) // hk.PACK
    if blocks == 0:
        assert threads == 0 and n < hk.PRIVATE_MIN_ENTRIES_PER_WORD * nwords
    else:
        assert threads in (512, 1024) and 4 * nwords <= 227 * 1024
        assert n // blocks >= hk.PRIVATE_MIN_ENTRIES_PER_WORD * nwords
        assert (blocks - 1) * rows * threads < hk.PRIVATE_TARGET_THREADS


def test_forced_route_is_checked():
    idx = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="route"):
        hk._words_launch(idx, None, 12, None, None, "bloom_words",
                         route="shared")
    with pytest.raises(ValueError, match="shared memory"):
        hk._words_launch(idx, None, 21, None, None, "bloom_words",
                         route="private")
    # a forced private route lowers the rule to one entry per word
    assert hk.private_words_grid(4, 1000, 13) == (0, 0)
    assert hk.private_words_grid(4, 1000, 13, 1) == (3, 512)
    assert hk.private_words_grid(4, 100, 13, 1) == (0, 0)
    assert hk.private_words_grid(4, 1 << 20, 21, 1) == (0, 0)


def test_cpu_route_launches_no_kernel(rng):
    before = dict(hk.BLOOM_LAUNCHES)
    hk.bloom_words(torch.zeros(8, dtype=torch.int32), None, 12)
    hk.bloom_words_rows(torch.zeros((2, 8), dtype=torch.int32), 12)
    assert hk.BLOOM_LAUNCHES == before


@pytest.mark.parametrize("bad,err", [
    (dict(wl=11), ValueError),
    (dict(wl=39), ValueError),
    (dict(rows_wl=27), ValueError),
    (dict(idx=torch.zeros(8, dtype=torch.int16)), TypeError),
    (dict(weight=torch.ones(8, dtype=torch.int64)), TypeError),
    (dict(weight=torch.ones(5, dtype=torch.int32)), ValueError),
    (dict(out=torch.zeros(129, dtype=torch.int32)), ValueError),
    (dict(out=torch.zeros((1, 128), dtype=torch.int32)), ValueError),
    (dict(out=torch.zeros(128, dtype=torch.int64)), ValueError),
    (dict(gate=torch.ones(2, dtype=torch.int32)), ValueError),
    (dict(idx=torch.zeros(8, dtype=torch.int32, device="meta")), ValueError),
])
def test_rejects(bad, err):
    idx = bad.get("idx", torch.zeros(8, dtype=torch.int32))
    with pytest.raises(err):
        if "rows_wl" in bad:
            hk.bloom_words_rows(idx.reshape(1, -1), bad["rows_wl"])
        else:
            hk.bloom_words(idx, bad.get("weight"), bad.get("wl", 12),
                           gate=bad.get("gate"), out=bad.get("out"))


# ------------------------------------------------------------ the model ----


def test_zeros_layout_and_range():
    bf = bloom.BloomFilter.zeros(14, device=CPU)
    assert bf.words.dtype == torch.int32 and bf.words.shape == (512,)
    assert bf.width == 1 << 14
    for wl in (11, 39):
        with pytest.raises(ValueError):
            bloom.BloomFilter.zeros(wl, device=CPU)


def test_zeros_defaults_to_the_card():
    """No device named: the filter is made on the card, never on the CPU;
    where there is none, making it raises."""
    if torch.cuda.is_available():
        assert bloom.BloomFilter.zeros(12).words.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            bloom.BloomFilter.zeros(12)


def test_jax_filter_carried_across(rng):
    """A filter built by the JAX package loads with ``from_numpy``, answers
    ``contains`` as JAX does (hits, misses, and words with bit 31 set) and
    comes back byte for byte."""
    wl = 14
    codes = rng.integers(0, 5, size=(6, 60), dtype=np.uint8)
    other = rng.integers(0, 4, size=(6, 60), dtype=np.uint8)
    th, _, jh, jv = _both_hashes(codes)
    jbf = jbloom.insert(jbloom.BloomFilter.zeros(wl), jh, jv, wl,
                        ingestion="scatter")
    words = np.asarray(jbf.words)
    assert (words >= 1 << 31).any()
    bf = bloom.BloomFilter.from_numpy(words, CPU)
    assert np.array_equal(bf.to_numpy(), words)
    assert bf.to_numpy().dtype == np.uint32
    oh, _, ojh, _ = _both_hashes(other)
    for t, j in ((th, jh), (oh, ojh)):
        assert np.array_equal(bloom.contains(bf, t, wl).numpy(),
                              np.asarray(jbloom.contains(jbf, j, wl)))
    with pytest.raises(TypeError):
        bloom.BloomFilter.from_numpy(words.view(np.int32), CPU)
    with pytest.raises(ValueError):
        bloom.BloomFilter.from_numpy(words[:100], CPU)


def test_contains_bit_31():
    """int32 ``>>`` is arithmetic: bit 31 set must not read as set bits
    below it."""
    words = np.zeros(128, np.uint32)
    words[0] = 1 << 31                     # bucket 31 * 128 = 3968
    bf = bloom.BloomFilter.from_numpy(words, CPU)
    h = torch.tensor([[3968], [3840], [0]], dtype=torch.int64)
    assert bloom.contains(bf, h, 12).tolist() == [True, False, False]


@pytest.mark.parametrize("wl", [12, 13, 14, 17, 18, 19, 20, 21])
def test_insert_vs_jax_scatter(rng, wl):
    """Every width, those the JAX package partitions (2**19 up) included,
    against the JAX package's scatter route."""
    codes = rng.integers(0, 5, size=(5, 50), dtype=np.uint8)   # with N
    th, tv, _, _ = _both_hashes(codes)
    bf = bloom.BloomFilter.zeros(wl, device=CPU)
    res = bloom.insert(bf, th, tv, wl)
    assert res is bf
    assert np.array_equal(bf.to_numpy(), _jax_scatter(codes, wl))


def test_insert_routes_by_width(monkeypatch, rng):
    """One direct ``bloom_words`` launch at every width: no partitioned
    route on the filter's path."""
    import nthash_tpu_torch.models.bloom as mod

    seen = []
    monkeypatch.setattr(mod, "bloom_words",
                        lambda *a, **k: seen.append(("direct", a[2])))
    h = torch.zeros((2, 3), dtype=torch.int64)
    v = torch.ones(2, dtype=torch.bool)
    widths = (12, 18, 19, 20, 30, 31)
    for wl in widths:  # stand-in words: only the width counts
        words = torch.zeros(1, dtype=torch.int32).expand(1 << (wl - 5))
        mod.insert(mod.BloomFilter(words), h, v, wl)
    assert seen == [("direct", wl) for wl in widths]


def test_insert_rejects():
    bf = bloom.BloomFilter.zeros(14, device=CPU)
    h = torch.zeros((2, 3), dtype=torch.int64)
    v = torch.ones(2, dtype=torch.bool)
    for wl in (11, 39):
        with pytest.raises(ValueError, match="width_log2"):
            bloom.insert(bf, h, v, wl)
    with pytest.raises(ValueError, match="width"):
        bloom.insert(bf, h, v, 15)


def test_insert_2_31_sparse(rng):
    """The widest filter: 2**31 bits through one direct launch, where the
    sentinel 2**31 does not fit an int32; checked at the set words and by
    the total popcount."""
    wl = 31
    h = torch.from_numpy(rng.integers(0, 1 << 62, size=(300, 2),
                                      dtype=np.int64))
    h[:5] |= 1 << 30                   # buckets in the top half
    v = torch.from_numpy(rng.random(300) < 0.8)
    bf = bloom.insert(bloom.BloomFilter.zeros(wl, device=CPU), h, v, wl)
    b = (h.numpy() & ((1 << wl) - 1))[v.numpy()].reshape(-1)
    want = {}
    for wi, bi in zip(hp.word_index(b), hp.bit_index(b)):
        want[int(wi)] = want.get(int(wi), 0) | (1 << int(bi))
    pos = np.fromiter(want, np.int64)
    got = bf.to_numpy()[pos]
    assert np.array_equal(got, np.fromiter(want.values(), np.uint32))
    assert int(bloom.count_set_bits(bf)) == len(set(b.tolist()))
    assert bool(bloom.contains(bf, h, wl)[v].all())


@pytest.mark.parametrize("wl", [14, 20])
def test_insert_from_buckets_vs_jax(rng, wl):
    codes = rng.integers(0, 5, size=(6, 40), dtype=np.uint8)
    bucks = hash_kmers_tm(prepare_codes(torch.from_numpy(codes)), K, H,
                          emit_buckets=wl)
    bf = bloom.BloomFilter.zeros(wl, device=CPU)
    assert bloom.insert_from_buckets(bf, bucks, emitted_width_log2=wl) is bf
    assert np.array_equal(bf.to_numpy(), _jax_scatter(codes, wl))
    if wl <= 18:  # and the JAX package's own bucket route (interpret mode)
        jb = jbloom.insert_from_buckets(
            jbloom.BloomFilter.zeros(wl), [jnp.asarray(b.numpy()) for b in bucks],
            emitted_width_log2=wl, interpret=True)
        assert np.array_equal(bf.to_numpy(), np.asarray(jb.words))


@pytest.mark.parametrize("wl", [19, 20, 21])
def test_insert_from_buckets_wide_vs_jax_scatter(rng, wl):
    """The widths the JAX package partitions: the port fills them directly,
    bit for bit as the JAX scatter ingestion does."""
    codes = rng.integers(0, 5, size=(7, 45), dtype=np.uint8)
    bucks = hash_kmers_tm(prepare_codes(torch.from_numpy(codes)), K, H,
                          emit_buckets=wl)
    bf = bloom.insert_from_buckets(bloom.BloomFilter.zeros(wl, device=CPU),
                                   bucks, emitted_width_log2=wl)
    assert np.array_equal(bf.to_numpy(), _jax_scatter(codes, wl))


def test_insert_from_buckets_one_launch_over_views(monkeypatch, rng):
    """The hash kernel's tensors (views of one output) take one
    ``bloom_words`` launch through a view of it; separate tensors one
    each; either way no concatenated copy."""
    import nthash_tpu_torch.models.bloom as mod

    seen = []
    real = mod.bloom_words

    def record(idx, weight, wl, **kw):
        seen.append((tuple(idx.shape), idx.data_ptr()))
        return real(idx, weight, wl, **kw)

    monkeypatch.setattr(mod, "bloom_words", record)
    wl = 20
    out = torch.from_numpy(rng.integers(-1, (1 << wl) + 2, size=(H, 6, 9))
                           .astype(np.int32))
    one = mod.insert_from_buckets(mod.BloomFilter.zeros(wl, device=CPU),
                                  list(out.unbind(0)))
    assert seen == [((H, 54), out.data_ptr())]
    each = mod.insert_from_buckets(mod.BloomFilter.zeros(wl, device=CPU),
                                   [b.clone() for b in out.unbind(0)])
    assert [shape for shape, _ in seen[1:]] == [(6, 9)] * H
    assert torch.equal(one.words, each.words)
    assert torch.equal(one.words, hk.bloom_words_plain(out, None, wl))


def test_insert_from_buckets_matches_pallas_hash_buckets(rng):
    """Buckets from the JAX package's own Pallas hash kernel (interpret
    mode) fill the same filter in both packages."""
    wl = 12
    codes = rng.integers(0, 5, size=(4, 21), dtype=np.uint8)
    jtm = kmer_pallas.prepare_codes(jnp.asarray(codes))
    import jax

    with jax.disable_jit():
        jbucks = kmer_pallas.hash_kmers_tm(jtm, 5, 2, emit_buckets=wl,
                                           interpret=True)
    bf = bloom.insert_from_buckets(
        bloom.BloomFilter.zeros(wl, device=CPU),
        [torch.from_numpy(np.array(b)) for b in jbucks])
    jbf = jbloom.insert_from_buckets(jbloom.BloomFilter.zeros(wl), jbucks,
                                     interpret=True)
    assert np.array_equal(bf.to_numpy(), np.asarray(jbf.words))


def test_insert_from_buckets_guards():
    bf = bloom.BloomFilter.zeros(14, device=CPU)
    b = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="emitted at width"):
        bloom.insert_from_buckets(bf, [b], emitted_width_log2=13)
    # the sentinel of the filter's own width is dropped
    bloom.insert_from_buckets(bf, [b, b + (1 << 14)], emitted_width_log2=14)
    assert int(bloom.count_set_bits(bf)) == 1
    wide = bloom.BloomFilter(torch.zeros(1, dtype=torch.int32).expand(1 << 26))
    with pytest.raises(ValueError, match="2\\*\\*30"):
        bloom.insert_from_buckets(wide, [b])


# ------------------------------------------- tests/test_bloom.py's cases ----


WL = 14


def _insert(codes):
    th, tv, _, _ = _both_hashes(codes)
    return bloom.insert(bloom.BloomFilter.zeros(WL, device=CPU), th, tv, WL), th


def test_insert_then_contains(rng):
    bf, th = _insert(rng.integers(0, 4, size=(8, 60), dtype=np.uint8))
    assert bool(bloom.contains(bf, th, WL).all())


def test_invalid_windows_not_inserted():
    bf, _ = _insert(np.full((1, 30), 4, dtype=np.uint8))  # an all-N read
    assert int(bloom.count_set_bits(bf)) == 0


def test_absent_kmers_mostly_miss(rng):
    bf, _ = _insert(rng.integers(0, 4, size=(4, 60), dtype=np.uint8))
    _, other = _insert(rng.integers(0, 4, size=(4, 60), dtype=np.uint8))
    # fill ratio ~ 208 * 3 / 16384: P(false positive) = ratio**3 << 1%
    assert bloom.contains(bf, other, WL).double().mean() < 0.05


def test_merge_is_union(rng):
    a = rng.integers(0, 4, size=(2, 40), dtype=np.uint8)
    b = rng.integers(0, 4, size=(2, 40), dtype=np.uint8)
    (bfa, ha), (bfb, hb) = _insert(a), _insert(b)
    merged = bloom.merge(bfa, bfb)
    assert merged.words.data_ptr() not in (bfa.words.data_ptr(),
                                           bfb.words.data_ptr())
    assert bool(bloom.contains(merged, ha, WL).all())
    assert bool(bloom.contains(merged, hb, WL).all())
    both, _ = _insert(np.concatenate([a, b]))
    assert torch.equal(merged.words, both.words)
    assert int(bloom.count_set_bits(merged)) <= int(
        bloom.count_set_bits(bfa)) + int(bloom.count_set_bits(bfb))


def test_count_set_bits_and_fill_ratio(rng):
    words = np.zeros((1 << WL) // 32, dtype=np.uint32)
    words[0] = 0b111
    bf = bloom.BloomFilter.from_numpy(words, CPU)
    assert float(bloom.fill_ratio(bf)) == pytest.approx(3 / (1 << WL))
    assert int(bloom.count_set_bits(bf)) == 3
    words = rng.integers(0, 1 << 32, size=(1 << WL) // 32, dtype=np.uint64) \
        .astype(np.uint32)
    words[:4] = [0xFFFFFFFF, 1 << 31, 0x80000001, 0]
    jbf = jbloom.BloomFilter(jnp.asarray(words))
    bf = bloom.BloomFilter.from_numpy(words, CPU)
    assert int(bloom.count_set_bits(bf)) == int(jbloom.count_set_bits(jbf)) \
        == int(np.unpackbits(words.view(np.uint8)).sum())
    assert float(bloom.fill_ratio(bf)) == pytest.approx(
        float(jbloom.fill_ratio(jbf)))


# ------------------------------------------------- the binned route ----


def _skewed_stream(rng, n, wl):
    """``_stream`` with a hot bucket (every eighth entry) and the last
    bucket of the width."""
    width = 1 << wl
    idx = _stream(rng, n, width) if wl < 31 else rng.integers(
        -3, width - 1, size=n).astype(np.int32)
    idx[::8] = 12345
    idx[5::16] = width - 1
    return idx


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("wl,n", [(21, 2 * hp.CHUNK + 7), (22, 5_001)])
def test_binned_pieces_compose_to_pallas_interpret(rng, wl, n, weighted):
    """The binning pass's plain version and the range pass's, composed, set
    the bits ``bloom_words_plain`` sets and the JAX ``mxu_bloom_words``
    sets in interpret mode; a weight drops the entries whose weight is 0
    in the binning pass."""
    idx = _skewed_stream(rng, n, wl)
    w = rng.integers(-2, 3, size=n).astype(np.int32) if weighted else None
    want = np.asarray(hp.mxu_bloom_words(
        jnp.asarray(idx), None if w is None else jnp.asarray(w), wl,
        interpret=True))
    t = torch.from_numpy(idx)
    tw = None if w is None else torch.from_numpy(w)
    for per in (1, 777, 1 << 17):
        bins = hk.bin_ranges(t[None], tw, wl, 20, per)
        assert bins.stage.dtype == torch.int32
        got = hk.bloom_ranges_plain(bins, 1, wl)
        assert np.array_equal(_words(got[0]), want)
    assert np.array_equal(_words(hk.bloom_words_plain(t, tw, wl)), want)


@pytest.mark.parametrize("rows,wl", [(3, 21), (2, 23), (1, 31)])
def test_binned_rows_compose_to_plain(rng, rows, wl):
    """Rows of ranges (row r's words follow row r - 1's), an empty row, a
    row all in one range, and ``out`` OR-ed into; at 2**31 the top range."""
    n = 4_003
    idx = np.stack([_skewed_stream(rng, n, wl) for _ in range(rows)])
    if rows > 1:
        idx[1] = -1
        idx[-1] = rng.integers(3 << 20, 4 << 20, size=n)
    if wl == 31:
        idx[0, ::3] = rng.integers((1 << 31) - (1 << 20), (1 << 31) - 1,
                                   size=idx[0, ::3].size)
    t = torch.from_numpy(idx.astype(np.int32))
    bins = hk.bin_ranges(t, None, wl, 20, 500)
    base = torch.from_numpy(rng.integers(-(2**31), 2**31,
                                         size=(rows, (1 << wl) // 32),
                                         dtype=np.int64).astype(np.int32))
    got = hk.bloom_ranges_plain(bins, rows, wl, out=base.clone())
    want = hk._words_plain(t, None, wl, None, base.clone())
    assert torch.equal(got, want)
    if wl <= hk.BLOOM_ROWS_MAX_WIDTH_LOG2:
        assert torch.equal(hk.bloom_ranges_plain(bins, rows, wl),
                           hk.bloom_words_rows_plain(t, wl))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("wl,n,per", [(21, 2 * hp.CHUNK + 7, 8),
                                      (22, 5_001, 16), (29, 9_999, 4096),
                                      (30, 70_001, 16), (30, 1_023, 8)])
def test_paged_pool_holds_skewed_words(rng, wl, n, per, weighted):
    """C1's pool over streams with a hot bucket, the last bucket,
    sentinels, buckets past the width and a weight dropping entries: the
    pages the ranges take (``range_pages``) fit ``page_pool``'s, and the
    binning and range passes' plain versions, composed, set what
    ``bloom_words_plain`` sets (at 2**21 and 2**22 also what the JAX
    ``mxu_bloom_words`` sets in interpret mode)."""
    idx = _skewed_stream(rng, n, wl)
    w = rng.integers(-2, 3, size=n).astype(np.int32) if weighted else None
    t = torch.from_numpy(idx)
    tw = None if w is None else torch.from_numpy(w)
    bins = hk.bin_ranges_plain(t[None], tw, wl, 20, per)
    pool, most = hk.page_pool(1, n, bins.counts.numel(), per)
    need = hk.range_pages(bins.counts, per)
    assert int(need.sum()) <= pool and int(need.max()) <= most
    assert int(bins.counts.sum()) <= pool * hk.page_entries(per)
    got = hk.bloom_ranges_plain(bins, 1, wl)
    assert torch.equal(got[0], hk.bloom_words_plain(t, tw, wl))
    if wl <= 22:
        want = np.asarray(hp.mxu_bloom_words(
            jnp.asarray(idx), None if w is None else jnp.asarray(w), wl,
            interpret=True))
        assert np.array_equal(_words(got[0]), want)


@pytest.mark.parametrize("wl", range(21, 32))
def test_words_binning_counts_first_only_by_runs(rng, wl):
    """C1's binning pass pages its stage and counts nothing first
    ("sectors": 512 and 1,024 ranges a row, 2**29 and 2**30 bits) where
    the rule says so; every other binned width counts by range before its
    "runs" scatter (``BIN_COUNT_LAUNCHES``). The CPU route launches
    neither."""
    body = hk.scatter_body(wl, hk.WORDS_RANGE_LOG2)
    assert body == ("sectors" if wl in (29, 30) else "runs")
    before = dict(hk.BIN_COUNT_LAUNCHES)
    t = torch.from_numpy(_skewed_stream(rng, 1_000, wl))
    bins = hk.bin_ranges(t[None], None, wl, hk.WORDS_RANGE_LOG2, 16)
    assert bins.pages is None
    assert hk.BIN_COUNT_LAUNCHES == before


@pytest.mark.parametrize("rows,n,wl,want", [
    # the 2**30 Bloom path: batch 0's [4, n] buckets as one stream
    (1, 124_780_544, 30, (1 << 17, 952 + 1024)),
    (1, 124_780_544, 31, (1 << 17, 952 + 2048)),
    (1, 124_780_544, 21, (1 << 17, 952 + 2)),
    # the private words' widths, too many ranges, too few updates: none
    (1, 124_780_544, 20, (0, 0)),
    (8, 1 << 22, 30, (0, 0)),
    (1, (1 << 25) - 1, 30, (0, 0)),
    (1, 1 << 25, 30, (63_552, 528 + 1024)),
    (0, 100, 30, (0, 0)),
    (1, 0, 30, (0, 0)),
])
def test_binned_words_grid(rows, n, wl, want):
    """The presence words' binned route is a pure function of the shapes."""
    assert hk.binned_words_grid(rows, n, wl) == want


def test_words_route_rule():
    route = hk._words_route_of
    assert route(1, 124_780_544, 17, None)[0] == "private"
    assert route(1, 124_780_544, 30, None)[0] == "binned"
    assert route(1, 1 << 24, 30, None)[0] == "direct"
    assert route(1, 1000, 30, "binned") == ("binned", 1 << 14, 1025)
    assert route(1, 1 << 20, 30, "direct") == ("direct", 0, 0)


@pytest.mark.parametrize("rows,wl", [(1, 12), (1, 20), (4096, 21), (3, 31)])
def test_binned_route_refused(rows, wl):
    """A forced binned route is refused at widths the private words serve
    and where one pass would need more than ``BINNED_MAX_RANGES`` ranges,
    before anything reaches the card."""
    idx = torch.zeros((rows, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="no binned route"):
        hk._words_launch(idx, None, wl, None, None, "bloom_words",
                         route="binned")
    with pytest.raises(ValueError, match="no binned route"):
        hk.bin_ranges(idx, None, wl, 20)


def test_bin_ranges_weight_needs_one_row():
    with pytest.raises(ValueError, match="single row"):
        hk.bin_ranges(torch.zeros((2, 8), dtype=torch.int32),
                      torch.ones(8, dtype=torch.int32), 21, 20)
    before = (dict(hk.BIN_LAUNCHES), dict(hk.RANGE_LAUNCHES),
              dict(hk.BLOOM_LAUNCHES))
    hk.bloom_words(torch.zeros(8, dtype=torch.int32), None, 30)
    assert (dict(hk.BIN_LAUNCHES), dict(hk.RANGE_LAUNCHES),
            dict(hk.BLOOM_LAUNCHES)) == before
