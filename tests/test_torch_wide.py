"""Filters and spaced-seed buckets past 2**31 bits on the CPU: the wide
routes (int64 buckets) of the seed kernels, ``bloom_words`` and the probe,
``bloom.insert_sequence_seeds`` and ``screen_reads`` on them.

The seed kernels' wide buckets are forced at small widths
(``route="wide"``), and the buckets' dtype takes ``bloom_words`` and the
probe down the wide routes with them; all are held to the benchmark's plain
spaced-seed hash (``portbench/core/seed_ref.py``), the
host screening reference (``portbench/reference/host_screen.py``), the
narrow routes' int32 results and, at a narrow width, the JAX package's
filter and ``contains``. The build runs the default route at 2**31 bits
(256 MiB of words) and one test at 2**32 bits (512 MiB), where the buckets
reach 2**31 and beyond. The CUDA
kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py``. Every comparison is of integers, with
tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nthash_tpu.models import bloom as jbloom
from nthash_tpu.ops import seed_jnp
from nthash_tpu.u64 import U64
from nthash_tpu_torch.models import bloom
from nthash_tpu_torch.ops import hist_kernel as hk
from nthash_tpu_torch.ops import probe_kernel, seed_kernel
from nthash_tpu_torch.ops.kmer_kernel import prepare_codes, sequence_rows
from portbench.core import nthash_ref, seed_ref
from portbench.reference import host_screen as ref_host
from portbench.reference import screen as ref_screen

#: The benchmark configuration's four patterns (26 care positions each).
CELL_SEEDS = ("11101111110111011011101111110111",
              "11110111011110111101111011101111",
              "11111011111011100111011111011111",
              "11011110111101111110111101111011")
CASES = {
    "cell": (CELL_SEEDS, 4, 16),
    "baseline": (("10101", "11011"), 3, 12),
}


def genome_and_reads(seed, size=900, n=40, length=70, sub=0.02,
                     n_rate=0.01):
    """uint8 genome [size] (0-3, with a few N) and reads [n, length] drawn
    from it, with substitutions and N (4) calls."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size, dtype=np.uint8)
    genome[rng.random(size) < 0.005] = 4
    starts = rng.integers(0, size - length + 1, n)
    reads = genome[starts[:, None] + np.arange(length)]
    sub_at = rng.random(reads.shape) < sub
    reads = np.where(sub_at, (reads + rng.integers(1, 4, reads.shape)) % 4,
                     reads).astype(np.uint8)
    reads[rng.random(reads.shape) < n_rate] = 4
    return torch.from_numpy(genome), torch.from_numpy(reads)


def ref_planes(codes, seeds, h, wl):
    """seed_ref's buckets [S, H, b, W] as the kernels' time-major planes
    [S * H] of [W, b], the sentinel 2**wl for an invalid window."""
    bk = seed_ref.window_buckets(codes, seeds, h, wl)
    bk = torch.where(bk < 0, 1 << wl, bk)
    return [bk[s, i].T for s in range(len(seeds)) for i in range(h)]


def ref_words(genome, seeds, h, wl):
    words = torch.zeros((1 << wl) // 32, dtype=torch.int32)
    bk = seed_ref.window_buckets(genome[None], seeds, h, wl)
    ref_host.set_bits(words, bk[bk >= 0])
    return words


def one_shot(genome, seeds, h, wl, route=None):
    """The filter from one insertion of all the genome's rows, as the
    screening cell's set-up builds it; ``route="wide"`` forces the seed
    kernels' int64 buckets, which take C1's wide route."""
    rows = prepare_codes(sequence_rows(genome, len(seeds[0]), 256))
    return bloom.insert_from_buckets(
        bloom.BloomFilter.zeros(wl, device="cpu"),
        seed_kernel.hash_seeds_tm_auto(rows, seeds, h, emit_buckets=wl,
                                       route=route),
        emitted_width_log2=wl)


def wide_hits(bf, tm, seeds, h, wl, out=None):
    """``screen_reads`` with the seed kernels' buckets forced wide: int64
    buckets, which take the wide probe."""
    buckets = seed_kernel.hash_seeds_tm_auto(tm, seeds, h, emit_buckets=wl,
                                             route="wide")
    assert buckets[0].dtype == torch.int64
    return bloom.hits_from_buckets(bf, buckets, num_seeds=len(seeds),
                                   num_hashes=h, emitted_width_log2=wl,
                                   out=out)


# ------------------------------------------------------------ the rules ----


def test_route_rules():
    """The seed kernels' buckets are int64 past 2**30, or where ``route``
    names the wide route; the words and the probe follow the buckets'
    dtype, and int32 buckets past the narrow kernels' limits (2**30 for
    the probe, 2**31 for the words) refuse, naming int64."""
    assert not seed_kernel.is_wide(30) and seed_kernel.is_wide(31)
    assert seed_kernel.is_wide(12, "wide") and not seed_kernel.is_wide(None)
    assert seed_kernel.bucket_dtype(38) == torch.int64
    assert seed_kernel.bucket_dtype(30) == torch.int32
    words = torch.zeros(4, dtype=torch.int32)    # refused before its size
    for call, match in [
            (lambda: seed_kernel.is_wide(31, "staged"), "wide route"),
            (lambda: seed_kernel.is_wide(None, "wide"), "emit_buckets"),
            (lambda: seed_kernel.is_wide(12, "fast"), "unknown"),
            (lambda: probe_kernel.probe_counts(
                torch.zeros((1, 5, 3), dtype=torch.int32), words, 1, 1, 31),
             "int64"),
            (lambda: hk.bloom_words(torch.zeros(4, dtype=torch.int32), None,
                                    32), "int64")]:
        with pytest.raises(ValueError, match=match):
            call()


def test_limits_are_2_38():
    """Filters and buckets to 2**38 bits; past it each entry refuses."""
    tm = torch.zeros((40, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="emit_buckets"):
        seed_kernel.hash_seeds_tm(tm, ("10101",), 1, emit_buckets=39)
    with pytest.raises(ValueError, match="width_log2"):
        bloom.BloomFilter.zeros(39, device="cpu")
    bloom.check_width(38)
    with pytest.raises(ValueError, match="width_log2"):
        hk.bloom_words(torch.zeros(4, dtype=torch.int64), None, 39)
    planes = torch.zeros((1, 5, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="width_log2"):
        probe_kernel.probe_counts(planes, torch.zeros(1 << 7,
                                                      dtype=torch.int32),
                                  1, 1, 39)


def test_wide_routes_take_int64_only():
    """Planes of two dtypes, or of another integer type, refuse; so do
    int32 buckets for a filter past 2**30 bits, and int64 words."""
    words = torch.zeros((1 << 14) // 32, dtype=torch.int32)
    p32 = torch.zeros((2, 5, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="one dtype"):
        probe_kernel.probe_counts([p32[0], p32[1].long()], words, 1, 2, 14)
    with pytest.raises(ValueError, match="int32 or int64"):
        probe_kernel.probe_counts(p32.short(), words, 1, 2, 14)
    with pytest.raises(TypeError, match="int32"):
        hk.bloom_words(torch.zeros(4, dtype=torch.int16), None, 14)
    bf = bloom.BloomFilter(torch.zeros(1, dtype=torch.int32).expand(1 << 28))
    with pytest.raises(ValueError, match="2\\*\\*30"):
        bloom.insert_from_buckets(bf, [p32[0]])


# ------------------------------------------------------ the wide routes ----


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("entry", ["hash_seeds_tm", "hash_seeds_tm_long"])
def test_wide_buckets_vs_reference(case, entry):
    """B1 and B3 forced wide at a small width: int64 planes equal to
    ``seed_ref``'s buckets and to the narrow route's int32 planes."""
    seeds, h, wl = CASES[case]
    _, reads = genome_and_reads(3)
    tm = prepare_codes(reads)
    fn = getattr(seed_kernel, entry)
    kw = {"time_tile": len(seeds[0])} if entry.endswith("long") else {}
    got = fn(tm, seeds, h, emit_buckets=wl, route="wide", **kw)
    narrow = fn(tm, seeds, h, emit_buckets=wl, **kw)
    want = ref_planes(reads, seeds, h, wl)
    assert len(got) == len(want) == len(seeds) * h
    for g, n, w in zip(got, narrow, want):
        assert g.dtype == torch.int64 and n.dtype == torch.int32
        assert torch.equal(g, w) and torch.equal(n.long(), w)


def test_buckets_past_2_31_by_width():
    """At 2**36 the width alone picks the wide buckets: int64, the
    reference's values, sentinel 2**36, many of them past 2**31."""
    seeds, h, _ = CASES["cell"]
    wl = 36
    _, reads = genome_and_reads(5)
    got = seed_kernel.hash_seeds_tm_auto(prepare_codes(reads), seeds, h,
                                         emit_buckets=wl)
    want = ref_planes(reads, seeds, h, wl)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and torch.equal(g, w)
    flat = torch.stack(got)
    assert int((flat == 1 << wl).sum()) > 0
    assert int(((flat >= 1 << 31) & (flat < 1 << wl)).sum()) > flat.numel() // 2


@pytest.mark.parametrize("weighted", [False, True])
def test_wide_words_vs_narrow_and_plain(weighted):
    """C1 on int64 indices at 2**14, the wide route: -1, the sentinel and
    values past the width among them, OR-ed into existing words, equal to the
    narrow route on the same indices as int32; the gate 0 sets nothing."""
    wl = 14
    rng = np.random.default_rng(7)
    idx = rng.integers(-2, (1 << wl) + 40, 5000)
    idx[rng.random(5000) < 0.05] = 1 << wl
    weight = (torch.from_numpy(rng.random(5000) < 0.7).to(torch.int32)
              if weighted else None)
    base = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (1 << wl) // 32)
                            .astype(np.int32))
    before = hk.ROUTE_LAUNCHES["wide_words"]
    got = hk.bloom_words(torch.from_numpy(idx), weight, wl, out=base.clone())
    assert hk.ROUTE_LAUNCHES["wide_words"] == before   # the CPU route: plain
    want = hk.bloom_words(torch.from_numpy(idx.astype(np.int32)), weight, wl,
                          out=base.clone())
    assert torch.equal(got, want)
    assert torch.equal(hk.bloom_words_plain(torch.from_numpy(idx), weight,
                                            wl, out=base.clone()), want)
    gate = torch.zeros(1, dtype=torch.int32)
    assert torch.equal(hk.bloom_words(torch.from_numpy(idx), weight, wl,
                                      out=base.clone(), gate=gate), base)


@pytest.mark.parametrize("h", [1, 3])
def test_wide_probe_vs_narrow(h):
    """The probe on int64 buckets at 2**14, the wide route, counts what the
    narrow probe counts on the same buckets as int32, the sentinel, -1 and
    buckets past the width among them, added into a slice of a wider
    tensor."""
    wl, s, w, r = 14, 2, 23, 301
    rng = np.random.default_rng(h)
    bits = rng.random(((1 << wl) // 32, 32)) < 0.8
    words = torch.from_numpy((bits * (1 << np.arange(32, dtype=np.int64)))
                             .sum(1).astype(np.uint32).view(np.int32))
    planes = rng.integers(0, 1 << wl, (s * h, w, r))
    planes[rng.random(planes.shape) < 0.02] = 1 << wl
    planes[rng.random(planes.shape) < 0.02] = -1
    planes[rng.random(planes.shape) < 0.02] = (1 << wl) + 9
    want = probe_kernel.probe_counts(torch.from_numpy(
        planes.astype(np.int32)), words, s, h, wl)
    assert int(want.sum()) > 0
    wide = torch.full((s, r + 10), 2, dtype=torch.int32)
    got = probe_kernel.probe_counts(torch.from_numpy(planes), words, s, h,
                                    wl, out=wide[:, 5:5 + r])
    assert torch.equal(got, 2 + want)
    assert bool((wide[:, :5] == 2).all() and (wide[:, 5 + r:] == 2).all())


# ------------------------------------------- the build and the screening ----


def small_chunks(monkeypatch, rows, seeds, h, wl):
    """The build in chunks of ``rows`` rows of ``bloom.SEQUENCE_ROW``
    windows: ``BUILD_CHUNK_BYTES`` cut to that many rows' buckets."""
    row = (seed_kernel.bucket_dtype(wl).itemsize * len(seeds) * h
           * bloom.SEQUENCE_ROW)
    monkeypatch.setattr(bloom, "BUILD_CHUNK_BYTES", rows * row)


#: The build's width by the route it takes: the narrowest filter whose
#: buckets the width alone makes int64 is 2**31 bits (256 MiB of words).
ROUTE_WIDTH = {None: 12, "wide": 31}


@pytest.mark.parametrize("rows", [1, 2, None])
@pytest.mark.parametrize("route", [None, "wide"])
def test_insert_sequence_seeds_vs_one_shot(monkeypatch, rows, route):
    """The chunked build, on either route (the narrow at 2**12, the wide by
    the width at 2**31), in chunks of one or two rows or one chunk, equals
    one insertion of the whole genome's rows and the reference's filter;
    Ns in the genome set nothing."""
    seeds, h, _ = CASES["baseline"]
    wl = ROUTE_WIDTH[route]
    genome, _ = genome_and_reads(11)
    want = one_shot(genome, seeds, h, wl)
    assert torch.equal(want.words, ref_words(genome, seeds, h, wl))
    if rows:
        small_chunks(monkeypatch, rows, seeds, h, wl)
    bf = bloom.BloomFilter.zeros(wl, device="cpu")
    assert bloom.insert_sequence_seeds(bf, genome, seeds, h) is bf
    assert torch.equal(bf.words, want.words)


def test_insert_sequence_seeds_edges(monkeypatch):
    """A sequence shorter than k sets nothing; int64 codes with values
    outside 0-4 read as N."""
    seeds, h, wl = CASES["baseline"]
    bf = bloom.BloomFilter.zeros(wl, device="cpu")
    bloom.insert_sequence_seeds(bf, torch.zeros(4, dtype=torch.uint8), seeds,
                                h)
    assert int(bloom.count_set_bits(bf)) == 0
    genome, _ = genome_and_reads(12)
    odd = genome.to(torch.int64)
    odd[genome == 4] = 9
    small_chunks(monkeypatch, 1, seeds, h, wl)
    bloom.insert_sequence_seeds(bf, odd, seeds, h)
    assert torch.equal(bf.words, one_shot(genome, seeds, h, wl).words)


@pytest.mark.parametrize("case", CASES)
def test_screen_reads_wide_vs_reference(case):
    """The screening forced wide (the filter built from wide buckets, the
    reads probed by them) counts what the reference counts and what the
    narrow route counts, pass after pass into one tensor."""
    seeds, h, wl = CASES[case]
    genome, reads = genome_and_reads(13 + len(case))
    bf = one_shot(genome, seeds, h, wl, "wide")
    assert torch.equal(bf.words, one_shot(genome, seeds, h, wl).words)
    cfg = {"seeds": seeds, "num_hashes": h, "width_log2": wl}
    want = ref_screen.hits(reads, bf.words, cfg)
    tm = prepare_codes(reads)
    counts = torch.zeros_like(want)
    for _ in range(2):
        wide_hits(bf, tm, seeds, h, wl, out=counts)
    assert torch.equal(counts, 2 * want)
    assert torch.equal(bloom.screen_reads(bf, tm, seeds, h), want)
    windows = reads.shape[1] - len(seeds[0]) + 1
    assert 0 < int(want.sum()) < len(seeds) * reads.shape[0] * windows


def test_wide_route_vs_jax():
    """At a width the JAX package takes, the wide route's filter is the JAX
    ``insert`` of its spaced-seed hashes of the genome, word for word, and
    its counts those of ``contains`` over the JAX hashes of the reads."""
    seeds, h, wl = CASES["baseline"]
    genome, reads = genome_and_reads(17, size=400, n=24, n_rate=0.0)
    genome = genome.clamp(max=3)
    g = seed_jnp.hash_kmers_seeds(jnp.asarray(genome.numpy()[None]), seeds, h)
    jbf = jbloom.insert(jbloom.BloomFilter.zeros(wl), g.hashes, g.valid, wl,
                        ingestion="scatter")
    bf = one_shot(genome, seeds, h, wl, "wide")
    assert np.array_equal(bf.to_numpy(), np.asarray(jbf.words))
    r = seed_jnp.hash_kmers_seeds(jnp.asarray(reads.numpy()), seeds, h)
    want = []
    for s in range(len(seeds)):
        part = U64(r.hashes.hi[..., s * h:(s + 1) * h],
                   r.hashes.lo[..., s * h:(s + 1) * h])
        want.append(np.asarray(jbloom.contains(jbf, part, wl) & r.valid)
                    .sum(1))
    got = wide_hits(bf, prepare_codes(reads), seeds, h, wl)
    assert np.array_equal(got.numpy(), np.stack(want))


def test_default_route_at_2_32(monkeypatch):
    """A 2**32-bit filter (512 MiB of words) on the default route: the
    build and the screening take the wide buckets by the width alone, and
    equal the reference's filter and counts, with buckets and words past
    2**31."""
    seeds, h, wl = CASES["cell"][0], 2, 32
    genome, reads = genome_and_reads(19, size=600, n=16, length=60)
    before = dict(seed_kernel.ROUTE_LAUNCHES)
    small_chunks(monkeypatch, 1, seeds, h, wl)
    bf = bloom.insert_sequence_seeds(bloom.BloomFilter.zeros(wl,
                                                             device="cpu"),
                                     genome, seeds, h)
    assert seed_kernel.ROUTE_LAUNCHES == before    # the CPU route: plain
    set_words = torch.nonzero(bf.words).reshape(-1)
    assert int(set_words.max()) >= 1 << 26        # bits past 2**31
    want = ref_words(genome, seeds, h, wl)
    assert int(ref_host.words_off(bf.words, want)) == 0
    del want
    cfg = {"seeds": seeds, "num_hashes": h, "width_log2": wl}
    got = bloom.screen_reads(bf, prepare_codes(reads), seeds, h)
    assert torch.equal(got, ref_screen.hits(reads, bf.words, cfg))
    assert int(got.sum()) > 0
    assert bool(bloom.contains(
        bf, torch.stack(seed_ref.window_hashes(genome[None, :40], seeds[0],
                                               h), -1)[0, :9], wl).all())


def test_set_bits_vs_presence():
    """The reference's block build: stores repeated until every bucket's
    bit shows give the packed presence of the buckets, with many buckets
    to one word and repeated buckets."""
    wl = 13
    rng = np.random.default_rng(23)
    b = torch.from_numpy(rng.integers(0, 1 << wl, 20000))
    b[:3000] = b[:3000] % 4096 // 128 * 128     # 32 bits of word 0 and kin
    words = torch.zeros((1 << wl) // 32, dtype=torch.int32)
    ref_host.set_bits(words, b)
    present = torch.zeros(1 << wl, dtype=torch.bool)
    present[b] = True
    assert torch.equal(words, nthash_ref.pack_words(present))
    assert ref_host.set_bit_count(words) == int(present.sum())
