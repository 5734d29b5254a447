"""The port's one-device sequence hashing against the JAX package, exactly.

``nthash_tpu_torch.parallel.sp`` is ``nthash_tpu/parallel/sp.py`` without
its mesh: the JAX functions run here on a 1-device "seq" mesh with the jnp
engine, the port's with both of its engines ("kernel": the wrappers, whose
CPU route is the plain roll; "torch": the batch-major reference engines).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nthash_tpu import oracle
from nthash_tpu.parallel import sp as jsp
from nthash_tpu.parallel.mesh import SEQ_AXIS, device_mesh
from nthash_tpu_torch.ops import kmer_kernel, seed_kernel
from nthash_tpu_torch.parallel import sp
from nthash_tpu_torch.u64 import to_numpy_u64

ENGINES = ["kernel", "torch"]
SEEDS = ("110011", "101101")


@pytest.fixture(scope="module")
def mesh1():
    return device_mesh(1, SEQ_AXIS)


def _jax_kmers(seq, k, h, mesh, tile=None):
    codes = jsp.shard_sequence(jnp.asarray(seq), mesh, k=k, tile=tile)
    res, valid = jsp.hash_long_sequence(codes, k, h, mesh, engine="jnp",
                                        tile=tile)
    return [r.to_np() for r in res], np.asarray(valid)


def _jax_seeds(seq, seeds, h, mesh, tile=None):
    k = len(seeds[0])
    codes = jsp.shard_sequence(jnp.asarray(seq), mesh, k=k, tile=tile)
    res, valid = jsp.hash_long_sequence_seeds(codes, seeds, h, mesh,
                                              engine="jnp", tile=tile)
    return [r.to_np() for r in res], np.asarray(valid)


def test_pick_tile_vs_jax():
    for c in (1, 2, 8, 9, 64, 96, 127, 128, 256, 300, 1009, 1024, 4096,
              65_536, 1 << 20):
        for k in (1, 2, 5, 9, 32, 33, 64, 100):
            for tile in (None, 8, 16, 128, 256, 1000):
                try:
                    want = jsp.pick_tile(c, k, tile)
                except ValueError:
                    with pytest.raises(ValueError, match="smaller than k-1"):
                        sp.pick_tile(c, k, tile)
                    continue
                assert sp.pick_tile(c, k, tile) == want, (c, k, tile)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("length,k,h,tile", [
    (512, 9, 2, None), (128, 4, 1, None), (1024, 32, 3, 64),
    (2048, 1, 1, 100), (1009, 9, 2, 16), (997, 32, 2, 40)])
def test_hash_long_sequence_vs_jax(rng, mesh1, engine, length, k, h, tile):
    """Prime lengths are padded to the tile as shard_sequence(k=) does."""
    seq = rng.integers(0, 5, size=(length,), dtype=np.uint8)
    want, wvalid = _jax_kmers(seq, k, h, mesh1, tile)
    codes = sp.shard_sequence(torch.from_numpy(seq), k=k, tile=tile)
    got, valid = sp.hash_long_sequence(codes, k, h, engine=engine, tile=tile)
    assert len(got) == h
    for g, w in zip(got, want):
        assert np.array_equal(to_numpy_u64(g), w)
    assert np.array_equal(valid.numpy(), wvalid)
    # and the oracle on the unpadded windows
    _, _, expect, v = oracle.hash_all_windows(seq, k, h)
    w = length - k + 1
    assert np.array_equal(np.stack([to_numpy_u64(g) for g in got], -1)[:w],
                          expect)
    assert np.array_equal(valid.numpy()[:w], v)
    assert not valid.numpy()[w:].any()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("length,h,tile", [(128, 2, None), (131, 2, 8),
                                           (600, 1, 32), (257, 3, None)])
def test_hash_long_sequence_seeds_vs_jax(rng, mesh1, engine, length, h, tile):
    seq = rng.integers(0, 5, size=(length,), dtype=np.uint8)
    want, wvalid = _jax_seeds(seq, SEEDS, h, mesh1, tile)
    codes = sp.shard_sequence(torch.from_numpy(seq), k=6, tile=tile)
    got, valid = sp.hash_long_sequence_seeds(codes, SEEDS, h, engine=engine,
                                             tile=tile)
    assert len(got) == len(SEEDS) * h
    for g, w in zip(got, want):
        assert np.array_equal(to_numpy_u64(g), w)
    assert np.array_equal(valid.numpy(), wvalid)
    _, _, expect = oracle.hash_all_windows_seeds(seq, SEEDS, h)
    w = length - 6 + 1
    assert np.array_equal(np.stack([to_numpy_u64(g) for g in got], -1)[:w],
                          expect)
    assert not valid.numpy()[w:].any()


def test_baseline_seeds_vs_jax(rng, mesh1):
    seq = rng.integers(0, 5, size=(1000,), dtype=np.uint8)
    want, wvalid = _jax_seeds(seq, ("10101", "11011"), 1, mesh1)
    got, valid = sp.hash_long_sequence_seeds(
        sp.shard_sequence(torch.from_numpy(seq), k=5), ("10101", "11011"), 1)
    for g, w in zip(got, want):
        assert np.array_equal(to_numpy_u64(g), w)
    assert np.array_equal(valid.numpy(), wvalid)


@pytest.mark.parametrize("length,k,tile", [(1009, 9, 16), (1009, 9, None),
                                           (131, 6, 8), (100, 40, None),
                                           (512, 9, None)])
def test_shard_sequence_vs_jax(rng, mesh1, length, k, tile):
    seq = rng.integers(0, 5, size=(length,), dtype=np.uint8)
    want = np.asarray(jsp.shard_sequence(jnp.asarray(seq), mesh1, k=k,
                                         tile=tile))
    got = sp.shard_sequence(torch.from_numpy(seq), k=k, tile=tile)
    assert np.array_equal(got.numpy(), want)
    assert sp.shard_sequence(torch.from_numpy(seq)).shape == (length,)


def test_pseudo_reads_vs_jax(rng):
    for c, k, t in ((64, 5, 16), (96, 9, 8), (256, 32, 256), (30, 1, 3)):
        ext = rng.integers(0, 5, size=(c + k - 1,), dtype=np.uint8)
        want = np.asarray(jsp.pseudo_reads(jnp.asarray(ext), k, t))
        assert np.array_equal(
            sp.pseudo_reads(torch.from_numpy(ext), k, t).numpy(), want)


def test_resolve_engine():
    assert sp.resolve_engine("auto", "cpu") == "torch"
    assert sp.resolve_engine("auto", torch.device("cpu")) == "torch"
    assert sp.resolve_engine("auto", torch.device("cuda", 0)) == "kernel"
    assert sp.resolve_engine("kernel") == "kernel"
    assert sp.resolve_engine("torch") == "torch"
    for bad in ("jnp", "pallas", "cuda"):
        with pytest.raises(ValueError, match="unknown engine"):
            sp.resolve_engine(bad)


def test_more_than_one_device_raises(rng):
    """Without a mesh a call spans one device: n_devices other than 1
    raises (tests/test_torch_parallel.py shards over 2 and 4 ranks)."""
    seq = torch.from_numpy(rng.integers(0, 4, size=(256,), dtype=np.uint8))
    with pytest.raises(ValueError, match="spans 1 device"):
        sp.shard_sequence(seq, k=9, n_devices=2)
    with pytest.raises(ValueError, match="spans 1 device"):
        sp.hash_long_sequence(seq, 9, 1, n_devices=4)
    with pytest.raises(ValueError, match="spans 1 device"):
        sp.hash_long_sequence_seeds(seq, SEEDS, 1, n_devices=8)


def test_n_devices_one_is_the_one_device_route(rng):
    seq = torch.from_numpy(rng.integers(0, 5, size=(300,), dtype=np.uint8))
    codes = sp.shard_sequence(seq, k=9, n_devices=1)
    assert torch.equal(codes, sp.shard_sequence(seq, k=9))
    for got, want in ((sp.hash_long_sequence(codes, 9, 2, n_devices=1),
                       sp.hash_long_sequence(codes, 9, 2)),
                      (sp.hash_long_sequence_seeds(codes, SEEDS, 1,
                                                   n_devices=1),
                       sp.hash_long_sequence_seeds(codes, SEEDS, 1))):
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
        assert torch.equal(got[1], want[1])


def test_cpu_routes_launch_no_kernel(rng):
    seq = torch.from_numpy(rng.integers(0, 4, size=(512,), dtype=np.uint8))
    before = (kmer_kernel.LAUNCHES, seed_kernel.LAUNCHES)
    sp.hash_long_sequence(seq, 9, 1, engine="kernel")
    sp.hash_long_sequence_seeds(seq, SEEDS, 1, engine="kernel")
    assert (kmer_kernel.LAUNCHES, seed_kernel.LAUNCHES) == before


def test_short_sequence_raises():
    with pytest.raises(ValueError, match="smaller than k-1"):
        sp.hash_long_sequence(torch.zeros(16, dtype=torch.uint8), 66, 1)


# The one-pass entries' plain versions (what engine="torch" and the CPU
# take) against the JAX package's pseudo-read route.

FLAT_CASES = [
    # length, k, tile, shard: a tile multiple, a prime padded and unpadded,
    # C < tile, k > tile, k = 1
    (1024, 9, 256, True), (1009, 9, None, True), (1009, 9, None, False),
    (100, 9, 256, False), (200, 40, 16, False), (300, 1, None, True)]


@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("length,k,tile,shard", FLAT_CASES)
def test_hash_sequence_plain_vs_jax(rng, mesh1, length, k, tile, shard, h):
    """Codes up to 7: every value above 4 is invalid."""
    seq = rng.integers(0, 8, size=(length,), dtype=np.uint8)
    if shard:
        want, wvalid = _jax_kmers(seq, k, h, mesh1, tile)
        codes = sp.shard_sequence(torch.from_numpy(seq), k=k, tile=tile)
    else:
        res, wv = jsp.hash_long_sequence(jnp.asarray(seq), k, h, mesh1,
                                         engine="jnp", tile=tile)
        want, wvalid = [r.to_np() for r in res], np.asarray(wv)
        codes = torch.from_numpy(seq)
    for got, valid in (kmer_kernel.hash_sequence_plain(codes, k, h),
                       kmer_kernel.hash_sequence(codes, k, h)):
        assert len(got) == h
        for g, w in zip(got, want):
            assert np.array_equal(to_numpy_u64(g), w)
        assert np.array_equal(valid.numpy(), wvalid)


@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("seeds", [("10101", "11011"), SEEDS,
                                   ("110100110011001011",
                                    "111111000000111111")])
@pytest.mark.parametrize("length,tile,shard", [
    (1024, 128, True), (1009, None, True), (1009, None, False),
    (60, 128, False), (301, 8, False)])
def test_hash_seeds_sequence_plain_vs_jax(rng, mesh1, seeds, length, tile,
                                          shard, h):
    seq = rng.integers(0, 8, size=(length,), dtype=np.uint8)
    k = len(seeds[0])
    if shard:
        want, wvalid = _jax_seeds(seq, seeds, h, mesh1, tile)
        codes = sp.shard_sequence(torch.from_numpy(seq), k=k, tile=tile)
    else:
        res, wv = jsp.hash_long_sequence_seeds(jnp.asarray(seq), seeds, h,
                                               mesh1, engine="jnp", tile=tile)
        want, wvalid = [r.to_np() for r in res], np.asarray(wv)
        codes = torch.from_numpy(seq)
    for got, valid in (seed_kernel.hash_seeds_sequence_plain(codes, seeds, h),
                       seed_kernel.hash_seeds_sequence(codes, seeds, h)):
        assert len(got) == len(seeds) * h
        for g, w in zip(got, want):
            assert np.array_equal(to_numpy_u64(g), w)
        assert np.array_equal(valid.numpy(), wvalid)


def test_sequence_entries_launch_nothing_on_cpu(rng):
    seq = torch.from_numpy(rng.integers(0, 5, size=(700,), dtype=np.uint8))
    before = (kmer_kernel.SEQUENCE_LAUNCHES, seed_kernel.SEQUENCE_LAUNCHES,
              kmer_kernel.LAUNCHES, seed_kernel.LAUNCHES)
    kmer_kernel.hash_sequence(seq, 9, 2)
    seed_kernel.hash_seeds_sequence(seq, SEEDS, 1)
    sp.hash_long_sequence(seq, 9, 1, engine="kernel")
    sp.hash_long_sequence_seeds(seq, SEEDS, 1, engine="kernel")
    assert (kmer_kernel.SEQUENCE_LAUNCHES, seed_kernel.SEQUENCE_LAUNCHES,
            kmer_kernel.LAUNCHES, seed_kernel.LAUNCHES) == before


@pytest.mark.parametrize("engine", ENGINES)
def test_short_sequence_raises_as_jax(mesh1, engine):
    """A chunk shorter than k - 1 raises on both packages, on every
    engine, with or without seeds."""
    short = np.zeros(16, dtype=np.uint8)
    with pytest.raises(ValueError, match="smaller than k-1"):
        jsp.hash_long_sequence(jnp.asarray(short), 66, 1, mesh1, engine="jnp")
    with pytest.raises(ValueError, match="smaller than k-1"):
        sp.hash_long_sequence(torch.from_numpy(short), 66, 1, engine=engine)
    with pytest.raises(ValueError, match="smaller than k-1"):
        sp.hash_long_sequence_seeds(torch.from_numpy(short), ("1" + "0" * 40
                                                              + "1",), 1,
                                    engine=engine)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seeds", [("000000",), ("000000", "110011"),
                                   ("110011", "000000", "101101")])
def test_seeds_without_care_positions_vs_jax(rng, mesh1, engine, seeds):
    """A seed with no care position hashes to 0 in every window, on both
    engines, alone and mixed with other seeds, as the JAX jnp engine gives
    it; the valid mask is the strict one."""
    seq = rng.integers(0, 5, size=(300,), dtype=np.uint8)
    want, wvalid = _jax_seeds(seq, seeds, 2, mesh1)
    codes = sp.shard_sequence(torch.from_numpy(seq), k=6)
    got, valid = sp.hash_long_sequence_seeds(codes, seeds, 2, engine=engine)
    assert len(got) == len(want) == len(seeds) * 2
    for g, w in zip(got, want):
        assert np.array_equal(to_numpy_u64(g), w)
    assert np.array_equal(valid.numpy(), wvalid)
    for si, s in enumerate(seeds):
        if "1" not in s:
            assert not any(to_numpy_u64(g).any() for g in got[2 * si:2 * si + 2])


def test_hash_sequence_rows_vs_jax(rng, mesh1):
    """k = 4,100 on a short sequence: the read kernel over pseudo-reads
    (``kmer_kernel.hash_sequence_rows``; on the CPU its plain versions), the
    route ``sp.hash_long_sequence`` takes on a CUDA tensor for a k past the
    one-pass entry's shared memory, against the JAX package's jnp engine;
    and the port's sp route on the CPU."""
    k, h = 4100, 2
    seq = rng.integers(0, 6, size=(k + 300,), dtype=np.uint8)
    want, wvalid = _jax_kmers(seq, k, h, mesh1)
    codes = sp.shard_sequence(torch.from_numpy(seq), k=k)
    got, valid = kmer_kernel.hash_sequence_rows(codes, k, h)
    assert len(got) == h
    for g, w in zip(got, want):
        assert np.array_equal(to_numpy_u64(g), w)
    assert np.array_equal(valid.numpy(), wvalid)
    got, valid = sp.hash_long_sequence(codes, k, h, engine="kernel")
    assert all(np.array_equal(to_numpy_u64(g), w) for g, w in zip(got, want))
    assert np.array_equal(valid.numpy(), wvalid)


def test_seeds_past_the_entry_vs_jax(rng, mesh1):
    """Seeds that ``seed_kernel.sequence_fits`` rejects (k = 8,000, two care
    runs each): ``sp.hash_long_sequence_seeds`` and the route it takes for
    them on a CUDA tensor (``hash_seeds_sequence_rows``, B1 over
    pseudo-reads; here its plain versions) against the JAX package."""
    seeds = ("1" + "0" * 7998 + "1", "11" + "0" * 7996 + "11")
    assert not seed_kernel.sequence_fits(seeds, 2)
    k = len(seeds[0])
    seq = rng.integers(0, 6, size=(k + 200,), dtype=np.uint8)
    want, wvalid = _jax_seeds(seq, seeds, 2, mesh1)
    codes = sp.shard_sequence(torch.from_numpy(seq), k=k)
    for got, valid in (sp.hash_long_sequence_seeds(codes, seeds, 2,
                                                   engine="kernel"),
                       seed_kernel.hash_seeds_sequence_rows(codes, seeds, 2)):
        assert len(got) == 4
        assert all(np.array_equal(to_numpy_u64(g), w)
                   for g, w in zip(got, want))
        assert np.array_equal(valid.numpy(), wvalid)
