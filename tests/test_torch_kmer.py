"""The port's k-mer engines against the JAX package, exactly.

``hash_kmers_tm_plain`` (what ``hash_kmers_tm`` runs on a CPU tensor) in all
three output modes, and the batch-major ``kmer_torch.hash_kmers``, are held
against ``nthash_tpu.ops.kmer_jnp.hash_kmers`` and the host oracle on the
same numpy-seeded codes, plus the reference's golden vectors and one tiny
case against the Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nthash_tpu import oracle
from nthash_tpu.ops import kmer_jnp
from nthash_tpu_torch.constants import encode_ascii
from nthash_tpu_torch.ops import kmer_kernel, kmer_torch
from nthash_tpu_torch.ops.kmer_kernel import (
    hash_kmers_batch,
    hash_kmers_tm,
    hash_kmers_tm_auto,
    hash_kmers_tm_plain,
    prepare_codes,
)
from nthash_tpu_torch.u64 import to_numpy_u64
from test_golden import ACATG_VECTORS, README_K5, README_SEQ

KS = [1, 5, 9, 31, 32, 33, 64, 65, 100]
B, L = 5, 110


def _codes(rng, b=B, length=L):
    """Codes 0-5: 4 is N, 5 is any other byte the engines clamp to 4."""
    return rng.integers(0, 6, size=(b, length), dtype=np.uint8)


def _tm(codes):
    return prepare_codes(torch.from_numpy(codes))


@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("k", KS)
def test_tm_hashes_and_fwd_rev_vs_jnp(rng, k, h):
    codes = _codes(rng)
    ref = kmer_jnp.hash_kmers(jnp.asarray(codes), k, h)
    outs = hash_kmers_tm_plain(_tm(codes), k, h, emit_fwd_rev=True)
    assert len(outs) == h + 2
    assert all(o.shape == (L - k + 1, B) and o.dtype == torch.int64
               for o in outs)
    got = np.stack([to_numpy_u64(o).T for o in outs[:h]], axis=-1)
    assert np.array_equal(got, ref.hashes.to_np())
    assert np.array_equal(to_numpy_u64(outs[h]).T, ref.fwd.to_np())
    assert np.array_equal(to_numpy_u64(outs[h + 1]).T, ref.rev.to_np())
    plain = hash_kmers_tm_plain(_tm(codes), k, h)
    assert all(torch.equal(a, b) for a, b in zip(plain, outs[:h]))


@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("k", KS)
def test_tm_buckets_vs_jnp(rng, k, h):
    wlog = 12
    codes = _codes(rng)
    ref = kmer_jnp.hash_kmers(jnp.asarray(codes), k, h)
    want = np.where(np.asarray(ref.valid)[..., None],
                    (ref.hashes.to_np() & np.uint64((1 << wlog) - 1))
                    .astype(np.int32), 1 << wlog)
    outs = hash_kmers_tm_plain(_tm(codes), k, h, emit_buckets=wlog)
    assert all(o.dtype == torch.int32 for o in outs)
    got = np.stack([o.numpy().T for o in outs], axis=-1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("k", KS)
def test_batch_major_engine_vs_jnp(rng, k, h):
    codes = _codes(rng)
    ref = kmer_jnp.hash_kmers(jnp.asarray(codes), k, h)
    res = kmer_torch.hash_kmers(torch.from_numpy(codes), k, h)
    assert np.array_equal(to_numpy_u64(res.hashes), ref.hashes.to_np())
    assert np.array_equal(to_numpy_u64(res.fwd), ref.fwd.to_np())
    assert np.array_equal(to_numpy_u64(res.rev), ref.rev.to_np())
    assert np.array_equal(res.valid.numpy(), np.asarray(ref.valid))
    hashes, valid = hash_kmers_batch(torch.from_numpy(codes), k, h)
    assert torch.equal(hashes, res.hashes)
    assert torch.equal(valid, res.valid)


@pytest.mark.parametrize("k", KS)
def test_vs_oracle(rng, k):
    codes = rng.integers(0, 5, size=(2, L), dtype=np.uint8)
    res = kmer_torch.hash_kmers(torch.from_numpy(codes), k, 4)
    outs = hash_kmers_tm_plain(_tm(codes), k, 4, emit_fwd_rev=True)
    for b in range(2):
        fwd, rev, hashes, valid = oracle.hash_all_windows(codes[b], k, 4)
        assert np.array_equal(to_numpy_u64(res.hashes[b]), hashes)
        assert np.array_equal(res.valid[b].numpy(), valid)
        assert np.array_equal(to_numpy_u64(outs[4][:, b]), fwd)
        assert np.array_equal(to_numpy_u64(outs[5][:, b]), rev)


@pytest.mark.parametrize("k", [1, 5, 32])
def test_window_valid_vs_jnp(rng, k):
    codes = _codes(rng)
    want = np.asarray(kmer_jnp.window_valid(jnp.asarray(codes), k))
    assert np.array_equal(
        kmer_torch.window_valid(torch.from_numpy(codes), k).numpy(), want)
    tm = _tm(codes)
    want_tm = np.asarray(kmer_jnp.window_valid_tm(jnp.asarray(tm.numpy()), k))
    assert np.array_equal(kmer_torch.window_valid_tm(tm, k).numpy(), want_tm)


def test_plane_tables_vs_jnp():
    for k in KS:
        assert tuple(kmer_torch.plane_tables(k)) == tuple(kmer_jnp.plane_tables(k))


def test_golden_readme_k5():
    codes = np.tile(encode_ascii(README_SEQ), (3, 1))
    outs = hash_kmers_tm(_tm(codes), 5, 1, emit_fwd_rev=True)
    canon, fwd, rev = (to_numpy_u64(o) for o in outs)
    res = kmer_torch.hash_kmers(torch.from_numpy(codes[0]), 5, 1)
    for pos, f, r, c in README_K5:
        assert (fwd[pos] == f).all() and (rev[pos] == r).all()
        assert (canon[pos] == c).all()
        assert to_numpy_u64(res.hashes)[pos, 0] == c
        assert to_numpy_u64(res.fwd)[pos] == f
    assert res.valid.all()


def test_golden_acatg_multihash():
    codes = encode_ascii("ACATGCATGCA")[None]
    outs = [to_numpy_u64(o) for o in hash_kmers_tm(_tm(codes), 5, 3)]
    res = to_numpy_u64(kmer_torch.hash_kmers(torch.from_numpy(codes), 5, 3).hashes)
    for pos, vals in ACATG_VECTORS:
        assert tuple(int(o[pos, 0]) for o in outs) == vals
        assert tuple(int(x) for x in res[0, pos]) == vals


def test_buckets_vs_pallas_interpret(rng):
    """One tiny case through the Pallas kernel itself (interpret mode,
    eager: under jit its unrolled steps take minutes to compile)."""
    from nthash_tpu.ops import kmer_pallas

    codes = rng.integers(0, 6, size=(4, 21), dtype=np.uint8)
    with jax.disable_jit():
        tm_j = kmer_pallas.prepare_codes(jnp.asarray(codes), 1)
        want = kmer_pallas.hash_kmers_tm(tm_j, 5, 2, emit_buckets=10,
                                         interpret=True)
        want = [np.asarray(w)[:, :4] for w in want]
    got = hash_kmers_tm(_tm(codes), 5, 2, emit_buckets=10)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_prepare_codes_layout():
    codes = torch.tensor([[0, 1, 2, 3, 4, 5, 200]], dtype=torch.uint8)
    tm = prepare_codes(codes)
    assert tm.dtype == torch.int32 and tm.shape == (7, 1) and tm.is_contiguous()
    assert tm[:, 0].tolist() == [0, 1, 2, 3, 4, 4, 4]
    assert prepare_codes(torch.zeros((3, 30), dtype=torch.uint8)).shape == (30, 3)


def test_cpu_route_launches_no_kernel(rng):
    before = kmer_kernel.LAUNCHES
    hash_kmers_tm(_tm(_codes(rng)), 5, 2, emit_buckets=10)
    hash_kmers_tm(_tm(_codes(rng)), 5, 2)
    assert kmer_kernel.LAUNCHES == before


def test_auto_is_the_one_kernel(rng, monkeypatch):
    """Both routes of hash_kmers_tm_auto are the one kernel (kmer_hash.cu,
    one segment per read or segments of time_tile windows), picked by the
    occupancy rule, and give identical outputs."""
    calls = []
    for name in ("hash_kmers_tm", "hash_kmers_tm_long"):
        fn = getattr(kmer_kernel, name)
        monkeypatch.setattr(kmer_kernel, name,
                            lambda *a, _f=fn, _n=name, **kw:
                            calls.append(_n) or _f(*a, **kw))
    short = _tm(_codes(rng))                      # W = 102 <= the tile
    long = _tm(_codes(rng, length=700))           # W = 692 > 256
    for tm, route in ((short, "hash_kmers_tm"), (long, "hash_kmers_tm_long")):
        for mode in ({}, {"emit_fwd_rev": True}, {"emit_buckets": 10}):
            calls.clear()
            got = hash_kmers_tm_auto(tm, 9, 2, **mode)
            assert calls == [route]
            want = hash_kmers_tm_plain(tm, 9, 2, **mode)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    calls.clear()
    hash_kmers_tm_auto(long, 9, 2, time_tile=900)  # one tile holds the read
    assert calls == ["hash_kmers_tm"]


@pytest.mark.parametrize("length,k,reads,tile,segmented", [
    (150, 32, 4096, None, False),           # W = 119 <= 256: one segment
    (150, 32, 1 << 18, None, False),        # the main path's batch
    (288, 32, 4096, None, True),            # W = 257 > 256
    (287, 32, 4096, None, False),           # W = 256: exactly one tile
    (10_000, 32, 4096, None, True),         # the long-read batch
    (10_000, 32, (1 << 18) - 1, None, True),
    (10_000, 32, 1 << 18, None, False),     # one full wave of reads
    (1000, 5, 16, 1000, False),             # a tile >= W
    (1000, 5, 16, 995, True),
])
def test_long_read_threshold_rule(length, k, reads, tile, segmented):
    assert kmer_kernel.long_read_threshold(length, k, reads, tile) is segmented
    assert kmer_kernel.SEGMENT_BELOW_READS == 1 << 18


def test_long_read_threshold_rejects_bad_tile():
    with pytest.raises(ValueError, match="multiple of k"):
        kmer_kernel.long_read_threshold(1000, 32, 16, 100)


@pytest.mark.parametrize("bad,err", [
    (dict(codes=torch.zeros((10, 3), dtype=torch.int64)), TypeError),
    (dict(codes=torch.zeros((3, 10), dtype=torch.int32).T), ValueError),
    (dict(k=0), ValueError),
    (dict(k=11), ValueError),
    (dict(h=0), ValueError),
    (dict(emit_fwd_rev=True, emit_buckets=10), ValueError),
    (dict(emit_buckets=31), ValueError),
    (dict(codes=torch.zeros((10, 3), dtype=torch.int32, device="meta")),
     ValueError),
])
def test_wrapper_rejects(bad, err):
    codes = bad.get("codes", torch.zeros((10, 3), dtype=torch.int32))
    with pytest.raises(err):
        hash_kmers_tm(codes, bad.get("k", 5), bad.get("h", 1),
                      emit_fwd_rev=bad.get("emit_fwd_rev", False),
                      emit_buckets=bad.get("emit_buckets"))


def test_engine_rejects_short_and_bad_k():
    with pytest.raises(ValueError, match="smaller than k"):
        kmer_torch.hash_kmers(torch.zeros(4, dtype=torch.uint8), 5)
    with pytest.raises(ValueError, match="greater than 0"):
        kmer_torch.hash_kmers(torch.zeros(4, dtype=torch.uint8), 0)


# The one-sequence entry: its rules and its CPU route.


def test_sequence_rules():
    """Span: 64 windows for every 32 bases of k (256 for the seed entry
    without fwd/rev), the 32 ceil(k / 32) warm-up steps half of them (an
    eighth). Ring: the aligned chunks of 32
    bases c - M - 1 .. c, M = ceil(k / 32), a lane. Grid: 1 to 8 warps
    beside the tables; ValueError where one warp does not fit, now past k
    = 6,784 (a ring of power-of-two rows of 32 lanes stopped at 4,064)."""
    for k in (1, 5, 31, 32, 33, 64, 100, 1000, 4064, 4065):
        span = kmer_kernel.sequence_span(k)
        m = -(-k // 32)
        assert span % 64 == 0 and span == 64 * m and 32 * m * 2 == span
        assert kmer_kernel.sequence_span(k, seeds=True, emit_fwd_rev=True) \
            == span
        seeds = kmer_kernel.sequence_span(k, seeds=True)
        assert seeds == 256 * m and 32 * m * 8 == seeds
        ring = kmer_kernel.sequence_ring(k)
        assert ring % 32 == 0 and k + 64 <= ring < k + 96
        warps, r = kmer_kernel.sequence_grid(k)
        assert r == ring and warps in (1, 2, 4, 8)
    assert kmer_kernel.sequence_grid(32) == (8, 96)
    assert kmer_kernel.sequence_grid(4064) == (1, 4128)
    assert kmer_kernel.sequence_grid(4065) == (1, 4160)
    assert kmer_kernel.sequence_grid(6784) == (1, 6848)
    with pytest.raises(ValueError, match="shared memory"):
        kmer_kernel.sequence_grid(6785)
    with pytest.raises(ValueError, match="shared memory"):
        kmer_kernel.sequence_grid(1000, 1, 500, 1)


@pytest.mark.parametrize("emit_fwd_rev,limit", [(False, 6784), (True, 6528)])
def test_sequence_fits(emit_fwd_rev, limit):
    """k fits the one-sequence entry up to the last k whose one warp fits
    beside the tables (h = 1): k = 4,064 and 4,065, which a ring of
    power-of-two rows split, both fit; past the limit the wrappers' callers
    take ``hash_sequence_rows``. More hashes take more table bytes."""
    fits = kmer_kernel.sequence_fits
    assert fits(4064, 1, emit_fwd_rev) and fits(4065, 1, emit_fwd_rev)
    assert fits(limit, 1, emit_fwd_rev) and not fits(limit + 1, 1,
                                                     emit_fwd_rev)
    assert fits(limit, 1, emit_fwd_rev) == (
        kmer_kernel.sequence_warps(limit, 1, 1, 1, emit_fwd_rev) > 0)
    assert not fits(limit + 1, 64, emit_fwd_rev)
    assert not fits(100_000, 1, emit_fwd_rev)


@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("k,length", [(1, 40), (9, 700), (33, 1100),
                                      (100, 3000)])
def test_hash_sequence_rows_is_the_plain_route(rng, k, length, h):
    """``hash_sequence_rows`` (the read kernel over pseudo-reads, here its
    plain versions) gives ``hash_sequence_plain``'s outputs, fwd/rev too."""
    seq = torch.from_numpy(rng.integers(0, 7, size=(length,),
                                        dtype=np.uint8))
    for fr in (False, True):
        got, valid = kmer_kernel.hash_sequence_rows(seq, k, h,
                                                    emit_fwd_rev=fr)
        want, wvalid = kmer_kernel.hash_sequence_plain(seq, k, h,
                                                       emit_fwd_rev=fr)
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(valid, wvalid)


def test_sequence_codes_dtypes(rng):
    """uint8 passes as it is; any other integer dtype has every value
    outside 0-4 set to 4 before it is narrowed; the hashes then agree."""
    raw = rng.integers(-300, 300, size=500)
    want = torch.from_numpy(np.where((raw < 0) | (raw > 4), 4, raw)
                            .astype(np.uint8))
    for dtype in (torch.int64, torch.int32, torch.int16):
        got = kmer_kernel.sequence_codes(torch.from_numpy(raw).to(dtype))
        assert got.dtype == torch.uint8 and torch.equal(got, want)
    u8 = torch.from_numpy(rng.integers(0, 256, size=500, dtype=np.uint8))
    assert kmer_kernel.sequence_codes(u8) is not None
    a = kmer_kernel.hash_sequence(torch.from_numpy(raw), 9, 2)
    b = kmer_kernel.hash_sequence(want, 9, 2)
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1])
    with pytest.raises(TypeError):
        kmer_kernel.sequence_codes(torch.zeros(5))
    with pytest.raises(ValueError, match="sequence"):
        kmer_kernel.sequence_codes(torch.zeros((2, 5), dtype=torch.uint8))


@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("k", [1, 9, 32, 65])
def test_hash_sequence_vs_oracle(rng, k, h):
    """hash_sequence on a CPU tensor (its plain version) against the host
    oracle inside the sequence; the off-end windows hash the invalid code
    and are invalid; no kernel launch."""
    seq = rng.integers(0, 6, size=(700,), dtype=np.uint8)
    before = kmer_kernel.SEQUENCE_LAUNCHES
    got, valid = kmer_kernel.hash_sequence(torch.from_numpy(seq), k, h)
    assert kmer_kernel.SEQUENCE_LAUNCHES == before
    _, _, want, wvalid = oracle.hash_all_windows(seq, k, h)
    w = 700 - k + 1
    assert np.array_equal(np.stack([to_numpy_u64(g) for g in got], -1)[:w],
                          want)
    assert np.array_equal(valid.numpy()[:w], wvalid) and not valid[w:].any()
    padded = np.concatenate([seq, np.full(k - 1, 4, np.uint8)])
    _, _, tail, _ = oracle.hash_all_windows(padded, k, h)
    assert np.array_equal(np.stack([to_numpy_u64(g) for g in got], -1), tail)


@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("k", [1, 7, 32, 65])
def test_hash_sequence_fwd_rev_vs_jax(rng, k, h):
    """``emit_fwd_rev=True`` appends every window's fwd and rev to the
    hashes, each equal to ``kmer_jnp.hash_kmers``' on the windows inside
    the sequence, invalid windows (an N inside) included; the hashes and
    validity are those of the route without the flag."""
    seq = rng.integers(0, 6, size=(420,), dtype=np.uint8)
    got, valid = kmer_kernel.hash_sequence(torch.from_numpy(seq), k, h,
                                           emit_fwd_rev=True)
    base, bvalid = kmer_kernel.hash_sequence(torch.from_numpy(seq), k, h)
    assert len(got) == h + 2 and torch.equal(valid, bvalid)
    assert all(torch.equal(a, b) for a, b in zip(got[:h], base))
    ref = kmer_jnp.hash_kmers(jnp.asarray(seq), k, h)
    w = 420 - k + 1
    assert np.array_equal(to_numpy_u64(got[h])[:w], ref.fwd.to_np())
    assert np.array_equal(to_numpy_u64(got[h + 1])[:w], ref.rev.to_np())
    assert np.array_equal(np.stack([to_numpy_u64(g) for g in got[:h]],
                                   -1)[:w], ref.hashes.to_np())
    plain, _ = kmer_kernel.hash_sequence_plain(torch.from_numpy(seq), k, h,
                                               emit_fwd_rev=True)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_sequence_grid_fwd_rev_stage():
    """The fwd/rev route's warp holds a second stage plane, spaced seeds
    their states (and, without fwd/rev, runs of 16 windows, not 32): the
    warps a block are those of 8, 4, 2, 1 that fit beside the tables and
    leave the most warps resident in a multiprocessor's shared memory (the
    larger on a tie); the route without the flag keeps its grid; 560 care
    runs of tables leave no room."""
    assert kmer_kernel.sequence_run() == 32
    assert kmer_kernel.sequence_run(True, seeds=True) == 32
    assert kmer_kernel.sequence_run(False, seeds=True) == 16
    assert kmer_kernel.sequence_grid(32) == (8, 96)
    assert kmer_kernel.sequence_grid(32, emit_fwd_rev=True) == (2, 96)
    assert kmer_kernel.sequence_grid(4064, emit_fwd_rev=True) == (1, 4128)
    assert kmer_kernel.sequence_grid(5, 2, 5, 1, True, seeds=True) == (8, 96)
    assert kmer_kernel.sequence_warps(32, 1, 500, 1) == 2
    assert kmer_kernel.sequence_warps(32, 1, 500, 1, emit_fwd_rev=True) == 1

    def resident(tables, per_warp, warps):
        smem = tables + warps * per_warp
        if smem > kmer_kernel.MAX_SHARED_BYTES:
            return 0
        return warps * min(233472 // (smem + 1024), 64 // warps)

    for k, nseeds, nruns in ((1, 1, 1), (97, 1, 1), (1000, 1, 1),
                             (32, 1, 500), (32, 1, 550), (5, 2, 5),
                             (81, 4, 46)):
        tables = kmer_kernel.sequence_tables_bytes(nseeds, nruns, 1)
        ring = (kmer_kernel.sequence_ring(k) // 4 + 8) * 128
        for fr, seeds, per_warp in (
                (False, False, ring + 8192), (True, False, ring + 2 * 8192),
                (False, True, ring + 4096 + 512 * nseeds),
                (True, True, ring + 2 * 8192 + 512 * nseeds)):
            got = kmer_kernel.sequence_warps(k, nseeds, nruns, 1, fr,
                                             seeds=seeds)
            best = max(resident(tables, per_warp, w) for w in (8, 4, 2, 1))
            assert got in (0, 1, 2, 4, 8)
            if not got:
                assert best == 0
                continue
            assert resident(tables, per_warp, got) == best
            assert all(resident(tables, per_warp, w) < best
                       for w in (8, 4, 2, 1) if w > got)
    with pytest.raises(ValueError, match="care runs"):
        kmer_kernel.sequence_grid(32, 1, 560, 1, emit_fwd_rev=True)