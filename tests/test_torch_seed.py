"""The port's spaced-seed engines against the JAX package, exactly.

``seed_torch.hash_kmers_seeds`` (the direct per-care-position reference)
is held against ``seed_jnp.hash_kmers_seeds``; ``hash_seeds_tm`` and
``hash_seeds_tm_long`` on a CPU tensor (their plain two-tap rolls) against
``seed_jnp`` at every seed shape and time tile, and against the Pallas
kernels in interpret mode at the JAX tests' own sizes; the SEED18 and
BASELINE golden vectors go through the batched engines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nthash_tpu import oracle
from nthash_tpu.ops import kmer_pallas, seed_jnp, seed_pallas
from nthash_tpu_torch.constants import encode_ascii
from nthash_tpu_torch.ops import kmer_kernel, seed_kernel, seed_torch
from nthash_tpu_torch.ops.kmer_kernel import prepare_codes
from nthash_tpu_torch.ops.seed_kernel import (
    hash_seeds_batch,
    hash_seeds_tm,
    hash_seeds_tm_auto,
    hash_seeds_tm_long,
    hash_seeds_tm_long_plain,
    hash_seeds_tm_plain,
)
from nthash_tpu_torch.u64 import to_numpy_u64
from test_golden_extended import SEED18, SEEDS18, SEQ_N

BASELINE = ("10101", "11011")
SEED_SETS = {
    "baseline": BASELINE,
    "seeds18": SEEDS18,
    "one_care": ("00100",),
    "one_base": ("1",),
    "zero_ends": ("0110", "0101"),
    "three": ("1100111", "1010101", "0111110"),
    "wide": ("1" * 8 + "0" * 24 + "1" * 8,),
}


def _tm(codes):
    return prepare_codes(torch.from_numpy(codes))


def _u64(outs):
    return [to_numpy_u64(o) if o.dtype == torch.int64 else o.numpy()
            for o in outs]


def _jnp_planes(codes, seeds, h, mode):
    """seed_jnp's result in the wrappers' per-plane [W, R] hash_arr order."""
    ref = seed_jnp.hash_kmers_seeds(jnp.asarray(codes), tuple(seeds), h)
    hashes, valid = ref.hashes.to_np(), np.asarray(ref.valid)
    planes = []
    for s in range(len(seeds)):
        group = [hashes[..., s * h + i] for i in range(h)]
        if "emit_buckets" in mode:
            wl = mode["emit_buckets"]
            group = [np.where(valid, g & np.uint64((1 << wl) - 1), 1 << wl)
                     .astype(np.int32) for g in group]
        elif mode.get("emit_fwd_rev"):
            group += [ref.fwd.to_np()[..., s], ref.rev.to_np()[..., s]]
        planes += [g.T for g in group]
    return planes


@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("name", list(SEED_SETS))
def test_direct_engine_vs_jnp(rng, name, h):
    seeds = SEED_SETS[name]
    codes = rng.integers(0, 6, size=(5, 90), dtype=np.uint8)
    ref = seed_jnp.hash_kmers_seeds(jnp.asarray(codes), seeds, h)
    got = seed_torch.hash_kmers_seeds(torch.from_numpy(codes), seeds, h)
    assert np.array_equal(to_numpy_u64(got.hashes), ref.hashes.to_np())
    assert np.array_equal(to_numpy_u64(got.fwd), ref.fwd.to_np())
    assert np.array_equal(to_numpy_u64(got.rev), ref.rev.to_np())
    assert np.array_equal(got.valid.numpy(), np.asarray(ref.valid))
    one = seed_torch.hash_kmers_seeds(torch.from_numpy(codes[0]), seeds, h)
    assert torch.equal(one.hashes, got.hashes[0])


@pytest.mark.parametrize("name", list(SEED_SETS))
def test_block_decomposition_vs_oracle(name):
    seeds = SEED_SETS[name]
    assert seed_torch.get_blocks(seeds) == oracle.get_blocks(seeds)
    assert seed_torch.care_positions(seeds) == seed_jnp.care_positions(seeds)
    assert seed_kernel.care_runs(seeds[0]) == seed_pallas.care_runs(seeds[0])
    for s in seeds:
        assert [tuple(t) for t in seed_kernel.seed_taps(s)] == \
            [tuple(t) for t in seed_pallas.seed_taps(s)]


@pytest.mark.parametrize("mode", [{}, {"emit_fwd_rev": True},
                                  {"emit_buckets": 11}],
                         ids=["hashes", "fwd_rev", "buckets"])
@pytest.mark.parametrize("name", list(SEED_SETS))
def test_tm_vs_jnp(rng, name, mode):
    seeds = SEED_SETS[name]
    codes = rng.integers(0, 6, size=(7, 80), dtype=np.uint8)
    got = hash_seeds_tm(_tm(codes), seeds, 2, **mode)
    want = _jnp_planes(codes, seeds, 2, mode)
    assert len(got) == len(want)
    for g, w in zip(_u64(got), want):
        assert g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("mult", [1, 2, 3, 100])
@pytest.mark.parametrize("name", ["baseline", "seeds18", "one_base",
                                  "zero_ends", "three"])
def test_long_vs_jnp_across_time_tiles(rng, name, mult):
    """Time tiles k, 2k, 3k and >= W; L not a multiple of the tile."""
    seeds = SEED_SETS[name]
    k = len(seeds[0])
    codes = rng.integers(0, 6, size=(3, 7 * k + 3), dtype=np.uint8)
    tm = _tm(codes)
    for mode in ({"emit_fwd_rev": True}, {"emit_buckets": 9}):
        got = hash_seeds_tm_long(tm, seeds, 2, time_tile=mult * k, **mode)
        for g, w in zip(_u64(got), _jnp_planes(codes, seeds, 2, mode)):
            assert np.array_equal(g, w)
        assert all(torch.equal(a, b) for a, b in zip(
            got, hash_seeds_tm_plain(tm, seeds, 2, **mode)))


def test_tm_vs_pallas_interpret_fwd_rev(rng):
    """Hashes + fwd/rev through the Pallas kernel itself (interpret mode,
    eager), at tests/test_seed_pallas.py's size."""
    b, length, seeds = 4, 10, ("110011",)
    codes = rng.integers(0, 4, size=(b, length), dtype=np.uint8)
    with jax.disable_jit():
        tm = kmer_pallas.prepare_codes(jnp.asarray(codes), 1)
        want = [o.to_np()[:, :b] for o in seed_pallas.hash_seeds_tm(
            tm, seeds, 1, interleave=1, emit_fwd_rev=True, interpret=True)]
    got = hash_seeds_tm(_tm(codes), seeds, 1, emit_fwd_rev=True)
    assert len(got) == 3
    for g, w in zip(_u64(got), want):
        assert np.array_equal(g, w)


def test_long_vs_pallas_interpret_buckets(rng):
    """Buckets through the time-tiled Pallas kernel (interpret mode,
    eager): three time tiles of k, the last padded."""
    b, length, seeds, wl = 2, 12, ("10101",), 10
    codes = rng.integers(0, 6, size=(b, length), dtype=np.uint8)
    with jax.disable_jit():
        tm = kmer_pallas.prepare_codes(jnp.asarray(codes), 1)
        want = [np.asarray(o)[:, :b] for o in seed_pallas.hash_seeds_tm_long(
            tm, seeds, 2, time_tile=5, emit_buckets=wl, interpret=True)]
    got = hash_seeds_tm_long(_tm(codes), seeds, 2, time_tile=5,
                             emit_buckets=wl)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("route", ["tm", "long", "batch"])
def test_seed18_goldens(route):
    """The reference's 18-wide two-seed vectors (N hashes as the zero seed)
    through the batched engines, as test_seed18_engine_direct does."""
    codes = np.tile(encode_ascii(SEQ_N), (3, 1))
    if route == "batch":
        hashes, _ = hash_seeds_batch(torch.from_numpy(codes), SEEDS18, 2)
        got = to_numpy_u64(hashes)[1]
    else:
        fn = hash_seeds_tm if route == "tm" else hash_seeds_tm_long
        kw = {} if route == "tm" else {"time_tile": 18}
        outs = fn(_tm(codes), SEEDS18, 2, **kw)
        got = np.stack([to_numpy_u64(o)[:, 1] for o in outs], axis=-1)
    for pos, *want in SEED18:
        assert list(got[pos]) == want


def test_baseline_goldens():
    """SURVEY.md section 8's spaced-seed vectors (seeds 10101 and 11011,
    h=3, k=5), as tests/test_seed_pallas.py::test_kernel_golden checks."""
    codes = np.tile(encode_ascii("TGACTGATCGAGTCGTACTAG"), (4, 1))
    hashes, _ = hash_seeds_batch(torch.from_numpy(codes), BASELINE, 3)
    h = to_numpy_u64(hashes)
    assert h[0, 0, 0] == 0x9F8F9FBF890D6351
    assert h[0, 0, 3] == 0x7539D859409E5B0A
    assert h[2, 1, 5] == 0xA2B26F83A7BF55DE
    assert h[3, 2, 0] == 0x9F8F9FBF890D6351


@pytest.mark.parametrize("name", ["baseline", "three"])
def test_batch_vs_jnp(rng, name):
    seeds = SEED_SETS[name]
    codes = rng.integers(0, 6, size=(6, 50), dtype=np.uint8)
    hashes, valid = hash_seeds_batch(torch.from_numpy(codes), seeds, 2)
    ref = seed_jnp.hash_kmers_seeds(jnp.asarray(codes), seeds, 2)
    assert np.array_equal(to_numpy_u64(hashes), ref.hashes.to_np())
    assert np.array_equal(valid.numpy(), np.asarray(ref.valid))


def test_strict_validity_covers_dont_care(rng):
    """An N at a don't-care position still makes the window invalid in
    bucket mode (seed_pallas.py:25-27), while its hash is emitted."""
    codes = np.zeros((1, 9), np.uint8)
    codes[0, 1] = 4                       # don't-care of "10101" at window 0
    got = hash_seeds_tm(_tm(codes), ("10101",), 1, emit_buckets=8)[0][:, 0]
    assert got.tolist()[:2] == [256, 256] and got.tolist()[2] != 256
    hashes = hash_seeds_tm(_tm(codes), ("10101",), 1)[0][:, 0]
    direct = seed_torch.hash_kmers_seeds(torch.from_numpy(codes[0]),
                                         ("10101",)).hashes[:, 0]
    assert torch.equal(hashes, direct)


def test_auto_dispatch(rng, monkeypatch):
    calls = []
    for name in ("hash_seeds_tm", "hash_seeds_tm_long"):
        fn = getattr(seed_kernel, name)
        monkeypatch.setattr(seed_kernel, name,
                            lambda *a, _f=fn, _n=name, **kw:
                            calls.append(_n) or _f(*a, **kw))
    short = _tm(rng.integers(0, 6, size=(3, 150), dtype=np.uint8))
    long = _tm(rng.integers(0, 6, size=(3, 400), dtype=np.uint8))
    for tm, route in ((short, "hash_seeds_tm"), (long, "hash_seeds_tm_long")):
        calls.clear()
        got = hash_seeds_tm_auto(tm, BASELINE, 2)
        assert calls == [route]
        assert all(torch.equal(a, b) for a, b in zip(
            got, hash_seeds_tm_plain(tm, BASELINE, 2)))


def test_cpu_route_launches_no_kernel(rng):
    before = (seed_kernel.LAUNCHES, seed_kernel.LONG_LAUNCHES)
    tm = _tm(rng.integers(0, 6, size=(3, 40), dtype=np.uint8))
    hash_seeds_tm(tm, BASELINE, 1)
    hash_seeds_tm_long(tm, BASELINE, 1, time_tile=5)
    assert (seed_kernel.LAUNCHES, seed_kernel.LONG_LAUNCHES) == before


@pytest.mark.parametrize("seeds,kw,match", [
    (("101", "1101"), {}, "equal length"),
    (("000",), {}, "no care positions"),
    (("10101", "00000"), {}, "no care positions"),
    ((), {}, "at least one seed"),
    (BASELINE, {"emit_fwd_rev": True, "emit_buckets": 10}, "exclusive"),
    (BASELINE, {"emit_buckets": 39}, "emit_buckets"),
    (("1" * 41,), {}, "smaller than k"),
])
def test_wrappers_reject(seeds, kw, match):
    tm = torch.zeros((40, 3), dtype=torch.int32)
    for fn in (hash_seeds_tm, hash_seeds_tm_long, hash_seeds_tm_plain,
               hash_seeds_tm_long_plain):
        with pytest.raises(ValueError, match=match):
            fn(tm, seeds, 1, **kw)


def test_wrappers_reject_layout_and_tile():
    with pytest.raises(TypeError):
        hash_seeds_tm(torch.zeros((40, 3), dtype=torch.int64), BASELINE)
    with pytest.raises(ValueError, match="contiguous"):
        hash_seeds_tm(torch.zeros((3, 40), dtype=torch.int32).T, BASELINE)
    with pytest.raises(ValueError, match="multiple of k"):
        hash_seeds_tm_long(torch.zeros((40, 3), dtype=torch.int32), BASELINE,
                           time_tile=12)
    with pytest.raises(ValueError, match="num_hashes"):
        hash_seeds_tm(torch.zeros((40, 3), dtype=torch.int32), BASELINE, 0)
    with pytest.raises(ValueError, match="equal length"):
        seed_torch.hash_kmers_seeds(torch.zeros((2, 9), dtype=torch.uint8),
                                    ("101", "11"))


# The staged kernel's route rule and tables, and the one-sequence entry.


def test_seed_grid_rule():
    """(warps, ring rows) from the shapes: up to 8 warps a block beside the
    pair tables; a ring of the smallest power of two >= k + 32; (0, 0),
    the global kernel, where one warp does not fit."""
    assert seed_kernel.seed_grid(5, 2, 5, 3) == (8, 64)
    assert seed_kernel.seed_grid(32, 1, 1, 1) == (8, 64)
    assert seed_kernel.seed_grid(33, 1, 1, 1) == (8, 128)
    assert seed_kernel.seed_grid(3002, 1, 2, 1) == (1, 4096)
    assert seed_kernel.seed_grid(1000, 1, 500, 1) == (0, 0)
    for k, s, runs, h in ((5, 2, 5, 3), (81, 1, 41, 2), (200, 4, 300, 4),
                          (3002, 1, 2, 1)):
        warps, ring = seed_kernel.seed_grid(k, s, runs, h)
        need = seed_kernel.tables_bytes(s, runs, h) + warps * (
            ring * 32 + s * 32 * 16)
        assert need <= seed_kernel.MAX_SHARED_BYTES
        assert ring >= k + 32 and ring & (ring - 1) == 0 and ring // 2 < k + 32
        assert warps * 2 > 8 or need + warps * (ring * 32 + s * 512) \
            > seed_kernel.MAX_SHARED_BYTES


@pytest.mark.parametrize("name", list(SEED_SETS))
def test_pair_tables_are_the_two_taps(name):
    """Entry 5 c_in + c_out of a run is the XOR of its entering and leaving
    taps, fwd then rev; code 4 leaves a tap out."""
    for taps in seed_kernel._all_taps(SEED_SETS[name]):
        vals = seed_kernel.pair_tables(taps)
        assert len(vals) == 50 * len(taps)
        for q, b in enumerate(taps):
            for ci in range(5):
                for co in range(5):
                    at = 50 * q + 2 * (5 * ci + co)
                    assert vals[at] == b.fwd_in[ci] ^ b.fwd_out[co]
                    assert vals[at + 1] == b.rev_in[ci] ^ b.rev_out[co]
            assert vals[50 * q + 2 * 24] == 0 and vals[50 * q + 2 * 4] \
                == b.fwd_in[0]


@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("name", ["baseline", "seeds18", "one_base",
                                  "three"])
def test_seeds_sequence_vs_oracle(rng, name, h):
    """The one-sequence entry's CPU route against the host oracle on the
    windows inside the sequence, and invalid past its end."""
    seeds = SEED_SETS[name]
    seq = rng.integers(0, 7, size=(333,), dtype=np.uint8)
    got, valid = seed_kernel.hash_seeds_sequence(torch.from_numpy(seq), seeds,
                                                 h)
    _, _, want = oracle.hash_all_windows_seeds(seq, seeds, h)
    w = 333 - len(seeds[0]) + 1
    assert np.array_equal(np.stack([to_numpy_u64(g) for g in got], -1)[:w],
                          want)
    assert len(got[0]) == 333 and not valid[w:].any()
    assert torch.equal(valid[:w], seed_torch.hash_kmers_seeds(
        torch.from_numpy(seq), seeds).valid)


def test_seeds_sequence_rejects():
    seq = torch.zeros(50, dtype=torch.uint8)
    for seeds, match in ((("101", "11"), "equal length"),
                         (("000",), "no care positions"), ((), "at least")):
        with pytest.raises(ValueError, match=match):
            seed_kernel.hash_seeds_sequence(seq, seeds, 1)
    with pytest.raises(ValueError, match="num_hashes"):
        seed_kernel.hash_seeds_sequence(seq, BASELINE, 0)
    with pytest.raises(ValueError, match="empty"):
        seed_kernel.hash_seeds_sequence(seq[:0], BASELINE, 1)
    with pytest.raises(TypeError):
        seed_kernel.hash_seeds_sequence(seq.float(), BASELINE, 1)


@pytest.mark.parametrize("name", ["baseline", "seeds18", "one_care",
                                  "zero_ends"])
def test_seeds_sequence_fwd_rev_vs_jax(rng, name):
    """``emit_fwd_rev=True`` follows each seed's group by its fwd and rev,
    equal to ``seed_jnp.hash_kmers_seeds``' at every window inside the
    sequence (invalid ones included, N as the zero seed); the pseudo-read
    route through B1 (``hash_seeds_sequence_rows``) gives the same planes."""
    seeds = SEED_SETS[name]
    k, h, s = len(seeds[0]), 2, len(seeds)
    seq = rng.integers(0, 6, size=(300,), dtype=np.uint8)
    got, valid = seed_kernel.hash_seeds_sequence(torch.from_numpy(seq), seeds,
                                                 h, emit_fwd_rev=True)
    assert len(got) == s * (h + 2)
    ref = seed_jnp.hash_kmers_seeds(jnp.asarray(seq), seeds, h)
    w = 300 - k + 1
    fwd, rev, hashes = ref.fwd.to_np(), ref.rev.to_np(), ref.hashes.to_np()
    for si in range(s):
        group = got[si * (h + 2):(si + 1) * (h + 2)]
        for i in range(h):
            assert np.array_equal(to_numpy_u64(group[i])[:w],
                                  hashes[:, si * h + i])
        assert np.array_equal(to_numpy_u64(group[h])[:w], fwd[:, si])
        assert np.array_equal(to_numpy_u64(group[h + 1])[:w], rev[:, si])
    rows, rvalid = seed_kernel.hash_seeds_sequence_rows(
        torch.from_numpy(seq), seeds, h, emit_fwd_rev=True)
    assert all(torch.equal(a, b) for a, b in zip(rows, got))
    assert torch.equal(rvalid, valid)
    base, bvalid = seed_kernel.hash_seeds_sequence(torch.from_numpy(seq),
                                                   seeds, h)
    assert torch.equal(bvalid, valid)
    assert all(torch.equal(base[si * h + i], got[si * (h + 2) + i])
               for si in range(s) for i in range(h))


def test_sequence_fits():
    """Where the seeds fit the one-sequence entry, decided from the shapes:
    the BASELINE seeds do, 600 care runs do not (then the facade and
    ``sp.hash_long_sequence_seeds`` take B1 over pseudo-reads), nor do
    1,200, nor a seed of k = 7,000; four seeds of 41 care runs do, and a
    seed of k = 6,784, the k-mer entry's limit."""
    assert seed_kernel.sequence_fits(BASELINE, 3, True)
    many = ("10" * 600,)
    assert not seed_kernel.sequence_fits(many, 1, False)
    assert not seed_kernel.sequence_fits(many, 1, True)
    assert not seed_kernel.sequence_fits(("10" * 1200,), 1, False)
    assert seed_kernel.sequence_fits(("10" * 40 + "1",) * 4, 1, True)
    wide = ("1" + "0" * 6782 + "1",)
    assert kmer_kernel.sequence_fits(len(wide[0]))
    assert seed_kernel.sequence_fits(wide)
    assert not seed_kernel.sequence_fits(("1" + "0" * 6998 + "1",))