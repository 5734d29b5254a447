"""The screening cell's yardstick: the benchmark's plain spaced-seed hash
(``core/seed_ref.py``) against the reference library's golden vectors and
the program's direct engine, the configuration's seeds and sizing, and the
kernel lists its roofline readers hold the program's spans to."""

import math

import pytest
import torch

from nthash_tpu_torch.ops.seed_torch import hash_kmers_seeds
from portbench.core import nthash_ref, seed_ref, spec

CELL = "screen_short_resident"
ASCII = {c: i for i, c in enumerate("ACGT")}
#: SeedNtHash("ACATGCATGCA", {"11100111"}, h=3): (pos, hashes), the
#: reference library's tests/tests.cpp:228-248.
SEED_VECTORS = [
    (0, (0x010BE4904AD8DE5D, 0x3E29E4F4C991628C, 0x3F35C984B13FEB20)),
    (1, (0x8200A7AA3EAF17C8, 0x344198402F4C2A9C, 0xB6423FE62E69C40C)),
    (2, (0x3CE8ADCBEAA56532, 0x162E91A4DBEDBF11, 0x53173F786A031F45)),
]


def codes_of(seq: str) -> torch.Tensor:
    return torch.tensor([[ASCII.get(c, 4) for c in seq]], dtype=torch.uint8)


def config() -> dict:
    return spec.cell(CELL).config


def test_golden_spaced_seed_vectors():
    hs = [[v & nthash_ref.M64 for v in h[0].tolist()] for h in
          seed_ref.window_hashes(codes_of("ACATGCATGCA"), "11100111", 3)]
    for pos, want in SEED_VECTORS:
        assert tuple(h[pos] for h in hs) == want


def test_all_care_seed_is_the_kmer_hash():
    c = codes_of("GATTACAGATTACACCTTGGAACCAGGTTCCAAGGTTCCAAGG")
    for a, b in zip(seed_ref.window_hashes(c, "1" * 32, 4),
                    nthash_ref.window_hashes(c, 32, 4)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seeds, h", [(None, 4), (("10101", "11011"), 3)])
def test_vs_the_programs_direct_engine(seeds, h):
    """Random reads with N, the configuration's four patterns (and the toy
    pair): every hash of every valid window is the program's
    ``seed_torch.hash_kmers_seeds``, which computes each window directly."""
    seeds = seeds or tuple(config()["seeds"])
    g = torch.Generator().manual_seed(2**31 + 3)
    codes = torch.randint(0, 4, (40, 90), generator=g, dtype=torch.uint8)
    codes[torch.rand(codes.shape, generator=g) < 0.01] = 4
    want = hash_kmers_seeds(codes, seeds, h)
    valid = nthash_ref.window_valid(codes, len(seeds[0]))
    assert torch.equal(valid, want.valid)
    for s, seed in enumerate(seeds):
        for i, got in enumerate(seed_ref.window_hashes(codes, seed, h)):
            assert torch.equal(got[valid], want.hashes[..., s * h + i][valid])


def test_buckets_mark_invalid_windows():
    c = codes_of("ACGTACGTNACGTACGTA")
    bk = seed_ref.window_buckets(c, ("10101", "11011"), 2, 12)
    assert bk.shape == (2, 2, 1, 14)
    valid = nthash_ref.window_valid(c, 5)[0]
    assert bool((bk[..., 0, ~valid] == -1).all())
    assert bool((bk[..., 0, valid] >= 0).all() and (bk < 4096).all())


def test_control_hashes_differ():
    c = codes_of("ACATGCATGCAGGTACCATTGACCATGACGTTACGATCGTAGCTAGCATCG")
    seed = config()["seeds"][0]
    full = seed_ref.window_buckets(c, (seed,), 4, 28)
    cut = seed_ref.window_buckets(c, (seed,), 4, 28, bits=32)
    assert torch.equal(full[:, 0], cut[:, 0])
    assert (full[:, 1:] != cut[:, 1:]).float().mean() > 0.9


def test_seeds_and_sizing():
    """Four symmetric 32-position patterns of 26 care positions, no
    position a don't-care in two of them; the filter the next power of two
    past BioBloomMaker's FPR 0.0075 at h = 4."""
    cfg = config()
    seeds = cfg["seeds"]
    assert len(seeds) == 4 and {len(s) for s in seeds} == {cfg["k"]}
    for s in seeds:
        assert s == s[::-1] and s.count("1") == 26
    zeros = [{i for i, ch in enumerate(s) if ch == "0"} for s in seeds]
    assert all(not a & b for i, a in enumerate(zeros) for b in zeros[i + 1:])
    n = len(seeds) * (cfg["genome_length"] - cfg["k"] + 1)
    h = cfg["num_hashes"]

    def fpr(width_log2):
        return (1 - math.exp(-h * n / 2**width_log2)) ** h

    assert fpr(cfg["width_log2"]) < 0.0075 < fpr(cfg["width_log2"] - 1)


def test_readers_name_the_cells_layers():
    readers = [spec.module("metrics", m["name"])
               for m in spec.cell(CELL).per_layer]
    got = {r.SPAN: r.KERNELS for r in readers
           if hasattr(r, "SPAN") and hasattr(r, "KERNELS")}
    assert got == {"nthash.seed": ("seed_staged_kernel", "seed_hash_kernel"),
                   "nthash.probe": ("bloom_probe_kernel",)}
