"""The benchmark's plain ntHash2 against the reference library's golden
vectors (values copied from the repository's golden tests), and its counts
and words against loops."""

import torch

from portbench.core import nthash_ref as ref

ASCII = {c: i for i, c in enumerate("ACGT")}


def codes_of(seq: str) -> torch.Tensor:
    return torch.tensor([[ASCII.get(c, 4) for c in seq]], dtype=torch.uint8)


def u64(t: torch.Tensor) -> list[int]:
    return [v & ref.M64 for v in t.reshape(-1).tolist()]


README_SEQ = "TGACTGATCGAGTCGTACTAG"
# (pos, canonical) of NtHash(README_SEQ, h=1, k=5)
README_K5 = [(0, 0x606F60C2A6FD7D2D), (1, 0x723E08B88C5BCF76),
             (2, 0x206F60C3AAF15B11), (3, 0xA09B4D553C4C3956),
             (4, 0x23594560032F40CF), (5, 0x8AF7FD017EA394E0),
             (6, 0x01F64B3DDAB26A18), (7, 0xA95E79797A9B31C3),
             (8, 0x2614616542EF37F2), (9, 0x4697FEA66C205DC3),
             (10, 0xD05FA29E0748E97E), (11, 0x73650B87C8BE71FA),
             (12, 0xC2CEC351AC77A909), (13, 0xEE30F1ABC88E13B5),
             (14, 0x16D3E327CC56807E), (15, 0x7947FE69B3E0ADAB),
             (16, 0x80D9E6D93C77AD71)]
# NtHash("ACATGCATGCA", h=3, k=5), windows 1 and 2
ACATG = [(1, (0x38CC00F940AEBDAE, 0xAB7E1B110E086FC6, 0x011A1818BCFDD553)),
         (2, (0x603A48C5A11C794A, 0xE66016E61816B9C4, 0xC5B13CB146996FFE))]
SEQ_N = ("GATTACAGATTACACCTTGGAACCNGGTTCCAAGGTTCCAAGG"
         "ACGTACGTACGTAGCTAGCTAGCTAGGCCATGCATGG")
# (pos, hash0, hash1) of NtHash(SEQ_N, h=2, k=32): the first valid windows
K32H2 = [(25, 0x6A700398DCA560DD, 0xF9A3181AD954FBA0),
         (26, 0xDB5A495371A0C110, 0x08367150FE5DDF2F),
         (27, 0x8150BE9CAE1F0869, 0x1FD929DC8CE3C247),
         (28, 0x85C2B62DFDCF2320, 0xF6F0BF8263AB38B7),
         (29, 0xAEC74E563F7D6DED, 0xBAD1D1CF6AB0072B)]
# (pos, hash0, hash1, hash2) of NtHash(SEQ_N with N -> T, h=3, k=65)
K65H3 = [(0, 0x571516A5C657DC79, 0x64B624242C288B34, 0x5F76E03C89387E54),
         (1, 0xBD8E87E893A19233, 0x8A86FE30A9565ABE, 0x51DB666205C82AEF),
         (2, 0x794DDB481409906D, 0x5C99BA3F38F342CA, 0xF0B0284279A25895)]


def test_readme_k5():
    (h0,) = ref.window_hashes(codes_of(README_SEQ), 5, 1)
    got = u64(h0)
    for pos, want in README_K5:
        assert got[pos] == want


def test_extensions_k5():
    hs = [u64(h) for h in ref.window_hashes(codes_of("ACATGCATGCA"), 5, 3)]
    for pos, want in ACATG:
        assert tuple(h[pos] for h in hs) == want


def test_k32_with_n():
    c = codes_of(SEQ_N)
    h0, h1 = (u64(h) for h in ref.window_hashes(c, 32, 2))
    valid = ref.window_valid(c, 32)[0].tolist()
    assert valid.index(True) == 25 and not any(valid[:25])
    for pos, a, b in K32H2:
        assert (h0[pos], h1[pos]) == (a, b)


def test_k65_past_the_rotation_period():
    hs = [u64(h) for h in ref.window_hashes(codes_of(SEQ_N.replace("N", "T")),
                                            65, 3)]
    for pos, *want in K65H3:
        assert [h[pos] for h in hs] == want


def test_control_words_differ():
    """In 32-bit words the canonical hash keeps its low 32 bits; the
    extensions' buckets take bits 32-54 of the product and change."""
    c = codes_of(SEQ_N.replace("N", "T"))
    full = ref.window_buckets(c, 32, 4, 28)
    cut = ref.window_buckets(c, 32, 4, 28, bits=32)
    assert torch.equal(full[0], cut[0])
    assert (full[1:] != cut[1:]).float().mean() > 0.9


def rand_codes(n=40, length=60, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = torch.randint(0, 4, (n, length), generator=g, dtype=torch.uint8)
    c[torch.rand((n, length), generator=g) < 0.02] = 4
    return c


def test_row_counts_vs_loop():
    c, k, h, wl = rand_codes(), 21, 3, 10
    got = ref.row_counts(c, k, h, wl, block=7)
    want = torch.zeros_like(got)
    hs = ref.window_hashes(c, k, h)
    valid = ref.window_valid(c, k)
    for i in range(h):
        for r in range(c.shape[0]):
            for w in range(valid.shape[1]):
                if valid[r, w]:
                    want[i, int(hs[i][r, w]) & ((1 << wl) - 1)] += 1
    assert torch.equal(got, want)
    assert int(got.sum()) == h * int(valid.sum())


def test_bloom_words_layout():
    c, k, h, wl = rand_codes(seed=1), 15, 2, 13
    words = ref.pack_words(ref.presence(c, k, h, wl, block=9))
    want = torch.zeros_like(words)
    for b in ref.window_buckets(c, k, h, wl).reshape(-1).tolist():
        w = ((b >> 12) << 7) | (b & 127)
        want[w] |= torch.tensor(1 << ((b >> 7) & 31)).to(torch.int32)
    assert torch.equal(words, want)
    assert torch.equal(ref.word_of(torch.tensor([5000, 4096 * 3 + 127])),
                       torch.tensor([(1 << 7) | (5000 & 127), 3 * 128 + 127]))
