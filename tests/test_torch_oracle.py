"""The port's host oracle (``nthash_tpu_torch/oracle.py``) against the JAX
package's, function by function, and against SURVEY §8's golden vectors.

Inputs are made from a seed with numpy; every comparison is exact.
"""

import numpy as np
import pytest

from nthash_tpu import oracle as joracle
from nthash_tpu import typedefs as jtypedefs
from nthash_tpu_torch import oracle, typedefs
from nthash_tpu_torch.ops import seed_torch

# SURVEY §8: NtHash("TGACTGATCGAGTCGTACTAG", h=1, k=5), (fwd, rev, canonical)
README = "TGACTGATCGAGTCGTACTAG"
README_K5 = [
    (0x2C984DF375275F54, 0x33D712CF31D61DD9, 0x606F60C2A6FD7D2D),
    (0x53AB9BBF14511759, 0x1E926CF9780AB81D, 0x723E08B88C5BCF76),
    (0x9D9B16C7F7804E4F, 0x82D449FBB3710CC2, 0x206F60C3AAF15B11),
    (0x831C12341C225650, 0x1D7F3B212029E306, 0xA09B4D553C4C3956),
    (0x05D3D5630EE1EE7A, 0x1D856FFCF44D5255, 0x23594560032F40CF),
    (0x013CAA9FE3DC7505, 0x89BB52619AC71FDB, 0x8AF7FD017EA394E0),
    (0x38B57486189A8AF7, 0xC940D6B7C217DF21, 0x01F64B3DDAB26A18),
    (0xC027A1920BA2B853, 0xE936D7E76EF87970, 0xA95E79797A9B31C3),
    (0x83B3345820EFBE24, 0xA2612D0D21FF79CE, 0x2614616542EF37F2),
    (0x048D99BB777A3E92, 0x420A64EAF4A61F31, 0x4697FEA66C205DC3),
    (0x2F6ED7AC26473A89, 0xA0F0CAF1E101AEF5, 0xD05FA29E0748E97E),
    (0xE6F790E3BFACBFDD, 0x8C6D7AA40911B21D, 0x73650B87C8BE71FA),
    (0xF723007CA07B1F47, 0xCBABC2D50BFC89C2, 0xC2CEC351AC77A909),
    (0xF57CFFF55E1E9F16, 0xF8B3F1B66A6F749F, 0xEE30F1ABC88E13B5),
    (0xF1D48693A3DA13ED, 0x24FF5C94287C6C91, 0x16D3E327CC56807E),
    (0xD9652C9C98964727, 0x9FE2D1CD1B4A6684, 0x7947FE69B3E0ADAB),
    (0xB8515960CF3327BE, 0xC8888D786D4485B3, 0x80D9E6D93C77AD71),
]
# SURVEY §8: seeds {10101, 11011}, h=3, k=5, windows 0..2
README_SEEDS = [
    (0x9F8F9FBF890D6351, 0x49E4088860AA19F8, 0x6B35294FA7A7F7B8,
     0x7539D859409E5B0A, 0xA39849FCE36E6ECC, 0x43EAC0D4B3D45959),
    (0x8DC5F8486FA3CF68, 0x80639943016BBB59, 0xD711B0635C1B2C37,
     0x343F35681027EEF7, 0x3F700FD7CC6B8E01, 0xA2B26F83A7BF55DE),
    (0x9F8F9FBF890D6351, 0x49E4088860AA19F8, 0x6B35294FA7A7F7B8,
     0xA9C9D84ABC727C26, 0x57FCA27B852A659D, 0x5A9F199A16858568),
]
SEED_SETS = [("10101", "11011"), ("110011", "101101"), ("1",),
             ("111110000000011111", "111111100001111111"),
             ("00000000000000000000000011000000000000000000000000",
              "11111111111111111111111100111111111111111111111111")]


def _seq(rng, n, alphabet=5):
    return rng.integers(0, alphabet, size=n, dtype=np.uint8)


def test_survey_golden_vectors():
    fwd, rev, hashes, valid = oracle.hash_all_windows(README, 5, 1)
    assert valid.all()
    for w, (f, r, c) in enumerate(README_K5):
        assert (int(fwd[w]), int(rev[w]), int(hashes[w, 0])) == (f, r, c)
        assert oracle.forward_hash(README[w:w + 5]) == f
        assert oracle.reverse_hash(README[w:w + 5]) == r
    _, _, sh = oracle.hash_all_windows_seeds(README, ("10101", "11011"), 3)
    for w, row in enumerate(README_SEEDS):
        assert tuple(int(x) for x in sh[w]) == row
    # the quirk vectors: SeedNtHash inits through an N, NtHash skips it
    seq = "ANCATGCATGCA"
    assert oracle.seed_nthash_positions(oracle._codes(seq), 5)[0] == 0
    _, _, qh = oracle.hash_all_windows_seeds(seq, ("11111",), 1)
    assert int(qh[0, 0]) == 0x8A3A49D6F85B53FF
    assert oracle.nthash_positions(oracle._codes(seq), 5)[0] == 2
    _, _, kh, _ = oracle.hash_all_windows(seq, 5, 1)
    assert int(kh[2, 0]) == 0x38CC00F940AEBDAE


@pytest.mark.parametrize("k", [1, 2, 5, 31, 33])
def test_scalar_hashes_and_rolls_vs_jax(rng, k):
    c = _seq(rng, 3 * k + 7)
    assert oracle.forward_hash(c, k) == joracle.forward_hash(c, k)
    assert oracle.reverse_hash(c, k) == joracle.reverse_hash(c, k)
    assert oracle.forward_hash(c) == joracle.forward_hash(c)
    for _ in range(20):
        fh, rh = (int(x) for x in rng.integers(0, 2**63, size=2))
        fh |= int(rng.integers(0, 2)) << 63
        co, ci = (int(x) for x in rng.integers(0, 5, size=2))
        for name in ("next_forward_hash", "prev_forward_hash",
                     "next_reverse_hash", "prev_reverse_hash"):
            assert getattr(oracle, name)(fh, k, co, ci) == \
                getattr(joracle, name)(fh, k, co, ci), name
        assert oracle.next_reverse_hash(rh, k, co, ci) == \
            joracle.next_reverse_hash(rh, k, co, ci)


@pytest.mark.parametrize("k,h", [(1, 1), (4, 3), (9, 2), (21, 4)])
def test_hash_all_windows_vs_jax(rng, k, h):
    c = _seq(rng, 120)
    c[rng.random(120) < 0.05] = 7  # above 4: invalid, as in the engines
    got = oracle.hash_all_windows(c, k, h)
    want = joracle.hash_all_windows(c, k, h)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.array_equal(oracle.window_valid(c, k),
                          joracle.window_valid(c, k))
    with pytest.raises(ValueError, match="smaller than k"):
        oracle.hash_all_windows(c[:k - 1], k, h)


@pytest.mark.parametrize("n_rate", [0.0, 0.05, 0.3])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_positions_vs_jax(rng, k, n_rate):
    c = _seq(rng, 200, 4)
    c[rng.random(200) < n_rate] = 4
    for start in (0, 1, 57, 199, 250):
        assert oracle.nthash_positions(c, k, start) == \
            joracle.nthash_positions(c, k, start)
        assert oracle.seed_nthash_positions(c, k, start) == \
            joracle.seed_nthash_positions(c, k, start)
    assert oracle.seed_nthash_positions(c[:k - 1], k) == []


@pytest.mark.parametrize("seeds", SEED_SETS)
def test_seed_functions_vs_jax(rng, seeds):
    k = len(seeds[0])
    assert oracle.parse_seeds(seeds) == joracle.parse_seeds(seeds)
    assert oracle.get_blocks(seeds) == joracle.get_blocks(seeds)
    # one copy: the spaced-seed engine takes the oracle's decomposition
    assert seed_torch.get_blocks is oracle.get_blocks
    assert seed_torch.seed_positions_of is oracle.seed_positions_of
    for b, m in zip(*oracle.get_blocks(seeds)):
        assert oracle.seed_positions_of(b, m) == joracle.seed_positions_of(b, m)
    c = _seq(rng, k + 40)
    positions = oracle.seed_positions_of(*[x[0] for x in oracle.get_blocks(seeds)])
    assert oracle.seed_forward_hash(c, k, positions) == \
        joracle.seed_forward_hash(c, k, positions)
    assert oracle.seed_reverse_hash(c, k, positions) == \
        joracle.seed_reverse_hash(c, k, positions)
    for g, w in zip(oracle.hash_all_windows_seeds(c, seeds, 2),
                    joracle.hash_all_windows_seeds(c, seeds, 2)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_codes_clamp_like_jax():
    raw = np.array([0, 1, 2, 3, 4, 5, 200], dtype=np.uint8)
    assert np.array_equal(oracle._codes(raw), joracle._codes(raw))
    assert np.array_equal(oracle._codes("ACGTUNacgtu"),
                          joracle._codes("ACGTUNacgtu"))


def test_typedefs_are_the_jax_ones():
    for name in ("NUM_HASHES_TYPE", "K_TYPE", "SpacedSeedBlocks",
                 "SpacedSeedMonomers"):
        assert getattr(typedefs, name) == getattr(jtypedefs, name)
