"""nthash_tpu_torch.constants == nthash_tpu.constants, table by table."""

import numpy as np
import pytest

import nthash_tpu.constants as jc
import nthash_tpu_torch.constants as tc

SCALARS = [
    "NTHASH_FN_NAME", "M64", "MASK33", "MASK31", "SROL_PERIOD",
    "SEED_A", "SEED_C", "SEED_G", "SEED_T", "SEED_N",
    "CODE_A", "CODE_C", "CODE_G", "CODE_T", "CODE_N", "NUM_CODES",
    "SEEDS", "COMP_CODE", "MULTISHIFT", "MULTISEED",
]
TABLES = ["ASCII_TO_CODE", "SEED_TAB_ASCII", "SROL_CYCLE"]


@pytest.mark.parametrize("name", SCALARS)
def test_scalar_constant(name):
    assert getattr(tc, name) == getattr(jc, name)


@pytest.mark.parametrize("name", TABLES)
def test_table(name):
    got, want = getattr(tc, name), getattr(jc, name)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


def _values(rng, n=300):
    edge = [0, 1, 1 << 32, 1 << 33, (1 << 63) - 1, 1 << 63, jc.M64,
            jc.SEED_A, jc.MULTISEED]
    return edge + [int(x) for x in rng.integers(0, 2**63, size=n, dtype=np.uint64)
                   * np.uint64(2) + rng.integers(0, 2, size=n, dtype=np.uint64)]


@pytest.mark.parametrize("fn", ["srol1", "sror1"])
def test_rotate_one(rng, fn):
    for x in _values(rng):
        assert getattr(tc, fn)(x) == getattr(jc, fn)(x)


@pytest.mark.parametrize("fn", ["srol", "sror"])
def test_rotate_d(rng, fn):
    for x in _values(rng, 40):
        for d in (0, 1, 31, 32, 33, 64, 1022, 1023, 5000):
            assert getattr(tc, fn)(x, d) == getattr(jc, fn)(x, d)


def test_srol_seed_nte64_extend(rng):
    for code in range(5):
        for d in (0, 1, 32, 64, 1023, 2047):
            assert tc.srol_seed(code, d) == jc.srol_seed(code, d)
    for k in (1, 5, 32, 65, 100):
        for i in range(6):
            assert tc.nte64_multiplier(i, k) == jc.nte64_multiplier(i, k)
    vals = _values(rng, 50)
    for f, r in zip(vals, vals[::-1]):
        assert tc.canonical(f, r) == jc.canonical(f, r)
        assert tc.extend_hashes(f, r, 32, 5) == jc.extend_hashes(f, r, 32, 5)


def test_encode_ascii():
    seq = "ACGTNacgtnUuRYKM-*" + "".join(map(chr, range(32, 127)))
    assert np.array_equal(tc.encode_ascii(seq), jc.encode_ascii(seq))
    assert np.array_equal(tc.encode_ascii(seq.encode()), jc.encode_ascii(seq))


@pytest.mark.parametrize("x,want", [
    (0, 0), (1, 1), ((1 << 63) - 1, (1 << 63) - 1), (1 << 63, -(1 << 63)),
    (jc.M64, -1), (jc.MULTISEED, jc.MULTISEED - (1 << 64)), (1 << 64, 0),
])
def test_to_i64(x, want):
    got = tc.to_i64(x)
    assert got == want
    assert np.int64(got).view(np.uint64) == np.uint64(x & jc.M64)
