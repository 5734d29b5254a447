"""nthash_tpu_torch.u64 (int64 tensors) fuzzed against the Python-int
constants.srol1 / sror1 / extend_hashes, including values with bit 63 set."""

import numpy as np
import pytest
import torch

from nthash_tpu import constants as jc
from nthash_tpu_torch import u64
from nthash_tpu_torch.u64 import from_numpy_u64, to_numpy_u64

M64 = (1 << 64) - 1


@pytest.fixture
def vals(rng):
    edge = np.array([0, 1, 1 << 32, (1 << 33) - 1, 1 << 33, (1 << 63) - 1,
                     1 << 63, M64, jc.SEED_A, jc.MULTISEED], dtype=np.uint64)
    rand = rng.integers(0, 2**64 - 1, size=2000, dtype=np.uint64, endpoint=True)
    out = np.concatenate([edge, rand])
    assert (out >> np.uint64(63)).any()  # bit 63 is exercised
    return out


def _check(got: torch.Tensor, want_ints):
    assert got.dtype == torch.int64
    assert to_numpy_u64(got).tolist() == [w & M64 for w in want_ints]


def test_roundtrip(vals):
    t = from_numpy_u64(vals)
    assert t.dtype == torch.int64
    assert np.array_equal(to_numpy_u64(t), vals)


@pytest.mark.parametrize("name", ["srol1", "sror1"])
def test_rotate_one(vals, name):
    got = getattr(u64, name)(from_numpy_u64(vals))
    _check(got, [getattr(jc, name)(int(v)) for v in vals])


def test_rotations_invert(vals):
    t = from_numpy_u64(vals)
    assert torch.equal(u64.sror1(u64.srol1(t)), t)
    assert torch.equal(u64.srol1(u64.sror1(t)), t)


def test_add(vals, rng):
    other = rng.permutation(vals)
    got = u64.add(from_numpy_u64(vals), from_numpy_u64(other))
    _check(got, [int(a) + int(b) for a, b in zip(vals, other)])


@pytest.mark.parametrize("s", [0, 1, 27, 31, 32, 33, 63])
def test_shr(vals, s):
    _check(u64.shr(from_numpy_u64(vals), s), [int(v) >> s for v in vals])


@pytest.mark.parametrize("m", [0, 1, 3, 0xFFFFFFFF, 1 << 32, jc.MULTISEED, M64])
def test_mul_const(vals, m):
    _check(u64.mul_const(from_numpy_u64(vals), m), [int(v) * m for v in vals])


@pytest.mark.parametrize("k,h", [(1, 1), (5, 3), (32, 4), (65, 6)])
def test_extend_hashes(vals, rng, k, h):
    fwd, rev = vals, rng.permutation(vals)
    canon = u64.add(from_numpy_u64(fwd), from_numpy_u64(rev))
    got = u64.extend_hashes(canon, k, h)
    assert len(got) == h
    want = [jc.extend_hashes(int(f), int(r), k, h) for f, r in zip(fwd, rev)]
    for i in range(h):
        _check(got[i], [w[i] for w in want])
