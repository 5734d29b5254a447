"""The port's batched blind scans (``ops/blind_scan.py``,
``ops/blind_seed_scan.py``) against the JAX package's, on the CPU.

Inputs (windows, fed bases, chosen bases) are made from a seed with numpy
and go through both; every state and hash is compared exactly. A JAX state
is carried into the port (``state_from_numpy``) and a port state back into
JAX (``state_to_numpy``), and both continue to the same results. On the CPU
``roll_many`` runs its plain version, the step loop; the kernel is held to it
on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nthash_tpu.ops import blind_scan as jbs
from nthash_tpu.ops import blind_seed_scan as jbss
from nthash_tpu.u64 import U64
from nthash_tpu_torch.ops import blind_scan as bs
from nthash_tpu_torch.ops import blind_seed_scan as bss
from nthash_tpu_torch.u64 import to_numpy_u64

B, T = 7, 11
SEED_SETS = [("110011", "101101"), ("1" * 6,), ("100001", "111111", "011110")]


def _jstate(st):
    """(fwd, rev, window, pos) host arrays of a JAX state."""
    return (st.fwd.to_np(), st.rev.to_np(), np.asarray(st.window),
            np.asarray(st.pos))


def _same(port_state, jax_state):
    got = bs.state_to_numpy(port_state)
    want = _jstate(jax_state)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)


def _to_jax(cls, st):
    fwd, rev, window, pos = bs.state_to_numpy(st)
    return cls(U64.from_np(fwd), U64.from_np(rev), jnp.asarray(window),
               jnp.asarray(pos))


@pytest.mark.parametrize("k", [1, 6, 33])
def test_kmer_scan_vs_jax(rng, k):
    windows = rng.integers(0, 4, size=(B, k), dtype=np.uint8)
    windows[0, 0] = 4  # an invalid base hashes as the zero seed
    chars = rng.integers(0, 4, size=(T, B), dtype=np.uint8)
    chars[3, 2] = 6
    choice = rng.integers(0, 4, size=B).astype(np.int32)

    st = bs.init_state(torch.from_numpy(windows))
    jst = jbs.init_state(jnp.asarray(windows))
    _same(st, jst)
    assert np.array_equal(to_numpy_u64(bs.hashes_of(st, 3)),
                          jbs.hashes_of(jst, 3).to_np())
    assert np.array_equal(to_numpy_u64(bs.peek4(st, 2)),
                          jbs.peek4(jst, 2).to_np())

    st2, hashes = bs.roll_many(st, torch.from_numpy(chars), 2)
    jst2, jhashes = jbs.roll_many(jst, jnp.asarray(chars), 2)
    assert hashes.shape == (T, B, 2)
    assert np.array_equal(to_numpy_u64(hashes), jhashes.to_np())
    _same(st2, jst2)

    # roll_select / roll_back_select, and peek4 after them
    st3 = bs.roll_select(st2, torch.from_numpy(choice))
    jst3 = jbs.roll_select(jst2, jnp.asarray(choice))
    _same(st3, jst3)
    back = bs.roll_back_select(st3, torch.from_numpy(choice[::-1].copy()))
    jback = jbs.roll_back_select(jst3, jnp.asarray(choice[::-1].copy()))
    _same(back, jback)
    assert np.array_equal(to_numpy_u64(bs.peek4(back, 1)),
                          jbs.peek4(jback, 1).to_np())

    # carried across: a JAX state into the port, the port's back into JAX
    carried = bs.state_from_numpy(*_jstate(jst3), "cpu")
    _same(carried, jst3)
    jcarried = _to_jax(jbs.BlindState, st3)
    a, ha = bs.roll_many(carried, torch.from_numpy(chars[:4]), 1)
    b, hb = jbs.roll_many(jcarried, jnp.asarray(chars[:4]), 1)
    _same(a, b)
    assert np.array_equal(to_numpy_u64(ha), hb.to_np())


def test_kmer_roll_then_back_is_identity(rng):
    k = 9
    windows = rng.integers(0, 4, size=(B, k), dtype=np.uint8)
    st = bs.init_state(torch.from_numpy(windows))
    choice = torch.from_numpy(rng.integers(0, 4, size=B).astype(np.int32))
    back = bs.roll_back_select(bs.roll_select(st, choice),
                               torch.from_numpy(windows[:, 0].astype(np.int32)))
    for x, y in zip(back, st):
        assert torch.equal(x, y)


@pytest.mark.parametrize("seeds", SEED_SETS)
def test_seed_scan_vs_jax(rng, seeds):
    k = len(seeds[0])
    windows = rng.integers(0, 4, size=(B, k), dtype=np.uint8)
    windows[1, 2] = 4
    chars = rng.integers(0, 4, size=(T, B), dtype=np.uint8)
    choice = rng.integers(0, 4, size=B).astype(np.int32)

    st = bss.init_state(torch.from_numpy(windows), seeds)
    jst = jbss.init_state(jnp.asarray(windows), seeds)
    _same(st, jst)
    assert np.array_equal(to_numpy_u64(bss.hashes_of(st, 3)),
                          jbss.hashes_of(jst, 3).to_np())

    st2, hashes = bss.roll_many(st, torch.from_numpy(chars), seeds, 2)
    jst2, jhashes = jbss.roll_many(jst, jnp.asarray(chars), seeds, 2)
    assert hashes.shape == (T, B, 2 * len(seeds))
    assert np.array_equal(to_numpy_u64(hashes), jhashes.to_np())
    _same(st2, jst2)

    st3 = bss.roll_select(st2, torch.from_numpy(choice), seeds)
    jst3 = jbss.roll_select(jst2, jnp.asarray(choice), seeds)
    _same(st3, jst3)
    back = bss.roll_back_select(st3, torch.from_numpy(choice), seeds)
    jback = jbss.roll_back_select(jst3, jnp.asarray(choice), seeds)
    _same(back, jback)

    # peek4 (no JAX counterpart) == the four roll_selects of JAX
    p4 = to_numpy_u64(bss.peek4(back, seeds, 2))
    for code in range(4):
        j = jbss.roll_select(jback, jnp.full((B,), code, jnp.int32), seeds)
        assert np.array_equal(p4[:, code], jbss.hashes_of(j, 2).to_np())

    carried = bss.state_from_numpy(*_jstate(jst3), "cpu")
    _same(carried, jst3)
    jcarried = _to_jax(jbss.BlindSeedState, st3)
    a, ha = bss.roll_many(carried, torch.from_numpy(chars[:3]), seeds, 1)
    b, hb = jbss.roll_many(jcarried, jnp.asarray(chars[:3]), seeds, 1)
    _same(a, b)
    assert np.array_equal(to_numpy_u64(ha), hb.to_np())


@pytest.mark.parametrize("seed", ["1", "11", "101", "1001001", "0110",
                                  "1100011", "0111110"])
def test_seed_roll_then_back_is_identity_at_every_edge(rng, seed):
    """roll then roll_back restores the state bit for bit, for seeds whose
    care runs start at 0 (the s - 1 = -1 tap: the incoming base), end at k
    (the e = k tap) or sit inside, every base of the window varied."""
    k = len(seed)
    windows = rng.integers(0, 5, size=(64, k), dtype=np.uint8)
    st = bss.init_state(torch.from_numpy(windows), (seed,))
    choice = torch.from_numpy(rng.integers(0, 4, size=64).astype(np.int32))
    rolled = bss.roll_select(st, choice, (seed,))
    back = bss.roll_back_select(
        rolled, torch.from_numpy(windows[:, 0].astype(np.int32)), (seed,))
    for x, y in zip(back, st):
        assert torch.equal(x, y)
    # and the rolled state is the direct hash of the shifted window
    shifted = np.concatenate([windows[:, 1:], choice.numpy()[:, None]], 1)
    direct = bss.init_state(torch.from_numpy(shifted), (seed,))
    assert torch.equal(rolled.fwd, direct.fwd)
    assert torch.equal(rolled.rev, direct.rev)


def test_init_rejects_mismatched_seeds():
    with pytest.raises(ValueError, match="length k"):
        bss.init_state(torch.zeros((2, 5), dtype=torch.int32), ("1111",))
    st = bs.init_state(torch.zeros((2, 5), dtype=torch.int32))
    with pytest.raises(ValueError, match="chars must be"):
        bs.roll_many(st, torch.zeros((3, 4), dtype=torch.int32))


def test_blind_warps_rule():
    """The staged blind kernel's warps a block, from the shapes: 8 for
    k-mers and the BASELINE seeds; fewer as the seeds' stage grows; 0 (the
    kernel with a thread's values in registers) when one warp no longer fits
    beside tables that still do."""
    from nthash_tpu_torch.ops import blind_kernel

    assert blind_kernel.blind_warps(("1" * 32,), 4) == 8
    assert blind_kernel.blind_warps(("10101", "11011"), 3) == 8
    assert blind_kernel.blind_warps(("1" * 8,) * 16, 8) == 4
    big = ("10" * 1379 + "1",)
    assert blind_kernel.tables_bytes(big, 4) <= blind_kernel.MAX_SHARED_BYTES
    assert blind_kernel.blind_warps(big, 4) == 0
    with pytest.raises(ValueError, match="do not fit"):
        blind_kernel.launch(torch.zeros((1, 1), dtype=torch.int32),
                            torch.zeros((1, 2759), dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int64),
                            torch.zeros(1, dtype=torch.int64), big, 4, warps=1)
