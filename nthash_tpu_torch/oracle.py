"""Pure-host (Python int / NumPy) reference implementation of ntHash2.

This is the parity anchor: a dead-simple, obviously-correct implementation of
every hash the framework computes, used by the test-suite to validate the engines
and kernels bit-for-bit. It is written from the mathematical definition

    fwd(s[0..k)) = XOR_{i<k} srol^(k-1-i)(SEED[s[i]])
    rev(s[0..k)) = XOR_{i<k} srol^(i)(SEED[comp(s[i])])
    canonical    = (fwd + rev) mod 2^64

(reference behavior: src/kmer.cpp:43-73, 123-152; src/internal.hpp:24-33)
rather than from the reference's table-driven CPU optimizations, so it is an
independent re-derivation that must agree with the reference's golden vectors.

The port's own copy of ``nthash_tpu/oracle.py`` (NumPy only), so that
``nthash_tpu_torch`` imports without JAX; ``tests/test_torch_oracle.py``
pins every function here to the JAX package's. The facade (``api.py``)
hashes a tile through it below ``AUTO_DEVICE_THRESHOLD`` windows, and the
spaced-seed engine (``ops/seed_torch.py``) takes its block decomposition
(:func:`get_blocks`, :func:`seed_positions_of`) from here.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .constants import (
    CODE_N,
    COMP_CODE,
    SEEDS,
    encode_ascii,
    extend_hashes,
    srol1,
    sror1,
    srol_seed,
)


def _codes(seq) -> np.ndarray:
    if isinstance(seq, (str, bytes, bytearray)):
        return encode_ascii(seq)
    # any code > 4 is "invalid base", same as the device engines
    # (ops/kmer_jnp.hash_kmers, ops/kmer_pallas.prepare_codes clamp too)
    return np.minimum(np.asarray(seq, dtype=np.uint8), 4)


def forward_hash(seq, k: int | None = None) -> int:
    """Forward-strand hash of the first k-mer ("ntf64")."""
    c = _codes(seq)
    k = len(c) if k is None else k
    h = 0
    for i in range(k):
        h ^= srol_seed(int(c[i]), k - 1 - i)
    return h


def reverse_hash(seq, k: int | None = None) -> int:
    """Reverse-complement hash of the first k-mer ("ntr64")."""
    c = _codes(seq)
    k = len(c) if k is None else k
    h = 0
    for i in range(k):
        h ^= srol_seed(COMP_CODE[int(c[i])], i)
    return h


def next_forward_hash(fh: int, k: int, code_out: int, code_in: int) -> int:
    """Roll the forward hash one base right (reference src/kmer.cpp:84-94)."""
    return srol1(fh) ^ SEEDS[code_in] ^ srol_seed(code_out, k)


def prev_forward_hash(fh: int, k: int, code_out: int, code_in: int) -> int:
    """Roll the forward hash one base left (reference src/kmer.cpp:104-114)."""
    return sror1(fh ^ srol_seed(code_in, k) ^ SEEDS[code_out])


def next_reverse_hash(rh: int, k: int, code_out: int, code_in: int) -> int:
    """Roll the reverse-complement hash one base right (reference src/kmer.cpp:164-174)."""
    return sror1(rh ^ srol_seed(COMP_CODE[code_in], k) ^ SEEDS[COMP_CODE[code_out]])


def prev_reverse_hash(rh: int, k: int, code_out: int, code_in: int) -> int:
    """Roll the reverse-complement hash one base left (reference src/kmer.cpp:184-194)."""
    return srol1(rh) ^ SEEDS[COMP_CODE[code_in]] ^ srol_seed(COMP_CODE[code_out], k)


def window_valid(codes: np.ndarray, k: int) -> np.ndarray:
    """Boolean [W] array: window w is free of invalid (non-ACGTU) bases."""
    c = _codes(codes)
    invalid = (c == CODE_N).astype(np.int64)
    p = np.concatenate([[0], np.cumsum(invalid)])
    return (p[k:] - p[:-k]) == 0


def hash_all_windows(seq, k: int, num_hashes: int = 1):
    """Hash every window of ``seq`` (valid or not; N contributes zero seed).

    Returns (fwd[W], rev[W], hashes[W, num_hashes], valid[W]) with uint64
    dtype. Window w's entries are exact ntHash2 values whenever valid[w].
    """
    c = _codes(seq)
    w = len(c) - k + 1
    if w <= 0:
        raise ValueError(f"sequence length {len(c)} is smaller than k ({k})")
    fwd = np.zeros(w, dtype=np.uint64)
    rev = np.zeros(w, dtype=np.uint64)
    hashes = np.zeros((w, num_hashes), dtype=np.uint64)
    fh = forward_hash(c, k)
    rh = reverse_hash(c, k)
    for p in range(w):
        if p > 0:
            fh = next_forward_hash(fh, k, int(c[p - 1]), int(c[p + k - 1]))
            rh = next_reverse_hash(rh, k, int(c[p - 1]), int(c[p + k - 1]))
        fwd[p] = fh
        rev[p] = rh
        hashes[p] = extend_hashes(fh, rh, k, num_hashes)
    return fwd, rev, hashes, window_valid(c, k)


def nthash_positions(codes: np.ndarray, k: int, start: int = 0) -> list[int]:
    """Positions NtHash::roll() visits: every w >= start whose window is valid
    (reference src/kmer.cpp:228-264 — N-skip + re-init lands on exactly the
    valid windows, in order)."""
    valid = window_valid(codes, k)
    return [int(p) for p in range(start, len(valid)) if valid[p]]


def seed_nthash_positions(codes: np.ndarray, k: int, start: int = 0) -> list[int]:
    """Positions SeedNtHash::roll() visits — replicates the reference's
    N-handling quirk (src/seed.cpp:151, 518-544): the init scan never detects
    Ns inside the window (it compares a char against the uint64 SEED_N), so a
    position is always accepted at (re-)init; during rolling, an N *incoming*
    base triggers pos += k followed by an unconditionally-successful init."""
    c = _codes(codes)
    n = len(c)
    if n < k:
        return []
    last = n - k
    out: list[int] = []
    pos = start
    if pos > last:
        return []
    out.append(pos)  # init always succeeds (quirk)
    while pos < last:
        if int(c[pos + k]) == CODE_N:
            pos += k
            if pos > last:
                break
            out.append(pos)  # re-init always succeeds (quirk)
        else:
            pos += 1
            out.append(pos)
    return out


# ---------------------------------------------------------------------------
# Spaced seeds ("ntmsm64")
# ---------------------------------------------------------------------------

def parse_seeds(seed_strings: Sequence[str]) -> list[list[int]]:
    """Pattern strings -> per-seed list of don't-care positions
    (reference src/seed.cpp:431-447)."""
    return [
        [i for i, ch in enumerate(s) if ch != "1"] for s in seed_strings
    ]


def get_blocks(seed_strings: Sequence[str]):
    """Decompose each pattern into rollable blocks + monomers, choosing the
    cheaper of care-representation vs complement (ignore) representation
    (reference src/seed.cpp:19-66).

    Returns (blocks, monomers): per seed, a list of [start, end) pairs and a
    list of monomer positions.
    """
    all_blocks, all_monomers = [], []
    for seed in seed_strings:
        pad = "0" if seed[-1] == "1" else "1"
        padded = seed + pad
        care_blocks: list[tuple[int, int]] = []
        ignore_blocks: list[tuple[int, int]] = []
        care_monos: list[int] = []
        ignore_monos: list[int] = []
        i_start = 0
        in_care = padded[0] == "1"
        for pos, ch in enumerate(padded):
            if in_care and ch == "0":
                if pos - i_start == 1:
                    care_monos.append(i_start)
                else:
                    care_blocks.append((i_start, pos))
                i_start = pos
                in_care = False
            elif not in_care and ch == "1":
                if pos - i_start == 1:
                    ignore_monos.append(i_start)
                else:
                    ignore_blocks.append((i_start, pos))
                i_start = pos
                in_care = True
        num_cares = len(care_blocks) * 2 + len(care_monos)
        num_ignores = len(ignore_blocks) * 2 + len(ignore_monos) + 2
        if num_ignores < num_cares:
            ignore_blocks.append((0, len(seed)))
            all_blocks.append(ignore_blocks)
            all_monomers.append(ignore_monos)
        else:
            all_blocks.append(care_blocks)
            all_monomers.append(care_monos)
    return all_blocks, all_monomers


def seed_positions_of(blocks, monomers) -> list[int]:
    """All positions covered by a seed's blocks+monomers (XOR semantics: a
    position covered an even number of times cancels out)."""
    counts: dict[int, int] = {}
    for b0, b1 in blocks:
        for p in range(b0, b1):
            counts[p] = counts.get(p, 0) + 1
    for p in monomers:
        counts[p] = counts.get(p, 0) + 1
    return sorted(p for p, c in counts.items() if c % 2 == 1)


def seed_forward_hash(seq, k: int, positions: Sequence[int]) -> int:
    """Spaced-seed forward hash: XOR of srol^(k-1-i)(SEED[s[i]]) over care positions."""
    c = _codes(seq)
    h = 0
    for i in positions:
        h ^= srol_seed(int(c[i]), k - 1 - i)
    return h


def seed_reverse_hash(seq, k: int, positions: Sequence[int]) -> int:
    """Spaced-seed reverse hash: XOR of srol^i(SEED[comp(s[i])]) over care positions."""
    c = _codes(seq)
    h = 0
    for i in positions:
        h ^= srol_seed(COMP_CODE[int(c[i])], i)
    return h


def hash_all_windows_seeds(
    seq, seed_strings: Sequence[str], num_hashes_per_seed: int = 1
):
    """Spaced-seed hash of every window (N contributes zero seed — matching
    the reference's SeedNtHash behavior, see seed_nthash_positions).

    Returns (fwd[W, S], rev[W, S], hashes[W, S*num_hashes_per_seed]) uint64.
    """
    c = _codes(seq)
    k = len(seed_strings[0])
    blocks, monomers = get_blocks(seed_strings)
    pos_sets = [
        seed_positions_of(b, m) for b, m in zip(blocks, monomers)
    ]
    w = len(c) - k + 1
    s = len(seed_strings)
    fwd = np.zeros((w, s), dtype=np.uint64)
    rev = np.zeros((w, s), dtype=np.uint64)
    hashes = np.zeros((w, s * num_hashes_per_seed), dtype=np.uint64)
    for p in range(w):
        win = c[p : p + k]
        for si, positions in enumerate(pos_sets):
            fh = seed_forward_hash(win, k, positions)
            rh = seed_reverse_hash(win, k, positions)
            fwd[p, si] = fh
            rev[p, si] = rh
            hashes[p, si * num_hashes_per_seed : (si + 1) * num_hashes_per_seed] = (
                extend_hashes(fh, rh, k, num_hashes_per_seed)
            )
    return fwd, rev, hashes
