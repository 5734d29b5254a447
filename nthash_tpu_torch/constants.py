"""Bit-exact ntHash2 ("ntHash_v2") constants and host-side scalar primitives.

Counterpart of ``nthash_tpu/constants.py``, kept as a standalone copy
(Python ints and numpy only) so the PyTorch package imports without JAX.
``tests/test_torch_constants.py`` pins every table and function here to the
JAX package's values.

Reference provenance (for parity checking, not copied code):
- per-base seeds:            reference src/internal.hpp:124-128
- split-rotate semantics:    reference src/internal.hpp:41-66 (srol/sror)
- multi-hash constants:      reference src/internal.hpp:91-94 (MULTISHIFT/MULTISEED)
- ASCII tables:              reference src/internal.hpp:130-165, 350-418

PyTorch has no usable uint64 arithmetic, so the port holds every 64-bit hash
as ``torch.int64`` with two's-complement wrap; :func:`to_i64` maps a Python
uint64 constant into that range.
"""

from __future__ import annotations

import numpy as np

#: Name of the hash function implemented (hash values are a persisted,
#: cross-implementation contract). Matches reference include/nthash/nthash.hpp:18.
NTHASH_FN_NAME = "ntHash_v2"

M64 = (1 << 64) - 1
MASK33 = (1 << 33) - 1  # bits 0..32: the 33-bit rotating sub-word
MASK31 = (1 << 31) - 1  # bits 33..63 (after >>33): the 31-bit rotating sub-word

#: Joint period of the split rotation (lcm(33, 31)).
SROL_PERIOD = 33 * 31  # 1023

# 64-bit random seeds per base (reference src/internal.hpp:124-128).
SEED_A = 0x3C8BFBB395C60474
SEED_C = 0x3193C18562A02B4C
SEED_G = 0x20323ED082572324
SEED_T = 0x295549F54BE24456
SEED_N = 0x0000000000000000

#: 2-bit base codes. Code 4 is "invalid/N" (zero seed).
CODE_A, CODE_C, CODE_G, CODE_T, CODE_N = 0, 1, 2, 3, 4
NUM_CODES = 5

#: Seed value per 2-bit code (index: CODE_*).
SEEDS = (SEED_A, SEED_C, SEED_G, SEED_T, SEED_N)

#: Complement code: A<->T, C<->G, N->N.
COMP_CODE = (CODE_T, CODE_G, CODE_C, CODE_A, CODE_N)

# Multi-hash ("nte64") extension constants (reference src/internal.hpp:91-94).
MULTISHIFT = 27
MULTISEED = 0x90B45D39FB6DA1FA


def to_i64(x: int) -> int:
    """Python uint64 (any int, taken mod 2**64) -> the int64 with the same
    bits, so it fits ``torch.tensor(..., dtype=torch.int64)``."""
    x &= M64
    return x - (1 << 64) if x >> 63 else x


def srol1(x: int) -> int:
    """Split-rotate-left by one: bits 0..32 and 33..63 rotate independently.

    Semantics match reference src/internal.hpp:41-48.
    """
    x &= M64
    lo = x & MASK33
    hi = x >> 33
    lo = ((lo << 1) | (lo >> 32)) & MASK33
    hi = ((hi << 1) | (hi >> 30)) & MASK31
    return (hi << 33) | lo


def sror1(x: int) -> int:
    """Split-rotate-right by one (inverse of :func:`srol1`).

    Semantics match reference src/internal.hpp:83-88.
    """
    x &= M64
    lo = x & MASK33
    hi = x >> 33
    lo = ((lo >> 1) | (lo << 32)) & MASK33
    hi = ((hi >> 1) | (hi << 30)) & MASK31
    return (hi << 33) | lo


def srol(x: int, d: int) -> int:
    """Split-rotate-left by ``d`` (any non-negative amount): the 33-bit and
    31-bit sub-words rotate by ``d % 33`` and ``d % 31`` respectively
    (reference src/internal.hpp:56-66)."""
    x &= M64
    d33 = d % 33
    d31 = d % 31
    lo = x & MASK33
    hi = x >> 33
    lo = ((lo << d33) | (lo >> (33 - d33))) & MASK33 if d33 else lo
    hi = ((hi << d31) | (hi >> (31 - d31))) & MASK31 if d31 else hi
    return (hi << 33) | lo


def sror(x: int, d: int) -> int:
    """Split-rotate-right by ``d``."""
    return srol(x, (-d) % SROL_PERIOD)


def canonical(fwd: int, rev: int) -> int:
    """Strand-neutral combiner: fwd + rev mod 2**64
    (reference src/internal.hpp:24-33)."""
    return (fwd + rev) & M64


def extend_hashes(fwd: int, rev: int, k: int, num_hashes: int) -> list[int]:
    """nte64 multi-hash extension (reference src/internal.hpp:104-118):
    ``h_0 = canonical(fwd, rev)``, ``h_i = h_0 * (i ^ k*MULTISEED)``,
    ``h_i ^= h_i >> MULTISHIFT``."""
    h0 = canonical(fwd, rev)
    out = [h0]
    for i in range(1, num_hashes):
        t = (h0 * ((i ^ (k * MULTISEED)) & M64)) & M64
        t ^= t >> MULTISHIFT
        out.append(t)
    return out


def nte64_multiplier(i: int, k: int) -> int:
    """The multiplier used for extended hash ``i`` at k-mer size ``k``."""
    return (i ^ (k * MULTISEED)) & M64


def _build_ascii_code_tab() -> np.ndarray:
    """ASCII byte -> base code (0..3) or CODE_N(=4) for anything else:
    upper+lowercase ACGT, U/u (RNA) maps to T (reference
    src/internal.hpp:130-165, 350-418)."""
    tab = np.full(256, CODE_N, dtype=np.uint8)
    for chars, code in (
        ("Aa", CODE_A),
        ("Cc", CODE_C),
        ("Gg", CODE_G),
        ("TtUu", CODE_T),
    ):
        for ch in chars:
            tab[ord(ch)] = code
    return tab


#: ASCII -> internal base code (0-3 valid, 4 invalid).
ASCII_TO_CODE = _build_ascii_code_tab()

#: ASCII -> seed value (parity mirror of reference SEED_TAB for tests).
SEED_TAB_ASCII = np.array([SEEDS[c] for c in ASCII_TO_CODE], dtype=np.uint64)


def _build_srol_cycle() -> np.ndarray:
    """``SROL_CYCLE[code, d] = srol^d(SEEDS[code])`` for d in [0, 1023)."""
    out = np.zeros((NUM_CODES, SROL_PERIOD), dtype=np.uint64)
    for code in range(NUM_CODES):
        v = SEEDS[code]
        for d in range(SROL_PERIOD):
            out[code, d] = v
            v = srol1(v)
    return out


SROL_CYCLE = _build_srol_cycle()


def srol_seed(code: int, d: int) -> int:
    """``srol^d(SEEDS[code])`` via the precomputed cycle (any d >= 0)."""
    return int(SROL_CYCLE[code, d % SROL_PERIOD])


def encode_ascii(seq) -> np.ndarray:
    """Encode a str/bytes sequence into base codes (uint8, 0-3 valid / 4 invalid)."""
    if isinstance(seq, str):
        seq = seq.encode("latin-1")
    buf = np.frombuffer(bytes(seq), dtype=np.uint8)
    return ASCII_TO_CODE[buf]
