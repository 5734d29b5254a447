"""Plain spaced-seed ntHash2 (ntHash2's ``SeedNtHash``) for the benchmark's
reference: every window's canonical hash and nte64 extensions under a seed
pattern of '1' (care) and '0' (don't care) positions.

Written from the definition, not from the program's rolling kernels: for a
seed s of length k and the window's bases c_0..c_{k-1},

    fwd = XOR_{i care} srol^(k-1-i)(SEED[c_i])
    rev = XOR_{i care} srol^(i)(SEED[comp(c_i)])
    h_0 = fwd + rev (mod 2**64)
    h_i = h_0 * (i ^ k * MULTISEED), then h_i ^= h_i >> 27 (logical)

the k-mer formulas of ``nthash_ref`` with the don't-care positions left
out. A window holding a base other than ACGT anywhere, a don't-care
position included, is not valid (``nthash_ref.window_valid``): the C++
``SeedNtHash`` would hash an N at a don't-care position of a read's first
window as if it were absent, a quirk this definition leaves out. ``bits=32``
computes the same formulas in 32-bit words, as ``nthash_ref`` does: the
control.

This file imports nothing of the program: it is the yardstick's own copy.
"""

from __future__ import annotations

import torch

from .nthash_ref import (
    COMP,
    M32,
    MULTISHIFT,
    SEEDS,
    as_i64,
    multiplier,
    srol,
    window_valid,
)


def care(seed: str) -> list[int]:
    """The care positions of a pattern."""
    return [i for i, ch in enumerate(seed) if ch == "1"]


def tables(seed: str, device, bits: int = 64
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 [care positions, 5]: fwd[j, c] = srol^(k-1-i)(SEED[c]) and
    rev[j, c] = srol^i(SEED[comp c]) for the j-th care position i, cut to
    ``bits``."""
    k = len(seed)
    mask = (1 << 64) - 1 if bits == 64 else M32
    fwd = [[as_i64(srol(SEEDS[c], k - 1 - i) & mask) for c in range(5)]
           for i in care(seed)]
    rev = [[as_i64(srol(SEEDS[COMP[c]], i) & mask) for c in range(5)]
           for i in care(seed)]
    return (torch.tensor(fwd, dtype=torch.int64, device=device),
            torch.tensor(rev, dtype=torch.int64, device=device))


def window_hashes(codes: torch.Tensor, seed: str, num_hashes: int,
                  bits: int = 64) -> list[torch.Tensor]:
    """Every window's h_0..h_{H-1} of reads codes [b, L] (uint8, 0-3 bases,
    4 anything else) under ``seed``: ``num_hashes`` int64 [b, L - k + 1]
    tensors, the uint64 bits."""
    k = len(seed)
    c = torch.clamp(codes.to(torch.int64), max=4)
    w = c.shape[1] - k + 1
    tf, tr = tables(seed, c.device, bits)
    fwd = torch.zeros((c.shape[0], w), dtype=torch.int64, device=c.device)
    rev = torch.zeros_like(fwd)
    for j, i in enumerate(care(seed)):
        part = c[:, i:i + w]
        fwd ^= tf[j].take(part)
        rev ^= tr[j].take(part)
    h0 = fwd + rev
    if bits == 32:
        h0 &= M32
    out = [h0]
    for i in range(1, num_hashes):
        m = multiplier(i, k)
        if bits == 32:
            t = (h0 * (m & M32)) & M32
            t ^= t >> MULTISHIFT
        else:
            t = h0 * as_i64(m)
            t ^= (t >> MULTISHIFT) & ((1 << (64 - MULTISHIFT)) - 1)
        out.append(t)
    return out


def window_buckets(codes: torch.Tensor, seeds, num_hashes: int,
                   width_log2: int, bits: int = 64) -> torch.Tensor:
    """int64 [S, H, b, W]: the low ``width_log2`` bits of every window's
    every hash under every seed, -1 where the window is not valid."""
    valid = window_valid(codes, len(seeds[0]))
    mask = (1 << width_log2) - 1
    return torch.stack([
        torch.stack([torch.where(valid, h & mask, -1)
                     for h in window_hashes(codes, s, num_hashes, bits)])
        for s in seeds])
