"""Batched spaced-seed ("ntmsm64") hashing engine in plain PyTorch.

Counterpart of ``nthash_tpu/ops/seed_jnp.py``; the reference's block
decomposition (``get_blocks``, ``seed_positions_of``) comes from the port's
own ``oracle.py``. The spaced-seed hash is an XOR
of independently rotated per-base seeds over the care positions only,

    fwd(w) = XOR_{i in care} srol^(k-1-i)(SEED[s[w+i]])
    rev(w) = XOR_{i in care} srol^(i)(SEED[comp(s[w+i])])

so every window is computed directly, one shifted-slice lookup and XOR per
care position, with no recurrence at all. That makes this engine an
independent reference for the rolling two-tap kernels of
``ops/seed_kernel.py``. The reference's N handling is automatic: an invalid
code selects the zero seed, and ``valid`` is strict over all k bases,
don't-care positions included.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .. import u64
from ..constants import COMP_CODE, srol_seed
from ..oracle import get_blocks, seed_positions_of
from .kmer_torch import window_valid


class SeedHashes(NamedTuple):
    """Spaced-seed hashes of every window; S seeds, W = L - k + 1 windows.

    ``hashes`` follows the reference hash_arr (seed-major:
    ``[..., s * num_hashes_per_seed + i]``); int64 holding uint64 bits.
    """

    fwd: torch.Tensor     # [B, W, S]
    rev: torch.Tensor     # [B, W, S]
    hashes: torch.Tensor  # [B, W, S * num_hashes_per_seed]
    valid: torch.Tensor   # [B, W] bool (strict ACGTU validity of the window)


def care_positions(seeds: Sequence[str]) -> list[list[int]]:
    """Care positions per seed via the reference block decomposition."""
    blocks, monomers = get_blocks(list(seeds))
    return [seed_positions_of(b, m) for b, m in zip(blocks, monomers)]


def check_seeds(seeds: Sequence[str]) -> int:
    """The common length k of ``seeds``; raises ValueError on an empty set or
    unequal lengths."""
    if not seeds:
        raise ValueError("at least one seed pattern is needed")
    k = len(seeds[0])
    if any(len(s) != k for s in seeds):
        raise ValueError("all seed strings must have equal length k")
    if k == 0:
        raise ValueError("seed patterns must not be empty")
    return k


def hash_kmers_seeds(codes: torch.Tensor, seeds: Sequence[str],
                     num_hashes_per_seed: int = 1) -> SeedHashes:
    """Hash all windows of a [B, L] (or [L]) batch under each spaced-seed
    pattern (all of length k), directly per care position."""
    squeeze = codes.dim() == 1
    if squeeze:
        codes = codes[None]
    codes = codes.to(torch.int64).clamp(max=4)
    b, length = codes.shape
    k = check_seeds(seeds)
    if length < k:
        raise ValueError(f"sequence length ({length}) is smaller than k ({k})")
    w = length - k + 1
    dev = codes.device

    fwd_list, rev_list, hash_list = [], [], []
    for positions in care_positions(seeds):
        fwd = torch.zeros((b, w), dtype=torch.int64, device=dev)
        rev = torch.zeros((b, w), dtype=torch.int64, device=dev)
        for i in positions:
            window_codes = codes[:, i:i + w]
            fwd_plane = u64.tensor([srol_seed(c, k - 1 - i) for c in range(4)]
                                   + [0], dev)
            rev_plane = u64.tensor([srol_seed(COMP_CODE[c], i)
                                    for c in range(4)] + [0], dev)
            fwd = fwd ^ fwd_plane[window_codes]
            rev = rev ^ rev_plane[window_codes]
        fwd_list.append(fwd)
        rev_list.append(rev)
        hash_list.extend(u64.extend_hashes(u64.add(fwd, rev), k,
                                           num_hashes_per_seed))

    fwd = torch.stack(fwd_list, dim=-1)
    rev = torch.stack(rev_list, dim=-1)
    hashes = torch.stack(hash_list, dim=-1)
    valid = window_valid(codes, k)
    if squeeze:
        return SeedHashes(fwd[0], rev[0], hashes[0], valid[0])
    return SeedHashes(fwd, rev, hashes, valid)
