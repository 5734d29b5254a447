"""Batched k-mer hashing engine in plain PyTorch: the reference engine of the port.

Counterpart of ``nthash_tpu/ops/kmer_jnp.py``. One Python loop over sequence
position rolls every read of the batch one base per step; warm-up and steady
state share one recurrence by treating the outgoing base of not-yet-complete
windows as N (zero seed):

    fwd_t = srol(fwd_{t-1}) ^ SEED[s_t] ^ srol^k(SEED[s_{t-k}])
    rev_t = sror(rev_{t-1} ^ SEED[comp(s_{t-k})]) ^ srol^(k-1)(SEED[comp(s_t)])

with s_{t-k} = N for t < k. At step t >= k-1 the state is the exact ntHash2
forward/reverse hash of window w = t-k+1. An invalid base contributes the
zero seed and roll-out cancels roll-in, so it corrupts only the windows that
contain it, which :func:`window_valid` masks.

Every 64-bit value is a ``torch.int64`` tensor (see ``u64.py``). The engine
runs on whatever device its input lies on; it is the plain version that the
CUDA kernel in ``ops/kmer_kernel.py`` is held against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import u64
from ..constants import COMP_CODE, SEEDS, sror1, srol_seed


class PlaneTables(NamedTuple):
    """The per-base constant tables for a given k (Python ints, uint64)."""

    fwd_in: tuple[int, ...]    # SEED[b]
    fwd_out: tuple[int, ...]   # srol^k(SEED[b])
    rev_in: tuple[int, ...]    # srol^(k-1)(SEED[comp(b)])
    rev_out: tuple[int, ...]   # SEED[comp(b)]
    rev_out_r: tuple[int, ...]  # sror(SEED[comp(b)]): sror folded into the
    #                             table so the roll-out XOR commutes past it


def plane_tables(k: int) -> PlaneTables:
    return PlaneTables(
        fwd_in=tuple(SEEDS[b] for b in range(5)),
        fwd_out=tuple(srol_seed(b, k) for b in range(5)),
        rev_in=tuple(srol_seed(COMP_CODE[b], k - 1) for b in range(5)),
        rev_out=tuple(SEEDS[COMP_CODE[b]] for b in range(5)),
        rev_out_r=tuple(sror1(SEEDS[COMP_CODE[b]]) for b in range(5)),
    )


class KmerHashes(NamedTuple):
    """Hashes of every window of a [B, L] batch; W = L - k + 1.

    ``hashes`` holds canonical + nte64 extensions stacked on the last axis.
    Only entries with ``valid[b, w]`` are defined ntHash2 values.
    """

    fwd: torch.Tensor     # [B, W] int64
    rev: torch.Tensor     # [B, W] int64
    hashes: torch.Tensor  # [B, W, num_hashes] int64
    valid: torch.Tensor   # [B, W] bool


def window_valid(codes: torch.Tensor, k: int) -> torch.Tensor:
    """[..., L] codes -> [..., W] bool: no invalid base in window."""
    p = torch.cumsum((codes >= 4).to(torch.int32), dim=-1)
    before = torch.cat([torch.zeros_like(p[..., :1]), p], dim=-1)
    return (p[..., k - 1:] - before[..., : p.shape[-1] - k + 1]) == 0


def window_valid_tm(codes_tm: torch.Tensor, k: int) -> torch.Tensor:
    """Time-major variant: [L, R] codes -> [W, R] bool (cumsum over time)."""
    return window_valid(codes_tm.T, k).T


def roll_tm(codes_tm: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[L, R] integer codes (0-3 valid, 4 invalid; larger values count as 4)
    -> (fwd [W, R], rev [W, R]) int64 forward/reverse hashes of every window."""
    length, reads = codes_tm.shape
    if k <= 0:
        raise ValueError("k must be greater than 0")
    if length < k:
        raise ValueError(f"sequence length ({length}) is smaller than k ({k})")
    dev = codes_tm.device
    tabs = plane_tables(k)
    fwd_in, fwd_out, rev_in, rev_out = (
        u64.tensor(t, dev)
        for t in (tabs.fwd_in, tabs.fwd_out, tabs.rev_in, tabs.rev_out)
    )
    codes = codes_tm.to(torch.int64).clamp(max=4)
    w = length - k + 1
    fwd_seq = torch.empty((w, reads), dtype=torch.int64, device=dev)
    rev_seq = torch.empty((w, reads), dtype=torch.int64, device=dev)
    fwd = torch.zeros(reads, dtype=torch.int64, device=dev)
    rev = torch.zeros(reads, dtype=torch.int64, device=dev)
    for t in range(length):
        c_in = codes[t]
        fwd = u64.srol1(fwd) ^ fwd_in[c_in]
        if t >= k:  # before that the outgoing base is N: zero seed
            c_out = codes[t - k]
            fwd = fwd ^ fwd_out[c_out]
            rev = rev ^ rev_out[c_out]
        rev = u64.sror1(rev) ^ rev_in[c_in]
        if t >= k - 1:
            fwd_seq[t - k + 1] = fwd
            rev_seq[t - k + 1] = rev
    return fwd_seq, rev_seq


def segment_codes(codes_tm: torch.Tensor, k: int, seg: int) -> torch.Tensor:
    """[L, R] codes -> [seg + k - 1, nseg * R]: the bases of each segment of
    ``seg`` windows as a read of its own (column j * R + r holds read r's
    bases [j * seg, (j + 1) * seg + k - 1), the tail padded with the
    invalid code), nseg = ceil((L - k + 1) / seg). Rolled from zero state,
    column j * R + r gives read r's windows [j * seg, (j + 1) * seg):
    a window's hash depends only on its own k bases."""
    length, reads = codes_tm.shape
    nseg = -(-(length - k + 1) // seg)
    pad = nseg * seg + k - 1 - length
    padded = torch.nn.functional.pad(codes_tm, (0, 0, 0, pad), value=4)
    rows = padded.unfold(0, seg + k - 1, seg)        # [nseg, R, seg + k - 1]
    return rows.permute(2, 0, 1).reshape(seg + k - 1, nseg * reads)


def unsegment(x: torch.Tensor, w: int, reads: int) -> torch.Tensor:
    """Inverse of :func:`segment_codes` for per-window outputs:
    [seg, nseg * R] -> [w, R] in window order."""
    seg = x.shape[0]
    return x.reshape(seg, -1, reads).transpose(0, 1).reshape(-1, reads)[:w]


def hash_kmers(codes: torch.Tensor, k: int, num_hashes: int = 1) -> KmerHashes:
    """Hash all k-mer windows of a batch of encoded reads.

    Args:
      codes: [B, L] (or [L]) integer base codes (0-3 = ACGT, >=4 invalid).
      k: k-mer size.
      num_hashes: hashes per k-mer (canonical + nte64 extensions).

    Returns KmerHashes with [B, W] leaves (W = L - k + 1).
    """
    squeeze = codes.dim() == 1
    if squeeze:
        codes = codes[None]
    codes = codes.to(torch.int64).clamp(max=4)
    fwd_tm, rev_tm = roll_tm(codes.T, k)
    fwd, rev = fwd_tm.T, rev_tm.T
    ext = u64.extend_hashes(u64.add(fwd, rev), k, num_hashes)
    hashes = torch.stack(ext, dim=-1)
    valid = window_valid(codes, k)
    if squeeze:
        return KmerHashes(fwd[0], rev[0], hashes[0], valid[0])
    return KmerHashes(fwd, rev, hashes, valid)
