"""Plain ntHash2 ("ntHash_v2") for the benchmark's reference: every window's
canonical hash and nte64 extensions, their buckets, and the count-min rows
and Bloom words they make.

Written from the definition, not from the program's rolling kernels:

    fwd(s[0..k)) = XOR_{i<k} srol^(k-1-i)(SEED[s[i]])
    rev(s[0..k)) = XOR_{i<k} srol^(i)(SEED[comp(s[i])])
    h_0 = fwd + rev (mod 2**64)
    h_i = h_0 * (i ^ k * MULTISEED), then h_i ^= h_i >> 27 (logical)

srol splits a word into bits 0..32 and 33..63 and rotates each on its own.
A window holding a base other than ACGT (code 4) is not counted. Each hash
is an int64 tensor whose bits are the uint64 value; PyTorch's ``>>`` is
arithmetic, so logical shifts mask the sign-extended bits.

``bits=32`` computes the same formulas in 32-bit words (every table entry,
sum and product cut to its low 32 bits): the control, the precision cut a
later change might be tempted to take. The canonical hash keeps its low 32
bits, but every extension's bucket changes: its low bits come from bits 27
and up of the 64-bit product.

This file imports nothing of the program: it is the yardstick's own copy.
"""

from __future__ import annotations

import torch

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1
MASK33 = (1 << 33) - 1
MASK31 = (1 << 31) - 1
#: Per-base seeds A, C, G, T and N (reference src/internal.hpp:124-128).
SEEDS = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324,
         0x295549F54BE24456, 0)
#: Complement of each code: A<->T, C<->G, N->N.
COMP = (3, 2, 1, 0, 4)
MULTISHIFT = 27
MULTISEED = 0x90B45D39FB6DA1FA
#: Word layout of the packed Bloom filter: bucket b = q * 4096 + s * 128 + j
#: is bit s of word q * 128 + j.
PACK = 32


def srol(x: int, d: int) -> int:
    """Split-rotate-left of a uint64 by ``d``: the 33-bit and 31-bit
    sub-words rotate by ``d % 33`` and ``d % 31``."""
    lo, hi = x & MASK33, x >> 33
    a, b = d % 33, d % 31
    lo = ((lo << a) | (lo >> (33 - a))) & MASK33 if a else lo
    hi = ((hi << b) | (hi >> (31 - b))) & MASK31 if b else hi
    return (hi << 33) | lo


def as_i64(x: int) -> int:
    """A uint64 as the int64 with the same bits."""
    x &= M64
    return x - (1 << 64) if x >> 63 else x


def multiplier(i: int, k: int) -> int:
    """The uint64 factor of extension ``i`` at k-mer size ``k``."""
    return (i ^ (k * MULTISEED)) & M64


def tables(k: int, device, bits: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 [k, 5]: fwd[j, c] = srol^(k-1-j)(SEED[c]) and rev[j, c] =
    srol^j(SEED[comp c]), cut to ``bits``."""
    mask = M64 if bits == 64 else M32
    fwd = [[as_i64(srol(SEEDS[c], k - 1 - j) & mask) for c in range(5)]
           for j in range(k)]
    rev = [[as_i64(srol(SEEDS[COMP[c]], j) & mask) for c in range(5)]
           for j in range(k)]
    return (torch.tensor(fwd, dtype=torch.int64, device=device),
            torch.tensor(rev, dtype=torch.int64, device=device))


def window_valid(codes: torch.Tensor, k: int) -> torch.Tensor:
    """bool [b, W]: window w of read r holds no code 4."""
    bad = torch.cumsum((codes >= 4).to(torch.int32), dim=1)
    bad = torch.nn.functional.pad(bad, (1, 0))
    return (bad[:, k:] - bad[:, :-k]) == 0


def window_hashes(codes: torch.Tensor, k: int, num_hashes: int,
                  bits: int = 64) -> list[torch.Tensor]:
    """Every window's h_0..h_{H-1} of reads codes [b, L] (uint8, 0-3 bases,
    4 anything else): ``num_hashes`` int64 [b, W] tensors."""
    c = torch.clamp(codes.to(torch.int64), max=4)
    w = c.shape[1] - k + 1
    tf, tr = tables(k, c.device, bits)
    fwd = torch.zeros((c.shape[0], w), dtype=torch.int64, device=c.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        part = c[:, j:j + w]
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


def window_buckets(codes: torch.Tensor, k: int, num_hashes: int,
                   width_log2: int, bits: int = 64) -> torch.Tensor:
    """The buckets of every valid window: int64 [H, n valid], row i the low
    ``width_log2`` bits of h_i."""
    valid = window_valid(codes, k).reshape(-1)
    mask = (1 << width_log2) - 1
    return torch.stack([(h.reshape(-1)[valid] & mask)
                        for h in window_hashes(codes, k, num_hashes, bits)])


def blocks(codes: torch.Tensor, block: int):
    """Row blocks of ``codes``, so the reference's transients stay small."""
    for s in range(0, codes.shape[0], block):
        yield codes[s:s + block]


def row_counts(codes: torch.Tensor, k: int, num_hashes: int, width_log2: int,
               *, bits: int = 64, block: int = 1 << 16,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Count-min rows of the reads: int32 [H, 2**width_log2], row i counting
    bucket i of every valid window; added into ``out`` when given."""
    if out is None:
        out = torch.zeros((num_hashes, 1 << width_log2), dtype=torch.int32,
                          device=codes.device)
    for part in blocks(codes, block):
        bk = window_buckets(part, k, num_hashes, width_log2, bits)
        ones = torch.ones(bk.shape[1], dtype=torch.int32, device=bk.device)
        for i in range(num_hashes):
            out[i].index_add_(0, bk[i], ones)
    return out


def presence(codes: torch.Tensor, k: int, num_hashes: int, width_log2: int,
             *, bits: int = 64, block: int = 1 << 16,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """bool [2**width_log2]: the buckets any valid window's any hash sets."""
    if out is None:
        out = torch.zeros(1 << width_log2, dtype=torch.bool,
                          device=codes.device)
    for part in blocks(codes, block):
        out[window_buckets(part, k, num_hashes, width_log2, bits)
            .reshape(-1)] = True
    return out


def pack_words(present: torch.Tensor) -> torch.Tensor:
    """bool [width] -> int32 words [width / 32] in the filter's layout (the
    uint32 bit patterns)."""
    p = present.reshape(-1, PACK, 128)
    words = torch.zeros((p.shape[0], 128), dtype=torch.int32,
                        device=present.device)
    for s in range(PACK):
        words |= p[:, s].to(torch.int32) << s
    return words.reshape(-1)


def word_of(bucket: torch.Tensor) -> torch.Tensor:
    """The word a bucket's bit lives in."""
    return ((bucket >> 12) << 7) | (bucket & 127)
