"""uint64 arithmetic on ``torch.int64`` tensors.

Counterpart of ``nthash_tpu/u64.py``. The TPU has no 64-bit integers, so the
JAX package carries every hash as a (hi, lo) pair of uint32 limbs. PyTorch
has int64 everywhere (its uint64 lacks shifts, add and compares), so here a
hash is one int64 tensor whose bits are the uint64 value: xor, add and
multiply wrap mod 2**64 exactly as unsigned arithmetic does, and the only
care needed is that ``>>`` is arithmetic, so logical right shifts mask off
the sign-extended bits.

Split-rotate semantics match reference src/internal.hpp:41-66, 83-88: bits
0..32 (the 33-bit sub-word) and bits 33..63 (the 31-bit sub-word) rotate
independently.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import MASK31, MASK33, MULTISHIFT, nte64_multiplier, to_i64


def shr(a: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift by a static amount 0 <= s < 64."""
    if s == 0:
        return a
    return (a >> s) & ((1 << (64 - s)) - 1)


def srol1(a: torch.Tensor) -> torch.Tensor:
    """Split-rotate-left by 1: bit32 -> bit0, bit63 -> bit33."""
    lo = a & MASK33
    hi = shr(a, 33)
    lo = ((lo << 1) | (lo >> 32)) & MASK33
    hi = ((hi << 1) | (hi >> 30)) & MASK31
    return (hi << 33) | lo


def sror1(a: torch.Tensor) -> torch.Tensor:
    """Split-rotate-right by 1: bit0 -> bit32, bit33 -> bit63."""
    lo = a & MASK33
    hi = shr(a, 33)
    lo = ((lo >> 1) | (lo << 32)) & MASK33
    hi = ((hi >> 1) | (hi << 30)) & MASK31
    return (hi << 33) | lo


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2**64."""
    return a + b


def mul_const(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2**64 for a Python-int constant m."""
    return a * to_i64(m)


def extend_hashes(canon: torch.Tensor, k: int, num_hashes: int) -> list[torch.Tensor]:
    """nte64 multi-hash extension (reference src/internal.hpp:104-118):
    hash_0 = canonical; hash_i = h0 * (i ^ k*MULTISEED); h_i ^= h_i >> 27."""
    out = [canon]
    for i in range(1, num_hashes):
        t = mul_const(canon, nte64_multiplier(i, k))
        out.append(t ^ shr(t, MULTISHIFT))
    return out


def tensor(values, device="cpu") -> torch.Tensor:
    """uint64 Python ints -> 1-D int64 tensor with the same bits on ``device``."""
    return torch.tensor([to_i64(v) for v in values], dtype=torch.int64,
                        device=device)


def to_numpy_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor (any device) -> numpy uint64 with the same bits."""
    return t.detach().cpu().numpy().view(np.uint64)


def from_numpy_u64(a, device="cpu") -> torch.Tensor:
    """numpy uint64 array -> int64 tensor with the same bits on ``device``."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64)).to(device)
