"""Batched stateful blind rolling: BlindNtHash over B walks at once.

Counterpart of ``nthash_tpu/ops/blind_scan.py``. The reference's BlindNtHash
(src/kmer.cpp:338-393) carries (fwd, rev, k-char window) and is fed one base
at a time, the de Bruijn graph traversal primitive. Here that state is
[B]-vectored int64 hashes (uint64 bits, ``u64.py``) plus a [B, k] int32
window, so B independent walks advance in lockstep:

- :func:`roll_many`: replay [T, B] caller-fed base streams. On a CUDA tensor
  one launch of ``csrc/blind.cu`` (``ops/blind_kernel.py``) rolls all T
  steps, the counterpart of the JAX package's compiled ``lax.scan``; on a
  CPU tensor its plain version :func:`roll_many_plain`, a step loop over
  :func:`_roll`.
- :func:`peek4`: the hashes of all four extensions of every walk, the
  batched peek('A'/'C'/'G'/'T').
- :func:`roll_select` / :func:`roll_back_select`: commit a per-walk chosen
  base, forwards or backwards (plain tensor ops on every device).

Every update is the scalar facade's bit-exact recurrence. Codes outside 0-3
hash as the zero seed; the window keeps the codes as given, oldest first,
as the JAX state does. :func:`state_from_numpy` / :func:`state_to_numpy`
carry a state across from and to the JAX package's host arrays.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import u64
from ..constants import COMP_CODE, SEEDS, srol_seed
from . import blind_kernel
from .kmer_torch import hash_kmers, plane_tables

#: Kernel launches made by :func:`roll_many` (``csrc/blind.cu``).
LAUNCHES = 0


class BlindState(NamedTuple):
    """State of B independent blind rollers with a shared k."""

    fwd: torch.Tensor     # [B] int64
    rev: torch.Tensor     # [B] int64
    window: torch.Tensor  # [B, k] int32 codes, window[:, 0] = oldest base
    pos: torch.Tensor     # [B] int32 (parity with BlindNtHash::get_pos)


def init_state(windows: torch.Tensor) -> BlindState:
    """Initialize from [B, k] code windows (hashes the window immediately,
    like the BlindNtHash ctor: no N handling, invalid codes hash as zero)."""
    windows = windows.to(torch.int32)
    b, k = windows.shape
    res = hash_kmers(windows, k, 1)
    return BlindState(res.fwd[:, 0], res.rev[:, 0], windows,
                      torch.zeros(b, dtype=torch.int32, device=windows.device))


def state_from_numpy(fwd_u64, rev_u64, window, pos, device) -> BlindState:
    """A state from host arrays, e.g. a JAX state's ``fwd.to_np()``,
    ``rev.to_np()``, ``np.asarray(window)`` and ``np.asarray(pos)``."""
    return BlindState(
        u64.from_numpy_u64(fwd_u64, device), u64.from_numpy_u64(rev_u64, device),
        torch.from_numpy(np.asarray(window, dtype=np.int32).copy()).to(device),
        torch.from_numpy(np.asarray(pos, dtype=np.int32).copy()).to(device))


def state_to_numpy(state) -> tuple[np.ndarray, ...]:
    """(fwd uint64, rev uint64, window int32, pos int32) host arrays, the
    JAX package's layout (its ``U64.to_np()`` values); for a blind or a
    blind spaced-seed state."""
    return (u64.to_numpy_u64(state.fwd), u64.to_numpy_u64(state.rev),
            state.window.cpu().numpy(), state.pos.cpu().numpy())


def lookup_codes(c: torch.Tensor) -> torch.Tensor:
    """Codes as table indices: 0-3 as they are, anything else 4 (the zero
    seed), int64."""
    c = c.to(torch.int64)
    return torch.where((c < 0) | (c > 4), 4, c)


class _Tables(NamedTuple):
    fwd_in: torch.Tensor     # SEED[b]
    fwd_out: torch.Tensor    # srol^k(SEED[b])
    rev_in: torch.Tensor     # srol^(k-1)(SEED[comp(b)])
    rev_out_r: torch.Tensor  # sror(SEED[comp(b)])
    rev_in_k: torch.Tensor   # srol^k(SEED[comp(b)]): prev_reverse incoming
    rev_in1: torch.Tensor    # SEED[comp(b)]: prev_reverse outgoing


@lru_cache(maxsize=32)
def _tables(k: int, device: torch.device) -> _Tables:
    t = plane_tables(k)
    return _Tables(*(u64.tensor(v, device) for v in (
        t.fwd_in, t.fwd_out, t.rev_in, t.rev_out_r,
        [srol_seed(COMP_CODE[b], k) for b in range(5)],
        [SEEDS[COMP_CODE[b]] for b in range(5)])))


def _roll(state: BlindState, c_in: torch.Tensor) -> BlindState:
    """One step right: the reference's next_forward/reverse_hash."""
    tabs = _tables(state.window.shape[1], state.fwd.device)
    ci, co = lookup_codes(c_in), lookup_codes(state.window[:, 0])
    fwd = u64.srol1(state.fwd) ^ tabs.fwd_in[ci] ^ tabs.fwd_out[co]
    rev = u64.sror1(state.rev) ^ tabs.rev_in[ci] ^ tabs.rev_out_r[co]
    window = torch.cat([state.window[:, 1:],
                        c_in.to(torch.int32)[:, None]], dim=1)
    return BlindState(fwd, rev, window, state.pos + 1)


def _roll_back(state: BlindState, c_in: torch.Tensor) -> BlindState:
    """Inverse roll (reference prev_forward/reverse_hash, kmer.cpp:104-114,
    184-194): remove the newest base, prepend c_in."""
    tabs = _tables(state.window.shape[1], state.fwd.device)
    ci, co = lookup_codes(c_in), lookup_codes(state.window[:, -1])
    fwd = u64.sror1(state.fwd ^ tabs.fwd_out[ci] ^ tabs.fwd_in[co])
    rev = u64.srol1(state.rev) ^ tabs.rev_in1[ci] ^ tabs.rev_in_k[co]
    window = torch.cat([c_in.to(torch.int32)[:, None],
                        state.window[:, :-1]], dim=1)
    return BlindState(fwd, rev, window, state.pos - 1)


def hashes_of(state: BlindState, num_hashes: int = 1) -> torch.Tensor:
    """Current canonical + extended hashes, int64 [B, num_hashes]."""
    k = state.window.shape[1]
    return torch.stack(
        u64.extend_hashes(u64.add(state.fwd, state.rev), k, num_hashes), -1)


def roll_many_plain(state: BlindState, chars: torch.Tensor,
                    num_hashes: int = 1):
    """Plain PyTorch version of :func:`roll_many`, on any device: one
    :func:`_roll` and :func:`hashes_of` a step."""
    out = torch.empty((chars.shape[0], state.fwd.shape[0], num_hashes),
                      dtype=torch.int64, device=state.fwd.device)
    for t in range(chars.shape[0]):
        state = _roll(state, chars[t])
        out[t] = hashes_of(state, num_hashes)
    return state, out


def roll_many(state: BlindState, chars: torch.Tensor, num_hashes: int = 1):
    """Replay [T, B] base streams; returns (final state, hashes int64
    [T, B, num_hashes]).

    A CUDA tensor goes through ``csrc/blind.cu`` (one launch for all T
    steps), a CPU tensor through :func:`roll_many_plain`.
    """
    global LAUNCHES
    if chars.dim() != 2 or chars.shape[1] != state.fwd.shape[0]:
        raise ValueError(f"chars must be [T, {state.fwd.shape[0]}], got "
                         f"{tuple(chars.shape)}")
    if not chars.is_cuda:
        if chars.device.type == "cpu":
            return roll_many_plain(state, chars, num_hashes)
        raise ValueError(f"no blind roll route for device {chars.device}")
    k = state.window.shape[1]
    out, fwd, rev, window = blind_kernel.launch(
        chars, state.window, state.fwd, state.rev, ("1" * k,), num_hashes)
    LAUNCHES += chars.shape[1] > 0  # no walk launches nothing
    return (BlindState(fwd[:, 0], rev[:, 0], window,
                       state.pos + chars.shape[0]), out)


def roll_select(state: BlindState, choice: torch.Tensor) -> BlindState:
    """Roll every walk by its per-lane chosen base code [B]."""
    return _roll(state, choice)


def roll_back_select(state: BlindState, choice: torch.Tensor) -> BlindState:
    """Roll every walk back by its per-lane chosen base code [B]."""
    return _roll_back(state, choice)


def peek4(state: BlindState, num_hashes: int = 1) -> torch.Tensor:
    """Hashes of all four possible extensions, int64 [B, 4, num_hashes]
    (DBG probing). The window is not shifted: only the hashes are formed."""
    k = state.window.shape[1]
    tabs = _tables(k, state.fwd.device)
    co = lookup_codes(state.window[:, 0])
    f = u64.srol1(state.fwd) ^ tabs.fwd_out[co]
    r = u64.sror1(state.rev) ^ tabs.rev_out_r[co]
    f4 = f[:, None] ^ tabs.fwd_in[:4]
    r4 = r[:, None] ^ tabs.rev_in[:4]
    return torch.stack(u64.extend_hashes(u64.add(f4, r4), k, num_hashes), -1)
