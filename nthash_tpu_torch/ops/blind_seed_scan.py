"""Batched stateful blind spaced-seed rolling: BlindSeedNtHash over B walks.

Counterpart of ``nthash_tpu/ops/blind_seed_scan.py``. The reference's
BlindSeedNtHash (src/seed.cpp:669-737) carries per-seed (fwd, rev) plus a
k-char window and is fed one base at a time. Here that state is [B, S]
int64 hashes plus a [B, k] int32 window, so B caller-fed walks advance in
lockstep.

Rolling uses the two-tap care-run updates of ``ops/seed_kernel.py``
(``seed_taps``), with taps gathered from the stored window at static
positions: for care run [s, e) the entering base is window position e (the
incoming base when e = k) and the leaving one position s. :func:`_roll_back`
is the exact algebraic inverse, bit for bit (reference seed.cpp:720-737),
with taps at window positions e - 1 and s - 1, where s - 1 = -1 is the
incoming (prepended) base. :func:`roll_many` on a CUDA tensor is one launch
of ``csrc/blind.cu``; on a CPU tensor its plain version, a step loop over
:func:`_roll`. :func:`peek4` has no JAX counterpart: the four extensions'
hashes, as ``blind_scan.peek4`` gives them for k-mers.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Sequence

import torch

from .. import u64
from . import blind_kernel, blind_scan
from .blind_scan import lookup_codes
from .seed_kernel import _all_taps
from .seed_torch import hash_kmers_seeds

#: Kernel launches made by :func:`roll_many` (``csrc/blind.cu``).
LAUNCHES = 0


class BlindSeedState(NamedTuple):
    """State of B independent blind spaced-seed rollers (shared seed set)."""

    fwd: torch.Tensor     # [B, S] int64
    rev: torch.Tensor     # [B, S] int64
    window: torch.Tensor  # [B, k] int32 codes, window[:, 0] = oldest base
    pos: torch.Tensor     # [B] int32


def init_state(windows: torch.Tensor, seeds: Sequence[str]) -> BlindSeedState:
    """Initialize from [B, k] code windows (hashes immediately, like the
    BlindSeedNtHash ctor: invalid codes hash as the zero seed)."""
    windows = windows.to(torch.int32)
    b, k = windows.shape
    if any(len(s) != k for s in seeds):
        raise ValueError("all seed strings must have length k")
    res = hash_kmers_seeds(windows, tuple(seeds), 1)
    return BlindSeedState(res.fwd[:, 0], res.rev[:, 0], windows,
                          torch.zeros(b, dtype=torch.int32,
                                      device=windows.device))


def state_from_numpy(fwd_u64, rev_u64, window, pos, device) -> BlindSeedState:
    """A state from host arrays ([B, S] uint64 fwd and rev, [B, k] window,
    [B] pos), e.g. a JAX state's ``fwd.to_np()`` and the rest."""
    return BlindSeedState(*blind_scan.state_from_numpy(fwd_u64, rev_u64,
                                                       window, pos, device))


#: (fwd, rev, window, pos) host arrays of a state, as for k-mers.
state_to_numpy = blind_scan.state_to_numpy


@lru_cache(maxsize=32)
def _taps(seeds: tuple[str, ...], device: torch.device):
    """Per seed, per care run: (s, e, fwd_in, fwd_out, rev_in, rev_out) with
    the four 5-entry tables as int64 tensors on ``device``."""
    k = len(seeds[0])
    return tuple(
        tuple((k - b.off_out, k - b.off_in,
               *(u64.tensor(v, device)
                 for v in (b.fwd_in, b.fwd_out, b.rev_in, b.rev_out)))
              for b in taps)
        for taps in _all_taps(seeds))


def _roll(seeds, state: BlindSeedState, c_in: torch.Tensor) -> BlindSeedState:
    k = state.window.shape[1]
    ci = lookup_codes(c_in)
    win = state.window
    fwds, revs = [], []
    for si, runs in enumerate(_taps(tuple(seeds), state.fwd.device)):
        f = u64.srol1(state.fwd[:, si])
        r = u64.sror1(state.rev[:, si])
        for s, e, fwd_in, fwd_out, rev_in, rev_out in runs:
            c_enter = ci if e == k else lookup_codes(win[:, e])
            c_leave = lookup_codes(win[:, s])
            f = f ^ fwd_in[c_enter] ^ fwd_out[c_leave]
            r = r ^ rev_in[c_enter] ^ rev_out[c_leave]
        fwds.append(f)
        revs.append(r)
    window = torch.cat([state.window[:, 1:],
                        c_in.to(torch.int32)[:, None]], dim=1)
    return BlindSeedState(torch.stack(fwds, -1), torch.stack(revs, -1),
                          window, state.pos + 1)


def _roll_back(seeds, state: BlindSeedState,
               c_in: torch.Tensor) -> BlindSeedState:
    """Exact inverse of :func:`_roll`: fwd(w-1) = sror(fwd(w) ^ E ^ O),
    rev(w-1) = srol(rev(w) ^ E_r ^ O_r), taps at window positions e-1 / s-1
    (s-1 = -1 selects the incoming prepended base)."""
    ci = lookup_codes(c_in)
    win = state.window
    fwds, revs = [], []
    for si, runs in enumerate(_taps(tuple(seeds), state.fwd.device)):
        f = state.fwd[:, si]
        r = state.rev[:, si]
        for s, e, fwd_in, fwd_out, rev_in, rev_out in runs:
            c_enter = lookup_codes(win[:, e - 1])
            c_leave = ci if s == 0 else lookup_codes(win[:, s - 1])
            f = f ^ fwd_in[c_enter] ^ fwd_out[c_leave]
            r = r ^ rev_in[c_enter] ^ rev_out[c_leave]
        fwds.append(u64.sror1(f))
        revs.append(u64.srol1(r))
    window = torch.cat([c_in.to(torch.int32)[:, None],
                        state.window[:, :-1]], dim=1)
    return BlindSeedState(torch.stack(fwds, -1), torch.stack(revs, -1),
                          window, state.pos - 1)


def hashes_of(state: BlindSeedState,
              num_hashes_per_seed: int = 1) -> torch.Tensor:
    """Current hashes, int64 [B, S * num_hashes_per_seed] in reference
    hash_arr (seed-major) order."""
    k = state.window.shape[1]
    canon = u64.add(state.fwd, state.rev)  # [B, S]
    ext = u64.extend_hashes(canon, k, num_hashes_per_seed)
    return torch.stack(ext, -1).reshape(canon.shape[0], -1)


def roll_select(state: BlindSeedState, choice: torch.Tensor,
                seeds: Sequence[str]) -> BlindSeedState:
    """Roll every walk by its per-lane chosen base code [B]."""
    return _roll(seeds, state, choice)


def roll_back_select(state: BlindSeedState, choice: torch.Tensor,
                     seeds: Sequence[str]) -> BlindSeedState:
    """Roll every walk back by its per-lane chosen base code [B]."""
    return _roll_back(seeds, state, choice)


def roll_many_plain(state: BlindSeedState, chars: torch.Tensor,
                    seeds: Sequence[str], num_hashes_per_seed: int = 1):
    """Plain PyTorch version of :func:`roll_many`, on any device: one
    :func:`_roll` and :func:`hashes_of` a step."""
    out = torch.empty((chars.shape[0], state.fwd.shape[0],
                       len(seeds) * num_hashes_per_seed),
                      dtype=torch.int64, device=state.fwd.device)
    for t in range(chars.shape[0]):
        state = _roll(seeds, state, chars[t])
        out[t] = hashes_of(state, num_hashes_per_seed)
    return state, out


def roll_many(state: BlindSeedState, chars: torch.Tensor,
              seeds: Sequence[str], num_hashes_per_seed: int = 1):
    """Replay [T, B] base streams; returns (final state, hashes int64
    [T, B, S * num_hashes_per_seed]).

    A CUDA tensor goes through ``csrc/blind.cu`` (one launch for all T
    steps), a CPU tensor through :func:`roll_many_plain`.
    """
    global LAUNCHES
    seeds = tuple(seeds)
    if chars.dim() != 2 or chars.shape[1] != state.fwd.shape[0]:
        raise ValueError(f"chars must be [T, {state.fwd.shape[0]}], got "
                         f"{tuple(chars.shape)}")
    if not chars.is_cuda:
        if chars.device.type == "cpu":
            return roll_many_plain(state, chars, seeds, num_hashes_per_seed)
        raise ValueError(f"no blind roll route for device {chars.device}")
    out, fwd, rev, window = blind_kernel.launch(
        chars, state.window, state.fwd, state.rev, seeds,
        num_hashes_per_seed)
    LAUNCHES += chars.shape[1] > 0  # no walk launches nothing
    return (BlindSeedState(fwd, rev, window, state.pos + chars.shape[0]),
            out)


def peek4(state: BlindSeedState, seeds: Sequence[str],
          num_hashes_per_seed: int = 1) -> torch.Tensor:
    """Hashes of all four possible extensions, int64 [B, 4, S *
    num_hashes_per_seed]."""
    b = state.fwd.shape[0]
    return torch.stack([
        hashes_of(_roll(seeds, state, torch.full(
            (b,), code, dtype=torch.int32, device=state.fwd.device)),
            num_hashes_per_seed)
        for code in range(4)], 1)
