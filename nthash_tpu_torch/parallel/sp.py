"""One genome-scale sequence hashed on one device.

Counterpart of ``nthash_tpu/parallel/sp.py`` without its mesh: the port
hashes on one device, so the halo exchange between devices (one
``ppermute`` of k - 1 bases) has no work to do, and the one device is the
JAX package's last device, whose halo is k - 1 invalid codes. Any request
for more than one device raises NotImplementedError (multi-GPU is later
work). ``resolve_engine`` picks the engine from the device of the codes, not
from a JAX backend query.

The JAX package reshapes the sequence into **overlapping pseudo-reads**
[C/t, t + k - 1] (each row carries the next row's first k - 1 bases) so its
batched engines hash t windows per row in parallel. The port's kernel route
hashes the flat sequence in one pass instead (``kmer_kernel.hash_sequence``,
``seed_kernel.hash_seeds_sequence``: a thread per segment of windows, no
copy of the sequence, no transpose of the outputs); the "torch" route and
the CPU take the plain versions beside them, pseudo-reads on the batch-major
engines. A window's hash depends only on its own k bases, so every route is
exact from its first window. The chunk is still validated as ``pick_tile``
does (one shorter than k - 1 raises, as in the JAX package), and
``pick_tile`` and ``pseudo_reads`` stay as the JAX package's counterparts.

Window w of the result is the window starting at base w; the last k - 1
entries run off the sequence's end and are masked invalid, as is every
window that covers padding.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.kmer_kernel import hash_sequence, hash_sequence_plain
from ..ops.seed_kernel import hash_seeds_sequence, hash_seeds_sequence_plain
from ..ops.seed_torch import check_seeds

ENGINES = ("kernel", "torch")


def _one_device(n_devices: int) -> None:
    if n_devices != 1:
        raise NotImplementedError(
            f"n_devices={n_devices}: sequence parallelism across GPUs (the "
            "halo exchange) is not ported yet (ROADMAP)")


def resolve_engine(engine: str = "auto", device=None) -> str:
    """'auto' -> "kernel" (the wrappers of ``ops/*_kernel.py``: the CUDA
    kernels for a GPU tensor, their plain versions for a CPU one), or
    "torch" (the batch-major reference engines of ``ops/*_torch.py``).
    "auto" takes "kernel" on a CUDA device and "torch" elsewhere, as the
    JAX package takes its Pallas kernel on a TPU only."""
    if engine == "auto":
        return "kernel" if torch.device(device or "cpu").type == "cuda" \
            else "torch"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: one of {ENGINES}")
    return engine


def shard_sequence(codes: torch.Tensor, k: int | None = None,
                   tile: int | None = None, n_devices: int = 1
                   ) -> torch.Tensor:
    """A [L] sequence ready for :func:`hash_long_sequence` on one device.

    With ``k`` given, any length is accepted: the sequence is padded with
    invalid codes up to a multiple of ``max(tile or 256, k - 1, 1)``, so it
    divides into pseudo-reads of at least k - 1 windows. Padded windows hold
    an invalid base and are masked like the off-end windows; window
    w < L - k + 1 is unaffected. Without ``k`` the sequence is returned as
    it is (one device divides any length).
    """
    _one_device(n_devices)
    if k is not None:
        t0 = max(tile or 256, k - 1, 1)
        pad = (-codes.shape[0]) % t0
        if pad:
            codes = torch.nn.functional.pad(codes, (0, pad), value=4)
    return codes


def check_chunk(c: int, k: int) -> int:
    """Raise, as the JAX package does, when a chunk of ``c`` bases is
    shorter than k - 1 (the one error :func:`pick_tile` raises); returns
    the least pseudo-read width, max(k - 1, 1)."""
    lo = max(k - 1, 1)
    if c < lo:
        raise ValueError(
            f"per-device chunk ({c}) is smaller than k-1 ({k - 1}); "
            "pad the sequence (shard_sequence with k=)")
    return lo


def pick_tile(c: int, k: int, tile: int | None = None) -> int:
    """Pseudo-read window count: a divisor of the chunk that is >= k-1
    (``pseudo_reads`` pads each row by t - k + 1, so t < k - 1 would be a
    negative pad), preferring the largest such divisor <= ``tile`` (default
    256) and falling back to the smallest one above."""
    lo = check_chunk(c, k)
    divisors = set()
    i = 1
    while i * i <= c:
        if c % i == 0:
            divisors.update((i, c // i))
        i += 1
    t0 = min(tile or 256, c)
    best_below = max((d for d in divisors if lo <= d <= t0), default=None)
    if best_below is not None:
        return best_below
    return min(d for d in divisors if d >= lo)


def pseudo_reads(ext: torch.Tensor, k: int, t: int) -> torch.Tensor:
    """[C + k - 1] halo-extended sequence -> overlapping rows [C/t, t + k - 1].

    Row i covers bases [i*t, (i+1)*t + k - 1): its t windows are the
    sequence's windows [i*t, (i+1)*t).
    """
    return ext.unfold(0, t + k - 1, t)


def hash_long_sequence(codes: torch.Tensor, k: int, num_hashes: int, *,
                       engine: str = "auto", tile: int | None = None,
                       n_devices: int = 1):
    """Hash every window of one long sequence on its device.

    Args:
      codes: [L] base codes (0-3 valid, 4 and above invalid), e.g. from
        :func:`shard_sequence` with ``k=``.
      engine: "auto", "kernel" or "torch" (:func:`resolve_engine`).
      tile: the JAX package's windows per pseudo-read (default 256); it
        no longer shapes the work, and the chunk is validated as
        :func:`pick_tile` does (:func:`check_chunk`).

    Returns (list of ``num_hashes`` int64 [L] tensors, valid [L] bool):
    entry w of hash i is nte64 hash i of window [w, w + k); the trailing
    k - 1 entries, which would run off the end, are masked invalid.
    """
    _one_device(n_devices)
    check_chunk(codes.shape[0], k)
    if resolve_engine(engine, codes.device) == "kernel":
        return hash_sequence(codes, k, num_hashes)
    return hash_sequence_plain(codes, k, num_hashes)


def hash_long_sequence_seeds(codes: torch.Tensor, seeds: Sequence[str],
                             num_hashes_per_seed: int, *,
                             engine: str = "auto", tile: int | None = None,
                             n_devices: int = 1):
    """Spaced-seed hash of every window of one long sequence on its device.

    As :func:`hash_long_sequence` (the spaced-seed hash depends only on the
    window's bases too; ``tile``, the JAX package's windows per pseudo-read,
    default 128, shapes nothing). Returns (list of S*H int64 [L] tensors in
    reference hash_arr order, valid [L]).
    """
    _one_device(n_devices)
    seeds = tuple(seeds)
    k = check_seeds(seeds)
    check_chunk(codes.shape[0], k)
    if resolve_engine(engine, codes.device) == "kernel":
        return hash_seeds_sequence(codes, seeds, num_hashes_per_seed)
    return hash_seeds_sequence_plain(codes, seeds, num_hashes_per_seed)
