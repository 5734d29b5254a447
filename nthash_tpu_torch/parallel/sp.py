"""One genome-scale sequence hashed on one device through pseudo-reads.

Counterpart of ``nthash_tpu/parallel/sp.py`` without its mesh: the port
hashes on one device, so the halo exchange between devices (one
``ppermute`` of k - 1 bases) has no work to do, and the one device is the
JAX package's last device, whose halo is k - 1 invalid codes. Any request
for more than one device raises NotImplementedError (multi-GPU is later
work). ``resolve_engine`` picks the engine from the device of the codes, not
from a JAX backend query.

The sequence is reshaped into **overlapping pseudo-reads** [C/t, t + k - 1]
(each row carries the next row's first k - 1 bases), so the batched engines
hash t windows per row in parallel: the rolling kernels (A1, and B1 for
spaced seeds) on a GPU, their plain versions on the CPU. A window's hash
depends only on its own k bases, so every pseudo-read is exact from its
first window.

Window w of the result is the window starting at base w; the last k - 1
entries run off the sequence's end and are masked invalid, as is every
window that covers padding.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.kmer_kernel import hash_kmers_tm, prepare_codes
from ..ops.kmer_torch import hash_kmers, window_valid
from ..ops.seed_kernel import hash_seeds_tm
from ..ops.seed_torch import check_seeds, hash_kmers_seeds

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


def pick_tile(c: int, k: int, tile: int | None = None) -> int:
    """Pseudo-read window count: a divisor of the chunk that is >= k-1
    (``pseudo_reads`` pads each row by t - k + 1, so t < k - 1 would be a
    negative pad), preferring the largest such divisor <= ``tile`` (default
    256) and falling back to the smallest one above."""
    lo = max(k - 1, 1)
    if c < lo:
        raise ValueError(
            f"per-device chunk ({c}) is smaller than k-1 ({k - 1}); "
            "pad the sequence (shard_sequence with k=)")
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


def _halo_extend(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Append the k - 1 invalid codes the JAX package's last device gets as
    its halo, so the off-end windows mask out."""
    return torch.nn.functional.pad(codes, (0, k - 1), value=4)


def pseudo_reads(ext: torch.Tensor, k: int, t: int) -> torch.Tensor:
    """[C + k - 1] halo-extended sequence -> overlapping rows [C/t, t + k - 1].

    Row i covers bases [i*t, (i+1)*t + k - 1): its t windows are the
    sequence's windows [i*t, (i+1)*t).
    """
    return ext.unfold(0, t + k - 1, t)


def _flat(planes) -> list[torch.Tensor]:
    """[t, rows] per-hash planes -> flat [rows * t] in window order."""
    return [p.T.reshape(-1) for p in planes]


def hash_long_sequence(codes: torch.Tensor, k: int, num_hashes: int, *,
                       engine: str = "auto", tile: int | None = None,
                       n_devices: int = 1):
    """Hash every window of one long sequence on its device.

    Args:
      codes: [L] base codes (0-3 valid, 4 and above invalid), e.g. from
        :func:`shard_sequence` with ``k=``.
      engine: "auto", "kernel" or "torch" (:func:`resolve_engine`).
      tile: windows per pseudo-read (default 256; adjusted to divide L).

    Returns (list of ``num_hashes`` int64 [L] tensors, valid [L] bool):
    entry w of hash i is nte64 hash i of window [w, w + k); the trailing
    k - 1 entries, which would run off the end, are masked invalid.
    """
    _one_device(n_devices)
    c = codes.shape[0]
    t = pick_tile(c, k, tile)
    pseudo = pseudo_reads(_halo_extend(codes, k), k, t)
    if resolve_engine(engine, codes.device) == "kernel":
        hashes = _flat(hash_kmers_tm(prepare_codes(pseudo), k, num_hashes))
    else:
        res = hash_kmers(pseudo, k, num_hashes)
        hashes = [res.hashes[..., i].reshape(-1) for i in range(num_hashes)]
    valid = window_valid(pseudo.to(torch.int32), k).reshape(-1)
    return hashes, valid


def hash_long_sequence_seeds(codes: torch.Tensor, seeds: Sequence[str],
                             num_hashes_per_seed: int, *,
                             engine: str = "auto", tile: int | None = None,
                             n_devices: int = 1):
    """Spaced-seed hash of every window of one long sequence on its device.

    Same pseudo-read scheme as :func:`hash_long_sequence` (the spaced-seed
    hash depends only on the window's bases too), with the JAX package's
    default of 128 windows per pseudo-read. Returns (list of S*H int64 [L]
    tensors in reference hash_arr order, valid [L]).
    """
    _one_device(n_devices)
    seeds = tuple(seeds)
    k = check_seeds(seeds)
    c = codes.shape[0]
    t = pick_tile(c, k, tile if tile is not None else 128)
    pseudo = pseudo_reads(_halo_extend(codes, k), k, t)
    nout = len(seeds) * num_hashes_per_seed
    if resolve_engine(engine, codes.device) == "kernel":
        hashes = _flat(hash_seeds_tm(prepare_codes(pseudo), seeds,
                                     num_hashes_per_seed))
    else:
        res = hash_kmers_seeds(pseudo, seeds, num_hashes_per_seed)
        hashes = [res.hashes[..., i].reshape(-1) for i in range(nout)]
    valid = window_valid(pseudo.to(torch.int32), k).reshape(-1)
    return hashes, valid
