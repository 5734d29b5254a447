"""Sequence parallelism: one genome-scale sequence sharded over GPUs.

Counterpart of ``nthash_tpu/parallel/sp.py``. The hash is position
decomposable, so a length-L sequence splits into one chunk a rank with only
a (k - 1)-base halo from the next rank: rank r owns windows [rC, (r+1)C) of
the padded sequence and needs the next rank's first k - 1 codes; the last
rank's halo is k - 1 invalid codes (4), so its off-end windows mask out.
The JAX package moves the halo with one ring ``ppermute``; here one
``all_gather`` of every rank's k - 1 head codes moves it
(:func:`_halo_extend`). A send/receive pair per rank would move less, but
gloo's point-to-point calls do not take CUDA tensors, and the all-gather
runs on NCCL and gloo, CUDA and CPU alike; the heads are n (k - 1) bytes.

The JAX package reshapes each chunk into **overlapping pseudo-reads**
[C/t, t + k - 1] (each row carries the next row's first k - 1 bases) so its
batched engines hash t windows per row in parallel. The port's kernel route
hashes the halo-extended chunk in one pass instead
(``kmer_kernel.hash_sequence``, ``seed_kernel.hash_seeds_sequence``: a
thread per segment of windows, no pseudo-read copy, no transpose of the
outputs; with a mesh the chunk and its halo are first joined into one
[C + k - 1] tensor); the "torch" route and the CPU take the plain versions beside
them, pseudo-reads on the batch-major engines. A window's hash depends only
on its own k bases, so every route is exact from its first window. The
chunk is still validated as ``pick_tile`` does (one shorter than k - 1
raises, as in the JAX package), and ``pick_tile`` and ``pseudo_reads`` stay
as the JAX package's counterparts.

``mesh=None`` hashes on one device with no group: the one device is the
JAX package's last device, whose halo is k - 1 invalid codes, so no halo is
added. ``n_devices``, if given, must be the number of devices the call
spans (1 without a mesh).

Window w of a rank's result is the window starting at base rC + w; the last
k - 1 windows of the sequence run off its end and are masked invalid, as is
every window that covers padding.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops import kmer_kernel, seed_kernel
from ..ops.kmer_kernel import hash_sequence, hash_sequence_plain
from ..ops.seed_kernel import (
    hash_seeds_sequence,
    hash_seeds_sequence_plain,
    with_empty_seeds,
)
from ..ops.seed_torch import check_seeds
from .dp import resolve_engine
from .mesh import all_gather, size_and_rank


def _spanned(mesh, n_devices: int | None) -> tuple[int, int]:
    """(devices the call spans, this rank); raise ValueError where
    ``n_devices`` names another count."""
    n, r = (1, 0) if mesh is None else size_and_rank(mesh)
    if n_devices is not None and n_devices != n:
        raise ValueError(
            f"n_devices={n_devices}: this call spans {n} device(s); pass "
            "the mesh of the whole process group (parallel/mesh.py "
            "device_mesh) to shard over GPUs")
    return n, r


def shard_sequence(codes: torch.Tensor, mesh=None, k: int | None = None,
                   tile: int | None = None, *,
                   n_devices: int | None = None) -> torch.Tensor:
    """This rank's chunk of a [L] sequence, for :func:`hash_long_sequence`.

    With ``k`` given, any length is accepted: the sequence is padded with
    invalid codes up to a multiple of ``n * max(tile or 256, k - 1, 1)``
    for a mesh of n ranks, so every chunk divides into pseudo-reads of at
    least k - 1 windows. Padded windows hold an invalid base and are masked
    like the off-end windows; window w < L - k + 1 is unaffected. Without
    ``k``, L must divide by n (any length on one device).
    """
    n, r = _spanned(mesh, n_devices)
    if k is not None:
        pad = (-codes.shape[0]) % (n * max(tile or 256, k - 1, 1))
        if pad:
            codes = torch.nn.functional.pad(codes, (0, pad), value=4)
    elif codes.shape[0] % n:
        raise ValueError(
            f"sequence length {codes.shape[0]} is not divisible by the "
            f"{n}-device seq mesh; pass k= to shard_sequence to pad")
    c = codes.shape[0] // n
    return codes[r * c:(r + 1) * c]


def _halo_extend(chunk: torch.Tensor, k: int, mesh) -> torch.Tensor:
    """[C] chunk -> [C + k - 1]: the next rank's first k - 1 codes appended,
    k - 1 invalid codes on the last rank."""
    if k == 1:
        return chunk
    n, r = size_and_rank(mesh)
    heads = all_gather(chunk[:k - 1], mesh)      # [n, k - 1]
    halo = heads[r + 1] if r + 1 < n else torch.full_like(heads[0], 4)
    return torch.cat([chunk, halo])


def _hash_chunk(fn, chunk: torch.Tensor, k: int, mesh):
    """``fn(codes) -> (hashes, valid)`` over this rank's chunk and its halo,
    cut back to the chunk's windows."""
    if mesh is None:
        return fn(chunk)
    c = chunk.shape[0]
    hashes, valid = fn(_halo_extend(chunk, k, mesh))
    return [h[:c] for h in hashes], valid[:c]


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


def hash_long_sequence(codes: torch.Tensor, k: int, num_hashes: int,
                       mesh=None, *, engine: str = "auto",
                       tile: int | None = None,
                       n_devices: int | None = None):
    """Hash every window of a long sequence sharded over the mesh.

    Args:
      codes: this rank's [C] chunk of base codes (0-3 valid, 4 and above
        invalid), e.g. from :func:`shard_sequence` with ``k=``; on one
        device (``mesh=None``) the whole sequence.
      engine: "auto", "kernel" or "torch" (``dp.resolve_engine``).
      tile: the JAX package's windows per pseudo-read (default 256); it
        no longer shapes the work, and the chunk is validated as
        :func:`pick_tile` does (:func:`check_chunk`).

    Returns (list of ``num_hashes`` int64 [C] tensors, valid [C] bool), this
    rank's windows: entry w of hash i is nte64 hash i of the window starting
    at base rC + w; the sequence's trailing k - 1 windows, which would run
    off its end, are masked invalid. On a CUDA tensor a k that does not fit
    the one-pass entry (``kmer_kernel.sequence_fits``) takes the read
    kernel over pseudo-reads (``kmer_kernel.hash_sequence_rows``).
    """
    _spanned(mesh, n_devices)
    check_chunk(codes.shape[0], k)
    fn = (hash_sequence if resolve_engine(engine, codes.device) == "kernel"
          else hash_sequence_plain)
    if codes.is_cuda and fn is hash_sequence \
            and not kmer_kernel.sequence_fits(k, num_hashes):
        fn = kmer_kernel.hash_sequence_rows
    return _hash_chunk(lambda x: fn(x, k, num_hashes), codes, k, mesh)


def hash_long_sequence_seeds(codes: torch.Tensor, seeds: Sequence[str],
                             num_hashes_per_seed: int, mesh=None, *,
                             engine: str = "auto", tile: int | None = None,
                             n_devices: int | None = None):
    """Spaced-seed hash of every window of a long sequence sharded over the
    mesh.

    As :func:`hash_long_sequence` (the spaced-seed hash depends only on the
    window's bases too; ``tile``, the JAX package's windows per pseudo-read,
    default 128, shapes nothing). Returns (list of S*H int64 [C] tensors in
    reference hash_arr order, valid [C]) for this rank's windows. A seed
    with no care position hashes to 0, as in the JAX package's jnp engine
    (``seed_kernel.with_empty_seeds``). On a CUDA tensor seeds that do not
    fit the one-pass entry (``seed_kernel.sequence_fits``) take B1 over
    pseudo-reads (``seed_kernel.hash_seeds_sequence_rows``), as the
    facade's tiles do.
    """
    _spanned(mesh, n_devices)
    seeds = tuple(seeds)
    k = check_seeds(seeds)
    check_chunk(codes.shape[0], k)
    kernel = resolve_engine(engine, codes.device) == "kernel"

    def hash_care(x, care):
        fn = hash_seeds_sequence if kernel else hash_seeds_sequence_plain
        if kernel and x.is_cuda and not seed_kernel.sequence_fits(
                care, num_hashes_per_seed):
            fn = seed_kernel.hash_seeds_sequence_rows
        return fn(x, care, num_hashes_per_seed)

    return _hash_chunk(
        lambda x: with_empty_seeds(hash_care, x, seeds, num_hashes_per_seed),
        codes, k, mesh)
