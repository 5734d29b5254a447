"""The spaced-seed rolling kernels over time-major reads, and their plain
versions.

Counterpart of ``nthash_tpu/ops/seed_pallas.py`` (``care_runs``,
``seed_taps``, ``hash_seeds_tm``, ``hash_seeds_tm_long``,
``hash_seeds_tm_auto``, ``hash_seeds_batch``). Both routes launch
``csrc/seed_hash.cu``: :func:`hash_seeds_tm` with one segment per read (B1,
the Pallas ``_kernel``), :func:`hash_seeds_tm_long` with segments of
``time_tile`` windows (B3, the Pallas ``_kernel_long``). The kernel is the
staged one wherever its shared memory fits a block (:func:`seed_grid`), else
the global one. :func:`hash_seeds_sequence` hashes one flat sequence in one
launch (``parallel/sp.py``'s kernel route). The source note says what bounds
the kernels on the H100.

Buckets past 2**30 bits (to 2**38, a filter past 2**31 bits) take the wide
route: the same kernels' int64 instances (``seed_staged_wide_kernel``,
``seed_hash_wide_kernel``), which write each bucket, and the sentinel
``2**emit_buckets``, in 8 bytes. The route follows from the width alone;
``route="wide"`` forces it at any width, for the tests.

The rolling reformulation is the JAX package's: the spaced-seed hash is an
XOR of independently rotated per-base seeds over the care positions, so for
each maximal care run [s, e) rolling the window by one base is two edge
updates (taps at offsets k - e and k - s behind the newest base). Each
wrapper launches the kernel for a CUDA tensor and runs its plain version for
a CPU tensor; there is no other route, and a failed launch raises. Either
runs inside the span ``nthash.seed`` (``utils/profiling.span``). Any R
works (no TPU read padding). ``ops/seed_torch.py`` is the independent
direct reference the tests hold both routes to.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Sequence

import torch

from .. import u64
from ..constants import COMP_CODE, SROL_PERIOD, nte64_multiplier, srol_seed
from ..utils.profiling import span
from . import cuda_build
from .hist_kernel import MAX_WIDTH_LOG2, WIDE_MAX_WIDTH_LOG2
from .kmer_kernel import (
    MAX_SHARED_BYTES,
    aligned,
    check_args,
    finish_planes,
    fit_warps,
    long_read_threshold,
    prepare_codes,
    resolve_time_tile,
    ring_rows,
    sequence_codes,
    sequence_grid,
    sequence_outputs,
    sequence_rows,
    sequence_span,
    sequence_warps,
    tables_bytes,
)
from .kmer_torch import segment_codes, unsegment, window_valid
from .seed_torch import check_seeds, hash_kmers_seeds

#: Kernel launches made by :func:`hash_seeds_tm` (one segment per read).
LAUNCHES = 0
#: Kernel launches made by :func:`hash_seeds_tm_long` (segmented).
LONG_LAUNCHES = 0
#: Kernel launches made by :func:`hash_seeds_sequence`.
SEQUENCE_LAUNCHES = 0
#: Of those, launches of its fwd/rev instance (``emit_fwd_rev=True``).
FWD_REV_LAUNCHES = 0
#: Read-kernel launches by route ("staged", "global", and "wide": either
#: kernel's int64 buckets).
ROUTE_LAUNCHES = {"staged": 0, "global": 0, "wide": 0}
#: The routes a read wrapper's ``route`` may name.
ROUTES = (None, "staged", "global", "wide")


class BlockTaps(NamedTuple):
    """Constants for one care run [s, e) of one seed (uint64 as Python ints)."""

    off_in: int                 # tap offset from t for the entering edge: k - e
    off_out: int                # tap offset for the leaving edge: k - s
    fwd_in: tuple[int, ...]     # srol^(k-e)(SEED[b])
    fwd_out: tuple[int, ...]    # srol^(k-s)(SEED[b])
    rev_in: tuple[int, ...]     # srol^(e-1)(SEED[comp(b)])
    rev_out: tuple[int, ...]    # srol^(s-1)(SEED[comp(b)])


def care_runs(seed: str) -> list[tuple[int, int]]:
    """Maximal runs of '1' (care) positions in a pattern string."""
    runs, start = [], None
    for i, ch in enumerate(seed):
        if ch == "1" and start is None:
            start = i
        elif ch != "1" and start is not None:
            runs.append((start, i))
            start = None
    if start is not None:
        runs.append((start, len(seed)))
    if not runs:
        raise ValueError(f"seed pattern has no care positions: {seed!r}")
    return runs


def seed_taps(seed: str) -> list[BlockTaps]:
    """The two taps of every care run of ``seed``. A run starting at 0 has
    the exponent s - 1 = -1, i.e. srol^1022 in the order-1,023 group."""
    k = len(seed)
    taps = []
    for s, e in care_runs(seed):
        taps.append(BlockTaps(
            off_in=k - e,
            off_out=k - s,
            fwd_in=tuple(srol_seed(c, k - e) for c in range(4)) + (0,),
            fwd_out=tuple(srol_seed(c, k - s) for c in range(4)) + (0,),
            rev_in=tuple(srol_seed(COMP_CODE[c], (e - 1) % SROL_PERIOD)
                         for c in range(4)) + (0,),
            rev_out=tuple(srol_seed(COMP_CODE[c], (s - 1) % SROL_PERIOD)
                          for c in range(4)) + (0,),
        ))
    return taps


@lru_cache(maxsize=64)
def _all_taps(seeds: tuple[str, ...]) -> tuple[tuple[BlockTaps, ...], ...]:
    return tuple(tuple(seed_taps(s)) for s in seeds)


def _check(codes_tm, seeds, num_hashes, emit_fwd_rev, emit_buckets) -> int:
    """Validate the arguments; returns k, the seeds' common length."""
    k = check_seeds(seeds)
    _all_taps(tuple(seeds))  # a pattern with no care position raises
    check_args(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets,
               WIDE_MAX_WIDTH_LOG2)
    return k


def is_wide(emit_buckets: int | None, route: str | None = None) -> bool:
    """Whether a call emits the wide buckets (int64): buckets past
    2**``MAX_WIDTH_LOG2`` bits, or ``route="wide"`` at any width. Raises
    for a route that cannot emit them."""
    if route not in ROUTES:
        raise ValueError(f"unknown seed_hash route {route!r}")
    if route == "wide" and emit_buckets is None:
        raise ValueError("the wide route emits buckets: give emit_buckets")
    wide = route == "wide" or (emit_buckets or 0) > MAX_WIDTH_LOG2
    if wide and route != "wide" and route is not None:
        raise ValueError(f"emit_buckets ({emit_buckets}) past "
                         f"{MAX_WIDTH_LOG2} takes the wide route, not "
                         f"{route!r}")
    return wide


def bucket_dtype(emit_buckets: int | None, route: str | None = None):
    """The dtype of a call's buckets: int64 on the wide route, else int32."""
    return torch.int64 if is_wide(emit_buckets, route) else torch.int32


def roll_seeds_tm(codes_tm: torch.Tensor, seeds: Sequence[str]):
    """[L, R] codes -> (per seed fwd [W, R], per seed rev [W, R]) int64: the
    two-tap roll of every seed, one Python step per base, each tap skipped
    until the roll is ``off`` bases in (the Pallas kernel's static guards)."""
    length, reads = codes_tm.shape
    k = len(seeds[0])
    dev = codes_tm.device
    codes = codes_tm.to(torch.int64).clamp(max=4)
    all_taps = [[(b.off_in, b.off_out, u64.tensor(b.fwd_in, dev),
                  u64.tensor(b.fwd_out, dev), u64.tensor(b.rev_in, dev),
                  u64.tensor(b.rev_out, dev)) for b in taps]
                for taps in _all_taps(tuple(seeds))]
    w = length - k + 1
    fwd_seq = [torch.empty((w, reads), dtype=torch.int64, device=dev)
               for _ in seeds]
    rev_seq = [torch.empty((w, reads), dtype=torch.int64, device=dev)
               for _ in seeds]
    fwd = [torch.zeros(reads, dtype=torch.int64, device=dev) for _ in seeds]
    rev = [torch.zeros(reads, dtype=torch.int64, device=dev) for _ in seeds]
    for t in range(length):
        for si, taps in enumerate(all_taps):
            f, r = u64.srol1(fwd[si]), u64.sror1(rev[si])
            for off_in, off_out, fwd_in, fwd_out, rev_in, rev_out in taps:
                if t >= off_in:
                    c = codes[t - off_in]
                    f = f ^ fwd_in[c]
                    r = r ^ rev_in[c]
                if t >= off_out:
                    c = codes[t - off_out]
                    f = f ^ fwd_out[c]
                    r = r ^ rev_out[c]
            fwd[si], rev[si] = f, r
            if t >= k - 1:
                fwd_seq[si][t - k + 1] = f
                rev_seq[si][t - k + 1] = r
    return fwd_seq, rev_seq


def _finish(codes_tm, fwds, revs, k, num_hashes, emit_fwd_rev, emit_buckets,
            dtype):
    """Per-seed [W, R] fwd/rev -> the wrappers' outputs in hash_arr order,
    buckets as ``dtype``."""
    return [o for f, r in zip(fwds, revs)
            for o in finish_planes(codes_tm, f, r, k, num_hashes,
                                   emit_fwd_rev, emit_buckets, dtype)]


def hash_seeds_tm_plain(codes_tm: torch.Tensor, seeds: Sequence[str],
                        num_hashes_per_seed: int = 1, *,
                        emit_fwd_rev: bool = False,
                        emit_buckets: int | None = None,
                        route: str | None = None) -> list[torch.Tensor]:
    """Plain PyTorch version of :func:`hash_seeds_tm`, on any device: the
    two-tap roll over whole reads (:func:`roll_seeds_tm`), then the nte64
    extensions per seed and, in bucket mode, strict validity; int64
    buckets on the wide route."""
    k = _check(codes_tm, seeds, num_hashes_per_seed, emit_fwd_rev,
               emit_buckets)
    dtype = bucket_dtype(emit_buckets, route)
    fwds, revs = roll_seeds_tm(codes_tm, seeds)
    return _finish(codes_tm, fwds, revs, k, num_hashes_per_seed,
                   emit_fwd_rev, emit_buckets, dtype)


def hash_seeds_tm_long_plain(codes_tm: torch.Tensor, seeds: Sequence[str],
                             num_hashes_per_seed: int = 1, *,
                             time_tile: int | None = None,
                             emit_fwd_rev: bool = False,
                             emit_buckets: int | None = None,
                             route: str | None = None
                             ) -> list[torch.Tensor]:
    """Plain PyTorch version of :func:`hash_seeds_tm_long`, on any device:
    the kernel's segments rolled from zero state as reads of their own
    (``kmer_torch.segment_codes``), then put back in window order."""
    k = _check(codes_tm, seeds, num_hashes_per_seed, emit_fwd_rev,
               emit_buckets)
    dtype = bucket_dtype(emit_buckets, route)
    w, reads = codes_tm.shape[0] - k + 1, codes_tm.shape[1]
    seg = min(resolve_time_tile(k, time_tile), w)
    fwds, revs = roll_seeds_tm(segment_codes(codes_tm, k, seg), seeds)
    return _finish(codes_tm, [unsegment(f, w, reads) for f in fwds],
                   [unsegment(r, w, reads) for r in revs], k,
                   num_hashes_per_seed, emit_fwd_rev, emit_buckets, dtype)


@lru_cache(maxsize=32)
def _kernel_tables(seeds: tuple[str, ...], num_hashes: int,
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(tables int64, meta int32) on ``device`` in ``seed_hash.cu``'s layout:
    per run its four 5-entry tables, then the nte64 multipliers for k =
    the pattern length; per run (off_in, off_out), then the S + 1 run
    offsets."""
    k = len(seeds[0])
    vals, offs, starts = [], [], [0]
    for taps in _all_taps(seeds):
        for b in taps:
            vals += list(b.fwd_in) + list(b.fwd_out) + list(b.rev_in) \
                + list(b.rev_out)
            offs += [b.off_in, b.off_out]
        starts.append(starts[-1] + len(taps))
    vals += [nte64_multiplier(i, k) for i in range(1, num_hashes)]
    tables = u64.tensor(vals, device)
    meta = torch.tensor(offs + starts, dtype=torch.int32, device=device)
    return tables, meta


def seed_grid(k: int, nseeds: int, nruns: int,
              num_hashes: int) -> tuple[int, int]:
    """(warps a block, ring rows) of the staged read kernel, from the shapes
    alone: up to 8 warps, each with its ring and every seed's state (16
    bytes a lane); (0, 0) when one warp does not fit beside the tables, and
    the global kernel runs instead."""
    ring = ring_rows(k)
    warps = fit_warps(tables_bytes(nseeds, nruns, num_hashes),
                      ring * 32 + nseeds * 32 * 16, 8)
    return (warps, ring) if warps else (0, 0)


def pair_tables(runs: Sequence[BlockTaps]) -> list[int]:
    """Per run its 25 (fwd, rev) pairs at 5 c_in + c_out, as uint64 Python
    ints, fwd before rev: (fwd_in[c_in] ^ fwd_out[c_out], rev_in[c_in] ^
    rev_out[c_out]), the two taps of a step in one entry."""
    vals = []
    for b in runs:
        for ci in range(5):
            for co in range(5):
                vals += [b.fwd_in[ci] ^ b.fwd_out[co],
                         b.rev_in[ci] ^ b.rev_out[co]]
    return vals


@lru_cache(maxsize=32)
def _pair_kernel_tables(seeds: tuple[str, ...], num_hashes: int,
                        device: torch.device
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(tables int64, meta int32) on ``device`` in the staged kernels'
    layout: every run's pair tables, then the nte64 multipliers for k = the
    pattern length; per run (off_in, off_out), then the S + 1 run offsets."""
    k = len(seeds[0])
    runs = [b for taps in _all_taps(seeds) for b in taps]
    starts = [0]
    for taps in _all_taps(seeds):
        starts.append(starts[-1] + len(taps))
    vals = pair_tables(runs) + [nte64_multiplier(i, k)
                                for i in range(1, num_hashes)]
    offs = [o for b in runs for o in (b.off_in, b.off_out)]
    return (u64.tensor(vals, device),
            torch.tensor(offs + starts, dtype=torch.int32, device=device))


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("seed_hash")
    fn = lib.nthash_seed_hash
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        seq = lib.nthash_seed_sequence
        seq.restype = ctypes.c_int
        seq.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
    return lib


def _launch(codes_tm, seeds, k, num_hashes, emit_fwd_rev, emit_buckets, seg,
            route=None):
    """Launch ``seed_hash.cu`` with ``seg`` windows per segment: the staged
    kernel where :func:`seed_grid` fits it, else the global one, each in
    its int64 instance on the wide route (:func:`is_wide`); ``route``
    ("staged", "global" or "wide") forces one, for the tests and the smoke
    run."""
    length, reads = codes_tm.shape
    dev = codes_tm.device
    nruns = sum(len(t) for t in _all_taps(seeds))
    warps, ring = seed_grid(k, len(seeds), nruns, num_hashes)
    wide = is_wide(emit_buckets, route)
    if route == "staged" and not warps:
        raise ValueError(f"{nruns} care runs at k={k} do not fit the staged "
                         "kernel's shared memory")
    if route == "global" or not warps:
        warps = ring = 0
        smem = (20 * nruns + num_hashes - 1) * 8 \
            + (2 * nruns + len(seeds) + 1) * 4
        if smem > MAX_SHARED_BYTES:
            raise ValueError(
                f"{nruns} care runs need {smem} bytes of tables, more than "
                f"the {MAX_SHARED_BYTES} bytes of shared memory a block may "
                "use")
    per_seed = num_hashes + (2 if emit_fwd_rev else 0)
    dtype = torch.int64 if emit_buckets is None or wide else torch.int32
    out = torch.empty((len(seeds) * per_seed, length - k + 1, reads),
                      dtype=dtype, device=dev)
    if reads == 0:
        return list(out.unbind(0))
    lib = _lib()
    tables, meta = (_pair_kernel_tables if warps else _kernel_tables)(
        seeds, num_hashes, dev)
    status = lib.nthash_seed_hash(
        dev.index, codes_tm.data_ptr(), length, reads, k, len(seeds), nruns,
        seg, num_hashes, int(emit_fwd_rev), emit_buckets or 0, int(wide),
        tables.data_ptr(), meta.data_ptr(), warps, ring, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, status, "seed_hash launch")
    ROUTE_LAUNCHES["wide" if wide else "staged" if warps else "global"] += 1
    return list(out.unbind(0))


def hash_seeds_tm(codes_tm: torch.Tensor, seeds: Sequence[str],
                  num_hashes_per_seed: int = 1, *,
                  emit_fwd_rev: bool = False,
                  emit_buckets: int | None = None,
                  route: str | None = None) -> list[torch.Tensor]:
    """Spaced-seed hash of every window of time-major coded reads.

    Args:
      codes_tm: [L, R] contiguous int32 base codes (0-3 valid, 4 invalid),
        e.g. from ``kmer_kernel.prepare_codes``. Any R; no padding.
      seeds: '1'/'0' pattern strings, all of one length k.
      num_hashes_per_seed: canonical + nte64 extensions per seed.
      emit_fwd_rev: additionally emit each seed's forward/reverse hashes.
      emit_buckets: if set (a width_log2 in [1, 38]), emit bucket indices
        with strict window validity (invalid -> sentinel
        ``2**emit_buckets``), as ``kmer_kernel.hash_kmers_tm`` does: int32
        up to 30, int64 past it (the wide route).
      route: None (by the shapes and the width), "staged", "global" or
        "wide" (int64 buckets at any width), for the tests.

    Returns:
      A list of [W, R] tensors in the reference hash_arr order (seed-major:
      seeds[0]'s hashes, then seeds[1]'s, ...); with emit_fwd_rev each
      seed's group is followed by its (fwd, rev). int64 hashes, or int32
      (int64 on the wide route) buckets.

    A CUDA tensor goes through the CUDA kernel (``csrc/seed_hash.cu``), a
    CPU tensor through :func:`hash_seeds_tm_plain`.
    """
    global LAUNCHES
    seeds = tuple(seeds)
    with span("nthash.seed"):
        k = _check(codes_tm, seeds, num_hashes_per_seed, emit_fwd_rev,
                   emit_buckets)
        if codes_tm.is_cuda:
            out = _launch(codes_tm, seeds, k, num_hashes_per_seed,
                          emit_fwd_rev, emit_buckets,
                          codes_tm.shape[0] - k + 1, route)
            # an empty batch launches nothing
            LAUNCHES += codes_tm.shape[1] > 0
            return out
        if codes_tm.device.type == "cpu":
            return hash_seeds_tm_plain(codes_tm, seeds, num_hashes_per_seed,
                                       emit_fwd_rev=emit_fwd_rev,
                                       emit_buckets=emit_buckets, route=route)
    raise ValueError(f"no seed_hash route for device {codes_tm.device}")


def hash_seeds_tm_long(codes_tm: torch.Tensor, seeds: Sequence[str],
                       num_hashes_per_seed: int = 1, *,
                       time_tile: int | None = None,
                       emit_fwd_rev: bool = False,
                       emit_buckets: int | None = None,
                       route: str | None = None) -> list[torch.Tensor]:
    """:func:`hash_seeds_tm` cut into segments of ``time_tile`` windows (a
    multiple of k; default ``kmer_kernel.pick_time_tile(k)``), one thread
    each. Same arguments and outputs as :func:`hash_seeds_tm`.

    A CUDA tensor goes through the CUDA kernel (``csrc/seed_hash.cu``), a
    CPU tensor through :func:`hash_seeds_tm_long_plain`.
    """
    global LONG_LAUNCHES
    seeds = tuple(seeds)
    with span("nthash.seed"):
        k = _check(codes_tm, seeds, num_hashes_per_seed, emit_fwd_rev,
                   emit_buckets)
        tile = resolve_time_tile(k, time_tile)
        if codes_tm.is_cuda:
            out = _launch(codes_tm, seeds, k, num_hashes_per_seed,
                          emit_fwd_rev, emit_buckets,
                          min(tile, codes_tm.shape[0] - k + 1), route)
            LONG_LAUNCHES += codes_tm.shape[1] > 0
            return out
        if codes_tm.device.type == "cpu":
            return hash_seeds_tm_long_plain(codes_tm, seeds,
                                            num_hashes_per_seed,
                                            time_tile=tile,
                                            emit_fwd_rev=emit_fwd_rev,
                                            emit_buckets=emit_buckets,
                                            route=route)
    raise ValueError(f"no seed_hash route for device {codes_tm.device}")


def hash_seeds_tm_auto(codes_tm: torch.Tensor, seeds: Sequence[str],
                       num_hashes_per_seed: int = 1,
                       **kwargs) -> list[torch.Tensor]:
    """:func:`hash_seeds_tm` or :func:`hash_seeds_tm_long`, by
    ``kmer_kernel.long_read_threshold`` (the occupancy rule); both give
    identical outputs."""
    length, reads = codes_tm.shape
    k = check_seeds(seeds)
    if long_read_threshold(length, k, reads, kwargs.get("time_tile")):
        return hash_seeds_tm_long(codes_tm, seeds, num_hashes_per_seed,
                                  **kwargs)
    kwargs.pop("time_tile", None)
    return hash_seeds_tm(codes_tm, seeds, num_hashes_per_seed, **kwargs)


def hash_seeds_batch(codes: torch.Tensor, seeds: Sequence[str],
                     num_hashes_per_seed: int = 1):
    """[B, L] batch -> (hashes int64 [B, W, S*H], valid bool [B, W]), the
    ``seed_torch.hash_kmers_seeds`` hash layout, through
    :func:`hash_seeds_tm_auto`."""
    res = hash_seeds_tm_auto(prepare_codes(codes), seeds, num_hashes_per_seed)
    hashes = torch.stack([r.T for r in res], dim=-1)
    return hashes, window_valid(codes.to(torch.int32), len(seeds[0]))


def _check_sequence(seeds, num_hashes_per_seed) -> int:
    """Validate the one-sequence entries' arguments; returns k."""
    k = check_seeds(seeds)
    _all_taps(tuple(seeds))  # a pattern with no care position raises
    if num_hashes_per_seed < 1:
        raise ValueError(f"num_hashes ({num_hashes_per_seed}) must be >= 1")
    return k


def hash_seeds_sequence_plain(codes: torch.Tensor, seeds: Sequence[str],
                              num_hashes_per_seed: int = 1, *,
                              emit_fwd_rev: bool = False):
    """Plain PyTorch version of :func:`hash_seeds_sequence`, on any device:
    the pseudo-read route on the direct engine
    (``kmer_kernel.sequence_rows``, then ``seed_torch.hash_kmers_seeds``
    and its strict ``valid``), trimmed to C."""
    seeds = tuple(seeds)
    k = _check_sequence(seeds, num_hashes_per_seed)
    codes = sequence_codes(codes)
    c = codes.shape[0]
    res = hash_kmers_seeds(sequence_rows(codes, k, sequence_span(k)), seeds,
                           num_hashes_per_seed)
    h = num_hashes_per_seed
    out = []
    for si in range(len(seeds)):
        out += [res.hashes[..., si * h + i].reshape(-1)[:c] for i in range(h)]
        if emit_fwd_rev:
            out += [res.fwd[..., si].reshape(-1)[:c],
                    res.rev[..., si].reshape(-1)[:c]]
    return out, res.valid.reshape(-1)[:c]


def _nruns(seeds: tuple[str, ...]) -> int:
    return sum(len(t) for t in _all_taps(seeds))


def sequence_fits(seeds: Sequence[str], num_hashes_per_seed: int = 1,
                  emit_fwd_rev: bool = False) -> bool:
    """Whether ``seeds`` fit the one-sequence entry's shared memory
    (``kmer_kernel.sequence_warps``), from the shapes alone; where they do
    not, :func:`hash_seeds_sequence` raises on a CUDA tensor and
    :func:`hash_seeds_sequence_rows` takes the read kernel instead."""
    seeds = tuple(seeds)
    return sequence_warps(len(seeds[0]), len(seeds), _nruns(seeds),
                          num_hashes_per_seed, emit_fwd_rev, seeds=True) > 0


@lru_cache(maxsize=32)
def _sequence_meta(seeds: tuple[str, ...], device: torch.device
                   ) -> torch.Tensor:
    """meta of ``nthash_seed_sequence``, int32: per run its two tap deltas
    b - 32 - off_in and b - 32 - off_out (b = (k - 1) % 32: where the tap
    reads in the lane's ring relative to the chunk staged last), then the
    S + 1 run offsets."""
    k = len(seeds[0])
    runs = [t for taps in _all_taps(seeds) for t in taps]
    starts = [0]
    for taps in _all_taps(seeds):
        starts.append(starts[-1] + len(taps))
    b = (k - 1) % 32
    deltas = [b - 32 - o for t in runs for o in (t.off_in, t.off_out)]
    return torch.tensor(deltas + starts, dtype=torch.int32, device=device)


def hash_seeds_sequence_rows(codes: torch.Tensor, seeds: Sequence[str],
                             num_hashes_per_seed: int = 1, *,
                             emit_fwd_rev: bool = False):
    """:func:`hash_seeds_sequence`'s outputs through B1 over pseudo-reads:
    ``kmer_kernel.sequence_rows`` cut by ``sequence_span(k)``, then
    :func:`hash_seeds_tm` (the staged read kernel where ``seed_grid`` fits
    it, else the global one) and the planes back in sequence order. For
    seed sets that do not fit the one-sequence entry (:func:`sequence_fits`);
    identical outputs, one more copy and two transposes."""
    seeds = tuple(seeds)
    k = _check_sequence(seeds, num_hashes_per_seed)
    codes = sequence_codes(codes)
    c = codes.shape[0]
    rows = sequence_rows(codes, k, sequence_span(k))
    planes = hash_seeds_tm(prepare_codes(rows), seeds, num_hashes_per_seed,
                           emit_fwd_rev=emit_fwd_rev)
    return ([p.T.reshape(-1)[:c] for p in planes],
            window_valid(rows.to(torch.int32), k).reshape(-1)[:c])


def with_empty_seeds(hash_care, codes: torch.Tensor, seeds: Sequence[str],
                     num_hashes_per_seed: int = 1, *,
                     emit_fwd_rev: bool = False):
    """A one-sequence entry's outputs for seeds of which some have no care
    position at all ('0's only), as the JAX package's direct engine and the
    reference give them: such a seed hashes to 0 (fwd, rev and every nte64
    extension) in every window.

    ``hash_care(codes, care_seeds)`` hashes the seeds that have a care
    position (one of :func:`hash_seeds_sequence`, its plain version or
    :func:`hash_seeds_sequence_rows` with the other arguments bound); the
    zero planes are put in their seeds' places. With no care seed nothing
    is hashed, and ``valid`` is the strict window validity the entries
    return. The entries themselves raise on such a seed, as the JAX
    package's Pallas route does.
    """
    seeds = tuple(seeds)
    care = tuple(s for s in seeds if "1" in s)
    if len(care) == len(seeds):
        return hash_care(codes, seeds)
    k = check_seeds(seeds)
    codes = sequence_codes(codes)
    c = codes.shape[0]
    per_seed = num_hashes_per_seed + (2 if emit_fwd_rev else 0)
    if care:
        outs, valid = hash_care(codes, care)
    else:
        outs = []
        valid = window_valid(sequence_rows(codes, k, sequence_span(k))
                             .to(torch.int32), k).reshape(-1)[:c]
    zeros = iter(torch.zeros((per_seed * (len(seeds) - len(care)), c),
                             dtype=torch.int64, device=codes.device).unbind(0))
    done = iter(outs)
    planes = [next(done if "1" in s else zeros)
              for s in seeds for _ in range(per_seed)]
    return planes, valid


def hash_seeds_sequence(codes: torch.Tensor, seeds: Sequence[str],
                        num_hashes_per_seed: int = 1, *,
                        emit_fwd_rev: bool = False):
    """Spaced-seed hash of every window of one flat sequence in one pass.

    Args:
      codes: [C] base codes as ``kmer_kernel.hash_sequence`` takes them.
      seeds: '1'/'0' pattern strings, all of one length k.
      num_hashes_per_seed: canonical + nte64 extensions per seed.
      emit_fwd_rev: additionally emit each seed's forward and reverse hash,
        after the seed's group (the batch entries' layout).

    Returns (list of S * H int64 [C] tensors in the reference hash_arr
    order, S * (H + 2) with ``emit_fwd_rev``; valid [C] bool): entry w
    covers bases [w, w + k), bases at or past C reading as the invalid code;
    ``valid[w]`` is strict over all k bases, don't-care positions included,
    and False off the end.

    A CUDA tensor goes through ``csrc/seed_hash.cu``'s one-sequence entry
    (one launch; raises ValueError for seeds whose tables and ring do not
    fit a block, :func:`sequence_fits`), a CPU tensor through
    :func:`hash_seeds_sequence_plain`.
    """
    seeds = tuple(seeds)
    with span("nthash.seed"):
        k = _check_sequence(seeds, num_hashes_per_seed)
        codes = sequence_codes(codes)
        if codes.is_cuda:
            return _launch_sequence(codes, seeds, k, num_hashes_per_seed,
                                    emit_fwd_rev)
        if codes.device.type == "cpu":
            return hash_seeds_sequence_plain(codes, seeds,
                                             num_hashes_per_seed,
                                             emit_fwd_rev=emit_fwd_rev)
    raise ValueError(f"no seed_hash route for device {codes.device}")


def _launch_sequence(codes, seeds, k, num_hashes_per_seed, emit_fwd_rev):
    """One launch of ``seed_hash.cu``'s one-sequence entry."""
    global SEQUENCE_LAUNCHES, FWD_REV_LAUNCHES
    c = codes.shape[0]
    if c == 0:
        raise ValueError("the sequence is empty")
    dev = codes.device
    nruns = _nruns(seeds)
    warps, _ = sequence_grid(k, len(seeds), nruns, num_hashes_per_seed,
                             emit_fwd_rev, seeds=True)
    per_seed = num_hashes_per_seed + (2 if emit_fwd_rev else 0)
    out, valid = sequence_outputs(len(seeds) * per_seed, c, dev)
    lib = _lib()
    tables, _ = _pair_kernel_tables(seeds, num_hashes_per_seed, dev)
    status = lib.nthash_seed_sequence(
        dev.index, aligned(codes).data_ptr(), c, k,
        sequence_span(k, seeds=True, emit_fwd_rev=emit_fwd_rev),
        len(seeds), nruns, num_hashes_per_seed, int(emit_fwd_rev),
        tables.data_ptr(), _sequence_meta(seeds, dev).data_ptr(), warps,
        out.data_ptr(), out.shape[1], valid.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, status, "seed_hash sequence launch")
    SEQUENCE_LAUNCHES += 1
    FWD_REV_LAUNCHES += emit_fwd_rev
    return list(out[:, :c].unbind(0)), valid[:c]
