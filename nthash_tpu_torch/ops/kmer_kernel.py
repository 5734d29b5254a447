"""The rolling-hash kernels over time-major reads, and their plain versions.

Counterpart of ``nthash_tpu/ops/kmer_pallas.py`` (``hash_kmers_tm``,
``pick_time_tile``, ``hash_kmers_tm_long``, ``long_read_threshold``,
``hash_kmers_tm_auto``, ``prepare_codes``, ``hash_kmers_batch``). Both
routes launch ``csrc/kmer_hash.cu``: :func:`hash_kmers_tm` with one segment
per read (A1, the Pallas ``_kernel``), :func:`hash_kmers_tm_long` with
segments of ``time_tile`` windows, one thread each (B2, the Pallas
``_kernel_long``). The source note says what bounds the kernel on the H100
and why segments replace the TPU's sequential time tiles.
:func:`hash_sequence` hashes one flat sequence through the same file's
one-sequence entry, in one pass (``parallel/sp.py``'s kernel route).

Each wrapper launches the kernel for a CUDA tensor and runs its plain
version (:func:`hash_kmers_tm_plain`, :func:`hash_kmers_tm_long_plain`) for
a CPU tensor; there is no other route, and a failed launch raises. The TPU
kernels' read padding (R a multiple of interleave * 1024) exists for the
(8,128) tiling and has no counterpart: any R and any L >= k work.
:func:`hash_kmers_tm_auto` picks the route by occupancy
(:func:`long_read_threshold`), not by VMEM.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import u64
from ..constants import nte64_multiplier
from ..utils.profiling import span
from . import cuda_build
from .kmer_torch import (
    hash_kmers,
    plane_tables,
    roll_tm,
    segment_codes,
    unsegment,
    window_valid,
    window_valid_tm,
)

#: Kernel launches made by :func:`hash_kmers_tm` (one segment per read).
LAUNCHES = 0
#: Kernel launches made by :func:`hash_kmers_tm_long` (segmented).
LONG_LAUNCHES = 0
#: Kernel launches made by :func:`hash_sequence`.
SEQUENCE_LAUNCHES = 0
#: Of those, launches of its fwd/rev instance (``emit_fwd_rev=True``).
FWD_REV_LAUNCHES = 0

#: Shared memory one block may use on the H100 (227 KB).
MAX_SHARED_BYTES = 232448
#: Shared memory of a multiprocessor (228 KB), and what each resident block
#: of it holds back for the system.
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024
#: Code rows a staged ring takes at a time (``roll.cuh``'s kRows).
RING_ROWS_AHEAD = 32


def prepare_codes(codes: torch.Tensor) -> torch.Tensor:
    """[B, L] integer codes -> time-major [L, B] int32 for the kernel, with
    codes above 4 clamped to 4 (invalid). Stays on the input's device."""
    codes = codes.to(torch.int32)
    return torch.where(codes > 4, 4, codes).T.contiguous()


def check_args(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets,
               max_bucket_bits: int = 30) -> None:
    """Raise on what the kernels do not take: the codes' layout, k, the
    hash count and the output mode (buckets of 1..``max_bucket_bits``
    bits)."""
    if codes_tm.dtype != torch.int32 or codes_tm.dim() != 2:
        raise TypeError(
            f"codes_tm must be a 2-D int32 [L, R] tensor, got "
            f"{codes_tm.dtype} of shape {tuple(codes_tm.shape)}")
    if not codes_tm.is_contiguous():
        raise ValueError("codes_tm must be contiguous (use prepare_codes)")
    if k <= 0:
        raise ValueError("k must be greater than 0")
    if codes_tm.shape[0] < k:
        raise ValueError(
            f"sequence length ({codes_tm.shape[0]}) is smaller than k ({k})")
    if num_hashes < 1:
        raise ValueError(f"num_hashes ({num_hashes}) must be >= 1")
    if emit_buckets is not None:
        if emit_fwd_rev:
            raise ValueError("emit_buckets and emit_fwd_rev are exclusive")
        if not 1 <= emit_buckets <= max_bucket_bits:
            raise ValueError(f"emit_buckets ({emit_buckets}) must be in "
                             f"[1, {max_bucket_bits}]")


def finish_planes(codes_tm, fwd, rev, k, num_hashes, emit_fwd_rev,
                  emit_buckets, bucket_dtype=torch.int32):
    """[W, R] fwd/rev -> the wrappers' outputs: the nte64 extensions (+ fwd,
    rev) or, in bucket mode, their low bits as ``bucket_dtype`` with invalid
    windows set to the sentinel. The spaced-seed wrappers use it once per
    seed."""
    ext = u64.extend_hashes(u64.add(fwd, rev), k, num_hashes)
    if emit_buckets is None:
        return ext + [fwd, rev] if emit_fwd_rev else ext
    valid = window_valid_tm(codes_tm, k)
    mask, width = (1 << emit_buckets) - 1, 1 << emit_buckets
    return [torch.where(valid, (e & mask).to(bucket_dtype), width)
            for e in ext]


def hash_kmers_tm_plain(codes_tm: torch.Tensor, k: int, num_hashes: int = 1, *,
                        emit_fwd_rev: bool = False,
                        emit_buckets: int | None = None) -> list[torch.Tensor]:
    """Plain PyTorch version of :func:`hash_kmers_tm`, on any device: the
    time-major roll of ``ops/kmer_torch.py`` (the recurrence of
    ``kmer_jnp.py``) over whole reads, then the nte64 extensions and, in
    bucket mode, the low bits with invalid windows set to the sentinel."""
    check_args(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets)
    fwd, rev = roll_tm(codes_tm, k)
    return finish_planes(codes_tm, fwd, rev, k, num_hashes, emit_fwd_rev,
                         emit_buckets)


def pick_time_tile(k: int, target: int = 256) -> int:
    """Windows per segment of the long-read route: the multiple of k
    closest to ``target`` (at least k), as the JAX package picks its time
    tile."""
    return k * max(1, round(target / k))


def resolve_time_tile(k: int, time_tile: int | None) -> int:
    """``time_tile``, or :func:`pick_time_tile` when None; raises unless it
    is a multiple of k (the JAX package's contract)."""
    if k <= 0:
        raise ValueError("k must be greater than 0")
    tile = time_tile or pick_time_tile(k)
    if tile % k:
        raise ValueError(f"time_tile ({tile}) must be a multiple of k ({k})")
    return tile


def hash_kmers_tm_long_plain(codes_tm: torch.Tensor, k: int,
                             num_hashes: int = 1, *,
                             time_tile: int | None = None,
                             emit_fwd_rev: bool = False,
                             emit_buckets: int | None = None
                             ) -> list[torch.Tensor]:
    """Plain PyTorch version of :func:`hash_kmers_tm_long`, on any device:
    the kernel's segments, each rolled from zero state by ``roll_tm`` as a
    read of its own (``time_tile + k - 1`` bases, the tail padded with the
    invalid code), then put back in window order. Only the segments' warm-up
    makes it differ from :func:`hash_kmers_tm_plain`, which the tests hold
    it equal to."""
    check_args(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets)
    seg = min(resolve_time_tile(k, time_tile), codes_tm.shape[0] - k + 1)
    fwd, rev = roll_tm(segment_codes(codes_tm, k, seg), k)
    w, reads = codes_tm.shape[0] - k + 1, codes_tm.shape[1]
    return finish_planes(codes_tm, unsegment(fwd, w, reads),
                         unsegment(rev, w, reads), k, num_hashes,
                         emit_fwd_rev, emit_buckets)


@lru_cache(maxsize=32)
def _kernel_tables(k: int, num_hashes: int, device: torch.device) -> torch.Tensor:
    """fwd_in, fwd_out, rev_in, rev_out_r (5 each) and the num_hashes - 1
    nte64 multipliers, as one int64 tensor on ``device``."""
    tabs = plane_tables(k)
    vals = (list(tabs.fwd_in) + list(tabs.fwd_out) + list(tabs.rev_in)
            + list(tabs.rev_out_r)
            + [nte64_multiplier(i, k) for i in range(1, num_hashes)])
    return u64.tensor(vals, device)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("kmer_hash")
    fn = lib.nthash_kmer_hash
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        seq = lib.nthash_kmer_sequence
        seq.restype = ctypes.c_int
        seq.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
    return lib


def _launch(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets, seg):
    """Launch ``kmer_hash.cu`` with ``seg`` windows per segment."""
    length, reads = codes_tm.shape
    dev = codes_tm.device
    nout = num_hashes + (2 if emit_fwd_rev else 0)
    dtype = torch.int64 if emit_buckets is None else torch.int32
    out = torch.empty((nout, length - k + 1, reads), dtype=dtype, device=dev)
    if reads == 0:
        return list(out.unbind(0))
    lib = _lib()
    tables = _kernel_tables(k, num_hashes, dev)
    status = lib.nthash_kmer_hash(
        dev.index, codes_tm.data_ptr(), length, reads, k, seg, num_hashes,
        int(emit_fwd_rev), emit_buckets or 0, tables.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, status, "kmer_hash launch")
    return list(out.unbind(0))


def hash_kmers_tm(codes_tm: torch.Tensor, k: int, num_hashes: int = 1, *,
                  emit_fwd_rev: bool = False,
                  emit_buckets: int | None = None) -> list[torch.Tensor]:
    """Hash all k-mer windows of time-major coded reads.

    Args:
      codes_tm: [L, R] contiguous int32 base codes (0-3 valid, 4 invalid),
        e.g. from :func:`prepare_codes`. Any R; no padding.
      k: k-mer size (any k >= 1).
      num_hashes: canonical + nte64 extensions per window.
      emit_fwd_rev: additionally emit the forward and reverse hashes.
      emit_buckets: if set (a width_log2 in [1, 30]), emit int32 bucket
        indices ``hash & (2**emit_buckets - 1)`` instead of 64-bit hashes,
        with windows that hold an invalid base set to the out-of-range
        sentinel ``2**emit_buckets`` (dropped by the histogram).

    Returns:
      A list of [W, R] tensors, W = L - k + 1, window w of read r at [w, r]:
      int64 canonical + extensions (+ fwd, rev), or int32 buckets.

    A CUDA tensor goes through the CUDA kernel (``csrc/kmer_hash.cu``), a
    CPU tensor through :func:`hash_kmers_tm_plain`; either inside the span
    ``nthash.hash`` (``utils/profiling.span``).
    """
    global LAUNCHES
    with span("nthash.hash"):
        check_args(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets)
        if codes_tm.is_cuda:
            out = _launch(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets,
                          codes_tm.shape[0] - k + 1)
            # an empty batch launches nothing
            LAUNCHES += codes_tm.shape[1] > 0
            return out
        if codes_tm.device.type == "cpu":
            return hash_kmers_tm_plain(codes_tm, k, num_hashes,
                                       emit_fwd_rev=emit_fwd_rev,
                                       emit_buckets=emit_buckets)
    raise ValueError(f"no kmer_hash route for device {codes_tm.device}")


def hash_kmers_tm_long(codes_tm: torch.Tensor, k: int, num_hashes: int = 1, *,
                       time_tile: int | None = None,
                       emit_fwd_rev: bool = False,
                       emit_buckets: int | None = None) -> list[torch.Tensor]:
    """:func:`hash_kmers_tm` cut into segments: one thread per ``time_tile``
    windows of a read (default :func:`pick_time_tile`, 256 at k=32), so
    that a few long reads still fill the card. Same arguments and outputs
    as :func:`hash_kmers_tm`; ``time_tile`` must be a multiple of k, as in
    the JAX package (whose kernel needs it for its history ring).

    A CUDA tensor goes through the CUDA kernel (``csrc/kmer_hash.cu``), a
    CPU tensor through :func:`hash_kmers_tm_long_plain`; either inside the
    span ``nthash.hash``.
    """
    global LONG_LAUNCHES
    with span("nthash.hash"):
        check_args(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets)
        tile = resolve_time_tile(k, time_tile)
        if codes_tm.is_cuda:
            out = _launch(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets,
                          min(tile, codes_tm.shape[0] - k + 1))
            LONG_LAUNCHES += codes_tm.shape[1] > 0
            return out
        if codes_tm.device.type == "cpu":
            return hash_kmers_tm_long_plain(codes_tm, k, num_hashes,
                                            time_tile=tile,
                                            emit_fwd_rev=emit_fwd_rev,
                                            emit_buckets=emit_buckets)
    raise ValueError(f"no kmer_hash route for device {codes_tm.device}")


#: Reads from which one thread per read (A1) is faster than segments (B2)
#: on the H100, for reads longer than one segment: 2**18 reads are 97% of
#: one wave of resident threads (132 SMs x 2,048 at A1's 32 registers).
#: Measured over a crossover grid of L 150 to 10,000 and R 4,096 to 2**20
#: on an NVIDIA H100 80GB HBM3 at 700 W (CHANGES.md, readings
#: behind the comments): B2 wins from 4,096 to 2**17 reads at 1,000 and
#: 10,000 bp, A1 from 2**18.
SEGMENT_BELOW_READS = 1 << 18


def long_read_threshold(length: int, k: int, reads: int,
                        time_tile: int | None = None) -> bool:
    """True when :func:`hash_kmers_tm_auto` takes the segmented route.

    The rule is occupancy, not memory: segments pay when a read holds more
    than one segment's windows and the reads alone, one thread each, do not
    fill one wave of resident threads (``reads < SEGMENT_BELOW_READS``).
    Then a few long reads roll on part of the card while the rest idles;
    segments give ``W / time_tile`` times as many threads. From one full
    wave on, every SM is busy either way and segments only add their
    (k - 1) / time_tile warm-up.
    """
    return (length - k + 1 > resolve_time_tile(k, time_tile)
            and reads < SEGMENT_BELOW_READS)


def hash_kmers_tm_auto(codes_tm: torch.Tensor, k: int, num_hashes: int = 1,
                       **kwargs) -> list[torch.Tensor]:
    """:func:`hash_kmers_tm` or :func:`hash_kmers_tm_long`, by
    :func:`long_read_threshold`; both give identical outputs."""
    length, reads = codes_tm.shape
    if long_read_threshold(length, k, reads, kwargs.get("time_tile")):
        return hash_kmers_tm_long(codes_tm, k, num_hashes, **kwargs)
    kwargs.pop("time_tile", None)
    return hash_kmers_tm(codes_tm, k, num_hashes, **kwargs)


def hash_kmers_batch(codes: torch.Tensor, k: int, num_hashes: int = 1):
    """[B, L] batch -> (hashes int64 [B, W, H], valid bool [B, W]), the
    ``kmer_torch.hash_kmers`` layout, through :func:`hash_kmers_tm_auto`."""
    res = hash_kmers_tm_auto(prepare_codes(codes), k, num_hashes)
    hashes = torch.stack([r.T for r in res], dim=-1)
    return hashes, window_valid(codes.to(torch.int32), k)


# ------------------------------------------------- one flat sequence ----


def ring_rows(k: int) -> int:
    """Rows of a warp's code ring in the staged read kernel (``roll.cuh``):
    the smallest power of two that holds k rows behind the step and the 32
    staged ahead."""
    return 1 << (k + RING_ROWS_AHEAD - 1).bit_length()


def tables_bytes(nseeds: int, nruns: int, num_hashes: int) -> int:
    """Shared bytes of the staged read kernel's tables (``roll.cuh``
    ``staged_tables_bytes``): 25 16-byte pairs and two offsets a care run,
    the nte64 multipliers and the seeds' run offsets, rounded to 16."""
    b = nruns * 25 * 16 + (num_hashes - 1) * 8 + nruns * 8 + (nseeds + 1) * 4
    return -(-b // 16) * 16


def fit_warps(tables: int, per_warp: int, warps: int) -> int:
    """The most warps a block (a power of two, at most ``warps``) whose
    shared memory fits beside the tables; 0 when not even one does."""
    while warps and tables + warps * per_warp > MAX_SHARED_BYTES:
        warps //= 2
    return warps


def sequence_ring(k: int) -> int:
    """Bytes of a lane's code ring in the one-sequence entries (``roll.cuh``
    ``seq``): the aligned chunks of 32 bases c - M - 1 .. c that chunk c's
    taps read, M = (k - 1) // 32 + 1."""
    return 32 * ((k - 1) // 32 + 3)


def pair_copies_log2(nruns: int) -> int:
    """log2 of the copies of each pair table in the one-sequence entries'
    shared memory: 8 (lane % 8 reads its own, so a quarter-warp's lookups
    never conflict) up to 8 care runs, else 1 (``seed_hash.cu``
    ``seed_copies_log2``; the k-mer entry has one run)."""
    return 3 if nruns <= 8 else 0


def sequence_tables_bytes(nseeds: int, nruns: int, num_hashes: int) -> int:
    """Shared bytes of the one-sequence entries' tables (``roll.cuh``
    ``seq::tables_bytes``): the pair tables and their copies, the nte64
    multipliers, two tap deltas a run and the seeds' run offsets, rounded
    to 16."""
    b = ((nruns * 25 * 16 << pair_copies_log2(nruns)) + (num_hashes - 1) * 8
         + (2 * nruns + nseeds + 1) * 4)
    return -(-b // 16) * 16


def sequence_run(emit_fwd_rev: bool = False, seeds: bool = False) -> int:
    """Windows a lane writes as one run of each output plane (``roll.cuh``
    ``seq``): 32 (256 bytes), or 16 for the spaced-seed entry without
    fwd/rev (``seed_hash.cu`` ``seed_run``)."""
    return 16 if seeds and not emit_fwd_rev else 32


def sequence_warp_bytes(k: int, emit_fwd_rev: bool = False,
                        nseeds: int = 0) -> int:
    """Shared bytes a warp of the one-sequence entries (``roll.cuh``
    ``seq::warp_bytes``): its ring (words R / 4 + 8 of 32 lanes), one or
    two stage planes (32 lanes x :func:`sequence_run` windows x 8 bytes)
    and, for spaced seeds (``nseeds`` > 0), the seeds' states (16 bytes a
    seed and lane)."""
    stage = 256 * sequence_run(emit_fwd_rev, nseeds > 0)
    return ((sequence_ring(k) // 4 + 8) * 128
            + (2 if emit_fwd_rev else 1) * stage + nseeds * 512)


def sequence_warps(k: int, nseeds: int = 1, nruns: int = 1,
                   num_hashes: int = 1, emit_fwd_rev: bool = False, *,
                   seeds: bool = False) -> int:
    """Warps a block of the one-sequence entries, from the shapes alone:
    each warp with its ring, stage and, for spaced seeds (``seeds``), the
    seeds' states beside one copy of the tables a block. Of 8, 4, 2 and 1,
    the one whose blocks leave the most warps resident in a multiprocessor's
    shared memory (the larger on a tie); 0 when one warp does not fit."""
    per_warp = sequence_warp_bytes(k, emit_fwd_rev, nseeds if seeds else 0)
    tables = sequence_tables_bytes(nseeds, nruns, num_hashes)
    best, most = 0, 0
    for warps in (8, 4, 2, 1):
        smem = tables + warps * per_warp
        if smem > MAX_SHARED_BYTES:
            continue
        resident = warps * min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES),
                               64 // warps)
        if resident > most:
            best, most = warps, resident
    return best


def sequence_grid(k: int, nseeds: int = 1, nruns: int = 1,
                  num_hashes: int = 1, emit_fwd_rev: bool = False, *,
                  seeds: bool = False) -> tuple[int, int]:
    """(warps a block, ring bytes a lane) of the one-sequence entries
    (:func:`sequence_warps`, :func:`sequence_ring`); raises ValueError when
    one warp does not fit beside the tables (several hundred care runs, or
    k in the thousands)."""
    warps = sequence_warps(k, nseeds, nruns, num_hashes, emit_fwd_rev,
                           seeds=seeds)
    if not warps:
        raise ValueError(
            f"{nruns} care runs at k={k} need more than the "
            f"{MAX_SHARED_BYTES} bytes of shared memory a block may use")
    return warps, sequence_ring(k)


def sequence_span(k: int, *, seeds: bool = False,
                  emit_fwd_rev: bool = False) -> int:
    """Windows a lane of the one-sequence entries rolls: 64 for every 32
    bases of k (rounded up), 256 for the spaced-seed entry without fwd/rev.
    A lane rolls 32 ceil(k / 32) warm-up steps first, a third of its steps
    at 64; but its output streams lie span * 8 bytes apart, and the writes
    gain more from the denser streams than the roll loses (a span sweep on
    the card; CHANGES.md, readings behind the comments). The seed
    entry without fwd/rev writes the fewest bytes a step and rolls the most
    (a lookup a care run): it keeps the longer span. The plain versions and
    the pseudo-read routes cut their rows by the default."""
    return (256 if seeds and not emit_fwd_rev else 64) * -(-k // 32)


def sequence_codes(codes: torch.Tensor) -> torch.Tensor:
    """A [C] integer sequence as the one-sequence entries take it: uint8 as
    it is (values above 4 read as 4), any other integer dtype with every
    value outside 0-4 set to 4 before it is narrowed to uint8."""
    if codes.dim() != 1:
        raise ValueError(f"codes must be a [C] sequence, got shape "
                         f"{tuple(codes.shape)}")
    if codes.dtype == torch.uint8:
        return codes.contiguous()
    if codes.dtype.is_floating_point or codes.dtype.is_complex \
            or codes.dtype == torch.bool:
        raise TypeError(f"codes must be integers, got {codes.dtype}")
    return torch.where((codes < 0) | (codes > 4), 4, codes).to(torch.uint8)


def sequence_rows(codes: torch.Tensor, k: int, span: int) -> torch.Tensor:
    """[C] codes -> [ceil(C / span), span + k - 1]: row j holds bases
    [j span, (j + 1) span + k - 1), those at or past C invalid (4), so its
    windows are the sequence's windows [j span, (j + 1) span), the off-end
    ones included (the pseudo-reads of ``parallel/sp.py`` cut by ``span``)."""
    c = codes.shape[0]
    if c == 0:
        raise ValueError("the sequence is empty")
    ext = torch.nn.functional.pad(codes, (0, k - 1), value=4)
    return segment_codes(ext[:, None], k, min(span, c)).T


def _check_sequence(k: int, num_hashes: int) -> None:
    if k <= 0:
        raise ValueError("k must be greater than 0")
    if num_hashes < 1:
        raise ValueError(f"num_hashes ({num_hashes}) must be >= 1")


def hash_sequence_plain(codes: torch.Tensor, k: int, num_hashes: int = 1, *,
                        emit_fwd_rev: bool = False):
    """Plain PyTorch version of :func:`hash_sequence`, on any device: the
    pseudo-read route on the batch-major engine (:func:`sequence_rows`, then
    ``kmer_torch.hash_kmers`` and its ``window_valid``), trimmed to C."""
    _check_sequence(k, num_hashes)
    codes = sequence_codes(codes)
    c = codes.shape[0]
    res = hash_kmers(sequence_rows(codes, k, sequence_span(k)), k, num_hashes)
    out = [res.hashes[..., i].reshape(-1)[:c] for i in range(num_hashes)]
    if emit_fwd_rev:
        out += [res.fwd.reshape(-1)[:c], res.rev.reshape(-1)[:c]]
    return out, res.valid.reshape(-1)[:c]


@lru_cache(maxsize=32)
def _sequence_tables(k: int, num_hashes: int,
                     device: torch.device) -> torch.Tensor:
    """The tables of ``nthash_kmer_sequence``, int64: the 25 (fwd, rev)
    pairs of the one care run [0, k), then the nte64 multipliers."""
    tabs = plane_tables(k)
    vals = []
    for ci in range(5):
        for co in range(5):
            vals += [tabs.fwd_in[ci] ^ tabs.fwd_out[co],
                     tabs.rev_in[ci] ^ tabs.rev_out_r[co]]
    vals += [nte64_multiplier(i, k) for i in range(1, num_hashes)]
    return u64.tensor(vals, device)


def sequence_outputs(planes: int, c: int, device) -> tuple[torch.Tensor,
                                                           torch.Tensor]:
    """(out [planes, C rounded up to 32] int64, valid [C rounded up to 32]
    bool) for the one-sequence entries, which write whole runs of windows
    and 32 valid bytes at a time; the callers keep the first C columns."""
    pitch = -(-c // 32) * 32
    return (torch.empty((planes, pitch), dtype=torch.int64, device=device),
            torch.empty(pitch, dtype=torch.bool, device=device))


def sequence_fits(k: int, num_hashes: int = 1,
                  emit_fwd_rev: bool = False) -> bool:
    """Whether a k-mer of size ``k`` fits the one-sequence entry's shared
    memory (:func:`sequence_warps`), from the shapes alone; where it does
    not, :func:`hash_sequence` raises on a CUDA tensor and
    :func:`hash_sequence_rows` takes the read kernel instead."""
    return sequence_warps(k, 1, 1, num_hashes, emit_fwd_rev) > 0


def hash_sequence_rows(codes: torch.Tensor, k: int, num_hashes: int = 1, *,
                       emit_fwd_rev: bool = False):
    """:func:`hash_sequence`'s outputs through the read kernel over
    pseudo-reads: :func:`sequence_rows` cut by ``sequence_span(k)``, then
    :func:`hash_kmers_tm_auto` (B2 for such k) and the planes back in
    sequence order. For k that do not fit the one-sequence entry
    (:func:`sequence_fits`); identical outputs, one more copy and two
    transposes. On a CPU tensor the read kernel's plain versions run."""
    _check_sequence(k, num_hashes)
    codes = sequence_codes(codes)
    c = codes.shape[0]
    rows = sequence_rows(codes, k, sequence_span(k))
    planes = hash_kmers_tm_auto(prepare_codes(rows), k, num_hashes,
                                emit_fwd_rev=emit_fwd_rev)
    return ([p.T.reshape(-1)[:c] for p in planes],
            window_valid(rows.to(torch.int32), k).reshape(-1)[:c])


def aligned(codes: torch.Tensor) -> torch.Tensor:
    """``codes``, copied when its first byte is not 16-byte aligned (the
    one-sequence entries stage 16 bytes a load)."""
    return codes if codes.data_ptr() % 16 == 0 else codes.clone()


def hash_sequence(codes: torch.Tensor, k: int, num_hashes: int = 1, *,
                  emit_fwd_rev: bool = False):
    """Hash every window of one flat sequence in one pass.

    Args:
      codes: [C] base codes (0-3 valid, 4 and above invalid), uint8 as
        ``parallel.sp.shard_sequence`` and the parser give them; any other
        integer dtype is clamped (:func:`sequence_codes`).
      k: k-mer size (any k >= 1).
      num_hashes: canonical + nte64 extensions per window.
      emit_fwd_rev: additionally emit every window's forward and reverse
        hash (the facade's tiles).

    Returns (list of ``num_hashes`` int64 [C] tensors, then fwd and rev with
    ``emit_fwd_rev``; valid [C] bool): entry w of hash i is nte64 hash i of
    window [w, w + k), bases at or past C reading as the invalid code;
    ``valid[w]`` is False where the window holds an invalid base or runs off
    the end.

    A CUDA tensor goes through ``csrc/kmer_hash.cu``'s one-sequence entry
    (one launch), a CPU tensor through :func:`hash_sequence_plain`.
    """
    global SEQUENCE_LAUNCHES, FWD_REV_LAUNCHES
    _check_sequence(k, num_hashes)
    codes = sequence_codes(codes)
    if not codes.is_cuda:
        if codes.device.type == "cpu":
            return hash_sequence_plain(codes, k, num_hashes,
                                       emit_fwd_rev=emit_fwd_rev)
        raise ValueError(f"no kmer_hash route for device {codes.device}")
    c = codes.shape[0]
    if c == 0:
        raise ValueError("the sequence is empty")
    dev = codes.device
    warps, _ = sequence_grid(k, 1, 1, num_hashes, emit_fwd_rev)
    out, valid = sequence_outputs(num_hashes + (2 if emit_fwd_rev else 0), c,
                                  dev)
    lib = _lib()
    status = lib.nthash_kmer_sequence(
        dev.index, aligned(codes).data_ptr(), c, k, sequence_span(k),
        num_hashes, int(emit_fwd_rev),
        _sequence_tables(k, num_hashes, dev).data_ptr(), warps,
        out.data_ptr(), out.shape[1], valid.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, status, "kmer_hash sequence launch")
    SEQUENCE_LAUNCHES += 1
    FWD_REV_LAUNCHES += emit_fwd_rev
    return list(out[:, :c].unbind(0)), valid[:c]
