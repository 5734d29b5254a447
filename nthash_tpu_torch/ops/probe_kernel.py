"""Probe of a packed Bloom filter by emitted buckets, and its plain version.

The port's own kernel, ``csrc/probe.cu``, behind no TPU kernel: the JAX
package queries a filter with ``models/bloom.contains``, a gather over
uint64 hashes. :func:`probe_counts` takes the int32 buckets the hash
kernels emit (``seed_kernel.hash_seeds_tm(..., emit_buckets=width_log2)``:
planes [S * h, W, R] in the seed-major hash_arr order, or that list of [W,
R] views) and adds into ``out`` [S, R], per seed and read, the windows
whose h buckets all have their bit set in the filter's words. A bucket
outside [0, 2**width_log2), the sentinel of a window holding an invalid
base among them, is a miss.

A CUDA tensor goes through the kernel, one launch a call, reading the
hash kernel's planes where they lie (consecutive views of one output, as
``hist_kernel.rows_view`` finds them; other planes are stacked into one
first, a copy); a CPU tensor through :func:`probe_counts_plain`. Either runs
inside the span ``nthash.probe``. The source note says what bounds the
kernel on the H100.

Filters past 2**31 bits (to 2**38) take the wide route: int64 buckets, the
seed kernels' wide buckets, probed by ``bloom_probe_wide_kernel`` with
64-bit word offsets. The buckets' dtype names the route: the seed kernels
emit int64 past 2**30 (or where their ``route="wide"`` forces it).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import span
from . import cuda_build
from .hist_kernel import (
    BLOOM_MIN_WIDTH_LOG2,
    MAX_WIDTH_LOG2,
    PACK,
    WIDE_MAX_WIDTH_LOG2,
    bit_index,
    rows_view,
    word_index,
)

#: Kernel launches made by :func:`probe_counts`, and the same by route.
LAUNCHES = 0
ROUTE_LAUNCHES = {"narrow": 0, "wide": 0}


def planes_of(buckets) -> list[torch.Tensor]:
    """The [W, R] planes of ``buckets``: a [P, W, R] tensor or a sequence of
    [W, R] tensors. Views, never copies."""
    if isinstance(buckets, torch.Tensor):
        if buckets.dim() != 3:
            raise ValueError(f"buckets must be [S * h, W, R], got "
                             f"{tuple(buckets.shape)}")
        return list(buckets.unbind(0))
    return list(buckets)


def check_args(planes, words, num_seeds, num_hashes, width_log2,
               out) -> None:
    """Raise ValueError on what the probe does not take: the plane count,
    the planes' dtype (int32 to 2**30, int64 to 2**38), shapes and device,
    the filter's words and width, and ``out``."""
    if num_seeds < 1 or num_hashes < 1:
        raise ValueError(f"num_seeds ({num_seeds}) and num_hashes "
                         f"({num_hashes}) must be >= 1")
    if not BLOOM_MIN_WIDTH_LOG2 <= width_log2 <= WIDE_MAX_WIDTH_LOG2:
        raise ValueError(f"width_log2 ({width_log2}) must be in "
                         f"[{BLOOM_MIN_WIDTH_LOG2}, {WIDE_MAX_WIDTH_LOG2}]: "
                         "the hash kernels emit buckets up to that width")
    if len(planes) != num_seeds * num_hashes:
        raise ValueError(f"{len(planes)} bucket planes are not {num_seeds} "
                         f"seeds x {num_hashes} hashes")
    first = planes[0]
    for p in planes:
        if (p.dtype not in (torch.int32, torch.int64) or p.dim() != 2
                or p.dtype != first.dtype):
            raise ValueError(f"bucket planes must be 2-D int32 or int64 "
                             f"[W, R] of one dtype, got {p.dtype} of shape "
                             f"{tuple(p.shape)}")
        if p.shape != first.shape or p.device != words.device:
            raise ValueError("bucket planes must share one shape and the "
                             "filter's device")
    if first.dtype == torch.int32 and width_log2 > MAX_WIDTH_LOG2:
        raise ValueError(f"int32 buckets are emitted at widths up to "
                         f"2**{MAX_WIDTH_LOG2}; at 2**{width_log2} they are "
                         "int64")
    if (words.dtype != torch.int32 or words.dim() != 1
            or not words.is_contiguous()
            or words.shape[0] * PACK != 1 << width_log2):
        raise ValueError(f"words must be the int32 [2**{width_log2} / "
                         f"{PACK}] of a filter of the buckets' width, got "
                         f"{words.dtype} of shape {tuple(words.shape)}")
    if out is not None and (out.dtype != torch.int32
                            or tuple(out.shape) != (num_seeds, first.shape[1])
                            or out.device != words.device
                            or out.stride(1) != 1):
        raise ValueError(f"out must be int32 [{num_seeds}, {first.shape[1]}] "
                         "on the filter's device with unit stride along the "
                         f"reads, got {out.dtype} of shape {tuple(out.shape)}")


def probe_counts_plain(buckets, words: torch.Tensor, num_seeds: int,
                       num_hashes: int, width_log2: int, *,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`probe_counts`, on any device: per
    seed, each plane's in-range buckets gathered from the words and their
    bits tested, AND-ed over the seed's planes and summed over the
    windows."""
    planes = planes_of(buckets)
    check_args(planes, words, num_seeds, num_hashes, width_log2, out)
    if out is None:
        out = torch.zeros((num_seeds, planes[0].shape[1]), dtype=torch.int32,
                          device=words.device)
    width = 1 << width_log2
    for s in range(num_seeds):
        hit = None
        for b in planes[s * num_hashes:(s + 1) * num_hashes]:
            inside = (b >= 0) & (b < width)
            b = torch.where(inside, b, 0)
            # int32 ``>>`` is arithmetic: the bit is masked after the shift
            got = words[word_index(b).to(torch.int64)]
            t = inside & (((got >> bit_index(b)) & 1) != 0)
            hit = t if hit is None else hit & t
        out[s] += hit.sum(0, dtype=torch.int32)
    return out


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("probe")
    if lib.nthash_bloom_probe.argtypes is None:
        for fn in (lib.nthash_bloom_probe, lib.nthash_bloom_probe_wide):
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ]
    return lib


def _launch(planes, words, num_seeds, num_hashes, width_log2, out):
    """One launch of ``probe.cu`` over the planes where they lie."""
    global LAUNCHES
    w, reads = planes[0].shape
    if w * reads == 0:
        return out
    stream = rows_view(planes)
    if stream is None:
        stream = torch.stack([p.contiguous() for p in planes]).view(
            len(planes), -1)
    dev = words.device
    lib = _lib()
    route = "wide" if planes[0].dtype == torch.int64 else "narrow"
    fn = lib.nthash_bloom_probe_wide if route == "wide" \
        else lib.nthash_bloom_probe
    status = fn(
        dev.index, stream.data_ptr(), stream.stride(0), num_seeds, num_hashes,
        w, reads, words.data_ptr(), width_log2, out.data_ptr(), out.stride(0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, status, "bloom_probe launch")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    return out


def probe_counts(buckets, words: torch.Tensor, num_seeds: int,
                 num_hashes: int, width_log2: int, *,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Per seed, the windows of each read whose buckets' bits are all set.

    Args:
      buckets: int32 [S * h, W, R], or int64 (the wide route), or that
        list of [W, R] planes, in the seed-major hash_arr order: plane ``s
        * num_hashes + i`` holds hash i of seed s, at the filter's width
        (sentinel ``2**width_log2`` for a window holding an invalid base).
      words: the filter's int32 words [2**width_log2 / 32]
        (``models/bloom.BloomFilter.words``).
      num_seeds, num_hashes: S and h.
      width_log2: the width the buckets were emitted at, which must be the
        filter's (2**12..2**30 for int32 buckets, to 2**38 for int64).
      out: int32 [S, R] to add into, in place; its rows may lie apart (a
        slice of a wider count tensor) but each row's reads are adjacent.
        A new zeroed tensor when None.

    Returns ``out``. Exact on every route.
    """
    with span("nthash.probe"):
        planes = planes_of(buckets)
        check_args(planes, words, num_seeds, num_hashes, width_log2, out)
        if out is None:
            out = torch.zeros((num_seeds, planes[0].shape[1]),
                              dtype=torch.int32, device=words.device)
        if words.is_cuda:
            return _launch(planes, words, num_seeds, num_hashes, width_log2,
                           out)
        if words.device.type == "cpu":
            return probe_counts_plain(planes, words, num_seeds, num_hashes,
                                      width_log2, out=out)
    raise ValueError(f"no bloom_probe route for device {words.device}")
