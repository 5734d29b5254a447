"""The blind-roll kernel: T caller-fed rolls of B walks in one launch.

The launch behind ``ops/blind_scan.py::roll_many`` and
``ops/blind_seed_scan.py::roll_many`` on a CUDA tensor (``csrc/blind.cu``;
the source note says what bounds it on the H100). The JAX package has no
Pallas kernel here: its ``roll_many`` is a ``lax.scan``
(``nthash_tpu/ops/blind_scan.py:99``, ``blind_seed_scan.py:141``), which
the TPU compiles into one program; this kernel is that program's
counterpart. The plain versions (a step loop over each module's ``_roll``,
in tensor ops) sit beside the wrappers in those modules, which count the
launches.

A k-mer walk is the walk of one seed with k care positions, so one kernel
serves both: :func:`launch` takes the seed set, ``("1" * k,)`` for k-mers.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import cuda_build
from .kmer_kernel import MAX_SHARED_BYTES, fit_warps
from .seed_kernel import _all_taps, _kernel_tables


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("blind")
    fn = lib.nthash_blind_roll
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
    return lib


def tables_bytes(seeds: Sequence[str], num_hashes: int) -> int:
    """Shared bytes of the kernels' tables: 20 uint64 and two offsets a care
    run, the nte64 multipliers and the seeds' run offsets."""
    nruns = sum(len(t) for t in _all_taps(tuple(seeds)))
    return (20 * nruns + num_hashes - 1) * 8 + (2 * nruns + len(seeds) + 1) * 4


def blind_warps(seeds: Sequence[str], num_hashes: int) -> int:
    """Warps a block of the staged kernel (``blind_staged_kernel``), from
    the shapes alone: up to 8, each with its 32 walks' seed states (16 bytes
    a seed) and its output stage (8 bytes a hash), beside the tables
    (rounded to 16 bytes); 0 when one warp does not fit, and the kernel
    with a thread's values in registers (``blind_roll_kernel``) runs."""
    s = len(seeds)
    return fit_warps(-(-tables_bytes(seeds, num_hashes) // 16) * 16,
                     32 * s * 16 + 32 * s * num_hashes * 8, 8)


def launch(chars: torch.Tensor, window: torch.Tensor, fwd: torch.Tensor,
           rev: torch.Tensor, seeds: Sequence[str], num_hashes: int,
           warps: int | None = None):
    """Roll every walk through its stream on the card.

    Args:
      chars: [T, B] integer codes on a CUDA device (the fed bases; outside
        0-3 hash as the zero seed).
      window: [B, k] int32 codes, oldest first; fwd, rev: [B, S] int64.
      seeds: S patterns of length k (``("1" * k,)`` for k-mers).
      num_hashes: canonical + nte64 extensions per seed.

    Returns (hashes int64 [T, B, S * num_hashes] seed-major, fwd [B, S],
    rev [B, S], window [B, k] int32): each step's hashes and the final state.
    The staged kernel runs where :func:`blind_warps` fits it, else the one
    with each thread's values in registers; ``warps`` forces the staged one
    at that many warps a block, or 0 the other (for the tests and the smoke
    run). Raises for a tensor off the card and for seed sets whose tables do
    not fit a block's shared memory.
    """
    seeds = tuple(seeds)
    if warps is None:
        warps = blind_warps(seeds, num_hashes)
    elif warps > blind_warps(seeds, num_hashes):
        raise ValueError(f"{warps} warps of the staged kernel do not fit "
                         "beside the tables")
    if not chars.is_cuda:
        raise ValueError(f"the blind kernel runs on CUDA tensors, not "
                         f"{chars.device}")
    if tables_bytes(seeds, num_hashes) > MAX_SHARED_BYTES:
        raise ValueError(
            f"{len(seeds)} seeds of length {len(seeds[0])} need more than the "
            f"{MAX_SHARED_BYTES} bytes of shared memory a block may use")
    steps, walks = chars.shape
    k = window.shape[1]
    dev = chars.device
    chars = chars.to(torch.int32).contiguous()
    window = window.to(torch.int32).contiguous()
    fwd = fwd.reshape(walks, -1).contiguous()
    rev = rev.reshape(walks, -1).contiguous()
    nseeds = len(seeds)
    out = torch.empty((steps, walks, nseeds * num_hashes), dtype=torch.int64,
                      device=dev)
    fwd1, rev1 = torch.empty_like(fwd), torch.empty_like(rev)
    window1 = torch.empty_like(window)
    if walks == 0:
        return out, fwd1, rev1, window1
    lib = _lib()
    tables, meta = _kernel_tables(seeds, num_hashes, dev)
    nruns = sum(len(t) for t in _all_taps(seeds))
    status = lib.nthash_blind_roll(
        dev.index, chars.data_ptr(), steps, walks, window.data_ptr(), k,
        nseeds, nruns, num_hashes, tables.data_ptr(), meta.data_ptr(),
        fwd.data_ptr(), rev.data_ptr(), out.data_ptr(), fwd1.data_ptr(),
        rev1.data_ptr(), window1.data_ptr(), warps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, status, "blind roll launch")
    return out, fwd1, rev1, window1
