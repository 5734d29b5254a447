"""The rolling-hash kernel over time-major reads, and its plain version.

Counterpart of ``nthash_tpu/ops/kmer_pallas.py`` (``hash_kmers_tm``,
``hash_kmers_tm_auto``, ``prepare_codes``, ``hash_kmers_batch``). The kernel
is ``csrc/kmer_hash.cu``, which replaces the Pallas ``_kernel``; its source
note says what bounds it on the H100.

:func:`hash_kmers_tm` launches the kernel for a CUDA tensor and runs
:func:`hash_kmers_tm_plain` for a CPU tensor; there is no other route, and a
failed launch raises. The TPU kernel's read padding (R a multiple of
interleave * 1024) and its time-tiled long-read variant exist for VMEM and
have no counterpart: any R and any L >= k go through the one kernel.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import u64
from ..constants import nte64_multiplier, to_i64
from . import cuda_build
from .kmer_torch import plane_tables, roll_tm, window_valid, window_valid_tm

#: Kernel launches made by :func:`hash_kmers_tm` in this process.
LAUNCHES = 0


def prepare_codes(codes: torch.Tensor) -> torch.Tensor:
    """[B, L] integer codes -> time-major [L, B] int32 for the kernel, with
    codes above 4 clamped to 4 (invalid). Stays on the input's device."""
    codes = codes.to(torch.int32)
    return torch.where(codes > 4, 4, codes).T.contiguous()


def _check(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets):
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
        if not 1 <= emit_buckets <= 30:
            raise ValueError(f"emit_buckets ({emit_buckets}) must be in [1, 30]")


def hash_kmers_tm_plain(codes_tm: torch.Tensor, k: int, num_hashes: int = 1, *,
                        emit_fwd_rev: bool = False,
                        emit_buckets: int | None = None) -> list[torch.Tensor]:
    """Plain PyTorch version of :func:`hash_kmers_tm`, on any device: the
    time-major roll of ``ops/kmer_torch.py`` (the recurrence of
    ``kmer_jnp.py``), then the nte64 extensions and, in bucket mode, the
    low bits with invalid windows set to the sentinel."""
    _check(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets)
    fwd, rev = roll_tm(codes_tm, k)
    ext = u64.extend_hashes(u64.add(fwd, rev), k, num_hashes)
    if emit_buckets is None:
        return ext + [fwd, rev] if emit_fwd_rev else ext
    valid = window_valid_tm(codes_tm, k)
    mask, width = (1 << emit_buckets) - 1, 1 << emit_buckets
    return [torch.where(valid, (e & mask).to(torch.int32), width) for e in ext]


@lru_cache(maxsize=32)
def _kernel_tables(k: int, num_hashes: int, device: torch.device) -> torch.Tensor:
    """fwd_in, fwd_out, rev_in, rev_out_r (5 each) and the num_hashes - 1
    nte64 multipliers, as one int64 tensor on ``device``."""
    tabs = plane_tables(k)
    vals = (list(tabs.fwd_in) + list(tabs.fwd_out) + list(tabs.rev_in)
            + list(tabs.rev_out_r)
            + [nte64_multiplier(i, k) for i in range(1, num_hashes)])
    return torch.tensor([to_i64(v) for v in vals], dtype=torch.int64,
                        device=device)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("kmer_hash")
    fn = lib.nthash_kmer_hash
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
    return lib


def _launch(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets):
    global LAUNCHES
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
        dev.index, codes_tm.data_ptr(), length, reads, k, num_hashes,
        int(emit_fwd_rev), emit_buckets or 0, tables.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, status, "kmer_hash launch")
    LAUNCHES += 1
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
    CPU tensor through :func:`hash_kmers_tm_plain`.
    """
    _check(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets)
    if codes_tm.is_cuda:
        return _launch(codes_tm, k, num_hashes, emit_fwd_rev, emit_buckets)
    if codes_tm.device.type == "cpu":
        return hash_kmers_tm_plain(codes_tm, k, num_hashes,
                                   emit_fwd_rev=emit_fwd_rev,
                                   emit_buckets=emit_buckets)
    raise ValueError(f"no kmer_hash route for device {codes_tm.device}")


#: The JAX package picks a time-tiled kernel here when the whole read would
#: not fit VMEM; the CUDA kernel has no such limit, so this is the one kernel.
hash_kmers_tm_auto = hash_kmers_tm


def hash_kmers_batch(codes: torch.Tensor, k: int, num_hashes: int = 1):
    """[B, L] batch -> (hashes int64 [B, W, H], valid bool [B, W]), the
    ``kmer_torch.hash_kmers`` layout, through :func:`hash_kmers_tm`."""
    res = hash_kmers_tm(prepare_codes(codes), k, num_hashes)
    hashes = torch.stack([r.T for r in res], dim=-1)
    return hashes, window_valid(codes.to(torch.int32), k)
