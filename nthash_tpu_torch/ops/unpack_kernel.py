"""The unpack kernel for the 2-bit wire format, and its plain version.

Counterpart of ``nthash_tpu/parallel/dp.py``'s ``unpack_codes_tm``, which
the JAX package computes in jnp outside any Pallas kernel: a kernel of the
port with no TPU kernel behind it. :func:`unpack_codes_tm` inverts
``io/stream.py::pack_codes`` on the card straight into the hash kernels'
time-major int32 layout, in place of ``prepare_codes`` on unpacked codes.
It launches ``csrc/unpack.cu`` for CUDA tensors and runs
:func:`unpack_codes_tm_plain` for CPU tensors; there is no other route, and
a failed launch raises. The source note says what bounds the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..io.stream import packed_shapes
from . import cuda_build

#: Kernel launches made by :func:`unpack_codes_tm`.
LAUNCHES = 0


def check_args(packed: torch.Tensor, nmask: torch.Tensor, length: int) -> None:
    """Raise unless (packed, nmask) are ``pack_codes``' planes of [B, length]
    codes on one device."""
    for name, t in (("packed", packed), ("nmask", nmask)):
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise TypeError(f"{name} must be a 2-D uint8 tensor, got "
                            f"{t.dtype} of shape {tuple(t.shape)}")
    if length < 1:
        raise ValueError(f"length ({length}) must be >= 1")
    want = packed_shapes((packed.shape[0], length))
    if (tuple(packed.shape), tuple(nmask.shape)) != want:
        raise ValueError(
            f"planes {tuple(packed.shape)} and {tuple(nmask.shape)} are not "
            f"pack_codes' {want[0]} and {want[1]} for length {length}")
    if packed.device != nmask.device:
        raise ValueError(f"packed on {packed.device}, nmask on {nmask.device}")


def unpack_codes_tm_plain(packed: torch.Tensor, nmask: torch.Tensor,
                          length: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`unpack_codes_tm`, on any device: the
    JAX package's shifts, stack and ``where`` with the batch kept minor."""
    check_args(packed, nmask, length)
    p_t = packed.T.to(torch.int32)                          # [L4/4, B]
    codes = torch.stack(
        [(p_t >> (2 * r)) & 3 for r in range(4)], dim=1
    ).reshape(-1, p_t.shape[1])                             # [L4, B]
    n_t = nmask.T.to(torch.int32)                           # [L8/8, B]
    nbits = torch.stack(
        [(n_t >> r) & 1 for r in range(8)], dim=1
    ).reshape(-1, n_t.shape[1])[: codes.shape[0]]           # [L4, B]
    return torch.where(nbits != 0, 4, codes)[:length]


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("unpack")
    fn = lib.nthash_unpack_codes
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
    return lib


def unpack_codes_tm(packed: torch.Tensor, nmask: torch.Tensor,
                    length: int) -> torch.Tensor:
    """(2-bit planes [B, ceil(L/4)], N bitmap [B, ceil(ceil4(L)/8)]) uint8
    from ``pack_codes`` -> [length, B] contiguous int32 codes (0-4), the
    layout ``hash_kmers_tm`` takes.

    A CUDA tensor goes through the CUDA kernel (``csrc/unpack.cu``), a CPU
    tensor through :func:`unpack_codes_tm_plain`.
    """
    global LAUNCHES
    check_args(packed, nmask, length)
    if packed.is_cuda:
        reads = packed.shape[0]
        dev = packed.device
        out = torch.empty((length, reads), dtype=torch.int32, device=dev)
        if reads == 0:
            return out
        packed, nmask = packed.contiguous(), nmask.contiguous()
        lib = _lib()
        status = lib.nthash_unpack_codes(
            dev.index, packed.data_ptr(), packed.shape[1], nmask.data_ptr(),
            nmask.shape[1], length, reads, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(lib, status, "unpack launch")
        LAUNCHES += 1
        return out
    if packed.device.type == "cpu":
        return unpack_codes_tm_plain(packed, nmask, length)
    raise ValueError(f"no unpack route for device {packed.device}")
