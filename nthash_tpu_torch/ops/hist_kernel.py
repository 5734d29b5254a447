"""Exact int32 row histograms: the CUDA kernel and its plain version.

Counterpart of ``nthash_tpu/ops/hist_pallas.py``: :func:`histogram_rows` is
``mxu_histogram_rows`` and :func:`histogram` is ``mxu_histogram``, named for
what they compute rather than for the TPU's matrix unit. The kernel is
``csrc/histogram.cu``, which replaces the Pallas ``_hist_kernel``; its source
note says what bounds it on the H100.

The TPU version builds one-hot operands and counts on the MXU, splitting
weights into 8-bit digit planes so bf16 products stay exact; its
``weight_bits`` chose how many planes to pay for. Here every update is one
integer atomic add, exact for any int32 weight, so ``weight_bits`` is gone.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MIN_WIDTH_LOG2 = 10
MAX_WIDTH_LOG2 = 26

#: Kernel launches made by :func:`histogram_rows` in this process.
LAUNCHES = 0


def _rows_and_weight(idx, weight, width_log2):
    """Validate; return (idx [R, N], weight None | [N] | [R, N])."""
    if not MIN_WIDTH_LOG2 <= width_log2 <= MAX_WIDTH_LOG2:
        raise ValueError(
            f"width_log2 ({width_log2}) must be in "
            f"[{MIN_WIDTH_LOG2}, {MAX_WIDTH_LOG2}]")
    if idx.dtype != torch.int32 or idx.dim() < 1:
        raise TypeError(f"idx must be an int32 [R, ...] tensor, got {idx.dtype}")
    rows = idx.shape[0]
    idx = idx.reshape(rows, -1)
    n = idx.shape[1]
    if weight is None:
        return idx, None
    if weight.dtype != torch.int32:
        raise TypeError(f"weight must be int32, got {weight.dtype}")
    if weight.device != idx.device:
        raise ValueError(f"weight on {weight.device}, idx on {idx.device}")
    if weight.numel() == n:
        return idx, weight.reshape(n)
    if weight.numel() == rows * n:
        return idx, weight.reshape(rows, n)
    raise ValueError(
        f"weight has {weight.numel()} entries; expected {n} (shared) or "
        f"{rows * n} (per row)")


def histogram_rows_plain(idx: torch.Tensor, weight: torch.Tensor | None,
                         width_log2: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`histogram_rows`, on any device:
    out-of-range entries masked out, ``index_add_`` in int64, then wrapped
    to int32 (mod 2**32)."""
    idx, weight = _rows_and_weight(idx, weight, width_log2)
    rows, n = idx.shape
    width = 1 << width_log2
    dev = idx.device
    if weight is None:
        w = torch.ones((rows, n), dtype=torch.int64, device=dev)
    else:
        w = weight.to(torch.int64).expand(rows, n)
    keep = (idx >= 0) & (idx < width)
    flat = idx.to(torch.int64) + torch.arange(rows, device=dev)[:, None] * width
    out = torch.zeros(rows * width, dtype=torch.int64, device=dev)
    out.index_add_(0, flat[keep], w[keep])
    wrapped = torch.remainder(out + (1 << 31), 1 << 32) - (1 << 31)
    return wrapped.to(torch.int32).reshape(rows, width)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("histogram")
    fn = lib.nthash_histogram_rows
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
    return lib


def _launch(idx, weight, width_log2):
    global LAUNCHES
    rows, n = idx.shape
    dev = idx.device
    out = torch.zeros((rows, 1 << width_log2), dtype=torch.int32, device=dev)
    if rows == 0 or n == 0:
        return out
    idx = idx.contiguous()
    if weight is not None:
        weight = weight.contiguous()
    lib = _lib()
    status = lib.nthash_histogram_rows(
        dev.index, idx.data_ptr(), rows, n,
        None if weight is None else weight.data_ptr(),
        n if weight is not None and weight.dim() == 2 else 0,
        width_log2, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, status, "histogram launch")
    LAUNCHES += 1
    return out


def histogram_rows(idx: torch.Tensor, weight: torch.Tensor | None,
                   width_log2: int) -> torch.Tensor:
    """R independent weighted histograms in one kernel launch.

    Args:
      idx: [R, ...] int32 bucket indices; entries outside
        [0, 2**width_log2) are dropped (encode invalid updates as e.g.
        ``width``).
      weight: int32, either [...] shared across rows or [R, ...]; ``None``
        counts each update once. Sums wrap mod 2**32.
      width_log2: log2 of the histogram width, in [10, 26].

    Returns:
      int32 [R, 2**width_log2], equal to ``np.bincount`` per row.

    There is no ``weight_bits``: every int32 weight is exact.

    A CUDA tensor goes through the CUDA kernel (``csrc/histogram.cu``), a
    CPU tensor through :func:`histogram_rows_plain`.
    """
    idx2, w = _rows_and_weight(idx, weight, width_log2)
    if idx2.is_cuda:
        return _launch(idx2, w, width_log2)
    if idx2.device.type == "cpu":
        return histogram_rows_plain(idx, weight, width_log2)
    raise ValueError(f"no histogram route for device {idx2.device}")


def histogram(idx: torch.Tensor, weight: torch.Tensor | None,
              width_log2: int) -> torch.Tensor:
    """Flat weighted histogram of ``idx`` (any shape) -> int32 [width].

    See :func:`histogram_rows`; this is the single-row convenience.
    """
    return histogram_rows(
        idx.reshape(1, -1),
        None if weight is None else weight.reshape(1, -1),
        width_log2,
    )[0]
