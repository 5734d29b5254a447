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

The range reaches 2**30, past the TPU kernel's 2**26: the sort-partitioned
path (``ops/part_kernel.py``) falls back to one full-width histogram under
skew. Two arguments serve that path: ``out`` accumulates into an existing
tensor (the sketch's rows), and ``gate`` (one device int32) lets the device,
not the host, decide whether a launch counts anything.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MIN_WIDTH_LOG2 = 10
MAX_WIDTH_LOG2 = 30

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


def _check_extras(idx, width_log2, gate, out):
    """Validate ``gate`` and ``out`` against idx [R, N]."""
    if gate is not None and (gate.dtype != torch.int32 or gate.numel() != 1
                             or gate.device != idx.device):
        raise ValueError("gate must be one int32 element on the idx's device")
    if out is not None and (
            out.dtype != torch.int32 or out.device != idx.device
            or tuple(out.shape) != (idx.shape[0], 1 << width_log2)
            or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous int32 [{idx.shape[0]}, "
            f"{1 << width_log2}] tensor on the idx's device")


def histogram_rows_plain(idx: torch.Tensor, weight: torch.Tensor | None,
                         width_log2: int, *, gate: torch.Tensor | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`histogram_rows`, on any device:
    out-of-range entries masked out, ``index_add_`` (in int64 with weights,
    then wrapped to int32 mod 2**32; in int32 without, where a count cannot
    wrap), the gate applied as a 0/1 factor so nothing waits on it."""
    idx, weight = _rows_and_weight(idx, weight, width_log2)
    _check_extras(idx, width_log2, gate, out)
    rows, n = idx.shape
    width = 1 << width_log2
    dev = idx.device
    keep = (idx >= 0) & (idx < width)
    flat = (idx.to(torch.int64)
            + torch.arange(rows, device=dev)[:, None] * width)[keep]
    if weight is None:
        # straight into ``out`` where given: at width 2**30 a second
        # full-width buffer would be another 4 GiB per row
        counts = (out.view(-1) if out is not None else
                  torch.zeros(rows * width, dtype=torch.int32, device=dev))
        w = torch.ones(flat.shape, dtype=torch.int32, device=dev)
        if gate is not None:
            w = w * (gate.reshape(()) != 0)
        counts.index_add_(0, flat, w)
        return counts.view(rows, width)
    wide = torch.zeros(rows * width, dtype=torch.int64, device=dev)
    w = weight.to(torch.int64).expand(rows, n)[keep]
    if gate is not None:
        w = w * (gate.reshape(()) != 0)
    wide.index_add_(0, flat, w)
    counts = (torch.remainder(wide + (1 << 31), 1 << 32)
              - (1 << 31)).to(torch.int32).reshape(rows, width)
    if out is None:
        return counts
    return out.add_(counts)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("histogram")
    fn = lib.nthash_histogram_rows
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
    return lib


def _launch(idx, weight, width_log2, gate, out):
    global LAUNCHES
    rows, n = idx.shape
    dev = idx.device
    if out is None:
        out = torch.zeros((rows, 1 << width_log2), dtype=torch.int32,
                          device=dev)
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
        width_log2, out.data_ptr(), None if gate is None else gate.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, status, "histogram launch")
    LAUNCHES += 1
    return out


def histogram_rows(idx: torch.Tensor, weight: torch.Tensor | None,
                   width_log2: int, *, gate: torch.Tensor | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """R independent weighted histograms in one kernel launch.

    Args:
      idx: [R, ...] int32 bucket indices; entries outside
        [0, 2**width_log2) are dropped (encode invalid updates as e.g.
        ``width``).
      weight: int32, either [...] shared across rows or [R, ...]; ``None``
        counts each update once. Sums wrap mod 2**32.
      width_log2: log2 of the histogram width, in [10, 30].
      gate: optional int32 tensor of one element on the same device; where
        it holds 0 nothing is counted. The device reads it, so a caller can
        choose between two launches without waiting on the host.
      out: optional contiguous int32 [R, 2**width_log2] to add the counts
        into (wrapping mod 2**32), instead of a new zeroed tensor.

    Returns:
      int32 [R, 2**width_log2], equal to ``np.bincount`` per row (``out``
      plus the counts when ``out`` is given).

    There is no ``weight_bits``: every int32 weight is exact.

    A CUDA tensor goes through the CUDA kernel (``csrc/histogram.cu``), a
    CPU tensor through :func:`histogram_rows_plain`.
    """
    idx2, w = _rows_and_weight(idx, weight, width_log2)
    _check_extras(idx2, width_log2, gate, out)
    if idx2.is_cuda:
        return _launch(idx2, w, width_log2, gate, out)
    if idx2.device.type == "cpu":
        return histogram_rows_plain(idx, weight, width_log2, gate=gate,
                                    out=out)
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
