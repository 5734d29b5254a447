"""Pinned host buffers for a stream's host->device copies.

A copy from pageable memory is neither asynchronous nor fast: CUDA stages
it through a pinned buffer of its own and the calling thread waits.
:class:`PinnedBuffers` lends page-locked buffers to the producers (the
parser writes a batch into one, or ``pack_codes`` its planes), and
:meth:`PinnedBuffers.to_device` copies a lent buffer to the card with
``non_blocking=True`` on a side stream. The compute stream waits on an
event recorded after that copy, and the buffer is lent again only once the
same event has completed, so a batch is never overwritten while the card
still reads it.

CUDA only: a pipeline on the CPU copies nothing and pins nothing.
"""

from __future__ import annotations

import math
import threading
from collections import deque

import numpy as np
import torch

from ..utils.profiling import span


class PinnedBuffers:
    """At most ``count`` page-locked host buffers, lent and reused in turn.

    Producers (any thread) take buffers with :meth:`arrays`; one consumer
    hands each back with :meth:`to_device`. Past ``count``, a producer
    reuses the buffer of the oldest copy once that copy has completed, or
    waits for a buffer to come back. :meth:`close` wakes every
    waiting producer with an error, so a consumer that stops early does not
    leave them blocked.
    """

    def __init__(self, device, count: int):
        if count < 1:
            raise ValueError(f"count ({count}) must be >= 1")
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"pinned buffers are for a CUDA device, not "
                             f"{self.device}")
        self.count = count
        self.copy_stream = torch.cuda.Stream(self.device)
        self._cv = threading.Condition()
        self._copying: deque = deque()   # (buffer, event), oldest first
        self._made = 0
        self._lent: dict[int, torch.Tensor] = {}   # data pointer -> buffer
        self._closed = False

    def _take(self, nbytes: int) -> torch.Tensor:
        """A buffer of at least ``nbytes``; where none is free, the wait
        for one runs inside the span ``nthash.pinned.wait``."""
        event = None
        with self._cv:
            while True:
                if self._closed:
                    raise RuntimeError("pinned buffers closed")
                if self._made < self.count:
                    self._made += 1
                    buf = None
                    break
                if self._copying:
                    buf, event = self._copying.popleft()
                    break
                with span("nthash.pinned.wait"):
                    self._cv.wait()
        if event is not None and not event.query():
            with span("nthash.pinned.wait"):
                event.synchronize()   # the card has read this buffer
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        with self._cv:
            self._lent[buf.data_ptr()] = buf
        return buf

    def arrays(self, *shapes) -> tuple[np.ndarray, ...]:
        """uint8 arrays of ``shapes``, back to back in one pinned buffer."""
        sizes = [math.prod(shape) for shape in shapes]
        buf = self._take(sum(sizes)).numpy()
        out, off = [], 0
        for shape, n in zip(shapes, sizes):
            out.append(buf[off:off + n].reshape(shape))
            off += n
        return tuple(out)

    def to_device(self, *arrays: np.ndarray) -> tuple[torch.Tensor, ...]:
        """Copy arrays that lie back to back in one lent buffer (from
        :meth:`arrays`) to the card in one copy; returns
        uint8 tensors of their shapes, ready on the current stream."""
        base = arrays[0].ctypes.data
        off = 0
        for a in arrays:
            if a.ctypes.data != base + off or a.dtype != np.uint8:
                raise ValueError("arrays must lie back to back in one "
                                 "buffer of this pool")
            off += a.nbytes
        with self._cv:
            buf = self._lent.pop(base, None)
        if buf is None:
            raise ValueError("arrays are not in a buffer lent by this pool")
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.copy_stream):
            dst = torch.empty(off, dtype=torch.uint8, device=self.device)
            dst.copy_(buf[:off], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        compute.wait_event(event)
        dst.record_stream(compute)
        with self._cv:
            self._copying.append((buf, event))
            self._cv.notify()
        out, off = [], 0
        for a in arrays:
            out.append(dst[off:off + a.nbytes].view(a.shape))
            off += a.nbytes
        return tuple(out)

    def close(self) -> None:
        """Refuse further loans and wake every waiting producer."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
