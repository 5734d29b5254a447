"""Streaming front-end: file -> fixed-shape uint8 code batches, parsed ahead.

Counterpart of ``nthash_tpu/io/stream.py`` (``sniff_read_length``,
``stream_code_batches``, ``Prefetcher``): a serial parse that can report and
resume from file offsets. The JAX package's byte-range parallel parse and
2-bit ``pack_codes`` wire format are not ported yet (ROADMAP).

- :func:`stream_code_batches` yields fixed-shape [batch_size, L] uint8 code
  batches, preferring the native C++ parser and falling back to the numpy
  reader when it cannot be built. The final partial batch is padded with
  invalid reads, whose windows are all masked.
- :class:`Prefetcher` runs the parse in a background thread with a bounded
  queue, so parsing the next batch overlaps device work on the current one.
"""

from __future__ import annotations

import queue
import threading
import weakref
from pathlib import Path
from typing import Iterator

import numpy as np

from ..constants import CODE_N


def sniff_read_length(path, sample: int = 1024) -> int:
    """Max sequence length over the first ``sample`` records (the row
    length for fixed-shape batching). A longer read later in the file is an
    error in :func:`stream_code_batches`."""
    from .fasta import read_fastx

    longest = 0
    for i, (_, seq) in enumerate(read_fastx(path)):
        longest = max(longest, len(seq))
        if i + 1 >= sample:
            break
    if longest == 0:
        raise ValueError(f"no records in {path}")
    return longest


def _native_ok(path) -> bool:
    from . import native_loader

    return Path(path).suffix != ".gz" and native_loader.available()


def _too_long(path, got: int, row_len: int) -> ValueError:
    return ValueError(
        f"read of length {got} in {path} exceeds the batch row length "
        f"{row_len}: pass read_length>={got}"
    )


def stream_code_batches(
    path,
    batch_size: int,
    read_length: int | None = None,
    *,
    use_native: str = "auto",
    on_long: str = "error",
    start_offset: int = 0,
    with_offsets: bool = False,
) -> Iterator[tuple]:
    """Yield ([batch_size, L] uint8 codes, n_real_reads) batches.

    Every batch has exactly ``batch_size`` rows (the last one padded with
    invalid-code rows). ``use_native``: "auto" | "native" | "numpy".

    A read longer than the row length (``read_length`` or the sniffed max of
    the first 1024 records) raises by default: fixed-shape batching would
    silently drop its tail windows. ``on_long="truncate"`` accepts that
    undercount explicitly and keeps each read's first ``L`` bases.

    ``with_offsets`` yields (codes, n, offset) instead, where ``offset`` is
    the file position just past the batch's last record; a later run passing
    it as ``start_offset`` resumes by seeking there. Both need the native
    parser.
    """
    if use_native not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown use_native {use_native!r}")
    if on_long not in ("error", "truncate"):
        raise ValueError(f"unknown on_long {on_long!r}")
    length = read_length or sniff_read_length(path)
    native = use_native == "native" or (
        use_native == "auto" and _native_ok(path)
    )
    if (with_offsets or start_offset) and not native:
        raise RuntimeError(
            "stream offsets require the native parser (uncompressed input)"
        )

    buf = np.full((batch_size, length), CODE_N, dtype=np.uint8)
    fill = 0

    def flush(n):
        out = buf.copy()
        if n < batch_size:
            out[n:] = CODE_N
        return out, n

    if native:
        from .native_loader import NativeFastxParser, sniff_format

        fmt = sniff_format(path) if start_offset else 0
        with NativeFastxParser(path, start_offset, None, fmt) as p:
            while True:
                n, longest = p.next_batch_into(buf[fill:])
                if longest > length and on_long == "error":
                    raise _too_long(path, longest, length)
                fill += n
                if fill == batch_size:
                    yield flush(fill) + ((p.tell(),) if with_offsets else ())
                    fill = 0
                elif n == 0:
                    break
            if fill:
                yield flush(fill) + ((p.tell(),) if with_offsets else ())
        return
    from .fasta import ASCII_TO_CODE, read_fastx

    for _, seq in read_fastx(path):
        if len(seq) > length and on_long == "error":
            raise _too_long(path, len(seq), length)
        arr = ASCII_TO_CODE[np.frombuffer(seq[:length], dtype=np.uint8)]
        buf[fill, : len(arr)] = arr
        buf[fill, len(arr):] = CODE_N
        fill += 1
        if fill == batch_size:
            yield flush(fill)
            fill = 0
    if fill:
        yield flush(fill)


class Prefetcher:
    """Background-thread iterator: produces up to ``depth`` items ahead.

    >>> with Prefetcher(stream_code_batches(p, 65536)) as pf:
    ...     for batch, n in pf:
    ...         ...  # parse of the next batch overlaps this body

    The producer checks a cancel flag on every put, so abandoning the
    iteration (with :meth:`close`, the context manager, or by dropping the
    object) unwinds it and closes the generator instead of leaving it
    blocked on the queue with the file open.
    """

    _DONE = object()

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err_box: list = []
        self._cancel = threading.Event()
        # the worker holds no reference to self, so an abandoned Prefetcher
        # is collectable and its finalizer cancels the producer
        self._thread = threading.Thread(
            target=self._run,
            args=(it, self._q, self._cancel, self._DONE, self._err_box),
            daemon=True,
        )
        self._finalizer = weakref.finalize(self, self._cancel.set)
        self._thread.start()

    @staticmethod
    def _run(it, q, cancel, done, err_box):
        try:
            for item in it:
                while not cancel.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if cancel.is_set():
                    close = getattr(it, "close", None)  # generator cleanup
                    if close is not None:
                        close()
                    return
        except BaseException as e:  # propagated to the consumer
            err_box.append(e)
        finally:
            while not cancel.is_set():
                try:
                    q.put(done, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer and release its resources (idempotent)."""
        self._cancel.set()
        while True:  # drain so a blocked put can observe the cancel flag
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err_box:
                    raise self._err_box[0]
                return
            yield item
