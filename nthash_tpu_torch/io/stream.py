"""Streaming front-end: file -> fixed-shape uint8 code batches, parsed ahead.

Counterpart of ``nthash_tpu/io/stream.py``:

- :func:`stream_code_batches` yields fixed-shape [batch_size, L] uint8 code
  batches, preferring the native C++ parser and falling back to the numpy
  reader when it cannot be built. The final partial batch is padded with
  invalid reads, whose windows are all masked. It can report and resume
  from file offsets.
- :func:`stream_code_batches_parallel` parses byte-range shards of the file
  in worker threads, one native parser each (its C calls release the GIL).
- :func:`pack_codes` and :func:`packed_batches`: the 2-bit host->device
  wire format, 2 bits a base plus an N bitmap of 1 bit a base. A 150-bp
  read packs to 38 + 19 = 57 bytes in place of 150, 2.63x fewer;
  ``ops/unpack_kernel.py`` inverts it on the card.
- :class:`Prefetcher` runs the parse in a background thread with a bounded
  queue, so parsing the next batch overlaps device work on the current one.

The parser writes each batch straight into the array it yields, which
comes from ``alloc(shape)`` where the caller passes one (the pipeline's
pinned host buffers, ``io/pinned.py``) and is a new numpy array otherwise;
no yielded array is written again. The work of making batch n (its
array, its parse) runs inside the span ``nthash.parse#n`` (``#shard.n`` in
a shard's worker; ``utils/profiling.numbered``), on the thread that parses;
one more span, numbered past the last batch, finds the end of the input.
"""

from __future__ import annotations

import queue
import threading
import weakref
from pathlib import Path
from typing import Iterator

import numpy as np

from ..constants import CODE_N
from ..utils.profiling import numbered


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
        f"{row_len}: pass read_length>={got} (or on_long='truncate' to "
        "hash only each read's first rows, undercounting k-mers)"
    )


def _new_batch(alloc, shape) -> np.ndarray:
    """The array the parser fills next: ``alloc(shape)`` or a new one."""
    if alloc is None:
        return np.empty(shape, np.uint8)
    out = alloc(shape)
    if (out.shape != shape or out.dtype != np.uint8
            or not out.flags.c_contiguous):
        raise ValueError(f"alloc must return a C-contiguous uint8 array of "
                         f"shape {shape}")
    return out


def stream_code_batches(
    path,
    batch_size: int,
    read_length: int | None = None,
    *,
    use_native: str = "auto",
    on_long: str = "error",
    start_offset: int = 0,
    with_offsets: bool = False,
    alloc=None,
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

    ``alloc(shape)``, if given, supplies each batch's array, which the
    parser fills in place (see the module docstring).
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

    shape = (batch_size, length)
    if native:
        from .native_loader import NativeFastxParser, sniff_format

        fmt = sniff_format(path) if start_offset else 0
        with NativeFastxParser(path, start_offset, None, fmt) as p:
            batches = _native_batches(p, shape, alloc, path, length, on_long,
                                      with_offsets)
            for _, item in numbered(batches, "nthash.parse"):
                yield item
        return
    batches = _numpy_batches(path, shape, alloc, length, on_long)
    for _, item in numbered(batches, "nthash.parse"):
        yield item


def _native_batches(p, shape, alloc, path, length, on_long,
                    with_offsets=False) -> Iterator[tuple]:
    """The batches of ``shape`` one native parser ``p`` fills, as
    (codes, n) or (codes, n, offset), the last padded with invalid rows."""
    batch_size = shape[0]
    buf, fill = _new_batch(alloc, shape), 0

    def flush():
        buf[fill:] = CODE_N
        return (buf, fill) + ((p.tell(),) if with_offsets else ())

    while True:
        n, longest = p.next_batch_into(buf[fill:])
        if longest > length and on_long == "error":
            raise _too_long(path, longest, length)
        fill += n
        if fill == batch_size:
            yield flush()
            buf, fill = _new_batch(alloc, shape), 0
        elif n == 0:
            break
    if fill:
        yield flush()


def _numpy_batches(path, shape, alloc, length, on_long) -> Iterator[tuple]:
    """:func:`_native_batches` by the numpy reader (no offsets)."""
    from .fasta import ASCII_TO_CODE, read_fastx

    batch_size = shape[0]
    buf, fill = _new_batch(alloc, shape), 0
    for _, seq in read_fastx(path):
        if len(seq) > length and on_long == "error":
            raise _too_long(path, len(seq), length)
        arr = ASCII_TO_CODE[np.frombuffer(seq[:length], dtype=np.uint8)]
        buf[fill, : len(arr)] = arr
        buf[fill, len(arr):] = CODE_N
        fill += 1
        if fill == batch_size:
            yield buf, fill
            buf, fill = _new_batch(alloc, shape), 0
    if fill:
        buf[fill:] = CODE_N
        yield buf, fill


#: Rows :func:`pack_codes` packs at a time: its temporaries stay in cache,
#: and few numpy calls (each takes the GIL) leave room for parse threads.
PACK_ROWS = 16384


def packed_shapes(batch_shape) -> tuple[tuple[int, int], tuple[int, int]]:
    """Shapes of :func:`pack_codes`' planes for a [B, L] batch:
    ([B, ceil(L/4)], [B, ceil(ceil4(L)/8)])."""
    b, length = batch_shape
    p = -(-length // 4)
    return (b, p), (b, -(-4 * p // 8))


def pack_codes(batch: np.ndarray, out=None) -> tuple[np.ndarray, np.ndarray]:
    """[B, L] uint8 base codes (0-4) -> (2-bit planes [B, ceil(L/4)],
    N bitmap [B, ceil(ceil4(L)/8)]), 2.63x fewer bytes than the codes at
    L = 150.

    Code p of a read is bits 2(p % 4)..2(p % 4)+1 of byte p // 4; its N
    flag is bit p % 8 of bitmap byte p // 8 (``np.packbits``' little bit
    order). The JAX package's arithmetic, :data:`PACK_ROWS` rows at a time.
    ``out``: the two uint8 arrays to write (a pinned buffer's views), else
    new ones.
    """
    if out is None:
        out = tuple(np.empty(shape, np.uint8)
                    for shape in packed_shapes(batch.shape))
    packed, nmask = out
    if (packed.shape, nmask.shape) != packed_shapes(batch.shape):
        raise ValueError(f"out shapes {packed.shape}, {nmask.shape} are not "
                         f"{packed_shapes(batch.shape)}")
    b = batch.shape[0]
    for s in range(0, b, PACK_ROWS):
        packed[s:s + PACK_ROWS], nmask[s:s + PACK_ROWS] = _pack_rows(
            batch[s:s + PACK_ROWS])
    return packed, nmask


def _pack_rows(batch: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """:func:`pack_codes` of a few rows. Codes are 0-4 and 4 & 3 == 0, so
    ``& 3`` zeroes an N's 2-bit code and bit 2 is exactly the N flag. Four
    bytes are folded into one with shifts on a uint32 view (word-parallel,
    no strided gathers)."""
    b, length = batch.shape
    l4 = -(-length // 4) * 4
    c = np.zeros((b, l4), np.uint8)
    c[:, :length] = batch
    w32 = c.view(np.uint32)                       # [b, l4/4], zero-copy
    two = w32 & np.uint32(0x03030303)
    p32 = two | (two >> np.uint32(6)) | (two >> np.uint32(12)) \
        | (two >> np.uint32(18))
    packed = (p32 & np.uint32(0xFF)).astype(np.uint8)
    nbytes_ = ((w32 >> np.uint32(2)) & np.uint32(0x01010101)).view(np.uint8)
    l8 = -(-l4 // 8) * 8
    if l8 != l4:
        nm = np.zeros((b, l8), np.uint8)
        nm[:, :l4] = nbytes_
    else:
        nm = nbytes_
    return packed, np.packbits(nm, axis=-1, bitorder="little")


def packed_batches(src, alloc=None) -> Iterator[tuple]:
    """Wrap a (batch, n, ...) code-batch iterator so each batch is
    :func:`pack_codes`-compressed: yields ((packed, nmask, L), n, ...), the
    rest of each item (a stream offset) passed through. ``alloc(*shapes)``,
    if given, supplies the planes' arrays."""
    for item in src:
        batch = item[0]
        out = None if alloc is None else alloc(*packed_shapes(batch.shape))
        packed, nmask = pack_codes(batch, out)
        yield ((packed, nmask, batch.shape[1]),) + tuple(item[1:])


def stream_code_batches_parallel(
    path,
    batch_size: int,
    read_length: int | None = None,
    *,
    threads: int = 4,
    on_long: str = "error",
    alloc=None,
    stage=None,
) -> Iterator[tuple]:
    """Multi-thread sharded parse: ``threads`` byte-range shards of the file
    parsed concurrently, each yielding fixed-shape [batch_size, L] code
    batches as (codes, n).

    Each worker drives a byte-range ``NativeFastxParser`` (its C calls
    release the GIL) and ships complete batches through one bounded queue;
    a worker's error is raised in the consumer, and abandoning the iterator
    stops the workers (every put checks a cancel flag).

    Batch **order is nondeterministic** across runs; the sketch and Bloom
    consumers are order-invariant, and checkpointing (which needs the
    serial cursor) refuses ``threads > 1``. Each worker's final partial
    batch is padded with invalid rows, so up to ``threads`` partial batches
    appear instead of one.

    ``alloc(shape)`` supplies each batch's array (see the module
    docstring); ``stage(item)``, if given, runs in the worker on each
    (codes, n) item and its result is shipped instead (the pipeline packs
    and pins there, off the consumer's thread).
    """
    from .native_loader import NativeFastxParser, available, sniff_format

    if not available():
        raise RuntimeError("parallel parse requires the native parser")
    if Path(path).suffix == ".gz":
        raise ValueError("parallel parse requires an uncompressed file")
    if on_long not in ("error", "truncate"):
        raise ValueError(f"unknown on_long {on_long!r}")
    length = read_length or sniff_read_length(path)
    fmt = sniff_format(path)
    size = Path(path).stat().st_size
    threads = max(1, min(threads, size))
    bounds = [size * i // threads for i in range(threads + 1)]
    shape = (batch_size, length)

    q: queue.Queue = queue.Queue(maxsize=2 * threads)
    cancel = threading.Event()
    _DONE = object()

    def worker(shard, start, end):
        def put(item):
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def ship(buf, n):
            item = (buf, n)
            return put(stage(item) if stage is not None else item)

        try:
            with NativeFastxParser(path, start, end, fmt) as p:
                batches = _native_batches(p, shape, alloc, path, length,
                                          on_long)
                for _, (buf, n) in numbered(batches, "nthash.parse", shard):
                    if not ship(buf, n):
                        return
        except BaseException as e:
            put(e)
        finally:
            put(_DONE)

    workers = [
        threading.Thread(target=worker, args=(i, bounds[i], bounds[i + 1]),
                         daemon=True)
        for i in range(threads)
    ]
    for w in workers:
        w.start()
    live = threads
    try:
        while live:
            item = q.get()
            if item is _DONE:
                live -= 1
                continue
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancel.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        for w in workers:
            w.join(timeout=5.0)


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
