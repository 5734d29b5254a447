"""ctypes bindings for the native C++ FASTX parser.

Counterpart of ``nthash_tpu/io/native_loader.py``: the encoder and the parser.
The parser source is this package's own copy, ``io/native/fastx.cpp`` (a test
keeps it byte-identical to the JAX package's), built with g++ at first use
into this package's git-ignored ``_build`` directory. Callers that cannot
build it (no toolchain) fall back to the numpy reader in ``io/fasta.py``
through :func:`available`: a choice of host parser only.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "io" / "native" / "fastx.cpp"
LIB = _PKG / "_build" / "libfastx.so"

_lib = None
_build_error: str | None = None


def _build() -> None:
    """Compile the parser unless an up-to-date library exists; written to a
    temporary name and renamed, so processes building at once never load a
    half-written file."""
    if LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime:
        return
    LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f".libfastx.{os.getpid()}.so")
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             str(SRC), "-o", str(tmp)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, LIB)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        _build()
        lib = ctypes.CDLL(str(LIB))
        lib.nthash_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p]
        lib.nthash_parser_open.restype = ctypes.c_void_p
        lib.nthash_parser_open.argtypes = [ctypes.c_char_p]
        lib.nthash_parser_open_range.restype = ctypes.c_void_p
        lib.nthash_parser_open_range.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.nthash_parser_tell.restype = ctypes.c_int64
        lib.nthash_parser_tell.argtypes = [ctypes.c_void_p]
        lib.nthash_parser_close.argtypes = [ctypes.c_void_p]
        lib.nthash_parser_next_batch.restype = ctypes.c_int64
        lib.nthash_parser_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.nthash_parser_error.restype = ctypes.c_char_p
        lib.nthash_parser_error.argtypes = [ctypes.c_void_p]
        _lib = lib
    except (subprocess.CalledProcessError, OSError) as e:
        _build_error = getattr(e, "stderr", None) or str(e)
    return _lib


def available() -> bool:
    return _load() is not None


def encode(seq: bytes) -> np.ndarray:
    """ASCII bytes -> uint8 base codes via the native encoder."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    out = np.empty(len(seq), dtype=np.uint8)
    lib.nthash_encode(seq, len(seq), out.ctypes.data_as(ctypes.c_void_p))
    return out


def sniff_format(path) -> int:
    """1 = FASTA ('>'), 2 = FASTQ ('@') from the file's first byte: a parser
    opened past the head needs it passed in."""
    with open(path, "rb") as f:
        first = f.read(1)
    if first == b">":
        return 1
    if first == b"@":
        return 2
    raise ValueError(f"{path}: not FASTA/FASTQ (first byte {first!r})")


class NativeFastxParser:
    """Streaming [B, L] code batches from a FASTA/FASTQ file (uncompressed).

    ``start``/``end`` open a byte-range: exactly the records whose header
    byte lies in [start, end) are parsed (resyncing to the next record
    boundary after ``start``). ``fmt`` (from :func:`sniff_format`) is
    required when ``start > 0``.
    """

    def __init__(self, path, start: int = 0, end: int | None = None,
                 fmt: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        if start > 0 and fmt == 0:
            raise ValueError("byte-range shards need fmt (sniff_format)")
        if start == 0 and end is None and fmt == 0:
            self._h = lib.nthash_parser_open(str(path).encode())
        else:
            self._h = lib.nthash_parser_open_range(
                str(path).encode(), start,
                (1 << 62) if end is None else end, fmt,
            )
        if not self._h:
            raise FileNotFoundError(path)

    def tell(self) -> int:
        """Byte offset just past the last parsed record (the next record's
        header offset): persist it to make stream resume an O(1) seek."""
        return int(self._lib.nthash_parser_tell(self._h))

    def close(self):
        if self._h:
            self._lib.nthash_parser_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _fill(self, out: np.ndarray) -> tuple[int, np.ndarray]:
        """Parse up to ``len(out)`` reads into the rows of ``out``; returns
        (reads produced, 0 at EOF; their true lengths)."""
        max_reads, row_len = out.shape
        lengths = np.empty(max_reads, dtype=np.int64)
        n = self._lib.nthash_parser_next_batch(
            self._h, max_reads, row_len,
            out.ctypes.data_as(ctypes.c_void_p),
            lengths.ctypes.data_as(ctypes.c_void_p),
        )
        if n < 0:
            raise ValueError(self._lib.nthash_parser_error(self._h).decode())
        return int(n), lengths[:n]

    def next_batch(self, max_reads: int, row_len: int):
        """Returns (codes [n, row_len] uint8, lengths [n] int64), or None at
        EOF. A read longer than ``row_len`` is truncated in ``codes``; its
        length says so."""
        codes = np.empty((max_reads, row_len), dtype=np.uint8)
        n, lengths = self._fill(codes)
        return (codes[:n], lengths) if n else None

    def batches(self, max_reads: int, row_len: int):
        """Yield :meth:`next_batch` results until EOF."""
        while True:
            b = self.next_batch(max_reads, row_len)
            if b is None:
                return
            yield b

    def next_batch_into(self, out: np.ndarray) -> tuple[int, int]:
        """Fill rows of a preallocated C-contiguous [max_reads, row_len]
        uint8 array; returns (reads produced, 0 at EOF; max true read length
        in the batch). Reads longer than row_len are truncated in ``out``;
        the caller detects that from the returned max length."""
        if out.dtype != np.uint8 or out.ndim != 2 or not out.flags.c_contiguous:
            raise ValueError("out must be a C-contiguous 2-D uint8 array")
        n, lengths = self._fill(out)
        return n, int(lengths.max()) if n else 0
