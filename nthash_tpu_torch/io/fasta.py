"""FASTA/FASTQ readers: files -> padded uint8 code batches (numpy, host side).

Counterpart of ``nthash_tpu/io/fasta.py``. Padding uses the invalid code (4),
which the engines mask, so padded tails never produce valid windows.
:func:`stream_batches` is the pure-numpy streaming reader; the counting path
streams through ``io/stream.py`` (native parser, fixed-shape batches).
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from ..constants import ASCII_TO_CODE, CODE_N


def _open(path) -> io.BufferedReader:
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta(path) -> Iterator[tuple[str, bytes]]:
    """Yield (name, sequence_bytes) records from a FASTA file (.gz ok)."""
    name = None
    chunks: list[bytes] = []
    with _open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                name = line[1:].split()[0].decode() if len(line) > 1 else ""
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, b"".join(chunks)


def read_fastq(path) -> Iterator[tuple[str, bytes, bytes]]:
    """Yield (name, sequence_bytes, quality_bytes) records from FASTQ (.gz ok)."""
    with _open(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            header = header.strip()
            if not header:
                continue
            if not header.startswith(b"@"):
                raise ValueError(f"malformed FASTQ header: {header[:50]!r}")
            seq = fh.readline().strip()
            plus = fh.readline()
            if not plus.startswith(b"+"):
                raise ValueError("malformed FASTQ record: missing '+' line")
            qual = fh.readline().strip()
            name = header[1:].split()[0].decode() if len(header) > 1 else ""
            yield name, seq, qual


def read_fastx(path) -> Iterator[tuple[str, bytes]]:
    """Yield (name, sequence) from FASTA or FASTQ, sniffing the format."""
    with _open(path) as fh:
        first = fh.peek(1)[:1] if hasattr(fh, "peek") else fh.read(1)
    if first == b">":
        yield from read_fasta(path)
    elif first == b"@":
        for name, seq, _ in read_fastq(path):
            yield name, seq
    else:
        raise ValueError(f"unrecognized FASTX format (first byte {first!r})")


def encode_batch(seqs: Iterable[bytes], length: int | None = None) -> np.ndarray:
    """Encode sequences into a [B, L] uint8 code batch, padding/truncating
    to ``length`` (default: the longest sequence) with the invalid code."""
    seqs = list(seqs)
    if not seqs:
        raise ValueError("empty batch")
    L = length or max(len(s) for s in seqs)
    out = np.full((len(seqs), L), CODE_N, dtype=np.uint8)
    for i, s in enumerate(seqs):
        arr = ASCII_TO_CODE[np.frombuffer(s[:L], dtype=np.uint8)]
        out[i, : len(arr)] = arr
    return out


@dataclass
class BatchConfig:
    batch_size: int = 65536
    read_length: int | None = None  # None: longest read in each batch


def stream_batches(path, config: BatchConfig = BatchConfig()
                   ) -> Iterator[np.ndarray]:
    """Stream a FASTA/FASTQ file as [batch_size, L] code batches.

    The final partial batch is yielded at its true size.
    """
    buf: list[bytes] = []
    for _, seq in read_fastx(path):
        buf.append(seq)
        if len(buf) == config.batch_size:
            yield encode_batch(buf, config.read_length)
            buf = []
    if buf:
        yield encode_batch(buf, config.read_length)
