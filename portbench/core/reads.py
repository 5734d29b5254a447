"""The benchmark's data: a genome and the reads sequenced from it, made on
the device from the seed, and the FASTQ file they make.

A genome of ``genome_length`` random bases stands in for the species' own.
Reads of ``read_length`` bases start at uniform positions, come from either
strand with even odds (the minus strand's read is the reverse complement),
then carry substitution errors (a base replaced by one of the three others)
and N calls at the given rates a base. Codes: 0-3 for ACGT, 4 for N.

Everything comes from one ``torch.Generator`` on the device, in chunks of
``CHUNK`` reads drawn in order, so the same seed on the same kind of device
gives the same reads, and every seed gives the same sizes.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

CHUNK = 1 << 18
ASCII = torch.tensor(list(b"ACGTN"), dtype=torch.uint8)


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number >= 0."""
    if seed < 0:
        raise ValueError(f"seed ({seed}) must be >= 0")
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))
    return g


def make_genome(data: dict, seed: int,
                device) -> tuple[torch.Tensor, torch.Generator]:
    """uint8 [genome_length] codes 0-3, the first draw of the seed's
    generator, and that generator, where ``make_reads`` goes on to draw the
    reads: the genome a seed's reads come from."""
    g = generator(seed, device)
    genome = torch.randint(0, 4, (data["genome_length"],), generator=g,
                           device=device, dtype=torch.uint8)
    return genome, g


def make_reads(data: dict, seed: int, device) -> torch.Tensor:
    """uint8 [reads, read_length] codes, per the configuration's ``data``
    (``genome_length``, ``reads``, ``read_length``, ``substitution_rate``,
    ``n_rate``), sequenced from ``make_genome``'s genome."""
    size, n, length = data["genome_length"], data["reads"], data["read_length"]
    if size < length:
        raise ValueError(f"genome ({size}) shorter than a read ({length})")
    genome, g = make_genome(data, seed, device)
    out = torch.empty((n, length), dtype=torch.uint8, device=device)
    offs = torch.arange(length, device=device)
    for s in range(0, n, CHUNK):
        m = min(CHUNK, n - s)
        start = torch.randint(0, size - length + 1, (m, 1), generator=g,
                              device=device)
        reads = genome[start + offs]
        minus = torch.rand(m, generator=g, device=device) < 0.5
        reads = torch.where(minus[:, None], (3 - reads).flip(1), reads)
        sub = torch.rand((m, length), generator=g,
                         device=device) < data["substitution_rate"]
        shift = torch.randint(1, 4, (m, length), generator=g, device=device,
                              dtype=torch.uint8)
        reads = torch.where(sub, (reads + shift) % 4, reads)
        n_call = torch.rand((m, length), generator=g,
                            device=device) < data["n_rate"]
        out[s:s + m] = torch.where(n_call, 4, reads)
    return out


def write_fastq(codes: torch.Tensor, path: Path) -> int:
    """Write the reads as FASTQ (``@r``, the bases, ``+``, quality ``I``),
    built on the codes' device a chunk at a time, and flush it to disk, so
    that no write-back runs inside the window; returns the bytes."""
    n, length = codes.shape
    width = 2 * length + 7
    ascii_ = ASCII.to(codes.device)
    head = torch.tensor(list(b"@r\n"), dtype=torch.uint8, device=codes.device)
    mid = torch.tensor(list(b"\n+\n"), dtype=torch.uint8, device=codes.device)
    written = 0
    with open(path, "wb") as f:
        for s in range(0, n, CHUNK):
            c = codes[s:s + CHUNK]
            rec = torch.empty((c.shape[0], width), dtype=torch.uint8,
                              device=codes.device)
            rec[:, 0:3] = head
            rec[:, 3:3 + length] = ascii_[c.long()]
            rec[:, 3 + length:6 + length] = mid
            rec[:, 6 + length:6 + 2 * length] = ord("I")
            rec[:, -1] = ord("\n")
            buf = rec.cpu().numpy().tobytes()
            f.write(buf)
            written += len(buf)
        f.flush()
        os.fsync(f.fileno())
    return written
