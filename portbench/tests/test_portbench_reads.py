"""The read generator: the same seed gives the same reads, another seed
others, at the same sizes, and the reads of two seeds stay bit for bit
those the generator gave before ``make_genome`` was factored out; the reads
come from the genome's two strands with the stated error and N rates; the
FASTQ holds them."""

import hashlib

import pytest
import torch

from portbench.core import reads

DATA = {"genome_length": 5000, "reads": 3000, "read_length": 150,
        "substitution_rate": 0.0025, "n_rate": 0.001}


def test_same_seed_same_reads():
    a = reads.make_reads(DATA, 2**31 + 5, "cpu")
    b = reads.make_reads(DATA, 2**31 + 5, "cpu")
    c = reads.make_reads(DATA, 2**31 + 6, "cpu")
    assert a.shape == c.shape == (3000, 150) and a.dtype == torch.uint8
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("seed, sha256", [
    (2**31 + 5,
     "074b161930e21f695aef19fe871becb31581d534aad9b841a411f38f30f8f710"),
    (2**40 + 3,
     "d7dfbb43aa09ac32cbc5fa3c9ee28c3eed2faf845390a4e5d51b2d2a96bb362f"),
])
def test_reads_pinned(seed, sha256):
    r = reads.make_reads(DATA, seed, "cpu")
    assert hashlib.sha256(r.numpy().tobytes()).hexdigest() == sha256


def test_rates_and_strands():
    data = dict(DATA, reads=20000, substitution_rate=0.0, n_rate=0.0)
    r = reads.make_reads(data, 3, "cpu")
    assert int(r.max()) <= 3
    genome, _ = reads.make_genome(data, 3, "cpu")
    text = bytes(genome.tolist())
    plus = sum(bytes(x.tolist()) in text for x in r[:200])
    minus = sum(bytes((3 - x).flip(0).tolist()) in text for x in r[:200])
    assert plus + minus == 200 and 60 < plus < 140
    noisy = reads.make_reads(dict(DATA, reads=20000), 3, "cpu")
    n_share = float((noisy == 4).float().mean())
    assert 0.0006 < n_share < 0.0014


def test_fastq(tmp_path):
    r = reads.make_reads(dict(DATA, reads=10), 1, "cpu")
    path = tmp_path / "r.fastq"
    nbytes = reads.write_fastq(r, path)
    lines = path.read_bytes().split(b"\n")
    assert nbytes == path.stat().st_size == 10 * (2 * 150 + 7)
    assert lines[0] == b"@r" and lines[2] == b"+" and lines[3] == b"I" * 150
    got = [[b"ACGTN".index(ch) for ch in lines[4 * i + 1]] for i in range(10)]
    assert torch.equal(torch.tensor(got, dtype=torch.uint8), r)
