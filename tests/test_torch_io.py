"""The port's FASTX readers and streaming front-end against the JAX package."""

import numpy as np
import pytest

from nthash_tpu.io import fasta as jfasta
from nthash_tpu.io import native_loader as jax_native_loader
from nthash_tpu.io import stream as jstream
from nthash_tpu_torch.io import fasta, native_loader
from nthash_tpu_torch.io.stream import (
    Prefetcher,
    sniff_read_length,
    stream_code_batches,
)

needs_native = pytest.mark.skipif(
    not jax_native_loader.available(), reason="no C++ toolchain")


@pytest.fixture
def fastq(tmp_path, rng):
    path = tmp_path / "reads.fq"
    n, L = 500, 37
    seqs = np.frombuffer(b"ACGTNacgtRY", np.uint8)[
        rng.integers(0, 11, size=(n, L))]
    with open(path, "wb") as f:
        for i in range(n):
            f.write(b"@r%d desc\n" % i + seqs[i].tobytes() + b"\n+\n"
                    + b"I" * L + b"\n")
    return path, n, L


@pytest.fixture
def fasta_file(tmp_path):
    path = tmp_path / "toy.fa"
    path.write_text(">a one\nACGT\nNNAC\n\n>b\nacgtu\n>c\nGGGGGGGGGGGG\n")
    return path


def test_readers_match_jax(fastq, fasta_file):
    path, *_ = fastq
    assert list(fasta.read_fastq(path)) == list(jfasta.read_fastq(path))
    assert list(fasta.read_fastx(path)) == list(jfasta.read_fastx(path))
    assert list(fasta.read_fasta(fasta_file)) == list(jfasta.read_fasta(fasta_file))
    assert list(fasta.read_fastx(fasta_file)) == list(jfasta.read_fastx(fasta_file))


def test_encode_batch_matches_jax():
    seqs = [b"ACGTN", b"acgtuRY", b"", b"GATTACAGATTACA"]
    for length in (None, 6):
        assert np.array_equal(fasta.encode_batch(seqs, length),
                              jfasta.encode_batch(seqs, length))
    with pytest.raises(ValueError):
        fasta.encode_batch([])


def test_bad_format(tmp_path):
    p = tmp_path / "x.txt"
    p.write_text("hello\n")
    with pytest.raises(ValueError):
        list(fasta.read_fastx(p))


@pytest.mark.parametrize("use_native", [
    "numpy", pytest.param("native", marks=needs_native)])
def test_batches_match_jax(fastq, use_native):
    path, n, L = fastq
    got = list(stream_code_batches(path, 128, use_native=use_native))
    want = list(jstream.stream_code_batches(path, 128, use_native=use_native))
    assert [m for _, m in got] == [m for _, m in want] == [128, 128, 128, 116]
    for (a, _), (b, _) in zip(got, want):
        assert a.shape == (128, L) and np.array_equal(a, b)
    assert (got[-1][0][116:] == 4).all()  # padded rows are invalid


@needs_native
def test_offsets_and_resume_match_jax(fastq):
    path, n, L = fastq
    got = list(stream_code_batches(path, 100, L, with_offsets=True))
    want = list(jstream.stream_code_batches(path, 100, L, with_offsets=True))
    assert [g[2] for g in got] == [w[2] for w in want]
    resumed = list(stream_code_batches(path, 100, L, start_offset=got[1][2]))
    rows = np.concatenate([b[:m] for b, m, _ in got])
    assert np.array_equal(np.concatenate([b[:m] for b, m in resumed]),
                          rows[200:])


@needs_native
def test_native_parser_builds_outside_jax_package():
    assert native_loader.available()
    assert native_loader.LIB.parent.name == "_build"
    assert native_loader.LIB.parent.parent.name == "nthash_tpu_torch"
    assert native_loader.LIB.exists()


def test_long_reads_error_or_truncate(fastq):
    """A read longer than the row raises by default, with either parser;
    none is truncated unless asked (below). A row long enough takes every
    read whole."""
    path, n, L = fastq
    assert sniff_read_length(path) == L
    parsers = ["numpy"] + (["native"] if native_loader.available() else [])
    for use_native in parsers:
        with pytest.raises(ValueError, match="exceeds"):
            list(stream_code_batches(path, 64, L - 1, use_native=use_native))
        batches = list(stream_code_batches(path, 64, L + 3,
                                           use_native=use_native))
        assert sum(m for _, m in batches) == n
        assert all((b[:, L:] == 4).all() for b, _ in batches)


@pytest.mark.parametrize("use_native", [
    "numpy", pytest.param("native", marks=needs_native)])
def test_on_long_truncate_matches_jax(tmp_path, use_native):
    """One 11-base read into rows of 10: ``on_long="truncate"`` keeps its
    first 10 bases, as the JAX package's stream does; "error" (the default)
    raises and any other value is refused."""
    path = tmp_path / "long.fq"
    path.write_bytes(b"@a\nACGTNACGTAC\n+\nIIIIIIIIIII\n@b\nGATTA\n+\nIIIII\n")
    got = list(stream_code_batches(path, 4, 10, use_native=use_native,
                                   on_long="truncate"))
    want = list(jstream.stream_code_batches(path, 4, 10, use_native=use_native,
                                            on_long="truncate"))
    assert [m for _, m in got] == [m for _, m in want] == [2]
    assert np.array_equal(got[0][0], want[0][0])
    assert got[0][0][0].tolist() == [0, 1, 2, 3, 4, 0, 1, 2, 3, 0]
    for kw in ({}, {"on_long": "error"}):
        with pytest.raises(ValueError, match="exceeds"):
            list(stream_code_batches(path, 4, 10, use_native=use_native, **kw))
    with pytest.raises(ValueError, match="on_long"):
        list(stream_code_batches(path, 4, 10, use_native=use_native,
                                 on_long="drop"))


def test_offsets_need_native(fastq):
    path, *_ = fastq
    with pytest.raises(RuntimeError):
        list(stream_code_batches(path, 64, use_native="numpy",
                                 with_offsets=True))


def test_prefetcher_order_errors_and_close():
    assert list(Prefetcher(iter(range(10)))) == list(range(10))

    def boom():
        yield 1
        raise RuntimeError("parse failed")

    it = iter(Prefetcher(boom()))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="parse failed"):
        next(it)

    closed = []

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.append(True)

    pf = Prefetcher(endless(), depth=2)
    assert next(iter(pf)) == 0
    pf.close()
    assert not pf._thread.is_alive()
    assert closed == [True]


@pytest.mark.parametrize("batch_size,read_length", [(64, None), (7, 20),
                                                    (500, 37), (1000, 50)])
def test_stream_batches_match_jax(fastq, fasta_file, batch_size,
                                  read_length):
    """BatchConfig / stream_batches: the numpy reader's batches, the last
    one at its true size."""
    for path in (fastq[0], fasta_file):
        cfg = fasta.BatchConfig(batch_size, read_length)
        want = list(jfasta.stream_batches(
            path, jfasta.BatchConfig(batch_size, read_length)))
        got = list(fasta.stream_batches(path, cfg))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.dtype == np.uint8 and np.array_equal(g, w)
    assert fasta.BatchConfig() == fasta.BatchConfig(65536, None)


@needs_native
def test_native_encode_matches_jax():
    seq = bytes(range(256)) + b"ACGTNacgtnRYKM" * 7
    assert np.array_equal(native_loader.encode(seq),
                          jax_native_loader.encode(seq))
    assert native_loader.encode(b"").shape == (0,)


@needs_native
@pytest.mark.parametrize("max_reads,row_len", [(64, 37), (100, 20),
                                               (1000, 40), (1, 37)])
def test_next_batch_and_batches_match_jax(fastq, max_reads, row_len):
    """next_batch (codes and true lengths, truncated rows) and batches
    against the JAX package's parser bindings."""
    path = fastq[0]
    with native_loader.NativeFastxParser(path) as p, \
            jax_native_loader.NativeFastxParser(path) as jp:
        got = list(p.batches(max_reads, row_len))
        want = list(jp.batches(max_reads, row_len))
        assert p.next_batch(max_reads, row_len) is None
    assert len(got) == len(want) > 0
    for (codes, lengths), (wcodes, wlengths) in zip(got, want):
        assert np.array_equal(codes, wcodes)
        assert np.array_equal(lengths, wlengths)
