"""The parallel parse, the packed wire format and the routes of count_file,
against the JAX package, exactly.

One JAX ``count_file`` at ``threads=3, pack_h2d=True`` (its Pallas kernels
in interpret mode, the costly part, compiled once for the module) and one
with a checkpoint at the same shapes are the references: every route of
the port's ``count_file`` must build their sketch.
"""

import threading
import time

import numpy as np
import pytest
import torch

from nthash_tpu.io import native_loader as jax_native_loader
from nthash_tpu.io import stream as jstream
from nthash_tpu.models import pipeline as jpipe
from nthash_tpu.parallel import dp as jdp
from nthash_tpu.utils import checkpoint as jckpt
from nthash_tpu_torch.constants import CODE_N
from nthash_tpu_torch.io import native_loader
from nthash_tpu_torch.io import stream
from nthash_tpu_torch.models import sketch as cms
from nthash_tpu_torch.models.pipeline import (
    PipelineConfig,
    ReadHashingPipeline,
    fused_count_step,
)
from nthash_tpu_torch.ops import unpack_kernel
from nthash_tpu_torch.ops.kmer_kernel import prepare_codes
from nthash_tpu_torch.parallel import dp
from nthash_tpu_torch.utils import checkpoint

K, H, WL = 9, 3, 12
N_READS, L = 300, 24
BATCH = 128
CPU = torch.device("cpu")
LENGTHS = [1, 3, 4, 7, 8, 31, 150, 10_000]

pytestmark = pytest.mark.skipif(
    not (native_loader.available() and jax_native_loader.available()),
    reason="no C++ toolchain for the native parsers")


def _write_fastq(path, rng, n=N_READS, length=L):
    """Reads of 1..length bases with N: short reads leave padded rows."""
    with open(path, "wb") as f:
        for i in range(n):
            m = int(rng.integers(1, length + 1))
            seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, size=m)]
            f.write(b"@r%d\n" % i + seq.tobytes() + b"\n+\n" + b"I" * m
                    + b"\n")
    return path


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The FASTQ, the JAX count_file's sketch at threads=3 and pack_h2d, and
    its serial packed run's final checkpoint."""
    tmp = tmp_path_factory.mktemp("stream")
    path = _write_fastq(tmp / "reads.fq", np.random.default_rng(8))
    cfg = jpipe.PipelineConfig(k=K, num_hashes=H, sketch_width_log2=WL,
                               n_devices=1, pack_h2d=True)
    jp = jpipe.ReadHashingPipeline(cfg)
    assert jp.count_file(path, batch_size=BATCH, read_length=L,
                         threads=3) == N_READS
    ckpt = tmp / "jax.ckpt.npz"
    jc = jpipe.ReadHashingPipeline(cfg)
    assert jc.count_file(path, batch_size=BATCH, read_length=L,
                         checkpoint_path=ckpt) == N_READS
    rows = np.asarray(jp.sketch.rows)
    assert np.array_equal(np.asarray(jc.sketch.rows), rows)
    return path, rows, ckpt


def _rows_multiset(batches):
    rows = np.concatenate([b[:m] for b, m, *_ in batches])
    return rows[np.lexsort(rows.T[::-1])]


# ------------------------------------------------------------ pack_codes ---

@pytest.mark.parametrize("length", LENGTHS)
def test_pack_codes_matches_jax(rng, length):
    """Byte-equal to the JAX package's, all five codes and padding rows,
    across several PACK_ROWS chunks where the batch is short enough."""
    reads = 3 if length == 10_000 else stream.PACK_ROWS * 2 + 5
    batch = rng.integers(0, 5, size=(reads, length), dtype=np.uint8)
    batch[-2:] = CODE_N
    got, want = stream.pack_codes(batch), jstream.pack_codes(batch)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.flags.c_contiguous
        assert g.shape == w.shape and np.array_equal(g, w)
    assert (got[0].shape, got[1].shape) == stream.packed_shapes(batch.shape)


def test_pack_codes_into_out_and_the_wire_ratio(rng):
    batch = rng.integers(0, 5, size=(40, 150), dtype=np.uint8)
    out = tuple(np.full(s, 7, np.uint8) for s in stream.packed_shapes(
        batch.shape))
    got = stream.pack_codes(batch, out)
    assert got[0] is out[0] and got[1] is out[1]
    assert all(np.array_equal(g, w) for g, w in zip(
        got, jstream.pack_codes(batch)))
    # 38 + 19 bytes a 150-bp read in place of 150: 2.63x
    assert sum(a.shape[1] for a in got) == 57
    assert round(150 / 57, 2) == 2.63
    with pytest.raises(ValueError, match="out shapes"):
        stream.pack_codes(batch, (out[1], out[0]))


def test_packed_batches_matches_jax(ref):
    """packed_batches over the stream with offsets yields what the JAX one
    yields, the offset passed through; into arrays from ``alloc`` too."""
    path, *_ = ref
    got = list(stream.packed_batches(stream.stream_code_batches(
        path, 64, L, with_offsets=True)))
    want = list(jstream.packed_batches(jstream.stream_code_batches(
        path, 64, L, with_offsets=True)))
    assert len(got) == len(want) == -(-N_READS // 64)
    lent = []

    def alloc(*shapes):
        lent.append(tuple(np.empty(s, np.uint8) for s in shapes))
        return lent[-1]

    into = list(stream.packed_batches(
        stream.stream_code_batches(path, 64, L, with_offsets=True), alloc))
    for g, w, a, out in zip(got, want, into, lent):
        assert g[1:] == w[1:] == a[1:]
        assert g[0][2] == w[0][2] == L
        for x, y, z in zip(g[0][:2], w[0][:2], a[0][:2]):
            assert np.array_equal(x, y) and np.array_equal(z, y)
        assert a[0][0] is out[0] and a[0][1] is out[1]


# ------------------------------------------------------ the parallel parse ---

@pytest.mark.parametrize("threads", [2, 3, 5])
def test_parallel_parse_matches_jax(ref, threads):
    """The same multiset of rows as the JAX serial and parallel parses;
    every batch full-shaped, a partial one padded, at most one a worker."""
    path, *_ = ref
    got = list(stream.stream_code_batches_parallel(path, 32, L,
                                                   threads=threads))
    serial = list(jstream.stream_code_batches(path, 32, L))
    par = list(jstream.stream_code_batches_parallel(path, 32, L,
                                                    threads=threads))
    mine = _rows_multiset(got)
    assert np.array_equal(mine, _rows_multiset(serial))
    assert np.array_equal(mine, _rows_multiset(par))
    assert sum(m for _, m in got) == N_READS
    assert all(b.shape == (32, L) and b.dtype == np.uint8 for b, _ in got)
    partial = [(b, m) for b, m in got if m < 32]
    assert len(partial) <= threads
    assert all((b[m:] == CODE_N).all() for b, m in partial)


def test_parallel_parse_alloc_and_stage(ref):
    """Each batch is parsed into an array from ``alloc`` and ``stage`` runs
    in the worker that parsed it, off the consumer's thread."""
    path, *_ = ref
    made, seen = [], []
    lock = threading.Lock()

    def alloc(shape):
        arr = np.empty(shape, np.uint8)
        with lock:
            made.append(arr)
        return arr

    def stage(item):
        seen.append(threading.current_thread())
        return ("staged",) + item

    got = list(stream.stream_code_batches_parallel(
        path, 32, L, threads=3, alloc=alloc, stage=stage))
    assert all(tag == "staged" for tag, *_ in got)
    assert all(any(b is a for a in made) for _, b, _ in got)
    assert threading.main_thread() not in seen
    assert np.array_equal(_rows_multiset([(b, m) for _, b, m in got]),
                          _rows_multiset(stream.stream_code_batches(
                              path, 32, L)))


def test_parallel_long_read_raises_the_jax_message(tmp_path):
    """A worker's over-length read is raised in the consumer with the JAX
    package's message (and the serial parse says the same)."""
    path = tmp_path / "var.fa"
    recs = b"".join(b">r%d\nACGTACGT\n" % i for i in range(200))
    path.write_bytes(recs + b">long\n" + b"ACGT" * 8 + b"\n")
    msgs = []
    for parse in (stream.stream_code_batches_parallel,
                  jstream.stream_code_batches_parallel):
        with pytest.raises(ValueError) as e:
            list(parse(path, 64, read_length=8, threads=3))
        msgs.append(str(e.value))
    with pytest.raises(ValueError) as e:
        list(stream.stream_code_batches(path, 64, read_length=8))
    assert msgs[0] == msgs[1] == str(e.value)
    assert "exceeds the batch row length" in msgs[0]


def test_parallel_parse_errors_match_jax(ref, tmp_path, monkeypatch):
    path, *_ = ref
    gz = tmp_path / "reads.fq.gz"
    gz.write_bytes(path.read_bytes())
    for parse in (stream.stream_code_batches_parallel,
                  jstream.stream_code_batches_parallel):
        with pytest.raises(ValueError, match="uncompressed"):
            list(parse(gz, 32, L, threads=2))
        with pytest.raises(ValueError, match="on_long"):
            list(parse(path, 32, L, threads=2, on_long="drop"))
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(jax_native_loader, "available", lambda: False)
    for parse in (stream.stream_code_batches_parallel,
                  jstream.stream_code_batches_parallel):
        with pytest.raises(RuntimeError, match="native parser"):
            list(parse(path, 32, L, threads=2))


def test_parallel_threads_capped_at_file_size(tmp_path):
    """threads = max(1, min(threads, size)): more threads than bytes parse
    the one record once, as the JAX package does."""
    path = tmp_path / "one.fa"
    path.write_bytes(b">a\nACGTA\n")
    for parse in (stream.stream_code_batches_parallel,
                  jstream.stream_code_batches_parallel):
        got = list(parse(path, 4, threads=50))
        assert sum(m for _, m in got) == 1
        assert got[0][0][0].tolist() == [0, 1, 2, 3, 0]


def test_parallel_parse_abandoned_stops_its_workers(ref):
    path, *_ = ref
    before = threading.active_count()
    it = stream.stream_code_batches_parallel(path, 8, L, threads=4)
    next(it)
    it.close()   # cancels the workers, drains the queue, joins them
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_serial_stream_parses_into_alloc(ref):
    """``alloc`` supplies every batch's array, filled in place; the batches
    equal the default ones; a wrong array is refused."""
    path, *_ = ref
    made = []

    def alloc(shape):
        made.append(np.full(shape, 9, np.uint8))
        return made[-1]

    for use_native in ("native", "numpy"):
        made.clear()
        got = list(stream.stream_code_batches(path, 64, L, alloc=alloc,
                                              use_native=use_native))
        want = list(jstream.stream_code_batches(path, 64, L,
                                                use_native=use_native))
        assert len(got) == len(want)
        for (g, m), (w, n) in zip(got, want):
            assert m == n and np.array_equal(g, w)
            assert any(g is a for a in made)
    with pytest.raises(ValueError, match="alloc"):
        list(stream.stream_code_batches(
            path, 64, L, alloc=lambda s: np.empty(s, np.int32)))


# ---------------------------------------------------------------- unpack ---

@pytest.mark.parametrize("length", LENGTHS)
def test_unpack_matches_jax_and_round_trips(rng, length):
    reads = 3 if length == 10_000 else 37
    batch = rng.integers(0, 5, size=(reads, length), dtype=np.uint8)
    batch[-1] = CODE_N
    packed, nmask = stream.pack_codes(batch)
    p, m = torch.from_numpy(packed), torch.from_numpy(nmask)
    before = unpack_kernel.LAUNCHES
    tm = dp.unpack_codes_tm(p, m, length)
    assert unpack_kernel.LAUNCHES == before   # the CPU runs the plain version
    assert tm.dtype == torch.int32 and tm.is_contiguous()
    assert np.array_equal(tm.numpy(), np.asarray(
        jdp.unpack_codes_tm(packed, nmask, length)))
    assert torch.equal(tm, unpack_kernel.unpack_codes_tm_plain(p, m, length))
    assert torch.equal(tm, prepare_codes(torch.from_numpy(batch)))
    bm = dp.unpack_codes(p, m, length)
    assert bm.dtype == torch.uint8
    assert np.array_equal(bm.numpy(), np.asarray(
        jdp.unpack_codes(packed, nmask, length)))
    assert np.array_equal(bm.numpy(), batch)


def test_unpack_refuses_what_pack_codes_does_not_make():
    packed, nmask = (torch.from_numpy(a) for a in stream.pack_codes(
        np.zeros((4, 10), np.uint8)))
    with pytest.raises(ValueError, match="pack_codes"):
        unpack_kernel.unpack_codes_tm(packed, nmask, 13)
    with pytest.raises(ValueError, match="pack_codes"):
        unpack_kernel.unpack_codes_tm(packed, nmask[:3], 10)
    with pytest.raises(TypeError, match="uint8"):
        unpack_kernel.unpack_codes_tm(packed.int(), nmask, 10)
    with pytest.raises(ValueError, match="length"):
        unpack_kernel.unpack_codes_tm(packed[:, :0], nmask[:, :0], 0)
    with pytest.raises(ValueError, match="device"):
        unpack_kernel.unpack_codes_tm(packed.to("meta"), nmask.to("meta"), 10)


def test_fused_count_packed_is_the_fused_step(rng):
    batch = rng.integers(0, 5, size=(50, 41), dtype=np.uint8)
    packed, nmask = (torch.from_numpy(a) for a in stream.pack_codes(batch))
    a = dp.fused_count_packed(packed, nmask,
                              cms.CountMinSketch.zeros(H, WL, CPU), K, 41)
    b = fused_count_step(prepare_codes(torch.from_numpy(batch)),
                         cms.CountMinSketch.zeros(H, WL, CPU), K)
    assert torch.equal(a.rows, b.rows)


# ---------------------------------------------------- count_file's routes ---

@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("threads", [1, 2, 4])
def test_count_file_routes_match_jax(ref, threads, pack):
    """Every route of the port's count_file builds the JAX count_file's
    sketch (threads=3, pack_h2d) and counts the same reads."""
    path, rows, _ = ref
    pipe = ReadHashingPipeline(PipelineConfig(
        k=K, num_hashes=H, sketch_width_log2=WL, pack_h2d=pack), device=CPU)
    assert pipe.count_file(path, batch_size=64, threads=threads) == N_READS
    assert np.array_equal(pipe.sketch.to_numpy(), rows)


def test_count_file_parallel_2_20_matches_jax_run_file(ref):
    """One case at PipelineConfig()'s width, packed and parallel, against
    the JAX run_file (the jnp engine, scatter counting) at 2**20."""
    path, *_ = ref
    cfg = dict(k=K, num_hashes=H, sketch_width_log2=20)
    jp = jpipe.ReadHashingPipeline(jpipe.PipelineConfig(**cfg, n_devices=1))
    jp.run_file(path, batch_size=BATCH, read_length=L, threads=3)
    pipe = ReadHashingPipeline(PipelineConfig(**cfg, pack_h2d=True),
                               device=CPU)
    assert pipe.count_file(path, batch_size=BATCH, threads=4) == N_READS
    assert np.array_equal(pipe.sketch.to_numpy(), np.asarray(jp.sketch.rows))


def test_packed_checkpoint_resume_matches_jax(ref, tmp_path):
    """A packed count_file interrupted after two batches and resumed equals
    the uninterrupted run, and its final checkpoint holds what the JAX
    package's packed run checkpointed."""
    path, rows, jax_ckpt = ref
    cfg = PipelineConfig(k=K, num_hashes=H, sketch_width_log2=WL,
                         pack_h2d=True)
    ckpt = tmp_path / "port.ckpt.npz"
    # the interrupted run: the first two batches, checkpointed after each
    sk = cms.CountMinSketch.zeros(H, WL, CPU)
    reads = offset = 0
    items = stream.packed_batches(stream.stream_code_batches(
        path, BATCH, L, with_offsets=True))
    for i, ((packed, nmask, length), m, off) in enumerate(items):
        if i == 2:
            break
        dp.fused_count_packed(torch.from_numpy(packed),
                              torch.from_numpy(nmask), sk, K, length)
        reads, offset = reads + m, off
    assert 0 < offset < path.stat().st_size
    ctx = {"input": f"{path.name}:{path.stat().st_size}",
           "batch_size": BATCH, "k": K, "num_hashes": H,
           "sketch_width_log2": WL}
    checkpoint.save(ckpt, {"rows": sk.rows, "reads": np.int64(reads),
                           "offset": np.int64(offset)}, context=ctx)
    resumed = ReadHashingPipeline(cfg, device=CPU)
    assert resumed.count_file(path, batch_size=BATCH, checkpoint_path=ckpt,
                              checkpoint_every=1) == N_READS
    whole = ReadHashingPipeline(cfg, device=CPU)
    assert whole.count_file(path, batch_size=BATCH) == N_READS
    assert torch.equal(resumed.sketch.rows, whole.sketch.rows)
    assert np.array_equal(resumed.sketch.to_numpy(), rows)
    like = {"rows": np.zeros_like(rows), "reads": np.int64(0),
            "offset": np.int64(0)}
    mine = jckpt.load(ckpt, like, expect_context=ctx)
    theirs = jckpt.load(jax_ckpt, like, expect_context=ctx)
    for key in like:
        assert np.array_equal(np.asarray(mine[key]), np.asarray(theirs[key]))
