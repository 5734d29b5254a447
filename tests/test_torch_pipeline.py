"""The port's sketch and streaming pipeline against the JAX package, exactly.

JAX's ``count_file`` runs its Pallas kernels in interpret mode on the CPU,
far too slowly for these tests, so the port's fused ``count_file`` is held
against JAX's ``run_file`` (the jnp engine plus scatter counting), which
builds the same sketch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nthash_tpu.io import native_loader as jax_native_loader
from nthash_tpu.models import pipeline as jpipe
from nthash_tpu.models import sketch as jcms
from nthash_tpu.ops import kmer_jnp
from nthash_tpu.utils import checkpoint as jckpt
from nthash_tpu_torch.io.stream import stream_code_batches
from nthash_tpu_torch.models import sketch as cms
from nthash_tpu_torch.models.pipeline import (
    PipelineConfig,
    ReadHashingPipeline,
    fused_count_step,
)
from nthash_tpu_torch.ops.hist_kernel import histogram_rows_plain
from nthash_tpu_torch.ops.kmer_kernel import prepare_codes
from nthash_tpu_torch.ops.kmer_torch import hash_kmers
from nthash_tpu_torch.u64 import to_numpy_u64
from nthash_tpu_torch.utils import checkpoint

K, H, WL = 9, 3, 12
CPU = torch.device("cpu")
needs_native = pytest.mark.skipif(
    not jax_native_loader.available(), reason="no C++ toolchain")


@pytest.fixture
def fastq(tmp_path, rng):
    """300 reads of 40 bp with N: batches of 128 leave a partial last one."""
    path = tmp_path / "reads.fq"
    n, L = 300, 40
    seqs = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, size=(n, L))]
    with open(path, "wb") as f:
        for i in range(n):
            f.write(b"@r%d\n" % i + seqs[i].tobytes() + b"\n+\n" + b"I" * L
                    + b"\n")
    return path, n, L


def _jax_reference_rows(codes, k, h, wl):
    """The JAX jnp reference step (as __graft_entry__.entry runs it)."""
    res = kmer_jnp.hash_kmers(jnp.asarray(codes), k, h)
    sk = jcms.update(jcms.CountMinSketch.zeros(h, wl), res.hashes, res.valid,
                     wl, ingestion="scatter")
    return np.asarray(sk.rows)


def _cfg(**kw):
    return PipelineConfig(**{"k": K, "num_hashes": H, "sketch_width_log2": WL,
                             **kw})


def _jax_pipe(**kw):
    return jpipe.ReadHashingPipeline(jpipe.PipelineConfig(
        **{"k": K, "num_hashes": H, "sketch_width_log2": WL, "n_devices": 1,
           **kw}))


@pytest.mark.parametrize("k,h,wl", [(9, 3, 12), (32, 4, 14), (5, 1, 10)])
def test_fused_count_step_vs_jnp(rng, k, h, wl):
    codes = rng.integers(0, 5, size=(6, 60), dtype=np.uint8)
    sk = cms.CountMinSketch.zeros(h, wl, CPU)
    out = fused_count_step(prepare_codes(torch.from_numpy(codes)), sk, k)
    assert out is sk  # updated in place
    assert np.array_equal(sk.to_numpy(), _jax_reference_rows(codes, k, h, wl))


def test_update_vs_jnp(rng):
    codes = rng.integers(0, 5, size=(6, 60), dtype=np.uint8)
    res = hash_kmers(torch.from_numpy(codes), K, H)
    sk = cms.update(cms.CountMinSketch.zeros(H, WL, CPU), res.hashes,
                    res.valid, WL)
    assert np.array_equal(sk.to_numpy(), _jax_reference_rows(codes, K, H, WL))
    # a second update accumulates
    cms.update(sk, res.hashes, res.valid, WL)
    assert np.array_equal(sk.to_numpy(),
                          2 * _jax_reference_rows(codes, K, H, WL))


def test_query_merge_vs_jnp(rng):
    codes = rng.integers(0, 5, size=(4, 50), dtype=np.uint8)
    res = hash_kmers(torch.from_numpy(codes), K, H)
    sk = cms.update(cms.CountMinSketch.zeros(H, WL, CPU), res.hashes,
                    res.valid, WL)
    jres = kmer_jnp.hash_kmers(jnp.asarray(codes), K, H)
    jsk = jcms.update(jcms.CountMinSketch.zeros(H, WL), jres.hashes,
                      jres.valid, WL, ingestion="scatter")
    assert np.array_equal(cms.query(sk, res.hashes, WL).numpy(),
                          np.asarray(jcms.query(jsk, jres.hashes, WL)))
    rows_t = [res.hashes[..., i].T for i in range(H)]
    assert torch.equal(cms.query_rows(sk, rows_t, WL),
                       cms.query(sk, res.hashes, WL).T)
    merged = cms.merge(sk, sk)
    assert np.array_equal(merged.to_numpy(),
                          np.asarray(jcms.merge(jsk, jsk).rows))


def test_update_from_buckets_guards(rng):
    sk = cms.CountMinSketch.zeros(2, WL, CPU)
    b = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="sketch rows"):
        cms.update_from_buckets(sk, [b])
    with pytest.raises(ValueError, match="emitted at width"):
        cms.update_from_buckets(sk, [b, b], emitted_width_log2=WL - 1)
    cms.update_from_buckets(sk, [b, b + (1 << WL)], emitted_width_log2=WL)
    assert sk.rows[0, 0] == 12 and sk.rows[1].sum() == 0  # sentinel dropped


@pytest.mark.parametrize("time_major", [True, False])
def test_step_and_query_vs_jax(rng, time_major):
    codes = rng.integers(0, 5, size=(8, 30), dtype=np.uint8)
    pipe = ReadHashingPipeline(_cfg(time_major=time_major), device=CPU)
    jp = _jax_pipe(time_major=time_major)
    hashes, valid = pipe.step(codes)
    jh, jv = jp.step(codes)
    assert np.array_equal(valid.numpy(), np.asarray(jv))
    if time_major:
        assert len(hashes) == H
        for a, b in zip(hashes, jh):
            assert np.array_equal(to_numpy_u64(a), b.to_np())
    else:
        assert np.array_equal(to_numpy_u64(hashes), jh.to_np())
    assert np.array_equal(pipe.sketch.to_numpy(), np.asarray(jp.sketch.rows))
    assert np.array_equal(pipe.query(hashes).numpy(), np.asarray(jp.query(jh)))


def test_count_file_vs_jax_run_file(fastq):
    path, n, L = fastq
    pipe = ReadHashingPipeline(_cfg(), device=CPU)
    assert pipe.count_file(path, batch_size=128) == n
    jp = _jax_pipe()
    jtotal = jp.run_file(path, batch_size=128, read_length=L)
    assert np.array_equal(pipe.sketch.to_numpy(), np.asarray(jp.sketch.rows))
    assert int(pipe.sketch.rows[0].sum()) == jtotal
    # run_file: the full-hash step path builds the same sketch and total
    pipe2 = ReadHashingPipeline(_cfg(), device=CPU)
    assert pipe2.run_file(path, batch_size=128) == jtotal
    assert torch.equal(pipe2.sketch.rows, pipe.sketch.rows)


def _crashed_run(path, batches, batch_size, L):
    """The state of a run that checkpointed after ``batches`` batches."""
    sk = cms.CountMinSketch.zeros(H, WL, CPU)
    reads = offset = 0
    for i, (batch, m, off) in enumerate(
            stream_code_batches(path, batch_size, L, with_offsets=True)):
        if i == batches:
            break
        fused_count_step(prepare_codes(torch.from_numpy(batch)), sk, K)
        reads, offset = reads + m, off
    ctx = {"input": f"{path.name}:{path.stat().st_size}",
           "batch_size": batch_size, "k": K, "num_hashes": H,
           "sketch_width_log2": WL}
    return sk, reads, offset, ctx


@needs_native
def test_checkpoint_resume(fastq, tmp_path):
    path, n, L = fastq
    ref = ReadHashingPipeline(_cfg(), device=CPU)
    assert ref.count_file(path, batch_size=64) == n
    sk, reads, offset, ctx = _crashed_run(path, 2, 64, L)
    assert 0 < offset < path.stat().st_size
    ckpt = tmp_path / "stream.ckpt.npz"
    checkpoint.save(ckpt, {"rows": sk.rows, "reads": np.int64(reads),
                           "offset": np.int64(offset)}, context=ctx)
    resumed = ReadHashingPipeline(_cfg(), device=CPU)
    assert resumed.count_file(path, batch_size=64, checkpoint_path=ckpt) == n
    assert torch.equal(resumed.sketch.rows, ref.sketch.rows)
    # the final checkpoint holds the whole stream
    state = checkpoint.load(ckpt, {"rows": ref.sketch.rows,
                                   "reads": np.int64(0),
                                   "offset": np.int64(0)})
    assert int(state["reads"]) == n
    assert int(state["offset"]) == path.stat().st_size
    assert torch.equal(state["rows"], ref.sketch.rows)


@needs_native
def test_checkpoint_every_and_context_mismatch(fastq, tmp_path):
    path, n, L = fastq
    ckpt = tmp_path / "every.npz"
    pipe = ReadHashingPipeline(_cfg(), device=CPU)
    assert pipe.count_file(path, batch_size=64, checkpoint_path=ckpt,
                           checkpoint_every=1) == n
    other = ReadHashingPipeline(_cfg(k=K + 1), device=CPU)
    with pytest.raises(ValueError, match="context mismatch"):
        other.count_file(path, batch_size=64, checkpoint_path=ckpt)


@needs_native
def test_jax_checkpoint_resumes_in_port(fastq, tmp_path):
    path, n, L = fastq
    _, reads, offset, ctx = _crashed_run(path, 2, 64, L)
    # the JAX package counts the first two batches and checkpoints them
    jp = _jax_pipe()
    from nthash_tpu.io.stream import stream_code_batches as jstream

    for i, (batch, m, off) in enumerate(
            jstream(path, 64, L, with_offsets=True)):
        if i == 2:
            break
        jp.step(batch)
        assert off <= offset
    ckpt = tmp_path / "jax.ckpt.npz"
    jckpt.save(ckpt, {"rows": jp.sketch.rows, "reads": np.int64(reads),
                      "offset": np.int64(offset)}, context=ctx)
    resumed = ReadHashingPipeline(_cfg(), device=CPU)
    assert resumed.count_file(path, batch_size=64, checkpoint_path=ckpt) == n
    ref = ReadHashingPipeline(_cfg(), device=CPU)
    ref.count_file(path, batch_size=64)
    assert torch.equal(resumed.sketch.rows, ref.sketch.rows)


def test_port_checkpoint_loads_in_jax(tmp_path, rng):
    rows = rng.integers(-5, 100, size=(H, 1 << WL)).astype(np.int32)
    ckpt = tmp_path / "port.ckpt.npz"
    checkpoint.save(ckpt, {"rows": torch.from_numpy(rows),
                           "reads": np.int64(7), "offset": np.int64(1234)},
                    context={"k": K})
    state = jckpt.load(ckpt, {"rows": jnp.zeros((H, 1 << WL), jnp.int32),
                              "reads": np.int64(0), "offset": np.int64(0)},
                       expect_context={"k": K})
    assert np.array_equal(np.asarray(state["rows"]), rows)
    assert int(state["reads"]) == 7 and int(state["offset"]) == 1234
    # and the file itself is what the JAX package writes
    jfile = tmp_path / "jax.ckpt.npz"
    jckpt.save(jfile, {"rows": jnp.asarray(rows), "reads": np.int64(7),
                       "offset": np.int64(1234)}, context={"k": K})
    meta = [np.load(p)["__meta__"].tobytes() for p in (ckpt, jfile)]
    assert meta[0] == meta[1]


@pytest.mark.parametrize("like", [
    {"rows": torch.zeros((2, 16), dtype=torch.int32)},
    {"rows": torch.zeros((1, 8), dtype=torch.int32), "reads": np.int64(0),
     "offset": np.int64(0)},
])
def test_checkpoint_rejects_other_structure(tmp_path, like):
    p = tmp_path / "c.npz"
    checkpoint.save(p, {"rows": torch.zeros((1, 16), dtype=torch.int32),
                        "reads": np.int64(0), "offset": np.int64(0)})
    with pytest.raises(ValueError):
        checkpoint.load(p, like)


def test_checkpoint_fn_name_guard(tmp_path, monkeypatch):
    p = tmp_path / "c.npz"
    sk = cms.CountMinSketch.zeros(2, 10, CPU)
    checkpoint.save(p, sk)
    assert torch.equal(checkpoint.load(p, sk).rows, sk.rows)
    monkeypatch.setattr(checkpoint, "NTHASH_FN_NAME", "ntHash_v999")
    with pytest.raises(ValueError, match="hash function"):
        checkpoint.load(p, sk)


def test_checkpoint_leaf_paths_match_jax(tmp_path):
    """Structures beyond count_file's dict flatten in JAX's order."""
    state = {"b": (np.arange(3), [np.ones(2)]),
             "a": jcms.CountMinSketch(np.zeros((1, 4), np.int32))}
    p = tmp_path / "tree.npz"
    checkpoint.save(p, state)
    back = jckpt.load(p, state)
    assert np.array_equal(back["b"][0], np.arange(3))
    assert np.array_equal(np.asarray(back["a"].rows), np.zeros((1, 4)))


def test_from_numpy_roundtrip(rng):
    jrows = jcms.CountMinSketch.zeros(H, WL).rows.at[1, 7].add(3)
    sk = cms.CountMinSketch.from_numpy(np.asarray(jrows), CPU)
    assert sk.rows.dtype == torch.int32 and sk.width == 1 << WL
    assert np.array_equal(sk.to_numpy(), np.asarray(jrows))
    with pytest.raises(TypeError):
        cms.CountMinSketch.from_numpy(np.zeros((2, 8), np.int64), CPU)


def test_wide_widths_raise(rng):
    """Widths 2**19..2**30 are counted (directly, at every width); a width
    outside [2**10, 2**30] raises ValueError everywhere."""
    pipe = ReadHashingPipeline(PipelineConfig(), device=CPU)  # default 2**20
    assert pipe.sketch.width == 1 << 20
    for wl in range(19, 31):
        cms.check_width(wl)
    for wl in (9, 31):
        with pytest.raises(ValueError):
            cms.check_width(wl)
        with pytest.raises(ValueError):
            ReadHashingPipeline(_cfg(sketch_width_log2=wl), device=CPU)
    tm = prepare_codes(torch.zeros((2, 20), dtype=torch.uint8))
    with pytest.raises(ValueError):
        fused_count_step(tm, cms.CountMinSketch.zeros(2, 9, CPU), 5)
    res = hash_kmers(torch.zeros((2, 20), dtype=torch.uint8), 5, 2)
    with pytest.raises(ValueError):
        cms.update(cms.CountMinSketch.zeros(2, 9, CPU), res.hashes,
                   res.valid, 9)


@pytest.mark.parametrize("wl", range(19, 31))
def test_wide_widths_count(rng, wl):
    """fused_count_step at every width the JAX package partitions, one row
    (4 GiB at 2**30), against the JAX engine's buckets, compared sparsely."""
    codes = rng.integers(0, 5, size=(6, 60), dtype=np.uint8)
    sk = cms.CountMinSketch.zeros(1, wl, CPU)
    fused_count_step(prepare_codes(torch.from_numpy(codes)), sk, 7)
    res = kmer_jnp.hash_kmers(jnp.asarray(codes), 7, 1)
    lo = np.asarray(res.hashes.lo)[..., 0].astype(np.int64)
    vals = (lo & ((1 << wl) - 1))[np.asarray(res.valid)]
    pos, cnt = np.unique(vals, return_counts=True)
    row = sk.rows[0]
    assert torch.equal(row[torch.from_numpy(pos)],
                       torch.from_numpy(cnt.astype(np.int32)))
    assert int(row.sum(dtype=torch.int64)) == len(vals)


@pytest.mark.parametrize("wl", [20, 22])
def test_partitioned_update_vs_jax_scatter(rng, wl):
    """update and update_from_buckets at widths the JAX package partitions
    equal its scatter ingestion (its partitioned route in interpret mode is
    far too slow at the planned chunk size)."""
    codes = rng.integers(0, 5, size=(6, 60), dtype=np.uint8)
    want = _jax_reference_rows(codes, K, H, wl)
    res = hash_kmers(torch.from_numpy(codes), K, H)
    sk = cms.update(cms.CountMinSketch.zeros(H, wl, CPU), res.hashes,
                    res.valid, wl)
    assert np.array_equal(sk.to_numpy(), want)
    hashes = [res.hashes[..., r].T for r in range(H)]
    valid = res.valid.T
    sk2 = cms.update_from_buckets(
        cms.CountMinSketch.zeros(H, wl, CPU),
        [torch.where(valid, cms.buckets(h, wl), 1 << wl) for h in hashes],
        emitted_width_log2=wl)
    assert np.array_equal(sk2.to_numpy(), want)


@pytest.mark.parametrize("wl", [19, 20])
def test_wide_sketch_vs_jax(rng, wl):
    """fused_count_step and update at the widths the JAX package partitions
    (2**19 up): the port counts them directly, into the same sketch."""
    codes = rng.integers(0, 5, size=(6, 60), dtype=np.uint8)
    want = _jax_reference_rows(codes, K, H, wl)
    sk = cms.CountMinSketch.zeros(H, wl, CPU)
    fused_count_step(prepare_codes(torch.from_numpy(codes)), sk, K)
    assert np.array_equal(sk.to_numpy(), want)
    res = hash_kmers(torch.from_numpy(codes), K, H)
    sk2 = cms.update(cms.CountMinSketch.zeros(H, wl, CPU), res.hashes,
                     res.valid, wl)
    assert np.array_equal(sk2.to_numpy(), want)


def test_sketch_routes_by_width(monkeypatch):
    """Both entry points count through the row histogram at every width:
    no partitioned route on the sketch's path."""
    seen = []

    def record(idx, weight, wl, **kw):
        seen.append((tuple(idx.shape), weight is not None, wl))

    monkeypatch.setattr(cms, "histogram_rows", record)
    hashes = torch.zeros((5, 2), dtype=torch.int64)
    valid = torch.ones(5, dtype=torch.bool)
    buckets = list(torch.zeros((2, 3, 4), dtype=torch.int32).unbind(0))
    widths = (10, 14, 18, 19, 20, 30)
    for wl in widths:  # stand-in rows: only the shape counts
        rows = torch.zeros(1, dtype=torch.int32).expand(2, 1 << wl)
        cms.update(cms.CountMinSketch(rows), hashes, valid, wl)
        cms.update_from_buckets(cms.CountMinSketch(rows), buckets,
                                emitted_width_log2=wl)
    assert seen == [x for wl in widths
                    for x in (((2, 5), True, wl), ((2, 12), False, wl))]


def test_update_from_buckets_one_launch_over_views(monkeypatch):
    """The hash kernel's rows (views of one output) take one histogram
    launch through a view of it; separate tensors one launch each."""
    seen = []
    real = cms.histogram_rows

    def record(idx, weight, wl, **kw):
        seen.append((tuple(idx.shape), idx.data_ptr()))
        return real(idx, weight, wl, **kw)

    monkeypatch.setattr(cms, "histogram_rows", record)
    out = torch.randint(0, (1 << WL) + 1, (H, 5, 7), dtype=torch.int32)
    sk = cms.update_from_buckets(cms.CountMinSketch.zeros(H, WL, CPU),
                                 list(out.unbind(0)))
    assert seen == [((H, 35), out.data_ptr())]
    sk2 = cms.update_from_buckets(cms.CountMinSketch.zeros(H, WL, CPU),
                                  [b.clone() for b in out.unbind(0)])
    assert [shape for shape, _ in seen[1:]] == [(1, 35)] * H
    assert torch.equal(sk.rows, sk2.rows)
    for r in range(H):
        assert torch.equal(sk.rows[r], histogram_rows_plain(
            out[r].reshape(1, -1), None, WL)[0])


def test_count_file_2_20_vs_jax_run_file(fastq):
    path, n, L = fastq
    cfg = _cfg(sketch_width_log2=20)
    pipe = ReadHashingPipeline(cfg, device=CPU)
    assert pipe.count_file(path, batch_size=128) == n
    jp = _jax_pipe(sketch_width_log2=20)
    jtotal = jp.run_file(path, batch_size=128, read_length=L)
    assert np.array_equal(pipe.sketch.to_numpy(), np.asarray(jp.sketch.rows))
    assert int(pipe.sketch.rows[0].sum()) == jtotal
    # fused_count_step batch by batch builds the same sketch
    sk = cms.CountMinSketch.zeros(H, 20, CPU)
    for batch, _ in stream_code_batches(path, 128, L):
        fused_count_step(prepare_codes(torch.from_numpy(batch)), sk, K)
    assert torch.equal(sk.rows, pipe.sketch.rows)


@pytest.mark.parametrize("cfg,err", [
    (dict(n_devices=2), ValueError),
    (dict(n_devices=4), ValueError),
    (dict(engine="pallas"), ValueError),
    (dict(engine="torch"), ValueError),
])
def test_unported_options_raise(cfg, err):
    """Without a process group the world is one device: n_devices other
    than 1 raises (tests/test_torch_parallel.py runs 2 and 4 ranks)."""
    with pytest.raises(err):
        ReadHashingPipeline(_cfg(**cfg), device=CPU)


@pytest.mark.parametrize("n_devices", [None, 1])
def test_one_device_needs_no_group(fastq, n_devices):
    """n_devices None or 1 with no process group: no mesh, no group
    formed, and the one-device sketch."""
    import torch.distributed as dist

    path, n, _ = fastq
    pipe = ReadHashingPipeline(_cfg(n_devices=n_devices), device=CPU)
    assert pipe.mesh is None and pipe.n_devices == 1
    assert pipe.count_file(path, batch_size=128) == n
    assert not dist.is_initialized()
    ref = ReadHashingPipeline(_cfg(), device=CPU)
    ref.count_file(path, batch_size=128)
    assert torch.equal(pipe.sketch.rows, ref.sketch.rows)


def test_pack_h2d_counts_as_unpacked(fastq):
    """PipelineConfig(pack_h2d=True) runs: the packed wire format builds the
    unpacked route's sketch, the JAX run_file's."""
    path, n, L = fastq
    pipe = ReadHashingPipeline(_cfg(pack_h2d=True), device=CPU)
    assert pipe.count_file(path, batch_size=128) == n
    jp = _jax_pipe()
    jp.run_file(path, batch_size=128, read_length=L)
    assert np.array_equal(pipe.sketch.to_numpy(), np.asarray(jp.sketch.rows))


def test_parallel_parse_raises(fastq, monkeypatch):
    """threads > 1 needs the native parser: without it both entry points
    raise the JAX package's RuntimeError, never parsing serially instead."""
    path, *_ = fastq
    from nthash_tpu.io import native_loader as jnl
    from nthash_tpu_torch.io import native_loader as nl

    monkeypatch.setattr(nl, "available", lambda: False)
    monkeypatch.setattr(jnl, "available", lambda: False)
    pipe = ReadHashingPipeline(_cfg(), device=CPU)
    for run in (pipe.count_file, pipe.run_file, _jax_pipe().run_file):
        with pytest.raises(RuntimeError, match="native parser"):
            run(path, threads=2)
    assert not pipe.sketch.rows.any()


@needs_native
@pytest.mark.parametrize("threads", [2, 3])
def test_run_file_threads_matches_jax(fastq, threads):
    """run_file and count_file over byte-range shards: the JAX run_file's
    sketch and total at the same thread count."""
    path, n, L = fastq
    jp = _jax_pipe()
    jtotal = jp.run_file(path, batch_size=64, read_length=L, threads=threads)
    pipe = ReadHashingPipeline(_cfg(), device=CPU)
    assert pipe.run_file(path, batch_size=64, threads=threads) == jtotal
    assert np.array_equal(pipe.sketch.to_numpy(), np.asarray(jp.sketch.rows))
    fused = ReadHashingPipeline(_cfg(), device=CPU)
    assert fused.count_file(path, batch_size=64, threads=threads) == n
    assert torch.equal(fused.sketch.rows, pipe.sketch.rows)


@pytest.mark.parametrize("threads", [2, 4])
def test_checkpoint_with_threads_raises_as_jax(fastq, tmp_path, threads):
    """Checkpointing with a parallel parse raises the reference's
    ValueError before anything is parsed or written."""
    path, *_ = fastq
    ckpt = tmp_path / "c.npz"
    with pytest.raises(ValueError) as want:
        _jax_pipe().count_file(path, checkpoint_path=ckpt, threads=threads)
    pipe = ReadHashingPipeline(_cfg(), device=CPU)
    with pytest.raises(ValueError) as got:
        pipe.count_file(path, checkpoint_path=ckpt, threads=threads)
    assert str(got.value) == str(want.value)
    assert not ckpt.exists()
