"""The port's multi-GPU paths on the CPU: gloo groups of 2 and 4 ranks
against the JAX package's 4- and 8-device CPU meshes, exactly.

Each group runs as separate processes (``tests/torch_parallel_worker.py``)
joined through a FileStore in a temporary directory, so no port is taken.
Both groups start once, together, and run every case; the JAX references
are computed here meanwhile. A rank returns its own share (its block of
reads, its chunk of the sequence) and the merged sketch or filter; the
shares, put back together, must equal the JAX package's global arrays.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from nthash_tpu.models import bloom as jbloom
from nthash_tpu.models import pipeline as jpipe
from nthash_tpu.models import sketch as jcms
from nthash_tpu.parallel import dp as jdp
from nthash_tpu.parallel import sp as jsp
from nthash_tpu.parallel.mesh import READS_AXIS, SEQ_AXIS, device_mesh
from nthash_tpu.utils import checkpoint as jckpt
from nthash_tpu_torch.io import native_loader
from nthash_tpu_torch.io.stream import stream_code_batches
from nthash_tpu_torch.models import bloom
from nthash_tpu_torch.models import sketch as cms
from nthash_tpu_torch.models.pipeline import fused_count_step
from nthash_tpu_torch.ops.kmer_kernel import hash_kmers_tm, prepare_codes
from nthash_tpu_torch.parallel import dp, mesh
from nthash_tpu_torch.utils import checkpoint

WORKER = Path(__file__).with_name("torch_parallel_worker.py")
ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
DP_KHW = (7, 3, 10)
FC_KHW = (5, 2, 10)
PIPE_KHW = (9, 3, 12)
BLOOM_WL = 12
SEEDS = ("110011", "101101")
N_READS, READ_LEN = 300, 40
U64 = np.uint64


def _inputs(rng):
    return {
        "dp_khw": np.array(DP_KHW), "fc_khw": np.array(FC_KHW),
        "pipe_khw": np.array(PIPE_KHW), "bloom_wl": np.array(BLOOM_WL),
        "dp_codes0": rng.integers(0, 5, size=(16, 40), dtype=np.uint8),
        "dp_codes1": rng.integers(0, 5, size=(16, 40), dtype=np.uint8),
        "fc_codes": rng.integers(0, 5, size=(8, 20), dtype=np.uint8),
        "wrap_counts": (2**30 + np.arange(4, dtype=np.int32)[:, None, None]
                        * np.ones((1, 2, 16), np.int32)).astype(np.int32),
        "wrap_base": np.full((2, 16), 2**31 - 10, np.int32),
        "union_words": rng.integers(-2**31, 2**31, size=(4, 256),
                                    dtype=np.int64).astype(np.int32),
        "sp_kmer_seq": rng.integers(0, 5, size=1009, dtype=np.uint8),
        "sp_kmer_kht": np.array((9, 2, 16)),
        "sp_seed_seq": rng.integers(0, 5, size=131, dtype=np.uint8),
        "sp_seed_kht": np.array((6, 2, 8)),
    }


def _write_fastq(path, rng):
    seqs = np.frombuffer(b"ACGTN", np.uint8)[
        rng.integers(0, 5, size=(N_READS, READ_LEN))]
    with open(path, "wb") as f:
        for i in range(N_READS):
            f.write(b"@r%d\n" % i + seqs[i].tobytes() + b"\n+\n"
                    + b"I" * READ_LEN + b"\n")


def _crashed_checkpoint(path, ckpt):
    """The checkpoint of a one-device run stopped after two batches of 64."""
    k, h, wl = PIPE_KHW
    sk = cms.CountMinSketch.zeros(h, wl, "cpu")
    reads = offset = 0
    for i, (batch, m, off) in enumerate(
            stream_code_batches(path, 64, READ_LEN, with_offsets=True)):
        if i == 2:
            break
        fused_count_step(prepare_codes(torch.from_numpy(batch)), sk, k)
        reads, offset = reads + m, off
    checkpoint.save(ckpt, {"rows": sk.rows, "reads": np.int64(reads),
                           "offset": np.int64(offset)}, context={
        "input": f"{path.name}:{path.stat().st_size}", "batch_size": 64,
        "k": k, "num_hashes": h, "sketch_width_log2": wl})


def _launch(world, work, inputs):
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    store = work / f"store{world}"
    return [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), str(store),
         str(inputs), str(work / f"out{world}"), str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env=env) for r in range(world)]


def _jax_refs(inp, path):
    """Every JAX reference, on 2-, 4- and 8-device CPU meshes."""
    refs = {}
    k, h, wl = DP_KHW
    m8 = device_mesh(8)
    for tm in (True, False):
        sk = jcms.CountMinSketch.zeros(h, wl)
        for step in (0, 1):
            codes = jdp.shard_reads(jnp.asarray(inp[f"dp_codes{step}"]), m8)
            hashes, valid, sk = jdp.hash_and_sketch(
                codes, sk, k, h, wl, m8, "jnp", time_major=tm)
            hashes = (np.stack([x.to_np() for x in hashes], -1) if tm
                      else hashes.to_np())
            lay = "tm" if tm else "bm"
            refs[f"hs_{lay}{step}"] = (hashes, np.asarray(valid),
                                       np.asarray(sk.rows))
    full = jcms.CountMinSketch(jnp.full((h, 1 << wl), 2**31 - 1, jnp.int32))
    refs["hs_wrap_rows"] = np.asarray(jdp.hash_and_sketch(
        jdp.shard_reads(jnp.asarray(inp["dp_codes0"]), m8), full, k, h, wl,
        m8, "jnp")[2].rows)
    for world in WORLDS:
        mw = device_mesh(world)
        refs[f"psum{world}"] = np.asarray(shard_map(
            lambda c, r: r + jax.lax.psum(c[0], READS_AXIS), mesh=mw,
            in_specs=(P(READS_AXIS), P()), out_specs=P(), check_vma=False)(
            jnp.asarray(inp["wrap_counts"][:world]),
            jnp.asarray(inp["wrap_base"])))
        words = jnp.asarray(inp["union_words"][:world].view(np.uint32))
        refs[f"union{world}"] = np.asarray(shard_map(
            lambda w: jbloom.union_across(w, READS_AXIS), mesh=mw,
            in_specs=(P(READS_AXIS),), out_specs=P(), check_vma=False)(
            words))[0]
    # fused counting: the Pallas kernels in interpret mode, two steps
    fk, fh, fwl = FC_KHW
    codes = jdp.shard_reads(jnp.asarray(inp["fc_codes"]), m8)
    sk = jcms.CountMinSketch.zeros(fh, fwl)
    for step in (1, 2):
        sk = jdp.fused_count(codes, sk, fk, m8, interpret=True)
        refs[f"fc_rows{step}"] = np.asarray(sk.rows)
    # the sequence, a prime length padded, on 8 and 4 devices
    for name, seeds, nd in (("sp_kmer", None, 8), ("sp_seed", SEEDS, 4)):
        sk_, sh, tile = (int(x) for x in inp[f"{name}_kht"])
        ms = device_mesh(nd, SEQ_AXIS)
        codes = jsp.shard_sequence(jnp.asarray(inp[f"{name}_seq"]), ms,
                                   k=sk_, tile=tile)
        if seeds is None:
            res, valid = jsp.hash_long_sequence(codes, sk_, sh, ms,
                                                engine="jnp", tile=tile)
        else:
            res, valid = jsp.hash_long_sequence_seeds(
                codes, seeds, sh, ms, engine="jnp", tile=tile)
        refs[name] = (np.asarray(codes), np.stack([r.to_np() for r in res],
                                                  -1), np.asarray(valid))
    # the pipeline's run_file on 8 devices (the sketch count_file builds)
    pk, ph, pwl = PIPE_KHW
    jp = jpipe.ReadHashingPipeline(jpipe.PipelineConfig(
        k=pk, num_hashes=ph, sketch_width_log2=pwl, n_devices=8))
    refs["run_total"] = jp.run_file(path, batch_size=63, read_length=READ_LEN)
    refs["run_rows"] = np.asarray(jp.sketch.rows)
    jp = jpipe.ReadHashingPipeline(jpipe.PipelineConfig(
        k=pk, num_hashes=ph, sketch_width_log2=pwl, n_devices=8))
    hashes, valid = jp.step(inp["dp_codes0"])
    refs["step"] = (np.stack([x.to_np() for x in hashes], -1),
                    np.asarray(valid), np.asarray(jp.sketch.rows))
    return refs


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups' per-rank results and the JAX references."""
    work = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(20)
    inp = _inputs(rng)
    inputs = work / "inputs.npz"
    np.savez(inputs, **inp)
    path = work / "reads.fq"
    _write_fastq(path, rng)
    assert native_loader.available()   # built once, before the ranks start
    _crashed_checkpoint(path, work / "crashed.ckpt.npz")
    procs = {world: _launch(world, work, inputs) for world in WORLDS}
    try:
        refs = _jax_refs(inp, path)
        outs = {world: [p.communicate(timeout=300)[0] for p in ps]
                for world, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
    for world, ps in procs.items():
        for r, (p, out) in enumerate(zip(ps, outs[world])):
            assert p.returncode == 0 and f"RANK_OK {r}/{world}" in out, out
    got = {world: [dict(np.load(work / f"out{world}.rank{r}.npz"))
                   for r in range(world)] for world in WORLDS}
    return {"inp": inp, "refs": refs, "got": got, "work": work,
            "path": path}


def _u64(a):
    return np.ascontiguousarray(a).view(U64)


def _cat(ranks, key, axis):
    return np.concatenate([g[key] for g in ranks], axis=axis)


@pytest.mark.parametrize("world", WORLDS)
def test_group_shape(groups, world):
    for r, g in enumerate(groups["got"][world]):
        assert int(g["world"]) == world == int(g["pipe_n_devices"])
        assert g["size_rank"].tolist() == [world, r]


@pytest.mark.parametrize("layout", ["tm", "bm"])
@pytest.mark.parametrize("world", WORLDS)
def test_hash_and_sketch_vs_jax(groups, world, layout):
    """Each rank's block of hashes and validity, put back together, and
    the merged sketch after each of two steps, on every rank."""
    ranks = groups["got"][world]
    axis = 1 if layout == "tm" else 0
    for step in (0, 1):
        hashes, valid, rows = groups["refs"][f"hs_{layout}{step}"]
        key = f"hs_{layout}{step}"
        assert np.array_equal(_u64(_cat(ranks, f"{key}_hashes", axis)),
                              hashes)
        assert np.array_equal(_cat(ranks, f"{key}_valid", axis), valid)
        for g in ranks:
            assert np.array_equal(g[f"{key}_rows"], rows)
    for g in ranks:
        assert np.array_equal(g["hs_torch_rows"],
                              groups["refs"]["hs_tm0"][2])


@pytest.mark.parametrize("world", WORLDS)
def test_second_step_adds_once(groups, world):
    """The merge adds each batch's all-reduced counts from a zeroed
    buffer: a second step adds its batch once and leaves the first
    batch's counts as they were (reducing the rows themselves would
    multiply them by the world size)."""
    _, _, rows0 = groups["refs"]["hs_tm0"]
    one = groups["refs"]["hs_tm1"][2] - rows0     # batch 1 alone
    assert one.sum() > 0
    for g in groups["got"][world]:
        assert np.array_equal(g["hs_tm1_rows"], rows0 + one)
        assert np.array_equal(g["fc_rows2"], 2 * g["fc_rows1"])


@pytest.mark.parametrize("world", WORLDS)
def test_merge_wraps_as_psum(groups, world):
    """int32 sums wrap, in the all-reduce (counts of 2**30 + rank) and in
    the add to rows near 2**31, as psum and the JAX step's add do."""
    inp = groups["inp"]
    want = groups["refs"][f"psum{world}"]
    counts = inp["wrap_counts"][:world]
    with np.errstate(over="ignore"):
        host = inp["wrap_base"] + counts.sum(axis=0, dtype=np.int32)
    exact = inp["wrap_base"].astype(np.int64) + counts.sum(axis=0,
                                                            dtype=np.int64)
    assert np.array_equal(want, host) and (want != exact).all()
    for g in groups["got"][world]:
        assert np.array_equal(g["merge_wrap_rows"], want)
        assert np.array_equal(g["hs_wrap_rows"], groups["refs"]["hs_wrap_rows"])
        assert (g["hs_wrap_rows"] < 0).any()


@pytest.mark.parametrize("world", WORLDS)
def test_fused_count_vs_jax(groups, world):
    """dp.fused_count twice and dp.fused_count_packed once against the JAX
    fused_count (Pallas interpret mode) on 8 devices."""
    refs = groups["refs"]
    for g in groups["got"][world]:
        assert np.array_equal(g["fc_rows1"], refs["fc_rows1"])
        assert np.array_equal(g["fc_rows2"], refs["fc_rows2"])
        assert np.array_equal(g["fcp_rows"], refs["fc_rows1"])
        assert bool(g["shard_raises"])


def test_shard_reads_raises_as_jax():
    m8 = device_mesh(8)
    with pytest.raises(ValueError):
        jdp.shard_reads(jnp.zeros((9, 4), jnp.uint8), m8)
    assert dp.shard_reads(torch.zeros(9, 4), None).shape == (9, 4)


@pytest.mark.parametrize("world", WORLDS)
def test_union_across_vs_jax(groups, world):
    """union_across over a DeviceMesh and over its group against the JAX
    union_across on a mesh of as many devices; the union of filters of
    each rank's reads is the one-device filter of all the reads."""
    want = groups["refs"][f"union{world}"]
    fk, fh, _ = FC_KHW
    tm = prepare_codes(torch.from_numpy(groups["inp"]["fc_codes"]))
    bf = bloom.BloomFilter.zeros(BLOOM_WL, "cpu")
    bloom.insert_from_buckets(bf, hash_kmers_tm(tm, fk, fh,
                                                emit_buckets=BLOOM_WL))
    for g in groups["got"][world]:
        assert np.array_equal(g["union_words"].view(np.uint32), want)
        assert np.array_equal(g["union_words_group"].view(np.uint32), want)
        assert np.array_equal(g["union_filter"], bf.words.numpy())


@pytest.mark.parametrize("engine", ["kernel", "torch"])
@pytest.mark.parametrize("name", ["sp_kmer", "sp_seed"])
@pytest.mark.parametrize("world", WORLDS)
def test_hash_long_sequence_vs_jax(groups, world, name, engine):
    """A prime length padded to each mesh's quantum: the ranks' chunks and
    windows, put back together, against the JAX package's; the windows
    past the sequence are invalid on both."""
    ranks = groups["got"][world]
    codes, hashes, valid = groups["refs"][name]
    chunks = _cat(ranks, f"{name}_chunk", 0)
    got_h = _u64(_cat(ranks, f"{name}_{engine}_hashes", 0))
    got_v = _cat(ranks, f"{name}_{engine}_valid", 0)
    n = min(len(chunks), len(codes))
    assert len(chunks) % (world * int(groups["inp"][f"{name}_kht"][2])) == 0
    assert np.array_equal(chunks[:n], codes[:n])
    assert (chunks[n:] == 4).all() and (codes[n:] == 4).all()
    assert np.array_equal(got_h[:n], hashes[:n])
    assert np.array_equal(got_v[:n], valid[:n])
    k = int(groups["inp"][f"{name}_kht"][0])
    w = len(groups["inp"][f"{name}_seq"]) - k + 1
    assert got_v[:w].any() and not got_v[w:].any() and not valid[w:].any()
    for g in ranks:
        assert bool(g["sp_raises"])


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_step_and_run_file_vs_jax(groups, world):
    """ReadHashingPipeline with n_devices = the world size: step returns
    this rank's block of the JAX step's time-major hashes and merges the
    sketch; run_file returns the whole file's total. An n_devices other
    than the world size raises."""
    ranks = groups["got"][world]
    hashes, valid, rows = groups["refs"]["step"]
    assert np.array_equal(_u64(_cat(ranks, "step_hashes", 1)), hashes)
    assert np.array_equal(_cat(ranks, "step_valid", 1), valid)
    for g in ranks:
        assert g["step_hashes"].shape[1] == 16 // world
        assert np.array_equal(g["step_rows"], rows)
        assert int(g["run_total"]) == groups["refs"]["run_total"]
        assert np.array_equal(g["run_rows"], groups["refs"]["run_rows"])
        assert bool(g["pipe_raises"])


@pytest.mark.parametrize("world", WORLDS)
def test_count_file_checkpoint_resume_vs_jax(groups, world):
    """count_file at n_devices = the world size with a checkpoint every
    batch (rank 0 writes it), and a resume from a one-device run that
    stopped after two batches: both sketches are the JAX run_file's on 8
    devices, and the JAX package reads the final checkpoints."""
    work, path = groups["work"], groups["path"]
    want = groups["refs"]["run_rows"]
    for g in groups["got"][world]:
        assert int(g["count_reads"]) == N_READS == int(g["resume_reads"])
        assert np.array_equal(g["count_rows"], want)
        assert np.array_equal(g["resume_rows"], want)
    like = {"rows": jnp.zeros_like(want), "reads": np.int64(0),
            "offset": np.int64(0)}
    for name, batch in ((f"full{world}", 64), (f"resumed{world}", 64)):
        state = jckpt.load(work / f"{name}.ckpt.npz", like, expect_context={
            "input": f"{path.name}:{path.stat().st_size}",
            "batch_size": batch, "k": PIPE_KHW[0],
            "num_hashes": PIPE_KHW[1], "sketch_width_log2": PIPE_KHW[2]})
        assert np.array_equal(np.asarray(state["rows"]), want)
        assert int(state["reads"]) == N_READS
        assert int(state["offset"]) == path.stat().st_size


def test_no_group_is_one_device():
    """Without a process group: world size 1, a mesh of any other size
    raises, and NCCL asked for in a build without it raises instead of
    falling back to gloo."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert mesh.world_size() == 1
    with pytest.raises(ValueError, match="n_devices=2"):
        mesh.device_mesh(2, device_type="cpu")
    if not dist.is_nccl_available():
        with pytest.raises(RuntimeError, match="nccl"):
            mesh.initialize_distributed("cpu", backend="nccl",
                                        store=dist.HashStore(), rank=0,
                                        world_size=1)
    assert not dist.is_initialized()


def test_device_mesh_forms_a_world_of_one():
    import torch.distributed as dist

    try:
        m = mesh.device_mesh(device_type="cpu")
        assert dist.get_backend() == "gloo"
        assert mesh.size_and_rank(m) == (1, 0)
        assert mesh.device_mesh(1, mesh.SEQ_AXIS, "cpu").mesh_dim_names == (
            mesh.SEQ_AXIS,)
        words = torch.tensor([5, -1, 0], dtype=torch.int32)
        assert torch.equal(bloom.union_across(words, m), words)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("local_rank,rank,want", [
    (None, 0, 0), (None, 5, 1), ("3", 0, 3), ("6", 1, 2)])
def test_rank_device(monkeypatch, local_rank, rank, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert mesh.rank_device("cuda", rank) == torch.device("cuda", want)
    assert mesh.rank_device("cuda:1", rank) == torch.device("cuda", 1)
    assert mesh.rank_device("cpu", rank) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.rank_device("cuda", rank)


def test_resolve_engine_is_shared():
    from nthash_tpu_torch.parallel import sp

    assert sp.resolve_engine is dp.resolve_engine
    assert dp.resolve_engine("auto", "cpu") == "torch"
    assert dp.resolve_engine("auto", torch.device("cuda", 0)) == "kernel"
    with pytest.raises(ValueError, match="unknown engine"):
        dp.resolve_engine("jnp")
