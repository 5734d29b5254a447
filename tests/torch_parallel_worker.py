"""One rank of a gloo group on the CPU (run by tests/test_torch_parallel.py).

Every rank reads the same inputs, joins the group through a FileStore (no
port), runs the port's distributed entry points on its share and writes
what it got to ``<out>.rank<r>.npz``; the test process holds the ranks'
results against the JAX package. Imports torch and the port only.

Usage: python torch_parallel_worker.py <rank> <world> <store> <inputs.npz>
       <out prefix> <work dir>
"""

import os
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def _raises(exc, fn, *args, **kwargs) -> bool:
    try:
        fn(*args, **kwargs)
    except exc:
        return True
    return False


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, inputs, out, work = sys.argv[3:7]
    work = Path(work)

    from nthash_tpu_torch.io.stream import pack_codes
    from nthash_tpu_torch.models import bloom
    from nthash_tpu_torch.models import sketch as cms
    from nthash_tpu_torch.models.pipeline import (
        PipelineConfig,
        ReadHashingPipeline,
    )
    from nthash_tpu_torch.ops.kmer_kernel import hash_kmers_tm, prepare_codes
    from nthash_tpu_torch.parallel import dp, mesh, sp

    cpu = torch.device("cpu")
    mesh.initialize_distributed(
        "cpu", store=dist.FileStore(store, world), rank=rank,
        world_size=world)
    mesh.initialize_distributed("cpu", rank=rank)   # a second call: no-op
    reads = mesh.device_mesh(device_type="cpu")
    seq_mesh = mesh.device_mesh(world, mesh.SEQ_AXIS, "cpu")
    inp = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
    got = {"world": np.int64(mesh.world_size()),
           "size_rank": np.array(mesh.size_and_rank(reads))}

    # dp.hash_and_sketch, both layouts, two steps into one sketch
    k, h, wl = (int(x) for x in inp["dp_khw"])
    for layout in ("tm", "bm"):
        sketch = cms.CountMinSketch.zeros(h, wl, cpu)
        for step in (0, 1):
            codes = dp.shard_reads(inp[f"dp_codes{step}"], reads)
            hashes, valid, out_sk = dp.hash_and_sketch(
                codes, sketch, k, h, wl, reads, "kernel",
                time_major=layout == "tm")
            assert out_sk is sketch
            if layout == "tm":
                hashes = torch.stack(hashes, dim=-1)     # [W, b, H]
            got[f"hs_{layout}{step}_hashes"] = hashes.numpy()
            got[f"hs_{layout}{step}_valid"] = valid.numpy()
            got[f"hs_{layout}{step}_rows"] = sketch.rows.numpy().copy()
    # the torch engine's first step
    _, _, sk = dp.hash_and_sketch(
        dp.shard_reads(inp["dp_codes0"], reads),
        cms.CountMinSketch.zeros(h, wl, cpu), k, h, wl, reads, "torch")
    got["hs_torch_rows"] = sk.rows.numpy()
    # rows near 2**31: the step's merge wraps as local_rows + psum does
    sk = cms.CountMinSketch(torch.full((h, 1 << wl), 2**31 - 1,
                                       dtype=torch.int32))
    dp.hash_and_sketch(dp.shard_reads(inp["dp_codes0"], reads), sk, k, h, wl,
                       reads, "kernel")
    got["hs_wrap_rows"] = sk.rows.numpy()
    # the all-reduce itself near 2**31: counts of 2**30 + rank on each rank
    counts = inp["wrap_counts"][rank].clone()
    base = cms.CountMinSketch(inp["wrap_base"].clone())
    got["merge_wrap_rows"] = dp._merge(base, counts, reads).rows.numpy()

    # dp.fused_count, twice, and dp.fused_count_packed of the same reads
    fk, fh, fwl = (int(x) for x in inp["fc_khw"])
    fcodes = inp["fc_codes"]
    sketch = cms.CountMinSketch.zeros(fh, fwl, cpu)
    dp.fused_count(dp.shard_reads(fcodes, reads), sketch, fk, reads)
    got["fc_rows1"] = sketch.rows.numpy().copy()
    dp.fused_count(dp.shard_reads(fcodes, reads), sketch, fk, reads)
    got["fc_rows2"] = sketch.rows.numpy().copy()
    packed, nmask = (torch.from_numpy(a) for a in pack_codes(fcodes.numpy()))
    sketch = cms.CountMinSketch.zeros(fh, fwl, cpu)
    dp.fused_count_packed(dp.shard_reads(packed, reads),
                          dp.shard_reads(nmask, reads), sketch, fk,
                          fcodes.shape[1], reads)
    got["fcp_rows"] = sketch.rows.numpy()
    got["shard_raises"] = np.bool_(_raises(
        ValueError, dp.shard_reads, fcodes[:world + 1], reads))

    # union_across: random words, and filters of each rank's reads
    words = inp["union_words"][rank]
    got["union_words"] = bloom.union_across(words, reads).numpy()
    got["union_words_group"] = bloom.union_across(
        words, mesh.group_of(reads)).numpy()
    bwl = int(inp["bloom_wl"])
    tm = prepare_codes(dp.shard_reads(fcodes, reads))
    bf = bloom.BloomFilter.zeros(bwl, cpu)
    bloom.insert_from_buckets(bf, hash_kmers_tm(tm, fk, fh,
                                                emit_buckets=bwl))
    got["union_filter"] = bloom.union_across(bf.words, reads).numpy()

    # sp: the halo exchange at prime lengths, padded
    for name, seeds in (("sp_kmer", None), ("sp_seed", ("110011", "101101"))):
        seq = inp[f"{name}_seq"]
        sk_, sh, tile = (int(x) for x in inp[f"{name}_kht"])
        chunk = sp.shard_sequence(seq, seq_mesh, k=sk_, tile=tile)
        got[f"{name}_chunk"] = chunk.numpy()
        for engine in ("kernel", "torch"):
            if seeds is None:
                hashes, valid = sp.hash_long_sequence(
                    chunk, sk_, sh, seq_mesh, engine=engine, tile=tile,
                    n_devices=world)
            else:
                hashes, valid = sp.hash_long_sequence_seeds(
                    chunk, seeds, sh, seq_mesh, engine=engine, tile=tile)
            got[f"{name}_{engine}_hashes"] = torch.stack(hashes, -1).numpy()
            got[f"{name}_{engine}_valid"] = valid.numpy()
    got["sp_raises"] = np.bool_(
        _raises(ValueError, sp.shard_sequence, inp["sp_kmer_seq"][:1009],
                seq_mesh)
        and _raises(ValueError, sp.hash_long_sequence, chunk, 9, 1,
                    seq_mesh, n_devices=1))

    # the pipeline: n_devices = the world size; step, run_file, count_file
    # with a checkpoint, and a resume from a run that stopped after two
    # batches
    path = work / "reads.fq"
    kw = {k: int(v) for k, v in zip(("k", "num_hashes", "sketch_width_log2"),
                                     inp["pipe_khw"])}
    got["pipe_raises"] = np.bool_(_raises(
        ValueError, ReadHashingPipeline,
        PipelineConfig(**kw, n_devices=2 * world), device=cpu))
    pipe = ReadHashingPipeline(PipelineConfig(**kw, n_devices=world),
                               device=cpu)
    got["pipe_n_devices"] = np.int64(pipe.n_devices)
    hashes, valid = pipe.step(inp["dp_codes0"].numpy())
    got["step_hashes"] = torch.stack(hashes, -1).numpy()
    got["step_valid"] = valid.numpy()
    got["step_rows"] = pipe.sketch.rows.numpy().copy()
    pipe = ReadHashingPipeline(PipelineConfig(**kw), device=cpu)
    got["run_total"] = np.int64(pipe.run_file(path, batch_size=63))
    got["run_rows"] = pipe.sketch.rows.numpy()
    ckpt = work / f"full{world}.ckpt.npz"
    pipe = ReadHashingPipeline(PipelineConfig(**kw), device=cpu)
    got["count_reads"] = np.int64(pipe.count_file(
        path, batch_size=63, checkpoint_path=ckpt, checkpoint_every=1))
    got["count_rows"] = pipe.sketch.rows.numpy()
    resumed = work / f"resumed{world}.ckpt.npz"
    if rank == 0:
        shutil.copy(work / "crashed.ckpt.npz", resumed)
    dist.barrier()
    pipe = ReadHashingPipeline(PipelineConfig(**kw), device=cpu)
    got["resume_reads"] = np.int64(pipe.count_file(
        path, batch_size=64, checkpoint_path=resumed))
    got["resume_rows"] = pipe.sketch.rows.numpy()

    np.savez(f"{out}.rank{rank}.npz", **got)
    dist.destroy_process_group()
    print(f"RANK_OK {rank}/{world} pid {os.getpid()}", flush=True)


if __name__ == "__main__":
    main()
