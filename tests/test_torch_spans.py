"""The port's spans (``utils/profiling.span``) on the CPU: nothing made
while no profiler runs, each layer's span where its work happens, the
stream's spans of one batch sharing its number, and the CLI's trace."""

import json
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nthash_tpu_torch.__main__ import main
from nthash_tpu_torch.models import bloom
from nthash_tpu_torch.models import sketch as cms
from nthash_tpu_torch.models.pipeline import (
    PipelineConfig,
    ReadHashingPipeline,
    fused_count_step,
)
from nthash_tpu_torch.ops import seed_kernel
from nthash_tpu_torch.ops.kmer_kernel import hash_kmers_tm_auto, prepare_codes
from nthash_tpu_torch.parallel import dp
from nthash_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]

#: Every span the port records, by name without its batch number.
SPANS = {"nthash.hash", "nthash.histogram", "nthash.bloom", "nthash.bin",
         "nthash.ranges", "nthash.parse", "nthash.pinned.wait",
         "nthash.stream.wait", "nthash.copy", "nthash.step",
         "nthash.allreduce", "nthash.checkpoint", "nthash.seed",
         "nthash.probe", "nthash.build"}


def spans_of(fn, *args, **kwargs):
    """The names of the ``nthash.`` rows recorded over ``fn(*args)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args, **kwargs)
    return [e.name for e in prof.events() if e.name.startswith("nthash.")]


def batches(n, reads=16, length=40, seed=7):
    rng = np.random.default_rng(seed)
    return [prepare_codes(torch.from_numpy(
        rng.integers(0, 5, (reads, length), dtype=np.uint8)))
        for _ in range(n)]


def write_fastq(path, reads=10, length=40, seed=3):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(reads):
            seq = "".join(rng.choice(list("ACGT"), length))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * length}\n")
    return path


class Unprintable:
    def __format__(self, spec):
        raise AssertionError("a span's name was built")

    __str__ = __repr__ = __format__


def test_span_off_is_the_shared_nullcontext():
    off = profiling.span("nthash.step", Unprintable(), shard=Unprintable())
    assert off is profiling._OFF is profiling.span("nthash.hash")
    with off as got:
        assert got is None


@pytest.mark.parametrize("n,shard,name", [
    (None, None, "nthash.step"), (3, None, "nthash.step#3"),
    (3, 1, "nthash.step#1.3")])
def test_span_names_under_profiler(n, shard, name):
    def opened():
        with profiling.span("nthash.step", n, shard):
            pass
    assert spans_of(opened) == [name]


def test_layers_make_no_record_function_without_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    (tm,) = batches(1)
    sketch = cms.CountMinSketch.zeros(2, 10, "cpu")
    fused_count_step(tm, sketch, 8)
    bf = bloom.BloomFilter.zeros(14, device="cpu")
    bloom.insert_from_buckets(bf, hash_kmers_tm_auto(tm, 8, 2,
                                                     emit_buckets=14))
    assert int(sketch.rows.sum()) > 0 and int(bf.words.ne(0).sum()) > 0


@pytest.mark.parametrize("n", [1, 3])
def test_fused_count_step_spans_a_batch(n):
    """One ``nthash.hash`` a batch; the CPU route's planes are separate
    tensors, so one ``nthash.histogram`` a row (the card's are views of
    one output and take one: ``test_torch_cuda.py``)."""
    rows = 2
    sketch = cms.CountMinSketch.zeros(rows, 10, "cpu")

    def steps():
        for tm in batches(n):
            fused_count_step(tm, sketch, 8)
    names = spans_of(steps)
    assert names.count("nthash.hash") == n
    assert names.count("nthash.histogram") == n * rows
    assert set(names) == {"nthash.hash", "nthash.histogram"}


def test_insert_from_buckets_records_bloom():
    (tm,) = batches(1)
    buckets = hash_kmers_tm_auto(tm, 8, 3, emit_buckets=14)
    bf = bloom.BloomFilter.zeros(14, device="cpu")
    names = spans_of(bloom.insert_from_buckets, bf, buckets,
                     emitted_width_log2=14)
    assert names == ["nthash.bloom"] * 3


SEEDS = ("110111011", "101111101")


def screening_filter():
    """A filter of 2**12 bits holding one batch's spaced-seed windows."""
    bf = bloom.BloomFilter.zeros(12, device="cpu")
    (tm,) = batches(1)
    return bloom.insert_from_buckets(
        bf, seed_kernel.hash_seeds_tm_auto(tm, SEEDS, 2, emit_buckets=12))


@pytest.mark.parametrize("n", [1, 3])
def test_screen_reads_spans_a_batch(n):
    """One ``nthash.seed`` (the seed kernel) and one ``nthash.probe`` a
    batch, nothing else."""
    bf = screening_filter()

    def screen():
        for tm in batches(n):
            bloom.screen_reads(bf, tm, SEEDS, 2)
    names = spans_of(screen)
    assert names.count("nthash.seed") == n
    assert names.count("nthash.probe") == n
    assert len(names) == 2 * n


@pytest.mark.parametrize("route", ["hash_seeds_tm", "hash_seeds_tm_long",
                                   "hash_seeds_sequence"])
def test_seed_wrappers_record_seed(route):
    (tm,) = batches(1)
    arg = tm[:, 0] if route == "hash_seeds_sequence" else tm
    assert spans_of(getattr(seed_kernel, route), arg, SEEDS) == \
        ["nthash.seed"]


def test_screen_reads_records_nothing_without_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) while off")

    bf = screening_filter()
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    (tm,) = batches(1)
    assert int(bloom.screen_reads(bf, tm, SEEDS, 2).sum()) > 0


def test_worker_thread_span_in_trace(tmp_path):
    def work():
        with profiling.span("nthash.parse", 5, shard=2):
            torch.arange(10).sum()

    with profiling.trace(tmp_path / "tr"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    (out,) = (tmp_path / "tr").glob("trace.*.json")
    ev = [e for e in json.loads(out.read_text())["traceEvents"]
          if e.get("name") == "nthash.parse#2.5"]
    assert len(ev) == 1 and ev[0]["tid"] != threading.get_native_id()


def trace_spans(directory):
    """tid -> [(name, start, end)] of the ``nthash.`` rows of the one
    Chrome trace in ``directory``."""
    (out,) = Path(directory).glob("trace.*.json")
    by_tid: dict = {}
    for e in json.loads(out.read_text())["traceEvents"]:
        if e.get("ph") == "X" and str(e.get("name")).startswith("nthash."):
            by_tid.setdefault(e["tid"], []).append(
                (e["name"], e["ts"], e["ts"] + e["dur"]))
    return by_tid


def by_number(rows, name):
    """{n: (start, end)} of the rows ``name#n``."""
    pat = re.compile(re.escape(name) + r"#(\d+)$")
    return {int(m.group(1)): (s, e) for r, s, e in rows
            if (m := pat.match(r))}


def inside(row, outer) -> bool:
    return any(s <= row[1] and row[2] <= e for s, e in outer)


@pytest.mark.parametrize("fused", [True, False], ids=["count_file",
                                                      "run_file"])
def test_cli_trace_holds_the_stream_spans(tmp_path, capsys, fused):
    """``count --trace``: the parse on a thread of its own, the consumer's
    wait, copy and step on another, the layers inside each step; with one
    parse thread the parse of batch n and its step share n, and the parse
    ends before the step starts."""
    fq = write_fastq(tmp_path / "r.fq")
    argv = ["count", str(fq), "-k", "8", "-n", "2", "--width-log2", "10",
            "--batch-size", "4", "--device", "cpu",
            "--trace", str(tmp_path / "tr")] + (["--fused"] if fused else [])
    assert main(argv) == 0
    capsys.readouterr()
    by_tid = trace_spans(tmp_path / "tr")
    (parser,) = [t for t, rows in by_tid.items()
                 if any(r[0].startswith("nthash.parse#") for r in rows)]
    (consumer,) = [t for t in by_tid if t != parser]
    rows = by_tid[consumer]
    steps = by_number(rows, "nthash.step")
    parses = by_number(by_tid[parser], "nthash.parse")
    assert sorted(steps) == [0, 1, 2]           # 10 reads in batches of 4
    assert sorted(parses) == [0, 1, 2, 3]       # and the parse finding EOF
    assert sorted(by_number(rows, "nthash.copy")) == [0, 1, 2]
    assert sorted(by_number(rows, "nthash.stream.wait")) == [0, 1, 2, 3]
    for n, (s, _) in steps.items():
        assert parses[n][1] <= s
    layers = [r for r in rows if r[0] in ("nthash.hash", "nthash.histogram")]
    assert {r[0] for r in layers} == {"nthash.hash", "nthash.histogram"}
    assert all(inside(r, steps.values()) for r in layers)
    assert sum(r[0] == "nthash.hash" for r in layers) == 3


def test_parallel_parse_numbers_each_shard(tmp_path):
    fq = write_fastq(tmp_path / "r.fq", reads=40)
    pipe = ReadHashingPipeline(PipelineConfig(k=8, num_hashes=2,
                                              sketch_width_log2=10), "cpu")
    with profiling.trace(tmp_path / "tr"):
        assert pipe.count_file(fq, batch_size=4, threads=2) == 40
    names = {r[0] for rows in trace_spans(tmp_path / "tr").values()
             for r in rows if r[0].startswith("nthash.parse#")}
    shards = {tuple(map(int, n.split("#")[1].split("."))) for n in names}
    assert {s for s, _ in shards} == {0, 1}


def test_count_file_checkpoint_spans(tmp_path):
    fq = write_fastq(tmp_path / "r.fq")
    pipe = ReadHashingPipeline(PipelineConfig(k=8, num_hashes=2,
                                              sketch_width_log2=10), "cpu")
    names = spans_of(pipe.count_file, fq, batch_size=4,
                     checkpoint_path=tmp_path / "ck", checkpoint_every=1)
    # one a batch, and the last written again at the end
    assert names.count("nthash.checkpoint") == 4


def test_merge_over_a_mesh_records_allreduce():
    import torch.distributed as dist

    from nthash_tpu_torch.parallel import mesh

    (tm,) = batches(1)
    codes = tm.T.to(torch.uint8).contiguous()
    try:
        m = mesh.device_mesh(device_type="cpu")
        sketch = cms.CountMinSketch.zeros(2, 10, "cpu")
        names = spans_of(dp.fused_count, codes, sketch, 8, m)
    finally:
        dist.destroy_process_group()
    assert names.count("nthash.allreduce") == 1
    assert names.index("nthash.hash") < names.index("nthash.allreduce")


def span_names(package: Path) -> set[str]:
    """The string literals starting ``nthash.`` in the sources under
    ``package``: the names its code gives ``span``, ``numbered`` or
    ``record_function``."""
    pat = re.compile(r"[\"'](nthash\.[a-z_.]+)[\"']")
    return {m.group(1) for p in package.rglob("*.py")
            for m in pat.finditer(p.read_text())}


def test_every_span_at_its_boundary_and_no_other():
    assert span_names(ROOT / "nthash_tpu_torch") == SPANS
    assert span_names(ROOT / "nthash_tpu") == set()


def test_insert_sequence_seeds_records_build(monkeypatch):
    """One ``nthash.build`` over the whole call, each chunk's seed hash and
    insertion inside it."""
    (tm,) = batches(1)
    genome = tm.T.reshape(-1)
    bf = bloom.BloomFilter.zeros(12, device="cpu")
    # chunks of one row: 2 seeds x 2 int32 buckets of its 256 windows
    monkeypatch.setattr(bloom, "BUILD_CHUNK_BYTES", 4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bloom.insert_sequence_seeds(bf, genome, SEEDS, 2)
    rows = {n: [(e.time_range.start, e.time_range.end)
                for e in prof.events() if e.name == n]
            for n in ("nthash.build", "nthash.seed", "nthash.bloom")}
    (s, t), = rows["nthash.build"]
    chunks = -(-(genome.numel() - len(SEEDS[0]) + 1) // 256)
    assert len(rows["nthash.seed"]) == chunks
    # the CPU route's planes are tensors of their own: an insertion each
    assert len(rows["nthash.bloom"]) == chunks * len(SEEDS) * 2
    assert all(s <= a and b <= t for n in ("nthash.seed", "nthash.bloom")
               for a, b in rows[n])
