"""The host screening cell: its entries in ``BENCHMARK.json`` (added at the
ends of their lists), its configuration's sizing, its reference's block
build and sector count, the kernel lists its roofline readers hold the
program's spans to, and a program without the wide routes failing at once.
The small cell's sound, control, fault and traced runs are the
``ONE_CARD`` cases of ``test_portbench_faults.py`` and
``test_portbench_spans.py``."""

import copy
import math

import pytest
import torch

from portbench.core import harness, nthash_ref, reads, spec
from portbench.reference import host_screen
from portbench.tests.small import small
from portbench.tests.test_portbench_new_structure import grown

CELL = "host_screen_short_resident"
CONFIG = "grch38_screen_seeds_k32"
READERS = ("wide_seed_hash_roofline.resident", "wide_probe_roofline.resident")
SHARED = ("resident_bases_per_s", "device_idle_share.resident",
          "host_ms_per_batch.resident", "idle_in_program_share.resident",
          "span_window_idle_share.resident")


def without_the_cell(bench: dict) -> dict:
    """``bench`` with the host screening entries taken out."""
    out = copy.deepcopy(bench)
    out["configs"] = [c for c in out["configs"] if c["name"] != CONFIG]
    out["workloads"] = [w for w in out["workloads"] if w["name"] != CELL]
    out["per_layer"] = [m for m in out["per_layer"]
                        if m["name"] not in READERS]
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    return out


def test_entries_only_added():
    """Taken out again, the cell's entries leave a benchmark that the
    present one only grows (new items at the ends of lists), and they are
    the configuration, the cell, the two readers and the cell's name in
    the five shared resident metrics."""
    bench = spec.benchmark()
    before = without_the_cell(bench)
    assert grown(before, bench)
    assert len(bench["configs"]) == len(before["configs"]) + 1
    assert len(bench["workloads"]) == len(before["workloads"]) + 1
    assert [m["name"] for m in bench["per_layer"][-2:]] == list(READERS)
    listing = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
               if CELL in m.get("workloads", ())}
    assert listing == set(SHARED) | set(READERS)
    cell = spec.cell(CELL)
    assert cell.chips == 1 and cell.structure == "host_screen"


def test_sizing():
    """BioBloomMaker's rule at FPR 0.0075 asks for ~1.26e11 bits; 2^37
    gives 0.0083 at h = 4, 2^38 would meet 0.0075; the seeds and h are the
    E. coli screen's."""
    cfg = spec.cell(CELL).config
    ecoli = spec.cell("screen_short_resident").config
    assert cfg["seeds"] == ecoli["seeds"] and cfg["k"] == ecoli["k"]
    assert cfg["num_hashes"] == ecoli["num_hashes"] == 4
    assert cfg["guarantees"] == ecoli["guarantees"]
    n = len(cfg["seeds"]) * (cfg["genome_length"] - cfg["k"] + 1)
    assert n == 4 * 3_088_286_370
    m = -n * math.log(0.0075) / math.log(2) ** 2
    assert 1.25e11 < m < 1.27e11 and 2**36 < m < 2**37

    def fpr(width_log2):
        return (1 - math.exp(-cfg["num_hashes"] * n / 2**width_log2)) ** 4

    assert 0.0075 < fpr(cfg["width_log2"]) < 0.0084 and fpr(38) < 0.0075
    assert set(cfg["reduced"]) == {"reads"}


def test_readers_name_the_cells_layers():
    readers = [spec.module("metrics", m["name"])
               for m in spec.cell(CELL).per_layer]
    got = {r.SPAN: r.KERNELS for r in readers
           if hasattr(r, "SPAN") and hasattr(r, "KERNELS")}
    assert got == {
        "nthash.seed": ("seed_staged_wide_kernel", "seed_hash_wide_kernel"),
        "nthash.probe": ("bloom_probe_wide_kernel",)}


@pytest.mark.parametrize("name", READERS)
def test_readers_silent_elsewhere(name):
    """Outside the host screening structure each wide reader reads
    nothing, and the E. coli screen's kernels are not in its list."""
    from portbench.core.trace import Trace

    ctx = harness.Context(small("screen_short_resident"), 1,
                          torch.device("cpu"))
    ctx.trace = Trace(1.0, 1.0, {"void bloom_probe_kernel(int)": 1.0,
                                 "void seed_staged_kernel<true>(int)": 1.0})
    reader = spec.module("metrics", name)
    assert reader.read(ctx) is None
    assert ctx.trace.seconds_of(reader.KERNELS) == 0


def test_reference_sectors_and_filter():
    """The reference's filter of the small genome (2^31 bits) holds the
    bits of its buckets and no other: each touched word the sum of its
    distinct buckets' bits, every other word 0. Each batch's distinct
    sectors are counted once, and lie between a batch's words / 8 and its
    words."""
    cell = small(CELL)
    ctx = harness.Context(cell, 2**31 + 7, torch.device("cpu"))
    ctx.codes = reads.make_reads(ctx.config, ctx.seed, ctx.device)
    cfg = ctx.config
    genome, _ = reads.make_genome(cfg, ctx.seed, ctx.device)
    bk = host_screen._buckets(genome[None], cfg)
    key = torch.unique(bk[bk >= 0])
    assert int(key.max()) >= 1 << 30
    word, inv = torch.unique(nthash_ref.word_of(key), return_inverse=True)
    bits = torch.zeros_like(word).index_add_(
        0, inv, torch.ones_like(key) << ((key >> 7) & 31))
    want = torch.zeros((1 << cfg["width_log2"]) // 32, dtype=torch.int32)
    want[word] = (bits - ((bits >> 31) << 32)).to(torch.int32)
    assert torch.equal(host_screen.genome_words(ctx), want)
    del want
    sectors, words = 0, 0
    for batch in ctx.batches():
        b = host_screen._buckets(batch, cfg)
        w = torch.unique(nthash_ref.word_of(b[b >= 0]))
        sectors += torch.unique(w // host_screen.SECTOR_WORDS).numel()
        words += w.numel()
    assert host_screen.distinct_touched(ctx) == sectors
    assert words / host_screen.SECTOR_WORDS <= sectors <= words


def test_program_without_the_wide_routes_fails_at_once(monkeypatch):
    """A program without ``insert_sequence_seeds`` fails in the driver's
    first lines, before the genome is made or anything is built."""
    from nthash_tpu_torch.models import bloom

    def refused(*a, **k):
        raise AssertionError("the genome was made")

    monkeypatch.delattr(bloom, "insert_sequence_seeds")
    monkeypatch.setattr(reads, "make_genome", refused)
    ctx = harness.Context(small(CELL), 1, torch.device("cpu"))
    with pytest.raises(AttributeError, match="insert_sequence_seeds"):
        spec.module("drivers", "host_screen_resident").Driver(ctx)
