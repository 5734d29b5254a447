"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips (in a fixture, never at import)
where there is no GPU. Run them on a machine with one (``--noconftest``:
the suite's conftest imports JAX, which that machine need not have):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

The default paths also run here at their full launch shapes (1M reads in
batches of 2**18, filters of 2**30 bits, 2**20 walks), and so do the widths
and sizes past 2**31 entries where the CPU tests cannot go.
"""

import functools
import re
import subprocess

import numpy as np
import pytest
import torch

from nthash_tpu_torch.models import bloom
from nthash_tpu_torch.models import sketch as cms
from nthash_tpu_torch.models.pipeline import (
    PipelineConfig,
    ReadHashingPipeline,
    fused_count_step,
)
from nthash_tpu_torch.io.stream import pack_codes, packed_shapes
from nthash_tpu_torch.ops import (
    cuda_build,
    hist_kernel,
    kmer_kernel,
    kmer_torch,
    probe_kernel,
    seed_kernel,
    unpack_kernel,
)
from nthash_tpu_torch.ops import part_kernel as pk
from nthash_tpu_torch.ops.hist_kernel import histogram_rows, histogram_rows_plain
from nthash_tpu_torch.ops.kmer_kernel import (
    hash_kmers_tm,
    hash_kmers_tm_plain,
    prepare_codes,
)
from nthash_tpu_torch.parallel import sp
from nthash_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _codes(rng, b=777, length=150):
    codes = rng.integers(0, 6, size=(b, length), dtype=np.uint8)
    return torch.from_numpy(codes)


@functools.lru_cache(maxsize=1)
def _reads(n, length):
    """uint8 [n, length] codes of random reads with ~1% N, kept for the
    next test of the same shape (the full-size tests share 1M reads)."""
    rng = np.random.default_rng(n + length)
    codes = rng.integers(0, 4, size=(n, length), dtype=np.uint8)
    codes[rng.random((n, length)) < 0.01] = 4
    return codes


#: Kernels that must not spill registers to local memory, by compile unit:
#: every instance of the spaced-seed and partition kernels, the one-sequence
#: entries and the binning pass's scatter (``bin.cuh``).
NO_SPILL = {"kmer_hash": r"_sequence_kernel", "seed_hash": r"_kernel",
            "partition": r"_kernel", "histogram": r"^bin_scatter_kernel",
            "bloom": r"^bin_scatter_kernel"}
#: The kernel a ptxas line names, out of its mangled name.
PTXAS_KERNEL = re.compile(
    r"Function properties for _Z\w*?\d+([a-z][a-z_]*_kernel)")


@pytest.mark.parametrize("source", sorted(NO_SPILL))
def test_no_register_spills(tmp_path, cuda, source):
    """ptxas's report of a fresh build of ``csrc/<source>.cu`` with the
    package's flags: no instance of the kernels ``NO_SPILL`` names spills."""
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
         str(tmp_path / f"lib{source}.so"),
         str(cuda_build.CSRC_DIR / f"{source}.cu")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    kernel, checked, spills = None, set(), []
    for line in proc.stderr.splitlines():
        m = PTXAS_KERNEL.search(line)
        if "Function properties for" in line:
            kernel = m.group(1) if m else None
        elif kernel and re.search(NO_SPILL[source], kernel) \
                and "spill" in line:
            checked.add(kernel)
            if re.search(r"[1-9]\d* bytes spill", line):
                spills.append(f"{kernel}: {line.strip()}")
    assert checked and not spills, (sorted(checked), spills)


@pytest.mark.parametrize("mode", [{}, {"emit_fwd_rev": True},
                                  {"emit_buckets": 14}, {"emit_buckets": 1}])
@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("k", [1, 5, 32, 33, 65, 100, 150])
def test_kmer_kernel_vs_plain(rng, cuda, k, h, mode):
    tm = prepare_codes(_codes(rng).to(cuda))
    before = kmer_kernel.LAUNCHES
    got = hash_kmers_tm(tm, k, h, **mode)
    assert kmer_kernel.LAUNCHES == before + 1
    want = hash_kmers_tm_plain(tm, k, h, **mode)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and torch.equal(g, w)
    # and the CPU plain path agrees with the card
    cpu = hash_kmers_tm(tm.cpu(), k, h, **mode)
    for g, c in zip(got, cpu):
        assert torch.equal(g.cpu(), c)


def _same(got, want):
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("mode", [{}, {"emit_fwd_rev": True},
                                  {"emit_buckets": 14}])
@pytest.mark.parametrize("reads,length,k,tile", [
    (777, 1000, 32, None), (1, 3000, 32, 64), (33, 40, 5, 10),
    (64, 32, 32, 32), (5, 300, 1, 7), (3, 70, 5, 5000)])
def test_kmer_long_kernel_vs_plain(rng, cuda, reads, length, k, tile, mode):
    tm = prepare_codes(_codes(rng, reads, length).to(cuda))
    before = (kmer_kernel.LAUNCHES, kmer_kernel.LONG_LAUNCHES)
    got = kmer_kernel.hash_kmers_tm_long(tm, k, 3, time_tile=tile, **mode)
    assert (kmer_kernel.LAUNCHES, kmer_kernel.LONG_LAUNCHES) == \
        (before[0], before[1] + 1)
    _same(got, kmer_kernel.hash_kmers_tm_long_plain(tm, k, 3, time_tile=tile,
                                                    **mode))
    _same(got, hash_kmers_tm(tm, k, 3, **mode))


@pytest.mark.parametrize("mode", [{}, {"emit_fwd_rev": True},
                                  {"emit_buckets": 12}])
@pytest.mark.parametrize("seeds", [("10101", "11011"), ("1",), ("00100",),
                                   ("0110", "1001", "1111"),
                                   ("110100110011001011",
                                    "111111000000111111")])
@pytest.mark.parametrize("reads,length", [(777, 150), (1, 400), (33, 18)])
def test_seed_kernels_vs_plain(rng, cuda, seeds, reads, length, mode):
    k = len(seeds[0])
    tm = prepare_codes(_codes(rng, reads, length).to(cuda))
    want = seed_kernel.hash_seeds_tm_plain(tm, seeds, 3, **mode)
    before = (seed_kernel.LAUNCHES, seed_kernel.LONG_LAUNCHES)
    _same(seed_kernel.hash_seeds_tm(tm, seeds, 3, **mode), want)
    for tile in (k, 3 * k, 1000 * k):
        _same(seed_kernel.hash_seeds_tm_long(tm, seeds, 3, time_tile=tile,
                                             **mode), want)
    assert (seed_kernel.LAUNCHES, seed_kernel.LONG_LAUNCHES) == \
        (before[0] + 1, before[1] + 3)


def test_auto_routes_on_card(rng, cuda):
    short = prepare_codes(_codes(rng, 500, 150).to(cuda))
    long = prepare_codes(_codes(rng, 500, 2000).to(cuda))
    before = (kmer_kernel.LAUNCHES, kmer_kernel.LONG_LAUNCHES)
    _same(kmer_kernel.hash_kmers_tm_auto(short, 32, 2),
          hash_kmers_tm_plain(short, 32, 2))
    _same(kmer_kernel.hash_kmers_tm_auto(long, 32, 2, emit_buckets=20),
          kmer_kernel.hash_kmers_tm_long_plain(long, 32, 2, emit_buckets=20))
    assert (kmer_kernel.LAUNCHES, kmer_kernel.LONG_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)


def test_kernels_refuse_bad_inputs(cuda):
    tm = torch.zeros((40, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kmer_kernel.hash_kmers_tm_long(tm.long(), 5, 1)
    with pytest.raises(ValueError, match="contiguous"):
        seed_kernel.hash_seeds_tm(torch.zeros((3, 40), dtype=torch.int32,
                                              device=cuda).T, ("101",))
    with pytest.raises(ValueError, match="multiple of k"):
        seed_kernel.hash_seeds_tm_long(tm, ("10101",), time_tile=7)
    with pytest.raises(ValueError, match="no care positions"):
        seed_kernel.hash_seeds_tm(tm, ("000",))
    # tables beyond the 227 KB of shared memory a block may use
    many = ("10" * 1500,)
    with pytest.raises(ValueError, match="shared memory"):
        seed_kernel.hash_seeds_tm(torch.zeros((3000, 3), dtype=torch.int32,
                                              device=cuda), many)


def test_seed18_goldens_on_card(cuda):
    from nthash_tpu_torch.constants import encode_ascii
    from nthash_tpu_torch.u64 import to_numpy_u64

    seq = ("GATTACAGATTACACCTTGGAACCNGGTTCCAAGGTTCCAAGG"
           "ACGTACGTACGTAGCTAGCTAGCTAGGCCATGCATGG")
    seeds = ("110100110011001011", "111111000000111111")
    codes = torch.from_numpy(np.tile(encode_ascii(seq), (2, 1))).to(cuda)
    hashes, _ = seed_kernel.hash_seeds_batch(codes, seeds, 2)
    assert list(to_numpy_u64(hashes)[1, 0]) == [
        0x598ABFC133B99142, 0xC1ABAFAF1EADE78F, 0xE895A7F010ED432F,
        0xD20AF1F39F107A60]


def test_sp_on_card_vs_cpu(rng, cuda):
    seq = torch.from_numpy(rng.integers(0, 5, size=100_003, dtype=np.uint8))
    for run in (lambda x: sp.hash_long_sequence(sp.shard_sequence(x, k=32),
                                                32, 2),
                lambda x: sp.hash_long_sequence_seeds(
                    sp.shard_sequence(x, k=5), ("10101", "11011"), 1)):
        got, valid = run(seq.to(cuda))
        want, wvalid = run(seq)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        assert torch.equal(valid.cpu(), wvalid)


def test_count_file_long_reads_cuda_vs_cpu(tmp_path, rng, cuda):
    path = tmp_path / "long.fq"
    seqs = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, size=(40, 3000))]
    with open(path, "wb") as f:
        for s in seqs:
            f.write(b"@r\n" + s.tobytes() + b"\n+\n" + b"I" * 3000 + b"\n")
    gpu = ReadHashingPipeline(PipelineConfig(), device=cuda)
    cpu = ReadHashingPipeline(PipelineConfig(), device="cpu")
    before = kmer_kernel.LONG_LAUNCHES
    assert gpu.count_file(path, batch_size=16, read_length=3000) == 40
    assert kmer_kernel.LONG_LAUNCHES == before + 3
    assert cpu.count_file(path, batch_size=16, read_length=3000) == 40
    assert torch.equal(gpu.sketch.rows.cpu(), cpu.sketch.rows)


@pytest.mark.parametrize("weights", ["per_row", "shared", "none"])
@pytest.mark.parametrize("wl", [10, 14, 18, 26])
def test_histogram_kernel_vs_plain(rng, cuda, wl, weights):
    n, width = 300_001, 1 << wl
    idx = rng.integers(-2, width + 2, size=(3, n)).astype(np.int32)
    w = rng.integers(-(2**31), 2**31, size=(3, n), dtype=np.int64)
    w = torch.from_numpy(w.astype(np.int32)).to(cuda)
    weight = {"per_row": w, "shared": w[1], "none": None}[weights]
    idx = torch.from_numpy(idx).to(cuda)
    before = hist_kernel.LAUNCHES
    got = histogram_rows(idx, weight, wl)
    assert hist_kernel.LAUNCHES == before + 1
    want = histogram_rows_plain(idx, weight, wl)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_histogram_kernel_2_30(rng, cuda):
    """The widest row, which the partitioned path's skew fallback counts
    into (one row of 4 GiB)."""
    idx = rng.integers(-2, (1 << 30) + 2, size=(1, 300_001)).astype(np.int32)
    idx = torch.from_numpy(idx).to(cuda)
    got = histogram_rows(idx, None, 30)
    want = histogram_rows_plain(idx, None, 30)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_histogram_gate_and_out(rng, cuda):
    idx = torch.from_numpy(rng.integers(0, 1 << 12, size=(2, 5000))
                           .astype(np.int32)).to(cuda)
    want = histogram_rows_plain(idx, None, 12)
    out = torch.ones((2, 1 << 12), dtype=torch.int32, device=cuda)
    for g in (0, 1):
        gate = torch.full((1,), g, dtype=torch.int32, device=cuda)
        got = histogram_rows(idx, None, 12, gate=gate, out=out.clone())
        assert torch.equal(got, out + g * want)
        plain = histogram_rows_plain(idx, None, 12, gate=gate, out=out.clone())
        assert torch.equal(plain, got)


def _hist_by_route(route, idx, weight, wl, gate=None, out=None):
    """The histogram kernel on validated idx [R, N] with its route forced
    (None: by shape)."""
    return hist_kernel._launch(idx, weight, wl, gate, out, route=route)


@pytest.mark.parametrize("route", ["private", "direct", None])
@pytest.mark.parametrize("weights", ["per_row", "shared", "none"])
@pytest.mark.parametrize("wl", [10, 11, 12, 13, 14, 15])
def test_histogram_routes_vs_plain(rng, cuda, wl, weights, route):
    """Each route with full-range weights (per row, shared, none), -1 and
    out-of-range indices, a closed and an open gate, an ``out`` that
    accumulates, odd N and rows that start off a 16-byte boundary."""
    n, width = 300_001, 1 << wl
    idx = torch.from_numpy(rng.integers(-2, width + 2, size=(3, n))
                           .astype(np.int32)).to(cuda)
    w = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(3, n),
                                      dtype=np.int64).astype(np.int32)).to(cuda)
    weight = {"per_row": w, "shared": w[1], "none": None}[weights]
    base = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(3, width),
                                         dtype=np.int64).astype(np.int32)).to(cuda)
    before = dict(hist_kernel.ROUTE_LAUNCHES)
    for g in (0, 1):
        gate = torch.full((1,), g, dtype=torch.int32, device=cuda)
        got = _hist_by_route(route, idx, weight, wl, gate, base.clone())
        want = histogram_rows_plain(idx, weight, wl, gate=gate,
                                    out=base.clone())
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    taken = "private" if route == "private" or (
        route is None and hist_kernel.private_counts_grid(3, n, wl)[0]) \
        else "direct"
    assert hist_kernel.ROUTE_LAUNCHES[taken] == before[taken] + 2
    # unaligned rows: row r starts at r * (n - 1) ints, the weights too
    sub = idx[:, 1:]
    wsub = None if weight is None else weight[..., 1:]
    got = _hist_by_route(route, sub.contiguous(), wsub if wsub is None
                         else wsub.contiguous(), wl)
    assert torch.equal(got, histogram_rows_plain(sub, wsub, wl))


def test_histogram_private_route_refuses_wide_rows(cuda):
    idx = torch.zeros((1, 1 << 20), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        _hist_by_route("private", idx, None, 16)


def test_no_partition_launch_on_default_paths(tmp_path, rng, cuda):
    """count_file at PipelineConfig() (2**20) and the Bloom step at 2**20
    launch the hash and histogram / presence-word kernels, and no partition
    kernel and no ``bloom_words_rows``."""
    path = tmp_path / "reads.fq"
    seqs = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, size=(900, 80))]
    with open(path, "wb") as f:
        for s in seqs:
            f.write(b"@r\n" + s.tobytes() + b"\n+\n" + b"I" * 80 + b"\n")
    parts = dict(pk.LAUNCHES)
    hist = hist_kernel.LAUNCHES
    bloom_before = dict(hist_kernel.BLOOM_LAUNCHES)
    pipe = ReadHashingPipeline(PipelineConfig(), device=cuda)
    assert pipe.count_file(path, batch_size=256) == 900
    assert hist_kernel.LAUNCHES == hist + 4  # one a batch
    tm = prepare_codes(_codes(rng, 3000).to(cuda))
    bf = bloom.insert_from_buckets(
        bloom.BloomFilter.zeros(20),
        kmer_kernel.hash_kmers_tm_auto(tm, 32, 4, emit_buckets=20),
        emitted_width_log2=20)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == parts
    assert hist_kernel.BLOOM_LAUNCHES["bloom_words_rows"] == \
        bloom_before["bloom_words_rows"]
    assert hist_kernel.BLOOM_LAUNCHES["bloom_words"] == \
        bloom_before["bloom_words"] + 1
    cpu = bloom.insert_from_buckets(
        bloom.BloomFilter.zeros(20, device="cpu"),
        hash_kmers_tm(tm.cpu(), 32, 4, emit_buckets=20))
    assert torch.equal(bf.words.cpu(), cpu.words)


def _chunks(rng, wl, rows=2, g=8, skew=False):
    p_log2, sub_log2, chunk_rows, cap = pk.plan(wl)
    n = rows * g * chunk_rows * 128
    if skew:
        idx = np.full(n, 77, np.int32)
    else:
        idx = rng.integers(0, (1 << wl) + 1, size=n, dtype=np.int32)
    x = torch.from_numpy(idx.reshape(rows, g, chunk_rows, 128))
    return x, p_log2, sub_log2, cap


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("wl", [19, 20, 22, 28, 30])
def test_partition_kernels_vs_plain(rng, cuda, wl, skew):
    x, p_log2, sub_log2, cap = _chunks(rng, wl, g=2 if wl >= 28 else 8,
                                      skew=skew)
    xd = x.to(cuda)
    before = dict(pk.LAUNCHES)
    srt, fb = pk.sort_chunks(xd, sub_log2, p_log2)
    over = pk.check_overflow(fb, p_log2, srt, sub_log2, cap)
    wins = pk.partition_windows(srt, fb, p_log2, sub_log2, cap_rows=cap)
    psrt, pfb = pk.sort_chunks_plain(xd, sub_log2, p_log2)
    pover = pk.check_overflow_plain(pfb, p_log2, psrt, sub_log2, cap)
    pwins = pk.partition_windows_plain(psrt, pfb, p_log2, sub_log2,
                                       cap_rows=cap)
    torch.cuda.synchronize()
    assert torch.equal(srt, psrt) and torch.equal(fb, pfb)
    assert bool(over) == bool(pover) == skew
    assert torch.equal(wins, pwins)
    assert pk.LAUNCHES["sort_tiles"] == before["sort_tiles"] + 1
    assert pk.LAUNCHES["windows"] == before["windows"] + 1
    merges = pk.LAUNCHES["merge_phase"] - before["merge_phase"]
    assert merges == max(0, (x.shape[2] * 128).bit_length() - 16)


@pytest.mark.parametrize("wl", [19, 20, 22, 26, 30])
def test_partitioned_histogram_vs_plain(rng, cuda, wl):
    width = 1 << wl
    rows = 1 if wl == 30 else 4     # a row at 2**30 is 4 GiB of counters
    idx = rng.integers(0, width, size=(rows, 1 << 20)).astype(np.int32)
    idx[:, rng.random(1 << 20) < 0.01] = -1
    idx[:, rng.random(1 << 20) < 0.01] = width
    idx = torch.from_numpy(idx).to(cuda)
    got = pk.partitioned_histogram_rows(idx, wl)
    want = histogram_rows_plain(idx, None, wl)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_partitioned_histogram_skew_gated_fallback(rng, cuda):
    """An all-identical stream overflows every window: the flag gates the
    windows' histogram off and the full-width one on, on the device."""
    idx = torch.full((1, 1 << 20), 12345, dtype=torch.int32, device=cuda)
    before = hist_kernel.LAUNCHES
    got = pk.partitioned_histogram_rows(idx, 20)
    assert hist_kernel.LAUNCHES == before + 2  # both launched, one counts
    torch.cuda.synchronize()
    assert int(got[0, 12345]) == 1 << 20 and int(got.sum()) == 1 << 20


def test_mostly_sentinel_stream_does_not_overflow(rng, cuda):
    x = torch.full((1, 1 << 16), 1 << 20, dtype=torch.int32)
    x[0, :130] = torch.from_numpy(rng.integers(0, 1 << 20, size=130,
                                               dtype=np.int32))
    p_log2, sub_log2, rows, cap = pk.plan(20)
    chunks = pk._pad_chunks(x.to(cuda), 1 << 20, rows * 128)
    srt, fb = pk.sort_chunks(chunks, sub_log2, p_log2)
    assert not bool(pk.check_overflow(fb, p_log2, srt, sub_log2, cap))


def test_fused_count_step_2_20_cuda_vs_cpu(rng, cuda):
    codes = _codes(rng, 3000)
    sk_gpu = cms.CountMinSketch.zeros(4, 20, cuda)
    sk_cpu = cms.CountMinSketch.zeros(4, 20, "cpu")
    fused_count_step(prepare_codes(codes.to(cuda)), sk_gpu, 32)
    fused_count_step(prepare_codes(codes), sk_cpu, 32)
    assert torch.equal(sk_gpu.rows.cpu(), sk_cpu.rows)


def test_fused_count_step_cuda_vs_cpu(rng, cuda):
    codes = _codes(rng, 3000)
    sk_gpu = cms.CountMinSketch.zeros(4, 14, cuda)
    sk_cpu = cms.CountMinSketch.zeros(4, 14, "cpu")
    fused_count_step(prepare_codes(codes.to(cuda)), sk_gpu, 32)
    fused_count_step(prepare_codes(codes), sk_cpu, 32)
    assert torch.equal(sk_gpu.rows.cpu(), sk_cpu.rows)


def test_count_file_cuda_vs_cpu(tmp_path, rng, cuda):
    path = tmp_path / "reads.fq"
    seqs = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, size=(900, 80))]
    with open(path, "wb") as f:
        for s in seqs:
            f.write(b"@r\n" + s.tobytes() + b"\n+\n" + b"I" * 80 + b"\n")
    for cfg in (PipelineConfig(k=21, num_hashes=3, sketch_width_log2=12),
                PipelineConfig()):
        gpu = ReadHashingPipeline(cfg, device=cuda)
        cpu = ReadHashingPipeline(cfg, device="cpu")
        assert gpu.count_file(path, batch_size=256) == 900
        assert cpu.count_file(path, batch_size=256) == 900
        assert torch.equal(gpu.sketch.rows.cpu(), cpu.sketch.rows)


def _plain_count(codes, wl, cuda, batch=1 << 14):
    """The plain hash -> count of ``codes`` at k=32, 4 hashes, 2**wl (int64),
    and the valid windows a row."""
    want = torch.zeros((4, 1 << wl), dtype=torch.int64, device=cuda)
    valid = 0
    for s in range(0, codes.shape[0], batch):
        tm = prepare_codes(torch.from_numpy(codes[s:s + batch]).to(cuda))
        for r, b in enumerate(hash_kmers_tm_plain(tm, 32, 4, emit_buckets=wl)):
            want[r] += histogram_rows_plain(b.reshape(1, -1), None, wl)[0]
        valid += int(kmer_torch.window_valid_tm(tm, 32).sum())
    return want, valid


def _counters():
    """Every launch counter the default paths move, copied."""
    return {"A1": kmer_kernel.LAUNCHES, "B2": kmer_kernel.LONG_LAUNCHES,
            "A2": hist_kernel.LAUNCHES,
            "route": dict(hist_kernel.ROUTE_LAUNCHES),
            "bin": dict(hist_kernel.BIN_LAUNCHES),
            "range": dict(hist_kernel.RANGE_LAUNCHES),
            "body": dict(hist_kernel.SCATTER_ROUTE_LAUNCHES),
            "C": dict(hist_kernel.BLOOM_LAUNCHES), "part": dict(pk.LAUNCHES)}


def _moved(before):
    """The launches since ``before``, by counter."""
    now = _counters()
    return {key: ({k: v - before[key][k] for k, v in now[key].items()}
                  if isinstance(now[key], dict) else now[key] - before[key])
            for key in now}


@pytest.mark.parametrize("wl,reads,length,batch", [
    (14, 1_000_000, 150, 1 << 18), (20, 1_000_000, 150, 1 << 18),
    (20, 16_384, 10_000, 4096)])
def test_count_file_full_batches_vs_plain(tmp_path, cuda, wl, reads, length,
                                          batch):
    """``count_file`` at the default paths' launch shapes: 1M reads of 150
    bp in batches of 2**18 at 2**14 (every histogram launch by private
    counters) and at ``PipelineConfig()``'s 2**20 (every batch binned: one
    binning pass by the rule's scatter body and one range pass), and 16,384
    reads of 10,000 bp in batches of 4,096 through B2; the sketch equals the
    plain hash -> count, a row's sum the valid windows, and no partition
    kernel launches."""
    codes = _reads(reads, length)
    path = _write_fastq(tmp_path / "reads.fq", codes)
    pipe = ReadHashingPipeline(PipelineConfig(sketch_width_log2=wl),
                               device=cuda)
    before = _counters()
    assert pipe.count_file(path, batch_size=batch, read_length=length) \
        == reads
    got = _moved(before)
    routes = [hist_kernel._counts_route(4, min(batch, reads - s)
                                        * (length - 31), wl, False, None)[0]
              for s in range(0, reads, batch)]
    assert set(routes) == {"private" if wl <= 15 else "binned"}
    hashed = "B2" if length > 150 else "A1"
    assert got[hashed] == got["A2"] == len(routes)
    assert got["A1"] + got["B2"] == len(routes)
    assert got["route"] == {r: routes.count(r) for r in got["route"]}
    binned = routes.count("binned")
    assert got["bin"]["histogram"] == got["range"]["histogram"] == binned
    body = binned and hist_kernel.scatter_body(wl,
                                               hist_kernel.COUNTS_RANGE_LOG2)
    assert got["body"] == {b: binned * (b == body) for b in got["body"]}
    assert not any(got["part"].values())
    want, valid = _plain_count(codes, wl, cuda)
    assert torch.equal(pipe.sketch.rows.long(), want)
    assert pipe.sketch.rows.sum(dim=1, dtype=torch.int64).tolist() == \
        [valid] * 4


def test_timeit_cuda_events(cuda):
    x = torch.ones(1 << 20, device=cuda)
    t = profiling.timeit(lambda y: y * 2, x, calls=5)
    assert len(t.samples) == 5 and t.seconds_per_call > 0


def _bloom_idx(rng, n, wl, rows=None):
    """int32 indices with -1, width and width + 10 among them (width
    2**31: -1 and the most negative int32)."""
    width = 1 << wl
    shape = (n,) if rows is None else (rows, n)
    idx = rng.integers(0, width, size=shape, dtype=np.int64)
    idx[rng.random(shape) < 0.02] = -1
    idx[rng.random(shape) < 0.02] = width if wl < 31 else -(1 << 31)
    idx[rng.random(shape) < 0.02] = width + 10 if wl < 31 else -7
    return torch.from_numpy(idx.astype(np.int32))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("wl", [12, 13, 18, 26, 31])
def test_bloom_words_kernel_vs_plain(rng, cuda, wl, weighted):
    idx = _bloom_idx(rng, 300_001, wl).to(cuda)
    w = (torch.from_numpy(rng.integers(-2, 3, size=300_001, dtype=np.int32))
         .to(cuda) if weighted else None)
    before = dict(hist_kernel.BLOOM_LAUNCHES)
    got = hist_kernel.bloom_words(idx, w, wl)
    assert hist_kernel.BLOOM_LAUNCHES == {
        **before, "bloom_words": before["bloom_words"] + 1}
    want = hist_kernel.bloom_words_plain(idx, w, wl)
    torch.cuda.synchronize()
    assert got.is_cuda and torch.equal(got, want)
    assert torch.equal(got.cpu(), hist_kernel.bloom_words(idx.cpu(), None if
                                                          w is None else
                                                          w.cpu(), wl))


@pytest.mark.parametrize("rows", [1, 3, 5, 64])
@pytest.mark.parametrize("wl", [12, 13, 18, 26])
def test_bloom_words_rows_kernel_vs_plain(rng, cuda, wl, rows):
    n = 600_000 // rows if wl < 26 else 50_000
    idx = _bloom_idx(rng, n, wl, rows).to(cuda)
    before = dict(hist_kernel.BLOOM_LAUNCHES)
    got = hist_kernel.bloom_words_rows(idx, wl)
    assert hist_kernel.BLOOM_LAUNCHES == {
        **before, "bloom_words_rows": before["bloom_words_rows"] + 1}
    want = hist_kernel.bloom_words_rows_plain(idx, wl)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("wl,rows", [(26, None), (31, None), (26, 3)])
def test_bloom_grid_stride_sparse(cuda, wl, rows):
    """More updates than one grid holds (4,096 blocks x 256 threads =
    2**20), so every thread loops, into a filter that stays sparse: a
    dropped or misplaced update shows in the words."""
    n = 5 * (1 << 20) + 3
    gen = torch.Generator(device=cuda).manual_seed(wl)
    shape = (n,) if rows is None else (rows, n)
    idx = torch.randint(0, 1 << wl, shape, device=cuda, generator=gen,
                        dtype=torch.int64).to(torch.int32)
    if rows is None:
        got = hist_kernel.bloom_words(idx, None, wl)
        want = hist_kernel.bloom_words_plain(idx, None, wl)
    else:
        got = hist_kernel.bloom_words_rows(idx, wl)
        want = hist_kernel.bloom_words_rows_plain(idx, wl)
    torch.cuda.synchronize()
    fill = int(bloom.count_set_bits(bloom.BloomFilter(want.reshape(-1))))
    assert 0 < fill < 0.5 * want.numel() * 32
    assert torch.equal(got, want)


def test_bloom_gate_and_out(rng, cuda):
    wl = 13
    idx = _bloom_idx(rng, 5000, wl).to(cuda)
    rows = _bloom_idx(rng, 5000, wl, 3).to(cuda)
    base = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(3, 256))
                            .astype(np.int32)).to(cuda)
    one = hist_kernel.bloom_words_plain(idx, None, wl)
    many = hist_kernel.bloom_words_rows_plain(rows, wl)
    for g in (0, 1):
        gate = torch.full((1,), g, dtype=torch.int32, device=cuda)
        out = base[0].clone()
        hist_kernel.bloom_words(idx, None, wl, gate=gate, out=out)
        out_rows = base.clone()
        hist_kernel.bloom_words_rows(rows, wl, gate=gate, out=out_rows)
        torch.cuda.synchronize()
        assert torch.equal(out, base[0] | one if g else base[0])
        assert torch.equal(out_rows, base | many if g else base)


@pytest.mark.parametrize("wl", [19, 20, 30])
def test_partitioned_bloom_words_vs_plain(rng, cuda, wl):
    idx = _bloom_idx(rng, 1 << 21, wl).to(cuda)
    before = (dict(pk.LAUNCHES), dict(hist_kernel.BLOOM_LAUNCHES))
    got = pk.partitioned_bloom_words(idx, wl)
    # the sort, the table, the windows and both gated word launches
    assert pk.LAUNCHES["windows"] == before[0]["windows"] + 1
    assert all(hist_kernel.BLOOM_LAUNCHES[k] == before[1][k] + 1
               for k in before[1])
    want = hist_kernel.bloom_words_plain(idx, None, wl)
    torch.cuda.synchronize()
    if wl < 30:
        assert torch.equal(got, want)
    else:  # sparse: the set words, then the total popcount
        b = idx[(idx >= 0) & (idx < (1 << wl))].long()
        pos = torch.unique(hist_kernel.word_index(b))
        assert torch.equal(got[pos], want[pos])
        assert int(bloom.count_set_bits(bloom.BloomFilter(got))) == \
            torch.unique(b).numel()


@pytest.mark.parametrize("kind", ["identical", "sentinel"])
def test_partitioned_bloom_skew_and_sentinel(rng, cuda, kind):
    wl = 20
    if kind == "identical":  # every window overflows: the gated fallback
        idx = torch.full((1 << 20,), 12345, dtype=torch.int32)
    else:  # mostly sentinel: must not trip the flag
        idx = torch.full((1 << 20,), 1 << wl, dtype=torch.int32)
        idx[:130] = torch.from_numpy(rng.integers(0, 1 << wl, size=130,
                                                  dtype=np.int32))
    idx = idx.to(cuda)
    p_log2, sub_log2, rows, cap = pk.plan(wl)
    _, flags = pk._partition(idx.reshape(1, -1), wl, p_log2, sub_log2, rows,
                             cap)
    assert flags.tolist() == ([1, 0] if kind == "identical" else [0, 1])
    got = pk.partitioned_bloom_words(idx, wl)
    assert torch.equal(got, hist_kernel.bloom_words_plain(idx, None, wl))


def test_bloom_insert_2_31_sparse(rng, cuda):
    wl = 31
    h = torch.from_numpy(rng.integers(0, 1 << 62, size=(200_000, 4),
                                      dtype=np.int64)).to(cuda)
    v = torch.from_numpy(rng.random(200_000) < 0.9).to(cuda)
    bf = bloom.insert(bloom.BloomFilter.zeros(wl, device=cuda), h, v, wl)
    b = (h & ((1 << wl) - 1))[v].reshape(-1)
    pos = torch.unique(hist_kernel.word_index(b))
    want = hist_kernel.bloom_words_plain(b.int(), None, wl)
    torch.cuda.synchronize()
    assert torch.equal(bf.words[pos], want[pos])
    assert int(bloom.count_set_bits(bf)) == torch.unique(b).numel()
    assert bool(bloom.contains(bf, h, wl)[v].all())


@pytest.mark.parametrize("wl", [14, 18, 19, 20, 22])
def test_bloom_insert_cuda_vs_cpu(rng, cuda, wl):
    from nthash_tpu_torch.ops.kmer_torch import hash_kmers

    res = hash_kmers(_codes(rng, 3000), 32, 4)
    gpu = bloom.insert(bloom.BloomFilter.zeros(wl), res.hashes.to(cuda),
                       res.valid.to(cuda), wl)
    cpu = bloom.insert(bloom.BloomFilter.zeros(wl, device="cpu"), res.hashes,
                       res.valid, wl)
    assert gpu.words.is_cuda and torch.equal(gpu.words.cpu(), cpu.words)
    assert bool(bloom.contains(gpu, res.hashes.to(cuda), wl)[
        res.valid.to(cuda)].all())


@pytest.mark.parametrize("wl", [17, 20])
def test_bloom_insert_from_buckets_cuda_vs_cpu(rng, cuda, wl):
    tm = prepare_codes(_codes(rng, 3000))
    bf_gpu = bloom.BloomFilter.zeros(wl)
    bf_cpu = bloom.BloomFilter.zeros(wl, device="cpu")
    before = dict(hist_kernel.BLOOM_LAUNCHES)
    bloom.insert_from_buckets(bf_gpu, hash_kmers_tm(tm.to(cuda), 32, 4,
                                                    emit_buckets=wl))
    bloom.insert_from_buckets(bf_cpu, hash_kmers_tm(tm, 32, 4,
                                                    emit_buckets=wl))
    assert torch.equal(bf_gpu.words.cpu(), bf_cpu.words)
    got = {k: hist_kernel.BLOOM_LAUNCHES[k] - before[k] for k in before}
    # the four tensors are views of the kernel's one output: one launch
    assert got == {"bloom_words": 1, "bloom_words_rows": 0}


@pytest.mark.parametrize("wl", [17, 20, 30])
def test_bloom_path_full_batches_vs_plain(cuda, wl):
    """The Bloom path over 1M reads in batches of 2**18 (the hash kernel's
    buckets -> ``insert_from_buckets``) at 2**17, 2**20 and 2**30: one
    ``bloom_words`` launch a batch (binned where the rule bins: one binning
    pass by the rule's scatter body and one range pass), no partition kernel
    and no ``bloom_words_rows``; the filter equals the plain hash -> plain
    insert, ``contains`` holds on every valid window, and two half-filters
    merge to the whole."""
    codes = _reads(1_000_000, 150)
    tms = [prepare_codes(torch.from_numpy(codes[s:s + (1 << 18)]).to(cuda))
           for s in range(0, codes.shape[0], 1 << 18)]

    def build(part):
        bf = bloom.BloomFilter.zeros(wl, device=cuda)
        for tm in part:
            bloom.insert_from_buckets(bf, kmer_kernel.hash_kmers_tm_auto(
                tm, 32, 4, emit_buckets=wl), emitted_width_log2=wl)
        return bf

    before = _counters()
    bf = build(tms)
    got = _moved(before)
    binned = sum(hist_kernel._words_route_of(
        1, 4 * tm.shape[1] * (tm.shape[0] - 31), wl, None)[0] == "binned"
        for tm in tms)
    assert got["A1"] == len(tms) and got["C"] == {
        "bloom_words": len(tms), "bloom_words_rows": 0}
    assert got["bin"]["bloom"] == got["range"]["bloom"] == binned
    body = binned and hist_kernel.scatter_body(wl,
                                               hist_kernel.WORDS_RANGE_LOG2)
    assert got["body"] == {b: binned * (b == body) for b in got["body"]}
    assert not any(got["part"].values())
    want = torch.zeros_like(bf.words)
    for tm in tms:
        for b in hash_kmers_tm_plain(tm, 32, 4, emit_buckets=wl):
            hist_kernel.bloom_words_plain(b, None, wl, out=want)
    assert torch.equal(bf.words, want)
    for tm in tms:
        hashes = torch.stack(kmer_kernel.hash_kmers_tm_auto(tm, 32, 4), -1)
        valid = kmer_torch.window_valid_tm(tm, 32)
        assert bool(bloom.contains(bf, hashes, wl)[valid].all())
    assert torch.equal(bloom.merge(build(tms[:2]), build(tms[2:])).words,
                       bf.words)


# ------------- the presence-word kernel's two routes and the tile sort ----


def _by_route(route, idx, weight, wl, gate=None, out=None):
    """The presence-word kernel with its route forced (None: by shape)."""
    return hist_kernel._words_launch(idx, weight, wl, gate, out,
                                     "bloom_words_rows", route=route)


@pytest.mark.parametrize("route", ["private", "direct", None])
@pytest.mark.parametrize("wl,rows,n", [(12, 1, 300_001), (13, 5, 100_003),
                                       (17, 1, 1_000_003), (18, 3, 300_001),
                                       (20, 1, 600_001), (13, 7, 999)])
def test_bloom_routes_vs_plain(rng, cuda, wl, rows, n, route):
    """Each route with weights, a closed and an open gate, and an ``out``
    that already holds bits: the merge's skip must lose none."""
    idx = _bloom_idx(rng, n, wl, rows).to(cuda)
    w = (torch.from_numpy(rng.integers(-1, 2, size=n, dtype=np.int32))
         .to(cuda) if rows == 1 else None)
    base = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31,
                                         size=(rows, 1 << (wl - 5)))
                            .astype(np.int32)).to(cuda)
    fresh = hist_kernel._words_plain(idx, w, wl, None, None)
    for g in (0, 1):
        gate = torch.full((1,), g, dtype=torch.int32, device=cuda)
        got = _by_route(route, idx, w, wl, gate, base.clone())
        torch.cuda.synchronize()
        assert torch.equal(got, base | fresh if g else base)
    # onto words that already hold every bit it sets, and onto none
    assert torch.equal(_by_route(route, idx, w, wl, None, fresh.clone()),
                       fresh)
    assert torch.equal(_by_route(route, idx, w, wl), fresh)
    # a row that starts off a 16-byte boundary
    assert torch.equal(_by_route(route, idx[:, 1:], None, wl),
                       hist_kernel._words_plain(idx[:, 1:], None, wl, None,
                                                None))


@pytest.mark.parametrize("route", ["private", "direct", None])
@pytest.mark.parametrize("what,wl,rows,n,top", [
    ("hot rows", 13, 128, 200_000, 1 << 11),
    ("sparse words", 18, 3, 100_000, 1 << 18),
    ("one block a row", 17, 512, 32_768, 1 << 17)])
def test_bloom_routes_sparse_words(cuda, what, wl, rows, n, top, route):
    """Words that stay sparse (fill below 0.5), so a dropped update shows:
    the [128, N] hot-row shape at 2**13, 2**18, and rows of 8 entries a
    word."""
    gen = torch.Generator(device=cuda).manual_seed(wl)
    idx = torch.randint(0, top, (rows, n), device=cuda, generator=gen,
                        dtype=torch.int32)
    want = hist_kernel.bloom_words_rows_plain(idx, wl)
    fill = int(bloom.count_set_bits(bloom.BloomFilter(want.reshape(-1))))
    assert 0 < fill < 0.5 * want.numel() * 32
    before = hist_kernel.BLOOM_LAUNCHES["bloom_words_rows"]
    got = _by_route(route, idx, None, wl)
    assert hist_kernel.BLOOM_LAUNCHES["bloom_words_rows"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_bloom_private_route_refuses_wide_rows(cuda):
    idx = torch.zeros((1, 1 << 20), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        _by_route("private", idx, None, 21)


@pytest.mark.parametrize("kind", ["random21", "random31", "equal",
                                  "sentinel", "sorted", "reversed"])
@pytest.mark.parametrize("rows", [1, 2, 8, 16, 64, 128, 256, 512, 2048])
def test_sort_tiles_kinds(cuda, rows, kind):
    """The tile sort at every tile size (128 ints up to 2**15, one to 8
    tiles a chunk, so odd and even tiles) on the inputs a network gets
    wrong first; then the merge rounds up to a sorted chunk."""
    gen = torch.Generator(device=cuda).manual_seed(rows)
    shape = (2, 3, rows, 128)
    if kind == "random31":
        x = torch.randint(0, (1 << 31) - 1, shape, device=cuda, generator=gen,
                          dtype=torch.int64).int()
    elif kind == "equal":
        x = torch.full(shape, 77, dtype=torch.int32, device=cuda)
    elif kind == "sentinel":
        x = torch.full(shape, 1 << 20, dtype=torch.int32, device=cuda)
    else:
        x = torch.randint(0, (1 << 20) + 1, shape, device=cuda, generator=gen,
                          dtype=torch.int32)
        if kind != "random21":
            x = x.reshape(-1).sort(descending=kind == "reversed").values \
                .reshape(shape)
    before = pk.LAUNCHES["sort_tiles"]
    got, tile = pk.sort_tiles(x)
    assert pk.LAUNCHES["sort_tiles"] == before + 1
    assert tile == min(rows * 128, 1 << 15)
    torch.cuda.synchronize()
    assert torch.equal(got, pk.sort_tiles_plain(x, tile))
    k = 2 * tile
    while k <= rows * 128:
        want = pk.merge_phase_plain(got, k)
        pk.merge_phase(got, tile, k)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        k *= 2
    assert torch.equal(got, pk._sort_plain(x))


def test_sort_64_tile_chunks(cuda):
    """The 2**30 plan's chunks: 16,384 rows, 64 tiles each."""
    gen = torch.Generator(device=cuda).manual_seed(30)
    x = torch.randint(0, (1 << 30) + 1, (1, 3, 16384, 128), device=cuda,
                      generator=gen, dtype=torch.int64).int()
    before = pk.LAUNCHES["merge_phase"]
    got = pk._sorted(x)
    assert pk.LAUNCHES["merge_phase"] == before + 6
    torch.cuda.synchronize()
    assert torch.equal(got, pk._sort_plain(x))


def test_sorted_2_30_plan_odd_chunks(cuda):
    """The 2**30 plan's chunks with R * G = 9, not a multiple of 8: every
    round by merge_plan's launches (a two-tile cluster in the first round,
    then grouped passes of 2 to 6 strides)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randint(0, (1 << 30) + 1, (3, 3, 16384, 128), device=cuda,
                      generator=gen, dtype=torch.int64).int()
    before = pk.LAUNCHES["merge_phase"]
    got = pk._sorted(x)
    assert pk.LAUNCHES["merge_phase"] == before + 6
    torch.cuda.synchronize()
    assert torch.equal(got, pk._sort_plain(x))


@pytest.mark.parametrize("kind", ["random21", "random31", "equal",
                                  "sentinel", "sorted", "reversed"])
@pytest.mark.parametrize("rows", [512, 1024, 4096, 16384, 32768, 65536])
def test_merge_phase_every_plan(cuda, rows, kind):
    """merge_phase at every round of chunks of 2 to 256 tiles of 2**15, so
    through every launch the plan picks (a cluster of two tiles alone and
    after a pass, grouped passes of 2 to 6 strides, and 4 + 4 at 2**23), on
    the tile sort's hard inputs; each round exact against
    merge_phase_plain."""
    gen = torch.Generator(device=cuda).manual_seed(rows)
    shape = (1, max(1, 65536 // rows), rows, 128)
    if kind == "random31":
        x = torch.randint(0, (1 << 31) - 1, shape, device=cuda, generator=gen,
                          dtype=torch.int64).int()
    elif kind == "equal":
        x = torch.full(shape, 77, dtype=torch.int32, device=cuda)
    elif kind == "sentinel":
        x = torch.full(shape, 1 << 20, dtype=torch.int32, device=cuda)
    else:
        x = torch.randint(0, (1 << 20) + 1, shape, device=cuda, generator=gen,
                          dtype=torch.int32)
        if kind != "random21":
            x = x.reshape(-1).sort(descending=kind == "reversed").values \
                .reshape(shape)
    got, tile = pk.sort_tiles(x)
    seen = set()
    k = 2 * tile
    while k <= rows * 128:
        passes, _, cluster = pk.merge_plan(rows * 128, k)
        seen.add((tuple(g for _, g in passes), cluster))
        want = pk.merge_phase_plain(got, k)
        before = pk.LAUNCHES["merge_phase"]
        pk.merge_phase(got, tile, k)
        assert pk.LAUNCHES["merge_phase"] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want), (k, passes, cluster)
        k *= 2
    assert torch.equal(got, pk._sort_plain(x))
    assert rows < 65536 or seen == {
        ((), 2), ((2,), 1), ((3,), 1), ((4,), 1), ((5,), 1), ((6,), 1),
        ((6,), 2), ((4, 4), 1)}


def test_merge_phase_refuses(cuda):
    x = torch.zeros((1, 1, 512, 128), dtype=torch.int32, device=cuda)
    off = torch.zeros(x.numel() + 4, dtype=torch.int32,
                      device=cuda)[1:x.numel() + 1].view(x.shape)
    for bad in (x[..., :64], x[:, :, ::2], off):   # lanes, strides, offset
        with pytest.raises(ValueError):
            pk.merge_phase(bad, 1 << 15, 1 << 16)
    with pytest.raises(ValueError):
        pk.merge_phase(x, 1 << 15, 1 << 15)   # k below 2 * tile
    with pytest.raises(ValueError):
        pk.merge_phase(x, 1 << 15, 1 << 17)   # k above the chunk
    lib = pk._lib()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for args in ((1 << 16, 1 << 15, 1 << 15, 1),   # stride above k / 2
                 (1 << 16, 1 << 16, 2, 1),         # stride below 4
                 (1 << 16, 1 << 16, 1 << 8, 7)):   # seven strides
        chunk, k, j, g = args
        assert lib.nthash_merge_strides(0, x.data_ptr(), x.numel(), chunk, k,
                                        j, g, stream) != 0
    assert lib.nthash_merge_span(0, x.data_ptr(), x.numel(), 1 << 16,
                                 1 << 16, 1 << 15, 4, stream) != 0


def _bounded_chunks(rng, kind, rows, p_log2, sub_log2, run=0, r=2, g=2,
                    at=None):
    """Sorted chunks [r, g, rows, 128] whose row maxima follow ``kind``:
    each row's values share its maximum's partition, so sorting keeps every
    row's maximum's partition (tests/test_torch_part.py::_chunks_of)."""
    parts = 1 << p_log2
    qs = np.empty((r * g, rows), np.int64)
    for i in range(r * g):
        if kind == "random":
            qs[i] = np.sort(rng.integers(0, parts + 1, size=rows))
        elif kind == "sentinel":
            qs[i] = parts
        elif kind == "equal":
            qs[i] = min(77 >> sub_log2, parts - 1)
        elif kind == "mostly_sentinel":
            qs[i] = parts
            qs[i, :1] = rng.integers(0, parts)
        elif kind == "empty":
            qs[i] = np.minimum(3 * np.arange(rows), parts)
        else:
            s = min(rows, parts) // 8 if at is None else at
            base = np.arange(rows) * 2
            base[s:s + run] = base[s]
            base[s + run:] += 1
            qs[i] = np.minimum(base, parts)
    vals = (qs[..., None] << sub_log2) + rng.integers(
        0, 1 << sub_log2, size=(r * g, rows, 128))
    vals = np.where(qs[..., None] >= parts, parts << sub_log2, vals)
    vals = np.sort(vals.reshape(r * g, -1), axis=-1)
    return torch.from_numpy(vals.astype(np.int32).reshape(r, g, rows, 128))


@pytest.mark.parametrize("kind", ["random", "sentinel", "equal",
                                  "mostly_sentinel", "empty"])
@pytest.mark.parametrize("p_log2", [0, 6, 13])
@pytest.mark.parametrize("rows", [1, 2, 64, 512, 16384])
def test_partition_bounds_kernel_edges(rng, cuda, rows, p_log2, kind):
    """The table and flags exact against plain, P > rows included, at caps
    0 (every window misses), 1, 3 and 6; R * G = 3 and 4."""
    for g in (2, 3):
        x = _bounded_chunks(rng, kind, rows, p_log2, 4, g=g).to(cuda)
        for cap in (0, 1, 3, 6):
            before = pk.LAUNCHES["partition_bounds"]
            fb, flags = pk.partition_bounds(x, 4, p_log2, cap)
            assert pk.LAUNCHES["partition_bounds"] == before + 1
            want_fb, want_flags = pk.partition_bounds_plain(x, 4, p_log2, cap)
            torch.cuda.synchronize()
            assert fb.shape == want_fb.shape and torch.equal(fb, want_fb)
            assert torch.equal(flags, want_flags), (g, cap)


@pytest.mark.parametrize("cap", [3, 6])
@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("rows", [64, 512, 16384])
def test_partition_bounds_runs_at_cap(rng, cuda, rows, cap, delta):
    """A run of cap - 1 equal maxima fits its window, cap and cap + 1 do
    not; the run sits inside a block of 256 rows or across the rows 255 |
    256 of two."""
    for at in [None] + ([256 - cap // 2] if rows > 256 else []):
        x = _bounded_chunks(rng, "run", rows, 13, 4, run=cap + delta,
                            at=at).to(cuda)
        fb, flags = pk.partition_bounds(x, 4, 13, cap)
        want_fb, want_flags = pk.partition_bounds_plain(x, 4, 13, cap)
        torch.cuda.synchronize()
        assert want_flags.tolist() == ([0, 1] if delta < 0 else [1, 0])
        assert torch.equal(fb, want_fb) and torch.equal(flags, want_flags)


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_partition_bounds_long_runs(rng, cuda, delta):
    """A window of 200 rows: the run check reads past the 32 rows a block
    stages after its own, for a run across two blocks."""
    x = _bounded_chunks(rng, "run", 16384, 13, 4, run=200 + delta,
                        at=1024 - 100).to(cuda)
    fb, flags = pk.partition_bounds(x, 4, 13, 200)
    want_fb, want_flags = pk.partition_bounds_plain(x, 4, 13, 200)
    torch.cuda.synchronize()
    assert want_flags.tolist() == ([0, 1] if delta < 0 else [1, 0])
    assert torch.equal(fb, want_fb) and torch.equal(flags, want_flags)


def test_partition_bounds_no_chunks(cuda):
    """No chunk: an empty table, flags (0, 1), and no table launch."""
    x = torch.zeros((0, 3, 64, 128), dtype=torch.int32, device=cuda)
    before = pk.LAUNCHES["partition_bounds"]
    fb, flags = pk.partition_bounds(x, 4, 6, 3)
    assert pk.LAUNCHES["partition_bounds"] == before
    assert fb.shape == (0, 3, 64) and flags.tolist() == [0, 1]


# The staged seed kernel (B1/B3) and the one-sequence entries.

MANY_RUNS = "10" * 40 + "1"             # 41 care runs of one base, k = 81
LONG_SEED = "1" + "0" * 3000 + "1"      # two runs, a ring of 4,096 rows


@pytest.mark.parametrize("route", ["staged", "global"])
@pytest.mark.parametrize("mode", [{}, {"emit_fwd_rev": True},
                                  {"emit_buckets": 12}])
@pytest.mark.parametrize("seeds", [
    ("1",), ("10101", "11011"), ("0110", "1001", "1111"),
    ("11", "01", "10", "11"), ("1" * 64,), ("1" * 33, "1" + "0" * 31 + "1"),
    (MANY_RUNS,), ("110100110011001011", "111111000000111111")])
@pytest.mark.parametrize("reads,length,tile", [
    (1, 300, None), (37, 150, 1), (100, 333, 7), (64, 90, 1000)])
def test_seed_routes_vs_plain(rng, cuda, route, seeds, reads, length, tile,
                              mode):
    """Both kernels, forced, against plain: S = 1-4, many care runs, k up
    to 81, R = 1 and R not a multiple of 32, tiles of one k, not dividing
    W, and >= W (``tile`` counts k-windows)."""
    k = len(seeds[0])
    length = max(length, k)
    tm = prepare_codes(_codes(rng, reads, length).to(cuda))
    want = seed_kernel.hash_seeds_tm_plain(tm, seeds, 2, **mode)
    before = dict(seed_kernel.ROUTE_LAUNCHES)
    got = seed_kernel._launch(tm, seeds, k, 2, mode.get("emit_fwd_rev", False),
                              mode.get("emit_buckets"), length - k + 1, route)
    _same(got, want)
    seg = min(tile * k, length - k + 1) if tile else length - k + 1
    _same(seed_kernel._launch(tm, seeds, k, 2,
                              mode.get("emit_fwd_rev", False),
                              mode.get("emit_buckets"), seg, route), want)
    assert seed_kernel.ROUTE_LAUNCHES[route] == before[route] + 2


@pytest.mark.parametrize("mode", [{}, {"emit_buckets": 9}])
def test_seed_long_pattern_staged(rng, cuda, mode):
    """A seed whose ring (4,096 rows) leaves room for one warp a block."""
    k = len(LONG_SEED)
    assert seed_kernel.seed_grid(k, 1, 2, 1)[0] >= 1
    tm = prepare_codes(_codes(rng, 40, k + 300).to(cuda))
    want = seed_kernel.hash_seeds_tm_plain(tm, (LONG_SEED,), 1, **mode)
    for tile in (None, k):
        _same(seed_kernel.hash_seeds_tm_long(tm, (LONG_SEED,), 1,
                                             time_tile=tile, **mode), want)


def test_seed_route_by_shapes(rng, cuda):
    """The staged kernel wherever seed_grid fits it; the global one beyond
    it (500 runs at k = 1,000: 200 KB of pair tables beside a 64 KB ring;
    80 KB of four-table runs), held to the direct engine."""
    from nthash_tpu_torch.ops.seed_torch import hash_kmers_seeds

    codes = _codes(rng, 50, 1010).to(cuda)
    tm = prepare_codes(codes)
    wide = ("10" * 500,)
    assert seed_kernel.seed_grid(1000, 1, 500, 1) == (0, 0)
    for seeds, route in ((("10101", "11011"), "staged"), (wide, "global")):
        before = dict(seed_kernel.ROUTE_LAUNCHES)
        got = seed_kernel.hash_seeds_tm(tm, seeds, 1)
        want = hash_kmers_seeds(codes, seeds, 1).hashes
        _same(got, [want[..., i].T for i in range(len(seeds))])
        assert seed_kernel.ROUTE_LAUNCHES[route] == before[route] + 1
    with pytest.raises(ValueError, match="staged"):
        seed_kernel._launch(tm, wide, 1000, 1, False, None, 11, "staged")


#: One base, a chunk of 32 and one either side, the spans of k <= 32 (64,
#: and 256 for seeds without fwd/rev) and one either side, 300, a multiple
#: of the span, neither a multiple of the span nor of 32, and a prime.
SEQ_LENGTHS = [1, 31, 32, 33, 63, 64, 65, 255, 256, 257, 300, 4096,
               8192 + 17, 100_003]
#: Four seeds, 46 care runs: one of 41 runs, one of a single run.
FOUR_SEEDS = ("10" * 40 + "1", "1" * 81, "11" + "0" * 77 + "11",
              "1" * 40 + "0" + "1" * 40)


@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("k", [1, 2, 5, 31, 32, 33, 64, 97, 100, 4064])
@pytest.mark.parametrize("length", SEQ_LENGTHS)
def test_hash_sequence_vs_plain(rng, cuda, length, k, h):
    """Lengths a multiple of the span, prime, neither a multiple of the
    span nor of 32, one chunk and one either side, shorter than one span
    and than k; k either side of a chunk; codes above 4."""
    seq = torch.from_numpy(rng.integers(0, 8, size=length, dtype=np.uint8))
    before = kmer_kernel.SEQUENCE_LAUNCHES
    got, valid = kmer_kernel.hash_sequence(seq.to(cuda), k, h)
    assert kmer_kernel.SEQUENCE_LAUNCHES == before + 1
    want, wvalid = kmer_kernel.hash_sequence_plain(seq, k, h)
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert len(got) == h and torch.equal(valid.cpu(), wvalid)


@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("seeds", [
    ("10101", "11011"), ("1",), ("0110", "1001", "1111"),
    ("110100110011001011", "111111000000111111"), (MANY_RUNS,), FOUR_SEEDS])
@pytest.mark.parametrize("length", SEQ_LENGTHS)
def test_hash_seeds_sequence_vs_plain(rng, cuda, length, seeds, h):
    seq = torch.from_numpy(rng.integers(0, 8, size=length, dtype=np.uint8))
    before = seed_kernel.SEQUENCE_LAUNCHES
    got, valid = seed_kernel.hash_seeds_sequence(seq.to(cuda), seeds, h)
    assert seed_kernel.SEQUENCE_LAUNCHES == before + 1
    want, wvalid = seed_kernel.hash_seeds_sequence_plain(seq, seeds, h)
    torch.cuda.synchronize()
    assert len(got) == len(seeds) * h
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert torch.equal(valid.cpu(), wvalid)


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
def test_sequence_entries_take_any_integer_view(rng, cuda, offset):
    """int32 codes with negatives and values above 4, and uint8 views that
    start ``offset`` bytes into their storage (not 16-byte aligned)."""
    raw = rng.integers(-3, 9, size=5001).astype(np.int32)
    as_u8 = torch.from_numpy(np.where((raw < 0) | (raw > 4), 4, raw)
                             .astype(np.uint8))
    x = torch.from_numpy(raw).to(cuda)
    for got, want in (
            (kmer_kernel.hash_sequence(x, 32, 2),
             kmer_kernel.hash_sequence_plain(as_u8, 32, 2)),
            (seed_kernel.hash_seeds_sequence(x, ("10101", "11011"), 1),
             seed_kernel.hash_seeds_sequence_plain(as_u8, ("10101", "11011"),
                                                   1)),
            (kmer_kernel.hash_sequence(as_u8.to(cuda)[offset:], 9, 1),
             kmer_kernel.hash_sequence_plain(as_u8[offset:], 9, 1)),
            (seed_kernel.hash_seeds_sequence(as_u8.to(cuda)[offset:],
                                             (MANY_RUNS,), 1,
                                             emit_fwd_rev=True),
             seed_kernel.hash_seeds_sequence_plain(as_u8[offset:],
                                                   (MANY_RUNS,), 1,
                                                   emit_fwd_rev=True))):
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got[0], want[0]))
        assert torch.equal(got[1].cpu(), want[1])


def test_sp_one_launch_each(rng, cuda):
    """The sequence paths launch their one-sequence entry once, and no read
    kernel."""
    seq = torch.from_numpy(rng.integers(0, 5, size=65_536, dtype=np.uint8))
    seq = seq.to(cuda)
    before = (kmer_kernel.LAUNCHES, kmer_kernel.SEQUENCE_LAUNCHES,
              seed_kernel.LAUNCHES, seed_kernel.SEQUENCE_LAUNCHES)
    sp.hash_long_sequence(seq, 32, 1)
    sp.hash_long_sequence_seeds(seq, ("10101", "11011"), 1)
    assert (kmer_kernel.LAUNCHES, kmer_kernel.SEQUENCE_LAUNCHES,
            seed_kernel.LAUNCHES, seed_kernel.SEQUENCE_LAUNCHES) == (
        before[0], before[1] + 1, before[2], before[3] + 1)


def _packed(rng, reads, length, cuda):
    """pack_codes' planes on the card of reads holding all five codes, the
    last eighth padding rows. Past 2**28 codes, random plane bytes made on
    the card (any bytes are valid input) and no codes."""
    if reads * length > 1 << 28:
        gen = torch.Generator(device=cuda).manual_seed(length)
        return (*(torch.randint(0, 256, shape, generator=gen, device=cuda,
                                dtype=torch.uint8)
                  for shape in packed_shapes((reads, length))), None)
    codes = rng.integers(0, 5, size=(reads, length), dtype=np.uint8)
    codes[reads - reads // 8:] = 4
    packed, nmask = pack_codes(codes)
    return (torch.from_numpy(packed).to(cuda),
            torch.from_numpy(nmask).to(cuda), codes)


@pytest.mark.parametrize("reads", [1, 33, 4096, 1 << 18])
@pytest.mark.parametrize("length", [1, 3, 4, 7, 8, 31, 150, 10_000])
def test_unpack_kernel_vs_plain(rng, cuda, length, reads):
    """Every (L, B) of the grid, 2**18 x 10,000 (2.6e9 codes, past 2**31)
    included; the plain version 2**14 reads at a time."""
    packed, nmask, codes = _packed(rng, reads, length, cuda)
    before = unpack_kernel.LAUNCHES
    got = unpack_kernel.unpack_codes_tm(packed, nmask, length)
    assert unpack_kernel.LAUNCHES == before + 1
    assert got.is_cuda and got.dtype == torch.int32 and got.is_contiguous()
    assert got.shape == (length, reads)
    for s in range(0, reads, 1 << 14):
        want = unpack_kernel.unpack_codes_tm_plain(
            packed[s:s + (1 << 14)], nmask[s:s + (1 << 14)], length)
        torch.cuda.synchronize()
        assert torch.equal(got[:, s:s + (1 << 14)], want)
    if codes is not None:
        assert np.array_equal(got.T.cpu().numpy(), codes)


def _write_fastq(path, codes):
    """uint8 [n, length] codes (0-4) as a FASTQ file, a record a read."""
    n, length = codes.shape
    rec = np.empty((n, 2 * length + 7), dtype=np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3:3 + length] = np.frombuffer(b"ACGTN", np.uint8)[codes]
    rec[:, 3 + length:6 + length] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + length:-1] = ord("I")
    rec[:, -1] = ord("\n")
    path.write_bytes(rec.tobytes())
    return path


def _fastq(path, rng, n, length):
    return _write_fastq(path, rng.integers(0, 5, size=(n, length))
                        .astype(np.uint8))


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("threads", [2, 4])
def test_count_file_routes_vs_serial(tmp_path, rng, cuda, threads, pack):
    """The parallel and packed routes give the serial sketch on the card,
    through the kernels (the unpack kernel on every packed batch)."""
    path = _fastq(tmp_path / "reads.fq", rng, 5000, 150)
    cfg = dict(k=21, num_hashes=3, sketch_width_log2=14)
    serial = ReadHashingPipeline(PipelineConfig(**cfg), device=cuda)
    assert serial.count_file(path, batch_size=512) == 5000
    pipe = ReadHashingPipeline(PipelineConfig(**cfg, pack_h2d=pack),
                               device=cuda)
    before = (kmer_kernel.LAUNCHES, unpack_kernel.LAUNCHES)
    assert pipe.count_file(path, batch_size=512, threads=threads) == 5000
    hashed = kmer_kernel.LAUNCHES - before[0]
    assert hashed >= 10
    assert unpack_kernel.LAUNCHES - before[1] == (hashed if pack else 0)
    assert torch.equal(pipe.sketch.rows, serial.sketch.rows)
    run = ReadHashingPipeline(PipelineConfig(**cfg), device=cuda)
    run.run_file(path, batch_size=512, threads=threads)
    assert torch.equal(run.sketch.rows, serial.sketch.rows)


@pytest.mark.parametrize("threads", [1, 4])
def test_packed_many_small_batches(tmp_path, rng, cuda, threads):
    """62 packed batches through a few pinned buffers equal the plain count:
    a buffer reused before its copy completed would change the sketch."""
    n = 62 * 256 - 100
    path = _fastq(tmp_path / "reads.fq", rng, n, 150)
    cfg = PipelineConfig(k=21, num_hashes=3, sketch_width_log2=14,
                         pack_h2d=True)
    pipe = ReadHashingPipeline(cfg, device=cuda)
    assert pipe.count_file(path, batch_size=256, threads=threads) == n
    cpu = ReadHashingPipeline(cfg, device="cpu")
    cpu.count_file(path, batch_size=256)
    assert torch.equal(pipe.sketch.rows.cpu(), cpu.sketch.rows)


@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("k", [1, 2, 5, 31, 32, 33, 64, 97])
@pytest.mark.parametrize("length", SEQ_LENGTHS)
def test_hash_sequence_fwd_rev_vs_plain(rng, cuda, length, k, h):
    """The fwd/rev instance of the one-sequence entry against its plain
    version, every entry (invalid windows included), and its hashes and
    validity against the route without the flag."""
    seq = torch.from_numpy(rng.integers(0, 8, size=length, dtype=np.uint8))
    before = kmer_kernel.SEQUENCE_LAUNCHES
    got, valid = kmer_kernel.hash_sequence(seq.to(cuda), k, h,
                                           emit_fwd_rev=True)
    base, bvalid = kmer_kernel.hash_sequence(seq.to(cuda), k, h)
    assert kmer_kernel.SEQUENCE_LAUNCHES == before + 2
    want, wvalid = kmer_kernel.hash_sequence_plain(seq, k, h,
                                                   emit_fwd_rev=True)
    torch.cuda.synchronize()
    assert len(got) == h + 2
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert all(torch.equal(g, b) for g, b in zip(got[:h], base))
    assert torch.equal(valid.cpu(), wvalid) and torch.equal(valid, bvalid)


@pytest.mark.parametrize("seeds", [
    ("10101", "11011"), ("1",), ("0110", "1001", "1111"),
    ("110100110011001011", "111111000000111111"), (MANY_RUNS,), FOUR_SEEDS])
@pytest.mark.parametrize("length", SEQ_LENGTHS)
def test_hash_seeds_sequence_fwd_rev_vs_plain(rng, cuda, length, seeds):
    seq = torch.from_numpy(rng.integers(0, 8, size=length, dtype=np.uint8))
    want, wvalid = seed_kernel.hash_seeds_sequence_plain(
        seq, seeds, 2, emit_fwd_rev=True)
    routes = [seed_kernel.hash_seeds_sequence_rows]
    if seed_kernel.sequence_fits(seeds, 2, True):
        routes.append(seed_kernel.hash_seeds_sequence)
    for route in routes:
        got, valid = route(seq.to(cuda), seeds, 2, emit_fwd_rev=True)
        torch.cuda.synchronize()
        assert len(got) == len(seeds) * 4
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        assert torch.equal(valid.cpu(), wvalid)


def _n_runs_at_edges(rng, length: int, span: int) -> np.ndarray:
    """Codes 0-7 with runs of 4 (N) across chunk and segment edges: two
    bases either side of every 32nd base up to 200 and of every span edge,
    a run of k-crossing length over the third segment edge, and 1% more."""
    codes = rng.integers(0, 8, size=length, dtype=np.uint8)
    edges = list(range(32, min(length, 200), 32)) + list(
        range(span, length, span))
    for e in edges:
        codes[max(e - 2, 0):e + 2] = 4
    if 3 * span < length:
        codes[3 * span - 40:3 * span + 70] = 4
    codes[rng.integers(0, length, size=length // 100)] = 4
    return codes


@pytest.mark.parametrize("fwd_rev", [False, True])
@pytest.mark.parametrize("k", [1, 5, 31, 32, 33, 97])
def test_hash_sequence_n_runs_at_edges(rng, cuda, k, fwd_rev):
    """Runs of N across chunk and segment edges: hashes and validity ==
    plain, the windows past the end invalid."""
    span = kmer_kernel.sequence_span(k)
    seq = torch.from_numpy(_n_runs_at_edges(rng, 5 * span + 77, span))
    got, valid = kmer_kernel.hash_sequence(seq.to(cuda), k, 2,
                                           emit_fwd_rev=fwd_rev)
    want, wvalid = kmer_kernel.hash_sequence_plain(seq, k, 2,
                                                   emit_fwd_rev=fwd_rev)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert torch.equal(valid.cpu(), wvalid)
    assert not bool(valid[seq.shape[0] - k + 1:].any())


@pytest.mark.parametrize("fwd_rev", [False, True])
@pytest.mark.parametrize("seeds", [("10101", "11011"), (MANY_RUNS,),
                                   FOUR_SEEDS])
def test_hash_seeds_sequence_n_runs_at_edges(rng, cuda, seeds, fwd_rev):
    span = kmer_kernel.sequence_span(len(seeds[0]), seeds=True,
                                     emit_fwd_rev=fwd_rev)
    seq = torch.from_numpy(_n_runs_at_edges(rng, 5 * span + 77, span))
    got, valid = seed_kernel.hash_seeds_sequence(seq.to(cuda), seeds, 2,
                                                 emit_fwd_rev=fwd_rev)
    want, wvalid = seed_kernel.hash_seeds_sequence_plain(
        seq, seeds, 2, emit_fwd_rev=fwd_rev)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert torch.equal(valid.cpu(), wvalid)


@pytest.mark.parametrize("k", [4065, 5000, 7000])
def test_long_sequence_past_the_old_cap(rng, cuda, k):
    """``sp.hash_long_sequence`` at k an entry with a ring of power-of-two rows refused (4,065,
    5,000: now the entry) and past the entry's shared memory (7,000: the
    read kernel over pseudo-reads, ``hash_sequence_rows``): no raise, ==
    the plain route on the CPU."""
    seq = torch.from_numpy(rng.integers(0, 6, size=k + 3000,
                                        dtype=np.uint8))
    codes = sp.shard_sequence(seq, k=k)
    entry = kmer_kernel.sequence_fits(k, 2)
    assert entry == (k < 7000)
    before = kmer_kernel.SEQUENCE_LAUNCHES
    got, valid = sp.hash_long_sequence(codes.to(cuda), k, 2)
    assert kmer_kernel.SEQUENCE_LAUNCHES == before + entry
    want, wvalid = sp.hash_long_sequence(codes, k, 2, engine="torch")
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert torch.equal(valid.cpu(), wvalid)


@pytest.mark.parametrize("k", [4100, 7000])
def test_nthash_kernel_engine_large_k(rng, cuda, k):
    """``NtHash(engine="kernel")`` on the card at k = 4,100 (the entry) and
    7,000 (``hash_sequence_rows``) == the same class on the CPU (the plain
    route): every position, hash, fwd and rev."""
    from nthash_tpu_torch import NtHash

    seq = rng.integers(0, 4, size=k + 600, dtype=np.uint8)
    seq[k + 300 + rng.integers(0, 300, size=3)] = 4   # windows past 300 hold N

    def walk(device):
        it = NtHash(seq, 3, k, engine="kernel", device=device)
        rows = []
        while it.roll():
            rows.append((it.get_pos(), it.get_forward_hash(),
                         it.get_reverse_hash(), it.hashes().copy()))
        return rows

    got, want = walk(cuda), walk("cpu")
    assert len(got) == len(want) > 0
    for (p, f, r, h), (wp, wf, wr, wh) in zip(got, want):
        assert p == wp and f == wf and r == wr and np.array_equal(h, wh)


def test_seeds_past_the_entry_on_card(rng, cuda):
    """``sp.hash_long_sequence_seeds`` with seeds ``sequence_fits`` rejects
    (1,200 care runs) takes B1 over pseudo-reads on the card: no raise, ==
    the plain route."""
    seeds = ("10" * 1200,)
    assert not seed_kernel.sequence_fits(seeds, 1)
    seq = torch.from_numpy(rng.integers(0, 6, size=6000, dtype=np.uint8))
    codes = sp.shard_sequence(seq, k=2400)
    before = seed_kernel.SEQUENCE_LAUNCHES
    got, valid = sp.hash_long_sequence_seeds(codes.to(cuda), seeds, 1)
    assert seed_kernel.SEQUENCE_LAUNCHES == before
    want, wvalid = sp.hash_long_sequence_seeds(codes, seeds, 1,
                                               engine="torch")
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert torch.equal(valid.cpu(), wvalid)


BLIND_SEEDS = [("10101", "11011"), ("110100110011001011",
                                    "111111000000111111")]


def _registers_kernel_agrees(state, chars, seeds, h, want, final):
    """blind.cu's kernel with a thread's values in registers, forced
    (``warps=0``; the route for seed sets too large to stage), == plain."""
    from nthash_tpu_torch.ops import blind_kernel

    out, fwd, rev, window = blind_kernel.launch(
        chars, state.window, state.fwd, state.rev, seeds, h, warps=0)
    torch.cuda.synchronize()
    walks = chars.shape[1]
    assert torch.equal(out, want) and torch.equal(window, final.window)
    assert torch.equal(fwd, final.fwd.reshape(walks, -1))
    assert torch.equal(rev, final.rev.reshape(walks, -1))


@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("steps", [0, 1, 4, 5, 6, 257])
@pytest.mark.parametrize("walks", [1, 31, 33, 4097])
def test_blind_roll_many_vs_plain(rng, cuda, walks, steps, h):
    """roll_many through csrc/blind.cu against the step loop, k-mers at
    k = 1, 5, 32 and 97 and two seed sets, every hash and the final state; codes
    outside 0-3 in the windows and the stream."""
    from nthash_tpu_torch.ops import blind_scan as bs
    from nthash_tpu_torch.ops import blind_seed_scan as bss

    for k in (1, 5, 32, 97):
        w = torch.from_numpy(rng.integers(-1, 6, size=(walks, k))
                             .astype(np.int32)).to(cuda)
        chars = torch.from_numpy(rng.integers(0, 6, size=(steps, walks))
                                 .astype(np.uint8)).to(cuda)
        st = bs.init_state(w)
        before = bs.LAUNCHES
        a, ha = bs.roll_many(st, chars, h)
        assert bs.LAUNCHES == before + 1
        b, hb = bs.roll_many_plain(st, chars, h)
        torch.cuda.synchronize()
        assert torch.equal(ha, hb)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        _registers_kernel_agrees(st, chars, ("1" * k,), h, hb, b)
    for seeds in BLIND_SEEDS:
        k = len(seeds[0])
        w = torch.from_numpy(rng.integers(0, 5, size=(walks, k))
                             .astype(np.int32)).to(cuda)
        chars = torch.from_numpy(rng.integers(0, 5, size=(steps, walks))
                                 .astype(np.int32)).to(cuda)
        st = bss.init_state(w, seeds)
        before = bss.LAUNCHES
        a, ha = bss.roll_many(st, chars, seeds, h)
        assert bss.LAUNCHES == before + 1
        b, hb = bss.roll_many_plain(st, chars, seeds, h)
        torch.cuda.synchronize()
        assert torch.equal(ha, hb)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        _registers_kernel_agrees(st, chars, seeds, h, hb, b)


def test_dbg_walks_replayed_through_roll_many(cuda):
    """The DBG probe at 2**20 walks of 64 steps, k=32, h=4 (``peek4`` ->
    ``contains`` on a 2**30-bit filter of a 2**25-base genome -> argmax ->
    ``roll_select``): the chosen bases replayed through ``roll_many`` (one
    launch) equal its plain version and the walked state."""
    from nthash_tpu_torch.ops import blind_scan as bs

    k, h, wl, walks, steps = 32, 4, 30, 1 << 20, 64
    gen = torch.Generator(device=cuda).manual_seed(29)
    genome = torch.randint(0, 4, (1 << 25,), dtype=torch.uint8, device=cuda,
                           generator=gen)
    ghash, gvalid = kmer_kernel.hash_sequence(genome, k, h)
    bf = bloom.insert(bloom.BloomFilter.zeros(wl, cuda),
                      torch.stack(ghash, -1), gvalid, wl)
    del ghash, gvalid
    starts = torch.randint(0, genome.numel() - k - steps, (walks,),
                           device=cuda, generator=gen)
    state0 = bs.init_state(genome[starts[:, None]
                                  + torch.arange(k, device=cuda)])
    state = state0
    choices = torch.empty((steps, walks), dtype=torch.int32, device=cuda)
    for t in range(steps):
        hit = bloom.contains(bf, bs.peek4(state, h), wl)
        choices[t] = torch.argmax(hit.to(torch.int8), dim=1)
        state = bs.roll_select(state, choices[t])
    before = bs.LAUNCHES
    replay, rhash = bs.roll_many(state0, choices, h)
    assert bs.LAUNCHES == before + 1
    plain, phash = bs.roll_many_plain(state0, choices, h)
    torch.cuda.synchronize()
    assert torch.equal(rhash, phash)
    assert all(torch.equal(x, y) for x, y in zip(replay, plain))
    assert all(torch.equal(x, y) for x, y in zip(replay, state))
    assert torch.equal(rhash[-1], bs.hashes_of(state, h))


def test_facade_on_the_card_vs_oracle(rng, cuda):
    """NtHash and SeedNtHash with engine="kernel" on the card: tiles of
    4,096 windows through the one-sequence entries (launches counted), every
    visited window equal to the host oracle, across tile boundaries."""
    from nthash_tpu_torch import NtHash, SeedNtHash, oracle

    codes = rng.integers(0, 4, size=20_000, dtype=np.uint8)
    codes[rng.random(20_000) < 0.01] = 4
    k = 21
    _, _, want, valid = oracle.hash_all_windows(codes, k, 3)
    before = kmer_kernel.SEQUENCE_LAUNCHES
    nth = NtHash(codes, 3, k, engine="kernel", device=cuda, tile_windows=4096)
    seen = [(nth.get_pos(), row.copy()) for row in nth]
    assert kmer_kernel.SEQUENCE_LAUNCHES > before
    assert [p for p, _ in seen] == np.nonzero(valid)[0].tolist()
    assert all(np.array_equal(r, want[p]) for p, r in seen)
    seeds = ("10101", "11011")
    _, _, swant = oracle.hash_all_windows_seeds(codes[:9000], seeds, 2)
    before = seed_kernel.SEQUENCE_LAUNCHES
    snt = SeedNtHash(codes, seeds, 2, 5, engine="kernel", device=cuda,
                     tile_windows=4096)
    while snt.roll() and snt.get_pos() < 9000 - 4:
        assert np.array_equal(snt.hashes(), swant[snt.get_pos()])
    assert seed_kernel.SEQUENCE_LAUNCHES > before


@pytest.mark.parametrize("seeds", [("0000", "1001"), ("0000",)])
def test_seeds_without_care_positions_on_card(rng, cuda, seeds):
    """A seed with no care position on the card: SeedNtHash with
    engine="kernel" (tiles of 1,024 windows) against the host oracle engine,
    window by window, and sp.hash_long_sequence_seeds on a CUDA tensor
    against the CPU; such a seed hashes to 0 in every window."""
    from nthash_tpu_torch import SeedNtHash

    codes = rng.integers(0, 4, size=5000, dtype=np.uint8)
    codes[rng.random(5000) < 0.02] = 4

    def walk(h):
        out = []
        while h.roll():
            out.append((h.get_pos(), h.hashes().tolist(),
                        h.get_forward_hash().tolist(),
                        h.get_reverse_hash().tolist()))
        return out

    got = walk(SeedNtHash(codes, seeds, 2, 4, engine="kernel", device=cuda,
                          tile_windows=1024))
    want = walk(SeedNtHash(codes, seeds, 2, 4, engine="oracle",
                           device="cpu"))
    assert got and got == want
    zero = [i for i, s in enumerate(seeds) if "1" not in s]
    assert all(h[2 * i:2 * i + 2] == [0, 0] and f[i] == r[i] == 0
               for _, h, f, r in got for i in zero)
    seq = torch.from_numpy(codes)

    def run(x):
        return sp.hash_long_sequence_seeds(sp.shard_sequence(x, k=4), seeds,
                                           2)

    hashes, valid = run(seq.to(cuda))
    whashes, wvalid = run(seq)
    assert len(hashes) == len(whashes) == 2 * len(seeds)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(hashes, whashes))
    assert torch.equal(valid.cpu(), wvalid)
    assert not any(hashes[2 * i + j].any() for i in zero for j in (0, 1))


@pytest.fixture
def nccl_mesh(tmp_path, cuda):
    """A real NCCL group of world size 1 (a FileStore, no port) and its
    mesh; destroyed after the test."""
    import torch.distributed as dist

    from nthash_tpu_torch.parallel import mesh

    mesh.initialize_distributed("cuda", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        assert dist.get_backend() == "nccl"
        yield mesh.device_mesh(1)
    finally:
        dist.destroy_process_group()


def test_nccl_fused_count_vs_one_device(tmp_path, rng, cuda, nccl_mesh):
    """dp.fused_count (twice) and hash_and_sketch over the NCCL group of
    one equal the one-device steps, through the kernels; ``count_file``
    over the group equals the plain count."""
    from nthash_tpu_torch.parallel import dp

    codes = _codes(rng, 4096).to(cuda)
    want = cms.CountMinSketch.zeros(4, 20, cuda)
    got = cms.CountMinSketch.zeros(4, 20, cuda)
    for _ in range(2):
        fused_count_step(prepare_codes(codes), want, 32)
        before = (kmer_kernel.LAUNCHES, hist_kernel.LAUNCHES)
        dp.fused_count(dp.shard_reads(codes, nccl_mesh), got, 32, nccl_mesh)
        assert (kmer_kernel.LAUNCHES, hist_kernel.LAUNCHES) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(got.rows, want.rows)
    sk = cms.CountMinSketch.zeros(4, 14, cuda)
    hashes, valid, _ = dp.hash_and_sketch(codes, sk, 32, 4, 14, nccl_mesh,
                                          time_major=True)
    pipe = ReadHashingPipeline(PipelineConfig(sketch_width_log2=14),
                               device=cuda)
    assert pipe.mesh is not None and pipe.n_devices == 1
    reads = rng.integers(0, 5, size=(3000, 150)).astype(np.uint8)
    path = _write_fastq(tmp_path / "reads.fq", reads)
    assert pipe.count_file(path, batch_size=1024) == 3000
    assert torch.equal(pipe.sketch.rows.long(), _plain_count(reads, 14,
                                                              cuda)[0])
    one = cms.CountMinSketch.zeros(4, 14, cuda)
    wh, wv, _ = dp.hash_and_sketch(codes, one, 32, 4, 14, None,
                                   time_major=True)
    assert all(torch.equal(a, b) for a, b in zip(hashes, wh))
    assert torch.equal(valid, wv) and torch.equal(sk.rows, one.rows)


@pytest.mark.parametrize("k", [1, 32, 97])
def test_nccl_union_and_sequence_vs_one_device(rng, cuda, nccl_mesh, k):
    from nthash_tpu_torch.parallel.mesh import SEQ_AXIS, device_mesh

    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=1 << 15,
                                          dtype=np.int64).astype(np.int32))
    got = bloom.union_across(words.to(cuda), nccl_mesh)
    assert got.is_cuda and torch.equal(got.cpu(), words)
    seq = torch.from_numpy(rng.integers(0, 5, size=100_003,
                                        dtype=np.uint8)).to(cuda)
    seq_mesh = device_mesh(1, SEQ_AXIS)
    chunk = sp.shard_sequence(seq, seq_mesh, k=k)
    before = kmer_kernel.SEQUENCE_LAUNCHES
    hashes, valid = sp.hash_long_sequence(chunk, k, 2, seq_mesh)
    assert kmer_kernel.SEQUENCE_LAUNCHES == before + 1
    want, wvalid = sp.hash_long_sequence(sp.shard_sequence(seq, k=k), k, 2)
    assert all(torch.equal(a, b) for a, b in zip(hashes, want))
    assert torch.equal(valid, wvalid)


def _gloo_rank(rank, world, store, inputs, out):
    """One rank of a gloo group on the one card (CUDA tensors): its blocks
    of the reads counted by ``dp.fused_count`` at 2**20 and filtered at
    2**20 then united by ``union_across``, and its chunk of the sequence
    hashed over the mesh; saved to ``<out>.<rank>.npz`` with the launches."""
    import datetime

    import torch.distributed as dist

    from nthash_tpu_torch.parallel import dp, mesh

    dev = torch.device("cuda", 0)
    mesh.initialize_distributed(
        "cuda", backend="gloo", rank=rank, world_size=world,
        store=dist.FileStore(store, world),
        timeout=datetime.timedelta(seconds=120))
    try:
        reads = mesh.device_mesh()
        data = np.load(inputs)
        codes = data["codes"]
        sketch = cms.CountMinSketch.zeros(4, 20, dev)
        bf = bloom.BloomFilter.zeros(20, dev)
        before = (kmer_kernel.LAUNCHES, hist_kernel.LAUNCHES,
                  hist_kernel.BLOOM_LAUNCHES["bloom_words"],
                  kmer_kernel.SEQUENCE_LAUNCHES)
        for s in range(0, codes.shape[0], 4096):
            block = dp.shard_reads(torch.from_numpy(codes[s:s + 4096]),
                                   reads).to(dev)
            dp.fused_count(block, sketch, 32, reads)
            bloom.insert_from_buckets(bf, kmer_kernel.hash_kmers_tm_auto(
                prepare_codes(block), 32, 4, emit_buckets=20),
                emitted_width_log2=20)
        words = bloom.union_across(bf.words, reads)
        seq_mesh = mesh.device_mesh(axis=mesh.SEQ_AXIS)
        chunk = sp.shard_sequence(torch.from_numpy(data["seq"]).to(dev),
                                  seq_mesh, k=32)
        hashes, valid = sp.hash_long_sequence(chunk, 32, 1, seq_mesh)
        launches = np.array([after - b for after, b in zip(
            (kmer_kernel.LAUNCHES, hist_kernel.LAUNCHES,
             hist_kernel.BLOOM_LAUNCHES["bloom_words"],
             kmer_kernel.SEQUENCE_LAUNCHES), before)])
        np.savez(f"{out}.{rank}.npz", sketch=sketch.rows.cpu().numpy(),
                 words=words.cpu().numpy(), hashes=hashes[0].cpu().numpy(),
                 valid=valid.cpu().numpy(), launches=launches)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_groups_share_one_card(tmp_path, rng, cuda, monkeypatch, world):
    """gloo groups of 2 and 4 processes on the one card, on CUDA tensors:
    every rank's all-reduced sketch and united filter equal the one-device
    results over all the reads, and its chunk of the sequence (the halo by
    one all-gather) equals that slice of the one-device hashes; every rank
    launched the hash, histogram, presence-word and sequence kernels."""
    import torch.multiprocessing as mp

    codes = rng.integers(0, 5, size=(3 * 4096 + 100, 150)).astype(np.uint8)
    seq = rng.integers(0, 5, size=1 << 20).astype(np.uint8)
    np.savez(tmp_path / "inputs.npz", codes=codes, seq=seq)
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    mp.spawn(_gloo_rank, args=(world, str(tmp_path / "store"),
                               str(tmp_path / "inputs.npz"),
                               str(tmp_path / "out")), nprocs=world)
    want = cms.CountMinSketch.zeros(4, 20, cuda)
    fused_count_step(prepare_codes(torch.from_numpy(codes).to(cuda)), want,
                     32)
    bf = bloom.insert_from_buckets(
        bloom.BloomFilter.zeros(20, cuda), kmer_kernel.hash_kmers_tm_auto(
            prepare_codes(torch.from_numpy(codes).to(cuda)), 32, 4,
            emit_buckets=20), emitted_width_log2=20)
    hashes, valid = sp.hash_long_sequence(torch.from_numpy(seq).to(cuda),
                                          32, 1)
    c = seq.size // world
    for rank in range(world):
        got = np.load(tmp_path / f"out.{rank}.npz")
        assert np.array_equal(got["sketch"], want.rows.cpu().numpy())
        assert np.array_equal(got["words"], bf.words.cpu().numpy())
        assert np.array_equal(got["hashes"],
                              hashes[0][rank * c:(rank + 1) * c].cpu().numpy())
        assert np.array_equal(got["valid"],
                              valid[rank * c:(rank + 1) * c].cpu().numpy())
        assert got["launches"][3] == 1 and (got["launches"] > 0).all()


# ----------------------------------- the binned routes (A2 and C1) ----


def _binned_edges(rng, rows, wl, rl, cuda):
    """(label, idx) edge shapes at 2**wl with ranges of 2**rl."""
    width = 1 << wl
    top = min(width + 3, (1 << 31) - 1)

    def rand(n, lo=-3, hi=top):
        return torch.from_numpy(rng.integers(lo, hi, size=(rows, n))
                                .astype(np.int32)).to(cuda)

    hot = rand(100_001)
    hot[:, ::8] = 777
    return ([(f"n={n}", rand(n)) for n in (1, 7, 1000, 8193, 65_541)]
            + [("unaligned", rand(65_542)[:, 1:]),
               # more tiles a row than the scatter's blocks hold in their
               # rings at once (132 SMs x 2 slots of 16K), each row off a
               # 16-byte boundary: the loop wraps, with a head and a tail
               ("unaligned, wrapping", rand(6_000_002)[:, 1:]),
               ("one range", rand(20_001, width - (1 << rl),
                                  min(width, (1 << 31) - 1))),
               ("one value", torch.full((rows, 20_001), 12345,
                                        dtype=torch.int32, device=cuda)),
               ("sentinel", torch.full((rows, 20_001),
                                       width if wl < 31 else -1,
                                       dtype=torch.int32, device=cuda)),
               ("hot", hot)])


def _bins_match(idx, weight, wl, rl, per=4096):
    """The kernel's binning pass, by the rule's scatter body
    (``SCATTER_ROUTE_LAUNCHES``; ``BIN_COUNT_LAUNCHES`` for the "runs"
    body only), against the plain one: counts, starts and blocks equal,
    each range's offsets equal as a multiset (:func:`hist_kernel.staged`).
    "runs": every range's cursor ended at the next range's start, and
    meta's row length word is 0. "sectors": range g took its pages
    [0, ``range_pages``) and none past them, each page of the pool once,
    the pages taken that meta counts (its word after the claims) are their
    sum, within ``page_pool``'s, and meta's row length word is the page
    table's."""
    body = hist_kernel.scatter_body(wl, rl)
    name = "bloom" if rl == hist_kernel.WORDS_RANGE_LOG2 else "histogram"
    before = (dict(hist_kernel.SCATTER_ROUTE_LAUNCHES),
              dict(hist_kernel.BIN_COUNT_LAUNCHES))
    got = hist_kernel.bin_ranges(idx, weight, wl, rl, per)
    before[0][body] += 1
    before[1][name] += body == "runs"
    assert (hist_kernel.SCATTER_ROUTE_LAUNCHES,
            hist_kernel.BIN_COUNT_LAUNCHES) == before
    want = hist_kernel.bin_ranges_plain(idx, weight, wl, rl, per)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    nranges = got.counts.numel()
    meta = torch.empty(0, dtype=torch.int64, device=idx.device).set_(
        got.counts.untyped_storage())
    if body == "runs":
        assert got.pages is None and int(meta[6 * nranges + 4]) == 0
        assert torch.equal(meta[2 * nranges + 1:3 * nranges + 1],
                           want.starts[1:])
    else:
        need = hist_kernel.range_pages(want.counts, per)
        pool, most = hist_kernel.page_pool(*idx.shape, nranges, per)
        assert got.pages.shape == (nranges, most)
        assert int(meta[6 * nranges + 4]) == most
        page = torch.arange(most, device=idx.device)
        assert torch.equal(got.pages > 0, page < need[:, None])
        taken = got.pages[got.pages > 0].long()
        assert int(meta[6 * nranges + 2]) == int(need.sum()) \
            == taken.numel() <= pool
        assert torch.equal(torch.sort(taken).values,
                           torch.arange(1, taken.numel() + 1,
                                        device=idx.device))
    rid = torch.repeat_interleave(
        torch.arange(want.counts.numel(), device=idx.device), want.counts)
    mask = (1 << rl) - 1
    assert torch.equal(
        torch.sort((rid << rl) | (hist_kernel.staged(got).long()
                                  & mask)).values,
        torch.sort((rid << rl) | (want.stage.long() & mask)).values)


@pytest.mark.parametrize("wl,rows", [(16, 4), (20, 4), (21, 3), (24, 4),
                                     (25, 4), (27, 1)])
def test_binned_histogram_vs_plain_and_direct(rng, cuda, wl, rows):
    """The binned A2 route, forced, against plain and direct atomics on
    whole tables at the edge shapes, with a gate of 0 and 1 into an
    accumulating ``out``; one binning and one range launch a call."""
    for what, idx in _binned_edges(rng, rows, wl, 15, cuda):
        before = (hist_kernel.BIN_LAUNCHES["histogram"],
                  hist_kernel.RANGE_LAUNCHES["histogram"])
        got = hist_kernel._launch(idx, None, wl, None, None, route="binned")
        assert (hist_kernel.BIN_LAUNCHES["histogram"],
                hist_kernel.RANGE_LAUNCHES["histogram"]) == (
                    before[0] + 1, before[1] + 1)
        want = histogram_rows_plain(idx, None, wl)
        direct = hist_kernel._launch(idx, None, wl, None, None,
                                     route="direct")
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(direct, want), what
        _bins_match(idx, None, wl, 15)
    base = torch.from_numpy(rng.integers(-2**31, 2**31, size=(rows, 1 << wl),
                                         dtype=np.int64).astype(np.int32))
    for g in (0, 1):
        gate = torch.full((1,), g, dtype=torch.int32, device=cuda)
        got = hist_kernel._launch(idx, None, wl, gate, base.to(cuda),
                                  route="binned")
        want = histogram_rows_plain(idx, None, wl, gate=gate,
                                    out=base.to(cuda))
        assert torch.equal(got, want)


@pytest.mark.parametrize("wl,rows", [(21, 1), (22, 3), (25, 1), (30, 1),
                                     (31, 1)])
def test_binned_words_vs_plain_and_direct(rng, cuda, wl, rows):
    """The binned C1 route, forced, against plain and direct atomics on
    whole words at the edge shapes, weighted (one row), with a gate of 0
    and 1 into words that already hold bits."""
    for what, idx in _binned_edges(rng, rows, wl, 20, cuda):
        weights = [None]
        if rows == 1:
            weights.append(torch.from_numpy(rng.integers(
                -1, 2, size=idx.shape[1]).astype(np.int32)).to(cuda))
        for w in weights:
            got = hist_kernel._words_launch(idx, w, wl, None, None,
                                            "bloom_words", route="binned")
            want = hist_kernel._words_plain(idx, w, wl, None, None)
            direct = hist_kernel._words_launch(idx, w, wl, None, None,
                                               "bloom_words", route="direct")
            torch.cuda.synchronize()
            assert torch.equal(got, want) and torch.equal(direct, want), what
            _bins_match(idx, w, wl, 20)
    base = torch.from_numpy(rng.integers(-2**31, 2**31,
                                         size=(rows, (1 << wl) // 32),
                                         dtype=np.int64).astype(np.int32))
    for g in (0, 1):
        gate = torch.full((1,), g, dtype=torch.int32, device=cuda)
        got = hist_kernel._words_launch(idx, None, wl, gate, base.to(cuda),
                                        "bloom_words", route="binned")
        want = hist_kernel._words_plain(idx, None, wl, gate, base.to(cuda))
        assert torch.equal(got, want)


@pytest.mark.parametrize("wl,rows", [(26, 4), (27, 4), (28, 4), (28, 1)])
def test_clustered_histogram_vs_plain(rng, cuda, wl, rows):
    """The clustered A2 route at 4 x 2**26..2**28 and 1 x 2**28, forced,
    against plain on whole tables at the edge shapes (n below the 4,096
    ranges, a row off a 16-byte boundary, every update in the last range,
    every update one value, sentinel-only rows, a hot counter), a uniform
    batch of one main-path batch's 124,780,544 updates, and a range with
    one offset 75,001 times a row (two chunks, a count past 65,535); one
    binning, one range pass and one ``ROUTE_LAUNCHES["clustered"]`` a
    call; a gate of 0 and 1 into an accumulating ``out``; and the rule's
    own choice for a call of 2**24 updates."""
    rl = hist_kernel.counts_range_log2(rows, wl)
    assert 16 <= rl <= 18
    width = 1 << wl
    hot = torch.randint(0, width, (rows, 150_002), device=cuda,
                        dtype=torch.int32)
    hot[:, 1::2] = width - (1 << rl) + (1 << 15) + 5
    bins = hist_kernel.bin_ranges(hot, None, wl, rl,
                                  hist_kernel.CLUSTERED_RANGE_ENTRIES)
    assert int(bins.counts.max()) > bins.per  # the hot range takes 2 chunks
    del bins
    cases = _binned_edges(rng, rows, wl, rl, cuda) + [
        ("uniform batch", torch.randint(0, width, (rows, 124_780_544 // rows),
                                        device=cuda, dtype=torch.int32)),
        ("hot range", hot)]
    for what, idx in cases:
        before = (hist_kernel.BIN_LAUNCHES["histogram"],
                  hist_kernel.RANGE_LAUNCHES["histogram"],
                  hist_kernel.ROUTE_LAUNCHES["clustered"])
        got = hist_kernel._launch(idx, None, wl, None, None,
                                  route="clustered")
        assert (hist_kernel.BIN_LAUNCHES["histogram"],
                hist_kernel.RANGE_LAUNCHES["histogram"],
                hist_kernel.ROUTE_LAUNCHES["clustered"]) == tuple(
                    b + 1 for b in before), what
        want = histogram_rows_plain(idx, None, wl)
        torch.cuda.synchronize()
        assert torch.equal(got, want), what
        del got, want
    base = torch.randint(-2**31, 2**31 - 1, (rows, 1 << wl), device=cuda,
                         dtype=torch.int32)
    for g in (0, 1):
        gate = torch.full((1,), g, dtype=torch.int32, device=cuda)
        got = hist_kernel._launch(idx, None, wl, gate, base.clone(),
                                  route="clustered")
        want = histogram_rows_plain(idx, None, wl, gate=gate,
                                    out=base.clone())
        assert torch.equal(got, want)
        del got, want
    del base
    idx = torch.randint(0, 1 << wl, (rows, (1 << 24) // rows), device=cuda,
                        dtype=torch.int32)
    before = hist_kernel.ROUTE_LAUNCHES["clustered"]
    got = histogram_rows(idx, None, wl)
    assert hist_kernel.ROUTE_LAUNCHES["clustered"] == before + 1
    assert torch.equal(got, histogram_rows_plain(idx, None, wl))


def _genome_batch(cuda, seed=2024, n=1 << 18, length=150):
    """uint8 [n, length] codes of reads from a random genome of E. coli's
    length (4,641,652 bases), at uniform starts on either strand, with 0.25%
    substitutions: the benchmark cells' kind of batch."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    genome = torch.randint(0, 4, (4_641_652,), generator=gen, device=cuda,
                           dtype=torch.uint8)
    start = torch.randint(0, genome.numel() - length + 1, (n, 1),
                          generator=gen, device=cuda)
    reads = genome[start + torch.arange(length, device=cuda)]
    minus = torch.rand(n, generator=gen, device=cuda) < 0.5
    reads = torch.where(minus[:, None], (3 - reads).flip(1), reads)
    sub = torch.rand((n, length), generator=gen, device=cuda) < 0.0025
    shift = torch.randint(1, 4, (n, length), generator=gen, device=cuda,
                          dtype=torch.uint8)
    return torch.where(sub, (reads + shift) % 4, reads)


def _kernels_run(fn):
    """Names of the kernels the device ran over ``fn()`` and a sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA}


@pytest.mark.parametrize("wl,rows,rl", [(28, 4, 18), (30, 1, 20)])
def test_bin_ranges_at_the_cells_shapes(cuda, wl, rows, rl):
    """The binning pass at the benchmark cells' shapes, on one batch of
    2**18 genome reads hashed at k=32 into 4 hashes: the count-min cell's
    [4, n] buckets at 2**28 (ranges of 2**18 counters) and the Bloom cell's
    one stream at 2**30 (ranges of 2**20 bits), against the plain pass, in
    chunks of 4,096 and of the route's own ``per`` (pages of 2**16 - 8 and
    2**17 entries); then the whole route the rule takes there (the
    clustered histogram, the binned words) against the plain version and
    direct atomics, with no ``bin_count_kernel`` on the device and
    ``BIN_COUNT_LAUNCHES`` unmoved."""
    tm = prepare_codes(_genome_batch(cuda))
    idx = hist_kernel.rows_view(hash_kmers_tm(tm, 32, 4, emit_buckets=wl))
    del tm
    idx = idx.reshape(rows, -1)
    assert idx.shape[1] == (1 << 20) * 119 // rows
    assert hist_kernel.scatter_body(wl, rl) == "sectors"
    before = dict(hist_kernel.BIN_COUNT_LAUNCHES)
    if rows == 4:
        kind, per, _ = hist_kernel._counts_route(rows, idx.shape[1], wl,
                                                 False, None)
        assert kind == "clustered"
        got, kernels = _kernels_run(lambda: histogram_rows(idx, None, wl))
        want = histogram_rows_plain(idx, None, wl)
        direct = hist_kernel._launch(idx, None, wl, None, None,
                                     route="direct")
    else:
        kind, per, _ = hist_kernel._words_route_of(rows, idx.shape[1], wl,
                                                   None)
        assert kind == "binned"
        got, kernels = _kernels_run(lambda: hist_kernel._words_launch(
            idx, None, wl, None, None, "bloom_words"))
        want = hist_kernel._words_plain(idx, None, wl, None, None)
        direct = hist_kernel._words_launch(idx, None, wl, None, None,
                                           "bloom_words", route="direct")
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(direct, want)
    assert hist_kernel.BIN_COUNT_LAUNCHES == before
    assert any("bin_scatter_kernel" in k for k in kernels), kernels
    assert not any("bin_count_kernel" in k for k in kernels), kernels
    del got, want, direct
    for chunk in (4096, per):
        _bins_match(idx, None, wl, rl, chunk)


def _skews(cuda, rows, wl, rl, n):
    """(label, idx [rows, n]) at the "sectors" body's worst splits: every
    update in one range (many pages), every range but one empty with
    sentinels and out-of-range buckets beside it, one range per row
    holding all but a scattered few, n a multiple of no tile or page."""
    width = 1 << wl
    last = width - (1 << rl)
    gen = torch.Generator(device=cuda).manual_seed(wl)

    def rand(lo, hi):
        return torch.randint(lo, hi, (rows, n), generator=gen, device=cuda,
                             dtype=torch.int32)

    junk = rand(-3, 3)
    junk[junk >= 0] = width + junk[junk >= 0] if wl < 31 else -1
    one = rand(last, width)
    one[:, ::3] = junk[:, ::3]
    few = rand(last, width)
    few[:, ::1000] = rand(0, width)[:, ::1000]
    return [("one range", rand(last, width)),
            ("one range among sentinels", one),
            ("one value", torch.full((rows, n), last + 5, dtype=torch.int32,
                                     device=cuda)),
            ("one range and a few others", few)]


@pytest.mark.parametrize("wl,rows,rl,route", [
    (28, 4, 18, "clustered"), (24, 4, 15, "binned"), (30, 1, 20, "words")])
def test_paged_bins_at_the_worst_skews(cuda, wl, rows, rl, route):
    """The "sectors" body's pages at the worst splits (:func:`_skews`),
    each hot range spanning many pages, with the route's own chunks: the
    pass against the plain one (:func:`_bins_match`) and the whole route,
    forced, bit for bit against the plain version."""
    assert hist_kernel.scatter_body(wl, rl) == "sectors"
    for what, idx in _skews(cuda, rows, wl, rl, 3_000_017):
        n = idx.shape[1]
        if route == "words":
            per = hist_kernel._words_route_of(rows, n, wl, "binned")[1]
            got = hist_kernel._words_launch(idx, None, wl, None, None,
                                            "bloom_words", route="binned")
            want = hist_kernel._words_plain(idx, None, wl, None, None)
        else:
            per = hist_kernel._counts_route(rows, n, wl, False, route)[1]
            got = hist_kernel._launch(idx, None, wl, None, None, route=route)
            want = histogram_rows_plain(idx, None, wl)
        torch.cuda.synchronize()
        assert torch.equal(got, want), what
        del got, want
        bins = hist_kernel.bin_ranges(idx, None, wl, rl, per)
        assert int(hist_kernel.range_pages(bins.counts, per).max()) > 10, \
            what
        del bins
        _bins_match(idx, None, wl, rl, per)


@pytest.mark.parametrize("wl,rows,rl", [(28, 4, 18), (24, 4, 15),
                                        (30, 1, 20), (20, 4, 15)])
def test_bin_refuses_short_scratch(cuda, wl, rows, rl):
    """The binning pass's C entry sizes its scratch itself (bin.cuh's
    scratch()): meta and a stage of the words and entries ``_bin_launch``
    gives pass, and one word or one entry fewer is refused
    (cudaErrorInvalidValue) before anything is launched, on both bodies
    and at chunks shorter than a tile (pages of several chunks)."""
    n = 300_007
    idx = torch.randint(0, 1 << wl, (rows, n), device=cuda,
                        dtype=torch.int32)
    nranges = hist_kernel.binned_ranges(rows, wl, rl)
    name = "bloom" if rl == hist_kernel.WORDS_RANGE_LOG2 else "histogram"
    lib = hist_kernel._lib() if name == "histogram" \
        else hist_kernel._bloom_lib()
    dtype = hist_kernel._stage_dtype(rl)
    for per in (4096, hist_kernel.BINNED_RANGE_ENTRIES):
        pool, most = 0, 0
        if hist_kernel.scatter_body(wl, rl) == "sectors":
            pool, most = hist_kernel.page_pool(rows, n, nranges, per)
        words = 6 * nranges + 5 + -(-nranges * most // 2)
        entries = pool * hist_kernel.page_entries(per) if pool \
            else rows * n
        for short_words, short_entries, ok in ((0, 0, True), (1, 0, False),
                                               (0, 1, False)):
            meta = torch.empty(words, dtype=torch.int64, device=cuda)
            stage = torch.empty(entries, dtype=dtype, device=cuda)
            args = [cuda.index or 0, idx.data_ptr(), rows, n]
            args += ([None, wl] if name == "bloom" else [wl, rl])
            status = getattr(lib, f"nthash_{name}_bin")(
                *args, per, meta.data_ptr(), words - short_words,
                stage.data_ptr(), entries - short_entries, None,
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            assert (status == 0) == ok, (per, short_words, short_entries,
                                         status)


def test_binned_is_the_rule_on_the_wide_paths(rng, cuda):
    """The rule bins A2 at 2**20 and C1 at 2**30 for a full batch, and the
    wrappers take it: one binning and one range launch a call."""
    idx = torch.randint(0, 1 << 20, (4, 1 << 22), device=cuda,
                        dtype=torch.int32)
    before = dict(hist_kernel.ROUTE_LAUNCHES)
    got = histogram_rows(idx, None, 20)
    assert hist_kernel.ROUTE_LAUNCHES["binned"] == before["binned"] + 1
    assert torch.equal(got, histogram_rows_plain(idx, None, 20))
    stream = torch.randint(0, 1 << 30, (1 << 25,), device=cuda,
                           dtype=torch.int32)
    before = dict(hist_kernel.RANGE_LAUNCHES)
    got = hist_kernel.bloom_words(stream, None, 30)
    assert hist_kernel.RANGE_LAUNCHES["bloom"] == before["bloom"] + 1
    assert torch.equal(got, hist_kernel.bloom_words_plain(stream, None, 30))


def _host_spans(fn):
    """The ``nthash.`` host rows recorded over ``fn()`` and a sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.name.startswith("nthash.")
            and e.device_type != DeviceType.CUDA]


def test_layer_spans_on_card(tmp_path, rng, cuda):
    """On the card one ``nthash.hash`` and one ``nthash.histogram`` a
    batch (the planes are views of one output: one launch); the binned
    route's two host steps inside the histogram's span; count_file's
    copy and step a batch."""
    tms = [prepare_codes(_codes(rng, 512).to(cuda)) for _ in range(3)]
    sketch = cms.CountMinSketch.zeros(4, 20, cuda)
    names = _host_spans(lambda: [fused_count_step(tm, sketch, 21)
                                 for tm in tms])
    assert names.count("nthash.hash") == 3
    assert names.count("nthash.histogram") == 3
    idx = torch.from_numpy(rng.integers(0, 1 << 20, (2, 4096),
                                        dtype=np.int32)).to(cuda)
    names = _host_spans(lambda: hist_kernel._launch(idx, None, 20, None,
                                                    None, route="binned"))
    assert names == ["nthash.bin", "nthash.ranges"]
    path = tmp_path / "reads.fq"
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (600, 80))]
    with open(path, "wb") as f:
        for s in seqs:
            f.write(b"@r\n" + s.tobytes() + b"\n+\n" + b"I" * 80 + b"\n")
    pipe = ReadHashingPipeline(PipelineConfig(k=21, num_hashes=2,
                                              sketch_width_log2=14), cuda)
    names = _host_spans(lambda: pipe.count_file(path, batch_size=256))
    for span in ("nthash.copy", "nthash.step"):
        assert sorted(n for n in names if n.startswith(span + "#")) == [
            f"{span}#{i}" for i in range(3)]
    assert names.count("nthash.hash") == 3


def test_pinned_wait_span_on_card(tmp_path, cuda):
    """A producer that finds no free pinned buffer waits inside
    ``nthash.pinned.wait``, on its own thread, until the consumer copies
    the buffer it holds."""
    import json
    import threading
    import time

    from nthash_tpu_torch.io.pinned import PinnedBuffers

    with profiling.trace(tmp_path / "tr"), PinnedBuffers(cuda, 1) as pool:
        held = pool.arrays((64,))
        got = []
        t = threading.Thread(target=lambda: got.append(pool.arrays((64,))))
        t.start()
        time.sleep(0.05)
        pool.to_device(*held)
        t.join(timeout=30)
        assert not t.is_alive() and got
        torch.cuda.synchronize()
    (out,) = (tmp_path / "tr").glob("trace.*.json")
    waits = [e for e in json.loads(out.read_text())["traceEvents"]
             if e.get("name") == "nthash.pinned.wait"]
    assert waits and all(e["tid"] != threading.get_native_id()
                         for e in waits)


#: The screening configuration's spaced seeds (26 care positions each).
SCREEN_SEEDS = ("11101111110111011011101111110111",
                "11110111011110111101111011101111",
                "11111011111011100111011111011111",
                "11011110111101111110111101111011")


def _screen_filter(genome, seeds, h, wl):
    """A filter of ``genome``'s windows under ``seeds``, built as the
    screening cell builds it: rows of 256 windows through the seed kernels
    to buckets, then ``insert_from_buckets``."""
    bf = bloom.BloomFilter.zeros(wl, device=genome.device)
    rows = prepare_codes(kmer_kernel.sequence_rows(genome, len(seeds[0]),
                                                   256))
    return bloom.insert_from_buckets(
        bf, seed_kernel.hash_seeds_tm_auto(rows, seeds, h, emit_buckets=wl),
        emitted_width_log2=wl)


def test_probe_kernel_at_the_cell_width(cuda):
    """One batch of the screening cell: 2^18 reads of 150 bp, half of them
    windows of a genome of E. coli's length and half random, 0.1% N, 4
    seeds x 4 hashes against a 2^28-bit filter of the genome. The probe
    kernel's counts equal the plain version's on the same buckets,
    max_abs_err 0."""
    wl, h = 28, 4
    g = torch.Generator(device=cuda).manual_seed(2**31 + 21)
    genome = torch.randint(0, 4, (4641652,), generator=g, device=cuda,
                           dtype=torch.uint8)
    bf = _screen_filter(genome, SCREEN_SEEDS, h, wl)
    n = 1 << 18
    starts = torch.randint(0, genome.shape[0] - 150 + 1, (n, 1), generator=g,
                           device=cuda)
    reads = genome[starts + torch.arange(150, device=cuda)]
    reads[1::2] = torch.randint(0, 4, (n // 2, 150), generator=g,
                                device=cuda, dtype=torch.uint8)
    reads[torch.rand((n, 150), generator=g, device=cuda) < 0.001] = 4
    buckets = seed_kernel.hash_seeds_tm_auto(prepare_codes(reads),
                                             SCREEN_SEEDS, h, emit_buckets=wl)
    before = probe_kernel.LAUNCHES
    got = probe_kernel.probe_counts(buckets, bf.words, 4, h, wl)
    assert probe_kernel.LAUNCHES == before + 1
    want = probe_kernel.probe_counts_plain(buckets, bf.words, 4, h, wl)
    torch.cuda.synchronize()
    assert int((got - want).abs().max()) == 0
    genomic, rand = got[:, 0::2].float().mean(), got[:, 1::2].float().mean()
    assert genomic > 100 and rand < 1


@pytest.mark.parametrize("h", [1, 2, 3, 4, 5, 8, 9])
@pytest.mark.parametrize("s", [1, 3])
def test_probe_kernel_vs_plain(rng, cuda, s, h):
    """One to nine hashes a seed, each test stopping at the first zero bit,
    into a column slice of a wider tensor, with the sentinel, -1 and buckets
    past the width among the planes and words with bit 31 set; planes that
    are not views of one output take the stacked copy."""
    wl, w, r = 14, 37, 1001
    bits = rng.random(((1 << wl) // 32, 32)) < 0.85
    words = torch.from_numpy((bits * (1 << np.arange(32, dtype=np.int64)))
                             .sum(1).astype(np.uint32).view(np.int32))
    planes = rng.integers(0, 1 << wl, (s * h, w, r)).astype(np.int32)
    planes[rng.random(planes.shape) < 0.01] = 1 << wl
    planes[rng.random(planes.shape) < 0.01] = -1
    planes[rng.random(planes.shape) < 0.01] = (1 << wl) + 3
    planes = torch.from_numpy(planes)
    want = probe_kernel.probe_counts_plain(planes, words, s, h, wl)
    assert int(want.sum()) > 0
    wide = torch.full((s, r + 200), 7, dtype=torch.int32, device=cuda)
    view = wide[:, 100:100 + r]
    got = probe_kernel.probe_counts(planes.to(cuda), words.to(cuda), s, h,
                                    wl, out=view)
    assert got is view
    copied = probe_kernel.probe_counts(
        [p.clone() for p in planes.to(cuda)], words.to(cuda), s, h, wl)
    torch.cuda.synchronize()
    assert torch.equal(view.cpu(), 7 + want)
    assert bool((wide[:, :100] == 7).all() and (wide[:, 100 + r:] == 7).all())
    assert torch.equal(copied.cpu(), want)


@pytest.mark.parametrize("seeds, h, wl", [(SCREEN_SEEDS, 4, 20),
                                          (("10101", "11011"), 3, 12)])
def test_screen_reads_cuda_vs_cpu(rng, cuda, seeds, h, wl):
    """``screen_reads`` on the card (B1, then the probe kernel) counts what
    its CPU route counts, over a filter built on the card that equals the
    one built on the CPU."""
    genome = torch.from_numpy(rng.integers(0, 4, 5000, dtype=np.uint8))
    starts = rng.integers(0, 5000 - 150 + 1, 333)
    reads = genome[torch.from_numpy(starts[:, None] + np.arange(150))]
    reads[torch.from_numpy(rng.random(reads.shape) < 0.01)] = 4
    on_card = _screen_filter(genome.to(cuda), seeds, h, wl)
    on_cpu = _screen_filter(genome, seeds, h, wl)
    assert torch.equal(on_card.words.cpu(), on_cpu.words)
    before = probe_kernel.LAUNCHES, seed_kernel.LAUNCHES
    got = bloom.screen_reads(on_card, prepare_codes(reads.to(cuda)), seeds, h)
    assert (probe_kernel.LAUNCHES, seed_kernel.LAUNCHES) == (before[0] + 1,
                                                              before[1] + 1)
    want = bloom.screen_reads(on_cpu, prepare_codes(reads), seeds, h)
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) > 0


# The wide routes: int64 buckets into filters past 2**31 bits.


def _direct_buckets(codes, seeds, h, wl):
    """int64 bucket planes [W, R] of reads [R, L] by the direct engine
    (``seed_torch.hash_kmers_seeds``), the sentinel 2**wl where a window is
    not valid."""
    from nthash_tpu_torch.ops.seed_torch import hash_kmers_seeds

    res = hash_kmers_seeds(codes, seeds, h)
    return [torch.where(res.valid, res.hashes[..., i] & ((1 << wl) - 1),
                        1 << wl).T for i in range(len(seeds) * h)]


@pytest.mark.parametrize("wl", [12, 30])
@pytest.mark.parametrize("seeds", [SCREEN_SEEDS, ("10101", "11011"),
                                   ("10" * 500,)])
def test_wide_seed_buckets_vs_plain(rng, cuda, seeds, wl):
    """B1 and B3 forced wide, by the staged kernel's int64 instance and
    (500 care runs, which the staged kernel cannot hold) the global one's:
    the direct engine's buckets as int64 planes, and the narrow route's
    int32 planes widened."""
    k = len(seeds[0])
    codes = _codes(rng, 50 if k > 100 else 333, k + 119).to(cuda)
    tm = prepare_codes(codes)
    want = _direct_buckets(codes, seeds, 2, wl)
    if k < 100:
        _same(seed_kernel.hash_seeds_tm_plain(tm, seeds, 2, emit_buckets=wl,
                                              route="wide"), want)
    before = dict(seed_kernel.ROUTE_LAUNCHES)
    got = seed_kernel.hash_seeds_tm(tm, seeds, 2, emit_buckets=wl,
                                    route="wide")
    assert seed_kernel.ROUTE_LAUNCHES["wide"] == before["wide"] + 1
    _same(got, want)
    _same(seed_kernel.hash_seeds_tm_long(tm, seeds, 2, emit_buckets=wl,
                                         time_tile=k, route="wide"), want)
    narrow = seed_kernel.hash_seeds_tm(tm, seeds, 2, emit_buckets=wl)
    _same([n.long() for n in narrow], want)


@pytest.mark.parametrize("wl", [36, 37])
def test_wide_seed_buckets_at_the_cell_widths(cuda, wl):
    """One batch of 2**18 reads of 150 bp under the four seeds x 4 hashes
    at 2**36 and 2**37, by the width alone: int64 buckets equal to the
    plain version's on slices of the reads, values past 2**31 and the
    sentinel among them."""
    g = torch.Generator(device=cuda).manual_seed(2**31 + 36)
    reads = torch.randint(0, 4, (1 << 18, 150), generator=g, device=cuda,
                          dtype=torch.uint8)
    reads[torch.rand(reads.shape, generator=g, device=cuda) < 0.001] = 4
    tm = prepare_codes(reads)
    before = dict(seed_kernel.ROUTE_LAUNCHES)
    got = seed_kernel.hash_seeds_tm_auto(tm, SCREEN_SEEDS, 4, emit_buckets=wl)
    assert seed_kernel.ROUTE_LAUNCHES == {**before,
                                          "wide": before["wide"] + 1}
    flat = torch.stack(got)
    assert flat.dtype == torch.int64
    assert int((flat == 1 << wl).sum()) > 0
    assert int(flat[flat < 1 << wl].max()) >= 1 << (wl - 1)
    for lo in (0, 123_457, (1 << 18) - 4096):
        part = tm[:, lo:lo + 4096].contiguous()
        want = seed_kernel.hash_seeds_tm_plain(part, SCREEN_SEEDS, 4,
                                               emit_buckets=wl)
        _same([p[:, lo:lo + 4096] for p in got], want)


def _filter_of(genome, wl):
    """The screening seeds' filter of ``genome`` at 2**wl, built on the
    card by the chunked entry (B1's buckets, then C1)."""
    return bloom.insert_sequence_seeds(
        bloom.BloomFilter.zeros(wl, device=genome.device), genome,
        SCREEN_SEEDS, 4)


@pytest.mark.parametrize("wl", [36, 37])
def test_wide_probe_at_the_cell_widths(cuda, wl):
    """The wide probe at 2**36 and 2**37 (8 and 16 GiB of words, offsets
    past 2**31) over one batch of 2**18 genome reads, half of them random:
    its counts equal the plain version's on slices of the reads, reads of
    the genome hit and random reads do not. The filter is the plain
    build's, set by the wide C1 on the card."""
    g = torch.Generator(device=cuda).manual_seed(2**31 + wl)
    genome = torch.randint(0, 4, (3_000_000,), generator=g, device=cuda,
                           dtype=torch.uint8)
    before = hist_kernel.ROUTE_LAUNCHES["wide_words"]
    bf = _filter_of(genome, wl)
    assert hist_kernel.ROUTE_LAUNCHES["wide_words"] > before
    # set words in the upper half: offsets past 2**31 at 2**37
    assert int(torch.nonzero(bf.words[bf.words.numel() // 2:]).numel()) > 0
    n = 1 << 18
    starts = torch.randint(0, genome.shape[0] - 150 + 1, (n, 1), generator=g,
                           device=cuda)
    reads = genome[starts + torch.arange(150, device=cuda)]
    reads[1::2] = torch.randint(0, 4, (n // 2, 150), generator=g,
                                device=cuda, dtype=torch.uint8)
    reads[torch.rand((n, 150), generator=g, device=cuda) < 0.001] = 4
    tm = prepare_codes(reads)
    buckets = seed_kernel.hash_seeds_tm_auto(tm, SCREEN_SEEDS, 4,
                                             emit_buckets=wl)
    before = dict(probe_kernel.ROUTE_LAUNCHES)
    got = probe_kernel.probe_counts(buckets, bf.words, 4, 4, wl)
    assert probe_kernel.ROUTE_LAUNCHES == {**before,
                                           "wide": before["wide"] + 1}
    for lo in (0, 77_777, n - 8192):
        want = probe_kernel.probe_counts_plain(
            [b[:, lo:lo + 8192] for b in buckets], bf.words, 4, 4, wl)
        torch.cuda.synchronize()
        assert torch.equal(got[:, lo:lo + 8192], want)
    genomic, rand = got[:, 0::2].float().mean(), got[:, 1::2].float().mean()
    assert genomic > 100 and rand < 1
    counts = bloom.screen_reads(bf, tm, SCREEN_SEEDS, 4)
    assert torch.equal(counts, got)


def test_wide_words_direct_at_2_37(rng, cuda):
    """C1's wide route (direct atomics, 64-bit word offsets) at 2**37 into
    a 16 GiB filter: int64 buckets across the whole width, -1, the sentinel
    and values past it among them, weighted, OR-ed into existing words;
    the words equal the plain version's, slice by slice."""
    wl = 37
    idx = torch.from_numpy(rng.integers(0, 1 << wl, 2_000_003)).to(cuda)
    idx[:5] = torch.tensor([-1, 1 << wl, (1 << wl) + 3, (1 << wl) - 1, 0])
    w = torch.from_numpy(rng.integers(0, 3, 2_000_003, dtype=np.int32)).to(
        cuda)
    got = torch.zeros((1 << wl) // 32, dtype=torch.int32, device=cuda)
    got[::4096] = 0x10001
    want = got.clone()
    before = hist_kernel.ROUTE_LAUNCHES["wide_words"]
    hist_kernel.bloom_words(idx, w, wl, out=got)
    assert hist_kernel.ROUTE_LAUNCHES["wide_words"] == before + 1
    hist_kernel.bloom_words_plain(idx, w, wl, out=want)
    torch.cuda.synchronize()
    for a, b in zip(got.split(1 << 28), want.split(1 << 28)):
        assert torch.equal(a, b)
    assert int(torch.nonzero(got[1 << 31:] & ~0x10001).numel()) > 0
