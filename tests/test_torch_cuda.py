"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips (in a fixture, never at import)
where there is no GPU. Run them on a machine with one (``--noconftest``:
the suite's conftest imports JAX, which that machine need not have):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

``chip_smoke.py`` checks the same kernels at the main path's full size.
"""

import numpy as np
import pytest
import torch

from nthash_tpu_torch.models import sketch as cms
from nthash_tpu_torch.models.pipeline import (
    PipelineConfig,
    ReadHashingPipeline,
    fused_count_step,
)
from nthash_tpu_torch.ops import hist_kernel, kmer_kernel
from nthash_tpu_torch.ops.hist_kernel import histogram_rows, histogram_rows_plain
from nthash_tpu_torch.ops.kmer_kernel import (
    hash_kmers_tm,
    hash_kmers_tm_plain,
    prepare_codes,
)
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
    cfg = PipelineConfig(k=21, num_hashes=3, sketch_width_log2=12)
    gpu = ReadHashingPipeline(cfg, device=cuda)
    cpu = ReadHashingPipeline(cfg, device="cpu")
    assert gpu.count_file(path, batch_size=256) == 900
    assert cpu.count_file(path, batch_size=256) == 900
    assert torch.equal(gpu.sketch.rows.cpu(), cpu.sketch.rows)


def test_timeit_cuda_events(cuda):
    x = torch.ones(1 << 20, device=cuda)
    t = profiling.timeit(lambda y: y * 2, x, calls=5)
    assert len(t.samples) == 5 and t.seconds_per_call > 0
