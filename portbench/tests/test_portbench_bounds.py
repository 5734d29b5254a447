"""The byte counts at small shapes, the share's arithmetic, and the trace's
union, name matching and gaps."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench.core import bounds, trace


def test_hash_bytes():
    # 3 reads of 10 bases at k=4: 7 windows a read, 2 hashes
    assert bounds.windows(10, 4) == 7 and bounds.windows(3, 4) == 0
    assert bounds.hash_bytes(3, 10, 4, 2) == 3 * 10 + 4 * 2 * 3 * 7


def test_scatter_bytes_and_share():
    assert bounds.scatter_bytes(100, 7) == 400 + 56
    card = "NVIDIA H100 80GB HBM3"
    # 3.35e9 bytes in 2 ms at 3.35 TB/s is half the roofline
    assert bounds.share(3.35e9, 2e-3, card) == pytest.approx(50.0)
    assert bounds.share(1.0, 0.0, card) is None
    assert bounds.hbm_bytes_per_s("another card") == 3.35e12


def test_merged():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert trace.merged(spans) == [(0.0, 2.0), (3.0, 4.0)]


def event(name, start_us, end_us, device=True, annotation=False):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start_us, end=end_us))


def test_summarize():
    events = [
        event("void nthash_bin::bin_count_kernel<int>(int const*)", 0, 100),
        event("(anonymous namespace)::kmer_hash_kernel<true, false>(int)",
              100, 300),
        event("Memcpy HtoD (Pinned -> Device)", 250, 400),
        event("nccl:all_reduce", 0, 1000, annotation=True),
        event("Activity Buffer Request", 0, 5000),
        event("kmer_hash_kernel2(int)", 1000, 1100),
        event("cudaDeviceSynchronize", 400, 1000, device=False),
        event("aten::add_", 1100, 1500, device=False),
    ]
    tr = trace.summarize(SimpleNamespace(events=lambda: events), 2.0)
    assert tr.busy_s == pytest.approx(500e-6)
    assert tr.seconds_of(["kmer_hash_kernel"]) == pytest.approx(200e-6)
    assert tr.seconds_of(["bin_count_kernel", "kmer_hash_kernel2"]) == \
        pytest.approx(200e-6)
    assert "nccl:all_reduce" not in tr.by_name
    assert tr.gaps == [("cudaDeviceSynchronize", pytest.approx(600e-6))]
    assert tr.top_ops(1)[0][1] == pytest.approx(200e-6)
    assert len(trace.short("x" * 500)) == 160
