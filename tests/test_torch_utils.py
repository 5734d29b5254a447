"""The port's timing harness and logging (CPU paths)."""

import logging

import torch

from nthash_tpu_torch.utils import metrics, profiling


def test_timeit_cpu_median():
    calls = []
    t = profiling.timeit(lambda x: calls.append(x), torch.zeros(1), calls=5,
                         warmup=2)
    assert len(calls) == 7
    assert len(t.samples) == 5
    assert sorted(t.samples)[2] == t.seconds_per_call >= 0


def test_union_seconds_counts_overlap_once():
    assert profiling.union_seconds([]) == 0.0
    assert profiling.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.75)]) == 4.0
    assert profiling.union_seconds([(4, 5), (0, 1), (0.5, 1)]) == 2.0


def test_trace_device_cpu_has_no_device_rows():
    calls = []
    tr = profiling.trace_device(lambda x: calls.append(x + 1), torch.zeros(8))
    assert len(calls) == 1
    assert tr.wall_seconds > 0
    assert tr.busy_seconds == 0.0 and tr.by_name == {}
    assert tr.idle_share == 1.0


def test_configure_logging(caplog):
    metrics.configure_logging(logging.INFO)
    try:
        with caplog.at_level(logging.INFO, logger="nthash_tpu_torch"):
            metrics.logger.info("hello %d", 3)
        assert "hello 3" in caplog.text
    finally:
        for h in list(metrics.logger.handlers):
            metrics.logger.removeHandler(h)


def test_counters_match_jax(monkeypatch):
    from nthash_tpu.utils import metrics as jmetrics

    got = metrics.Counters(started_at=100.0)
    want = jmetrics.Counters(started_at=100.0)
    monkeypatch.setattr(metrics.time, "time", lambda: 102.0)
    monkeypatch.setattr(jmetrics.time, "time", lambda: 102.0)
    for c in (got, want):
        c.observe_batch(reads=10, windows=300, valid=250, num_hashes=4,
                        bytes_in=1500)
        c.observe_batch(reads=5, windows=150, valid=149)
    assert got.rates() == want.rates() == {
        "reads_per_s": 7.5, "kmers_per_s": 199.5, "hashes_per_s": 574.5}
    fields = ("reads", "batches", "windows", "valid_kmers",
              "skipped_windows", "hashes", "bytes_in", "started_at")
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields] == \
        [15, 2, 450, 399, 51, 1149, 1500, 100.0]


def test_counters_log(caplog):
    c = metrics.Counters()
    c.observe_batch(reads=3, windows=10, valid=7)
    with caplog.at_level(logging.INFO, logger="nthash_tpu_torch"):
        c.log()
    assert "reads=3 batches=1 valid_kmers=7 skipped=3" in caplog.text


def test_throughput_matches_jax():
    from nthash_tpu.utils import profiling as jprofiling

    t = profiling.Timing(0.25, (0.25, 0.5, 0.1))
    assert t.per_second(10) == 40.0
    want = jprofiling.throughput(jprofiling.Timing(0.25, 3), windows=1000,
                                 num_hashes=4)
    assert profiling.throughput(t, windows=1000, num_hashes=4) == want == {
        "seconds_per_call": 0.25, "kmers_per_s": 4000.0,
        "hashes_per_s": 16000.0}


def test_trace_writes_a_chrome_trace(tmp_path):
    import json

    with profiling.trace(tmp_path / "tr") as prof:
        torch.arange(1000).sum()
    assert prof is not None
    (out,) = (tmp_path / "tr").glob("trace.*.json")
    assert "traceEvents" in json.loads(out.read_text())
