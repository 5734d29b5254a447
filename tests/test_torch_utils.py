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


def test_trace_writes_a_chrome_trace(tmp_path):
    import json

    with profiling.trace(tmp_path / "tr") as prof:
        torch.arange(1000).sum()
    assert prof is not None
    (out,) = (tmp_path / "tr").glob("trace.*.json")
    assert "traceEvents" in json.loads(out.read_text())
