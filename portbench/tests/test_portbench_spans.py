"""The readers of the program's spans (``core/spans.py``): their arithmetic
on a window of known spans and busy intervals, what they read from a
profile, the harness running them, and, on the card, the layers' spans
against the kernel lists the roofline readers match by name."""

import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from nthash_tpu_torch.utils import profiling
from portbench.core import harness, reads, spans, spec, trace
from portbench.tests.small import small

ONE_CARD = [w["name"] for w in spec.benchmark()["workloads"]
            if w["chips"] == 1]


def window(**kw):
    """10 s; the device busy 6 of them; a span (1, 4) with one nested in
    it, and a span (6, 7); two batches."""
    args = dict(window_s=10.0, batches=2,
                busy=[(0.0, 2.0), (3.0, 5.0), (8.0, 10.0)],
                spans=[("nthash.step#0", 1.0, 4.0), ("nthash.hash", 1.5, 3.5),
                       ("nthash.stream.wait#1", 6.0, 7.0)])
    args.update(kw)
    return spans.Window(**args)


def test_readings_of_known_spans():
    w = window()
    assert w.in_program() == [(1.0, 4.0), (6.0, 7.0)]
    assert w.host_ms_per_batch() == pytest.approx(2000.0)
    # idle inside the spans: (2, 3) and (6, 7)
    assert w.idle_in_program_share() == pytest.approx(20.0)
    assert w.idle_share() == pytest.approx(40.0)


def test_nested_spans_count_once():
    nested = window(spans=window().spans + [("nthash.bin", 2.0, 2.5),
                                            ("nthash.ranges", 3.0, 3.9)])
    assert nested.host_ms_per_batch() == window().host_ms_per_batch()
    assert nested.idle_in_program_share() == \
        window().idle_in_program_share()


@pytest.mark.parametrize("spans_at", [
    [(0.5, 9.5)], [(2.0, 3.0)], [(0.0, 10.0)], [(1.0, 1.5), (5.0, 9.0)]])
def test_idle_in_program_at_most_idle(spans_at):
    w = window(spans=[("nthash.step", s, e) for s, e in spans_at])
    assert 0.0 <= w.idle_in_program_share() <= w.idle_share()


def test_nothing_to_read_without_spans():
    w = window(spans=[])
    assert w.host_ms_per_batch() is None
    assert w.idle_in_program_share() is None
    assert w.idle_share() is None


def test_overlap():
    assert spans.overlap([(0, 2), (3, 5)], [(1, 4)]) == 2
    assert spans.overlap([(0, 1)], [(1, 2)]) == 0
    assert spans.overlap([], [(0, 1)]) == 0


def row(name, start_us, end_us, device=False, annotation=False, thread=1):
    return spans.Row(name, device, start_us / 1e6, end_us / 1e6, thread,
                     annotation)


def as_event(r):
    """A :class:`spans.Row` as the profiler's event list gives it, for
    ``trace.summarize``."""
    return SimpleNamespace(
        name=r.name,
        device_type=DeviceType.CUDA if r.on_device else DeviceType.CPU,
        is_user_annotation=r.annotation, thread=r.thread,
        time_range=SimpleNamespace(start=r.start * 1e6, end=r.end * 1e6))


def test_read_a_profile_busy_as_summarize():
    rows = [
        row(spans.WINDOW, 0, 1000),
        row("nthash.hash", 100, 300),
        row("nthash.hash", 120, 200, device=True, annotation=True),
        row("kmer_hash_kernel", 120, 200, device=True),
        row("nthash.histogram", 300, 500),
        row("histogram_rows_kernel", 350, 700, device=True),
        row("Activity Buffer Request", 0, 1000, device=True),
        row("nthash.parse#0", 0, 900, thread=2),
        row("cudaDeviceSynchronize", 500, 1000),
    ]
    w = spans.read(rows, batches=1)
    assert w.window_s == pytest.approx(1e-3)
    assert [n for n, _, _ in w.spans] == ["nthash.hash", "nthash.histogram"]
    events = [as_event(r) for r in rows]
    got = trace.summarize(SimpleNamespace(events=lambda: events), w.window_s)
    assert spans.total(w.busy) == pytest.approx(got.busy_s)
    # idle inside the spans (100, 500): (100, 120) and (200, 350), 17%
    assert w.idle_in_program_share() == pytest.approx(17.0)
    assert w.host_ms_per_batch() == pytest.approx(0.4)
    # busy (120, 200) and (350, 700) of 1000 us
    assert w.idle_share() == pytest.approx(57.0)
    assert spans.read(rows[1:], batches=1) is None


def layer_profile():
    """A CPU profile of one ``fused_count_step`` inside the window's row."""
    from nthash_tpu_torch.models.pipeline import fused_count_step
    from nthash_tpu_torch.models.sketch import CountMinSketch
    from nthash_tpu_torch.ops.kmer_kernel import prepare_codes
    from torch.profiler import ProfilerActivity, profile, record_function

    tm = prepare_codes(torch.randint(0, 5, (32, 40), dtype=torch.uint8))
    sketch = CountMinSketch.zeros(2, 10, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(spans.WINDOW):
            fused_count_step(tm, sketch, 8)
    return prof


def test_summarize_same_with_and_without_span_rows():
    """A recorded CPU profile of the layers: ``summarize``'s fields are
    those of the same events with the spans' rows taken out."""
    events = list(layer_profile().events())
    bare = [e for e in events if not e.name.startswith(spans.PREFIX)]
    assert len(bare) < len(events)
    a = trace.summarize(SimpleNamespace(events=lambda: events), 1.0)
    b = trace.summarize(SimpleNamespace(events=lambda: bare), 1.0)
    assert (a.busy_s, a.by_name, a.gaps) == (b.busy_s, b.by_name, b.gaps)


def test_rows_as_the_event_list():
    """The rows read from the kineto results hold the profiler's events of
    the window and the spans: the same names, threads and times."""
    prof = layer_profile()

    def ours(name):
        return name == spans.WINDOW or name.startswith(spans.PREFIX)

    events = sorted((e.name, e.thread, e.time_range.start / 1e6,
                     e.time_range.end / 1e6)
                    for e in prof.events() if ours(e.name))
    rows = sorted((r.name, r.thread, r.start, r.end)
                  for r in spans.rows_of(prof) if ours(r.name))
    assert [r[:2] for r in rows] == [e[:2] for e in events]
    assert [r[2:] for r in rows] == [pytest.approx(e[2:], abs=1e-9)
                                     for e in events]
    w = spans.read(spans.rows_of(prof), batches=1)
    assert {n for n, _, _ in w.spans} == {"nthash.hash", "nthash.histogram"}


@pytest.mark.parametrize("cell", ONE_CARD)
def test_harness_reads_both_metrics(cell):
    out = harness.run_cell(small(cell), 2**31 + 17, 0.2, True, device="cpu",
                           t_start=time.time())
    got = out["metrics"]
    assert out["correct"]
    assert got["host_ms_per_batch.resident"]["value"] > 0
    inside = got["idle_in_program_share.resident"]["value"]
    assert 0 < inside <= got["span_window_idle_share.resident"]["value"] <= 100


def test_no_reading_from_a_program_without_spans(monkeypatch):
    """A program before the spans: nothing read, no window traced."""
    cell = small(ONE_CARD[0])
    monkeypatch.delattr(profiling, "span")
    monkeypatch.setattr(spec, "module", None)    # no driver may be built
    ctx = harness.Context(cell, 1, torch.device("cpu"))
    ctx.trace = trace.Trace(1.0, 0.0)
    assert spans.of(ctx) is None


def test_window_traced_once_a_run(monkeypatch):
    """Each reader asks for the window; it is traced once a run and kept
    on that run's context, not on another's."""
    calls = []

    def traced(ctx):
        calls.append(ctx)
        return window()

    monkeypatch.setattr(spans, "_traced_window", traced)
    one, two = (harness.Context(small(ONE_CARD[0]), s, torch.device("cpu"))
                for s in (1, 2))
    assert spans.of(one) is spans.of(one)
    assert spans.of(two) is not spans.of(one)
    assert calls == [one, two]


def layer_kernels(cell):
    """Span name -> the kernel list of the roofline reader that reads it:
    each of ``cell``'s per-layer readers that names both its ``SPAN`` and
    its ``KERNELS``."""
    readers = [spec.module("metrics", m["name"])
               for m in spec.cell(cell).per_layer]
    return {r.SPAN: r.KERNELS for r in readers
            if hasattr(r, "SPAN") and hasattr(r, "KERNELS")}


@pytest.mark.parametrize("cell, spans_read", [
    ("cms_short_resident", {"nthash.hash", "nthash.histogram"}),
    ("bloom_short_resident", {"nthash.hash", "nthash.bloom"})])
def test_layer_kernels_by_the_readers(cell, spans_read):
    got = layer_kernels(cell)
    assert set(got) == spans_read
    assert got["nthash.hash"] == ("kmer_hash_kernel",)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_layer_spans_on_the_card(cuda, cell):
    """One traced pass of the cell at its size: each kernel launched inside
    a layer's span is in that layer's reader's list, each listed kernel
    that ran was launched inside the span, busy time is the same without
    the spans' annotation rows on the device's timeline, and the span
    readers' rows give the busy time ``summarize`` gives."""
    from torch.profiler import ProfilerActivity, profile, record_function

    c = spec.cell(cell)
    ctx = harness.Context(c, 2**31 + 5, torch.device("cuda", 0))
    ctx.codes = reads.make_reads(ctx.config, ctx.seed, ctx.device)
    drv = spec.module("drivers", f"{c.structure}_{c.path}").Driver(ctx)
    drv.one_pass()
    harness.sync(ctx.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(spans.WINDOW):
            drv.one_pass()
            harness.sync(ctx.device)
    drv.close()
    events = list(prof.events())
    # the readers' rows give the device's busy time as ``summarize`` does
    assert spans.total(spans.read(spans.rows_of(prof), 1).busy) == \
        pytest.approx(trace.summarize(prof, 1.0).busy_s, rel=1e-6)
    kernel_of = {e.id: e.name for e in events
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)}
    launches = [e for e in events if e.device_type != DeviceType.CUDA
                and e.name.startswith("cudaLaunchKernel")]
    found = []
    for name, listed in layer_kernels(cell).items():
        rows = [(e.time_range.start, e.time_range.end) for e in events
                if e.name == name and e.device_type != DeviceType.CUDA]
        assert rows, name
        for e in launches:
            kernel = kernel_of.get(e.id)
            if kernel is None:
                continue
            is_listed = trace.Trace(0.0, 0.0, {kernel: 1.0}).seconds_of(
                listed) > 0
            within = any(s <= e.time_range.start and e.time_range.end <= t
                         for s, t in rows)
            if within or is_listed:
                found.append((name, kernel, within, is_listed))
    wrong = [f for f in found if f[2] != f[3]]
    assert found and not wrong, wrong
    bare = [e for e in events if not (e.device_type == DeviceType.CUDA
                                      and e.name.startswith(spans.PREFIX))]
    assert len(bare) < len(events)
    a = trace.summarize(SimpleNamespace(events=lambda: events), 1.0)
    b = trace.summarize(SimpleNamespace(events=lambda: bare), 1.0)
    assert a.busy_s == b.busy_s and a.by_name == b.by_name


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
