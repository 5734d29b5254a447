"""The program's own spans over a traced window of a resident cell, for the
readers of the host dispatch layer (``metrics/host_ms_per_batch.resident``,
``metrics/idle_in_program_share.resident``,
``metrics/span_window_idle_share.resident``).

While a profiler runs, the program names its layers' host work on the
profiler's timeline: host rows whose names start ``nthash.``
(``nthash_tpu_torch/utils/profiling.span``), beside the device's rows.
The harness keeps only ``core/trace.summarize``'s totals of its traced
window, so these readers trace a window of their own right after it, as
long as the harness's: the cell's driver built anew over the same reads,
one untraced pass, then whole passes, each ending in a sync as in the
harness's window, under a profiler set as the harness's. The window is the
host row ``portbench.window`` drawn around those passes, on the profiler's
clock; its thread is the window's thread. Busy time is the union of the device rows by
``core/trace``'s rule (the profiler's buffers and the annotations drawn
over a span's kernels left out). The window's own idle
share is reported beside the share inside the spans, so that the part of
the idle time outside them reads as the difference. A program that records
no spans gives nothing to read, and no window is traced. The window is
traced once a run and kept on the run's context.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple

from . import harness, spec, trace

PREFIX = "nthash."
WINDOW = "portbench.window"


def total(intervals) -> float:
    return sum(e - s for s, e in intervals)


def overlap(a, b) -> float:
    """Length of the intersection of two lists of disjoint intervals, each
    in order (``trace.merged``'s output)."""
    out, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


@dataclass
class Window:
    """One traced window: its length and batches, the device's busy
    intervals and the window thread's ``nthash.`` spans, in seconds."""

    window_s: float
    batches: int
    busy: list[tuple[float, float]] = field(default_factory=list)
    spans: list[tuple[str, float, float]] = field(default_factory=list)

    def in_program(self) -> list[tuple[float, float]]:
        """The union of the spans: the outermost ones, a nested span
        counted once."""
        return trace.merged((s, e) for _, s, e in self.spans)

    def idle_share(self) -> float | None:
        """Per cent of the window in which the device runs nothing."""
        if not self.spans or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - total(self.busy) / self.window_s)

    def host_ms_per_batch(self) -> float | None:
        """The program's host time a batch, ms: the spans' union over the
        window's batches."""
        if not self.spans or self.batches <= 0:
            return None
        return 1e3 * total(self.in_program()) / self.batches

    def idle_in_program_share(self) -> float | None:
        """Per cent of the window in which the device runs nothing while
        the window's thread is inside a span."""
        if not self.spans or self.window_s <= 0:
            return None
        prog = self.in_program()
        return 100.0 * (total(prog) - overlap(prog, self.busy)) / self.window_s


class Row(NamedTuple):
    """One row of a profile, times in seconds on the profiler's clock."""

    name: str
    on_device: bool
    start: float
    end: float
    thread: int
    annotation: bool


def rows_of(prof) -> list[Row]:
    """The rows of a finished ``torch.profiler.profile``, read from its
    kineto results as they are: building its event list (``prof.events()``)
    for a 30-s window of the Bloom cell takes about a minute on the card's
    host, this a few seconds. Times count from the trace's start, as the
    event list's do (seconds since the epoch would keep only 0.24 us)."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    out = []
    for e in results.events():
        start = e.start_ns() - t0
        out.append(Row(e.name(), e.device_type() == DeviceType.CUDA,
                       start / 1e9, (start + e.duration_ns()) / 1e9,
                       e.start_thread_id(), e.is_user_annotation()))
    return out


def read(rows, batches: int) -> Window | None:
    """The :class:`Window` of a profile's rows (:class:`Row`), or None
    where they hold no ``portbench.window`` row."""
    marks = [r for r in rows if r.name == WINDOW and not r.on_device]
    if not marks:
        return None
    mark = marks[0]
    lo, hi = mark.start, mark.end
    dev, spans = [], []
    for r in rows:
        if r.on_device:
            if not (r.name in trace.PROFILER_ROWS or r.annotation):
                dev.append((max(r.start, lo), min(r.end, hi)))
        elif r.thread == mark.thread and r.name.startswith(PREFIX):
            spans.append((r.name, r.start, r.end))
    busy = trace.merged((s, t) for s, t in dev if t > s)
    return Window(hi - lo, batches, busy, spans)


def _traced_window(ctx) -> Window | None:
    from nthash_tpu_torch.utils import profiling

    if (ctx.cell.path != "resident" or ctx.trace is None or ctx.world != 1
            or not hasattr(profiling, "span")):
        return None
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = ctx.device
    drv = spec.module("drivers", f"{ctx.cell.structure}_{ctx.cell.path}"
                      ).Driver(ctx)
    try:
        drv.one_pass()
        harness.sync(dev)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        passes = 0
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                t0 = time.perf_counter()
                while passes == 0 or time.perf_counter() - t0 < ctx.window_s:
                    drv.one_pass()
                    harness.sync(dev)
                    passes += 1
    finally:
        drv.close()
    t0 = time.perf_counter()
    win = read(rows_of(prof), passes * len(ctx.batches()))
    del prof
    if win is None or not win.spans:
        return None
    harness.log(f"[spans] {passes} passes in {win.window_s:.6f} s, read in "
                f"{time.perf_counter() - t0:.3f} s; idle "
                f"{win.idle_share():.4f}%, inside the spans "
                f"{win.idle_in_program_share():.4f}%")
    return win


def of(ctx) -> Window | None:
    """The span window of ``ctx``'s run, traced once a run and kept on the
    context as ``span_window``; None where the cell is not a one-card
    resident cell, the run is not traced, or the program records no
    spans."""
    if "span_window" not in vars(ctx):
        ctx.span_window = _traced_window(ctx)
    return ctx.span_window
