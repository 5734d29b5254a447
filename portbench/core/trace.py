"""What the benchmark reads from ``torch.profiler``'s trace of a window.

Busy time is the union of the device's own rows (kernels, copies, memsets),
leaving out the rows the profiler records for its own buffers and the
annotations it draws on the device's timeline over a ``record_function``'s
kernels (``nccl:all_reduce`` over NCCL's kernel): neither is work of the
device. Summing each row's time instead of the union would count a copy
beside a kernel twice. The idle share is one less busy over the window.
The arithmetic is a copy of the program's ``utils/profiling.trace_device``
(which keeps the annotations), so that a change there cannot move it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

#: Device rows the profiler records for its own buffers, not for the work.
PROFILER_ROWS = frozenset({"Activity Buffer Request"})


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint intervals, in order:
    overlapping activity (a copy beside a kernel) counts once."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class Trace:
    """One traced window: its length, the device's busy seconds, device
    seconds by row name, and the longest idle gaps labelled by what the
    host was doing."""

    window_s: float
    busy_s: float
    by_name: dict[str, float] = field(default_factory=dict)
    gaps: list[tuple[str, float]] = field(default_factory=list)

    def seconds_of(self, names) -> float:
        """Device seconds of the rows whose name holds one of ``names`` as
        a whole word (``bin_count_kernel`` matches ``void
        bin_count_kernel<...>(...)``, not ``bin_count_kernel2``)."""
        pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
            re.escape(n) for n in names) + r")(?![A-Za-z0-9_])")
        return sum(t for name, t in self.by_name.items() if pat.search(name))

    def top_ops(self, n: int = 10) -> list[list]:
        return [[short(name), t] for name, t in
                sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]]


def short(name: str, most: int = 160) -> str:
    """A row's name cut to ``most`` characters (PyTorch's own kernels have
    names of a thousand)."""
    return name if len(name) <= most else name[:most - 3] + "..."


def summarize(prof, window_s: float, top_gaps: int = 10) -> Trace:
    """Read a finished ``torch.profiler.profile`` of a window."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        span = (e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type == DeviceType.CUDA:
            if not (e.name in PROFILER_ROWS
                    or getattr(e, "is_user_annotation", False)):
                dev.append((e.name, span))
        else:
            host.append((e.name, span))
    by_name: dict[str, float] = {}
    for name, (s, e) in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    busy = merged(span for _, span in dev)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:top_gaps]
    host.sort(key=lambda x: x[1][0])
    labelled = []
    for length, s, e in gaps:
        mid = 0.5 * (s + e)
        # the innermost host row over the gap's middle: the latest to start
        inner = [name for name, (hs, he) in host if hs <= mid <= he]
        labelled.append((short(inner[-1]) if inner else "no traced host op",
                         length))
    return Trace(window_s, sum(e - s for s, e in busy), by_name, labelled)
