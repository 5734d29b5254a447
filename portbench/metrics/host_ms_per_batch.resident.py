"""Host dispatch a batch on the resident path, in ms: the union of the
program's outermost ``nthash.`` spans on the window's thread (checks, route
choice, allocations and the ctypes launches of the hash, histogram and
Bloom layers), over the window's batches (``core/spans``)."""

from portbench.core import spans


def read(ctx):
    win = spans.of(ctx)
    return None if win is None else win.host_ms_per_batch()
