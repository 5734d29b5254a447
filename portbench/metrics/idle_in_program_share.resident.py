"""Per cent of the window in which the device runs nothing while the
window's thread is inside one of the program's ``nthash.`` spans: the part
of the device's idle time that the program's own host work causes; the
rest is the benchmark's sync and loop between passes (``core/spans``)."""

from portbench.core import spans


def read(ctx):
    win = spans.of(ctx)
    return None if win is None else win.idle_in_program_share()
