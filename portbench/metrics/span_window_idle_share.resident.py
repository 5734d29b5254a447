"""Per cent of the span readers' own traced window in which the device ran
nothing (``core/spans``): the whole of which
``idle_in_program_share.resident`` is the part inside the program's spans;
the rest is the benchmark's sync and loop between passes."""

from portbench.core import spans


def read(ctx):
    win = spans.of(ctx)
    return None if win is None else win.idle_share()
