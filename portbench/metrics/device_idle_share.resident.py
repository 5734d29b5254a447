"""Share of the traced window in which the device ran nothing, over the
resident cells (``core/readers.idle_share``)."""

from portbench.core import readers


def read(ctx):
    return readers.idle_share(ctx, "resident")
