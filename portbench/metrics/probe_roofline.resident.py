"""Share of the roofline of the Bloom filter's probe (one kernel by name):
every emitted bucket read once, each filter word a batch probes read once
and every read's per-seed count read and written once, over the window's
passes, at the card's memory rate, over the kernel's device time."""

from portbench.core import bounds

KERNELS = ("bloom_probe_kernel",)
#: The program's span around the layer's launches.
SPAN = "nthash.probe"


def read(ctx):
    if (ctx.cell.path != "resident" or ctx.cell.structure != "screen"
            or ctx.trace is None):
        return None
    cfg = ctx.config
    n, seeds = cfg["reads"], len(cfg["seeds"])
    buckets = seeds * cfg["num_hashes"] * n * bounds.windows(
        cfg["read_length"], cfg["k"])
    nbytes = ctx.passes * (4 * buckets + 4 * ctx.distinct_touched()
                           + 8 * seeds * n)
    return bounds.share(nbytes, ctx.trace.seconds_of(KERNELS), ctx.card)
