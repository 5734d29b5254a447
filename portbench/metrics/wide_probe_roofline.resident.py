"""Share of the roofline of the wide probe (one kernel by name) on the host
screening cells: every int64 bucket read once at 8 bytes, each distinct
32-byte filter sector a batch probes read once (the reference's
``distinct_touched``: the filter lies in device memory, and its words are
read by the sector), and every read's per-seed count read and written once,
over the window's passes, at the card's memory rate, over the kernel's
device time. None outside the host screening structure."""

from portbench.core import bounds

KERNELS = ("bloom_probe_wide_kernel",)
#: The program's span around the layer's launches.
SPAN = "nthash.probe"
#: Bytes of one wide bucket, of one sector of the filter, of one count.
BUCKET_BYTES, SECTOR_BYTES, COUNT_BYTES = 8, 32, 4


def read(ctx):
    if (ctx.cell.path != "resident" or ctx.cell.structure != "host_screen"
            or ctx.trace is None):
        return None
    cfg = ctx.config
    n, seeds = cfg["reads"], len(cfg["seeds"])
    buckets = seeds * cfg["num_hashes"] * n * bounds.windows(
        cfg["read_length"], cfg["k"])
    nbytes = ctx.passes * (BUCKET_BYTES * buckets
                           + SECTOR_BYTES * ctx.distinct_touched()
                           + 2 * COUNT_BYTES * seeds * n)
    return bounds.share(nbytes, ctx.trace.seconds_of(KERNELS), ctx.card)
