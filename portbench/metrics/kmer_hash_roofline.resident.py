"""Share of the roofline of the hash kernels that emit buckets (A1, and B2
where the route takes it; one kernel by name): the codes read once at a
byte a base and every bucket written once, over the window's passes, at
the card's memory rate, over the kernels' device time."""

from portbench.core import bounds

KERNELS = ("kmer_hash_kernel",)
#: The program's span around the layer's launches.
SPAN = "nthash.hash"


def read(ctx):
    if ctx.cell.path != "resident" or ctx.trace is None:
        return None
    cfg, d = ctx.config, ctx.config
    nbytes = ctx.passes * bounds.hash_bytes(
        d["reads"], d["read_length"], cfg["k"], cfg["num_hashes"])
    return bounds.share(nbytes, ctx.trace.seconds_of(KERNELS), ctx.card)
