"""Share of the roofline of the spaced-seed hash kernels that emit buckets
(B1, and B3 where the route takes it; two kernels by name, the staged and
the global): the codes read once at a byte a base and one int32 bucket
written a window, a seed and a hash, over the window's passes, at the
card's memory rate, over the kernels' device time."""

from portbench.core import bounds

KERNELS = ("seed_staged_kernel", "seed_hash_kernel")
#: The program's span around the layer's launches.
SPAN = "nthash.seed"


def read(ctx):
    if (ctx.cell.path != "resident" or "seeds" not in ctx.config
            or ctx.trace is None):
        return None
    cfg = ctx.config
    n, length = cfg["reads"], cfg["read_length"]
    planes = len(cfg["seeds"]) * cfg["num_hashes"]
    nbytes = ctx.passes * (n * length
                           + 4 * planes * n * bounds.windows(length, cfg["k"]))
    return bounds.share(nbytes, ctx.trace.seconds_of(KERNELS), ctx.card)
