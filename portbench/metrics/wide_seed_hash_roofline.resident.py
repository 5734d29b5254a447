"""Share of the roofline of the spaced-seed hash kernels' wide buckets (B1,
and B3 where the route takes it; the staged and the global kernel's int64
instances, by name) on the host screening cells: the codes read once at a
byte a base and every (window, seed, hash) bucket written once at 8 bytes,
the narrowest machine word that holds a bucket past 2^31, over the
window's passes, at the card's memory rate, over the kernels' device
time. None outside the host screening structure."""

from portbench.core import bounds

KERNELS = ("seed_staged_wide_kernel", "seed_hash_wide_kernel")
#: The program's span around the layer's launches.
SPAN = "nthash.seed"
#: Bytes of one wide bucket.
BUCKET_BYTES = 8


def read(ctx):
    if (ctx.cell.path != "resident" or ctx.cell.structure != "host_screen"
            or ctx.trace is None):
        return None
    cfg = ctx.config
    n, length = cfg["reads"], cfg["read_length"]
    planes = len(cfg["seeds"]) * cfg["num_hashes"]
    nbytes = ctx.passes * (n * length + BUCKET_BYTES * planes * n
                           * bounds.windows(length, cfg["k"]))
    return bounds.share(nbytes, ctx.trace.seconds_of(KERNELS), ctx.card)
