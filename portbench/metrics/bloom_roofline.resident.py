"""Share of the roofline of the Bloom filter's scatter (C1: every kernel it
launches: the binning pass, the range pass, private words or direct
atomics): every emitted bucket index read once and each word a batch
touches read and written once, over the window's passes, at the card's
memory rate, over those kernels' device time."""

from portbench.core import readers

KERNELS = ("bloom_rows_kernel", "bloom_rows_private_kernel",
           "bloom_ranges_kernel", "bin_count_kernel", "bin_scan_kernel",
           "bin_scatter_kernel")
#: The program's span around the layer's launches.
SPAN = "nthash.bloom"


def read(ctx):
    return readers.scatter_share(ctx, "bloom", KERNELS)
