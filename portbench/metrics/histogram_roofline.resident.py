"""Share of the roofline of the row histogram (every kernel it launches:
the binning pass, the range pass, private counters or direct atomics):
every emitted bucket index read once and each (row, counter) a batch
touches read and written once, over the window's passes, at the card's
memory rate, over those kernels' device time."""

from portbench.core import readers

KERNELS = ("histogram_rows_kernel", "histogram_rows_private_kernel",
           "histogram_ranges_kernel", "bin_count_kernel", "bin_scan_kernel",
           "bin_scatter_kernel")
#: The program's span around the layer's launches.
SPAN = "nthash.histogram"


def read(ctx):
    return readers.scatter_share(ctx, "count_min", KERNELS)
