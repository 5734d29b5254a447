"""The table of peaks and the bytes each kernel family must move.

Each count is of the work the inputs need, worked out from the shapes and
the data, the same whatever route or kernel does the work: every input byte
read once, every output byte written once. A share of the roofline is the
least time those bytes take at the card's published memory rate, over the
device time the family's kernels took; it cannot pass 100% unless the
count is too high or the time leaves out part of the work.
"""

from __future__ import annotations

#: Published peaks (NVIDIA data sheet, H100 SXM, at its full 700 W): device
#: memory bytes a second. The system runs no model, so no FLOP peak is used.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}
#: The card a share is stated against when the run's card is not in the
#: table; the run prints which it used.
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def hbm_bytes_per_s(card: str) -> float:
    return PEAKS.get(card, PEAKS[DEFAULT_CARD])["hbm_bytes_per_s"]


def windows(length: int, k: int) -> int:
    """k-mer windows of one read."""
    return max(0, length - k + 1)


def hash_bytes(reads: int, length: int, k: int, num_hashes: int) -> int:
    """The hash kernels emitting buckets: the codes read once at one byte a
    base, and one int32 bucket written a window and a hash."""
    return reads * length + 4 * num_hashes * reads * windows(length, k)


def scatter_bytes(updates: int, distinct: int) -> int:
    """A scatter of ``updates`` int32 indices into int32 cells (counters or
    words), ``distinct`` of which it touches: the indices read once, and
    each touched cell read and written once."""
    return 4 * updates + 8 * distinct


def share(nbytes: float, seconds: float, card: str) -> float | None:
    """Per cent of the roofline: the least time for ``nbytes`` over the
    device ``seconds``; None where no device time was recorded."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / hbm_bytes_per_s(card) / seconds
