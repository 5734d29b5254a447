"""Bases over the whole window of back-to-back passes over the batches on
the card, each pass ending in a device sync (host clock)."""

from portbench.core import readers


def read(ctx):
    return readers.bases_per_s(ctx, "resident")
