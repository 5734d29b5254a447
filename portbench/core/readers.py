"""Arithmetic the per-layer and end-to-end readers share; each reader in
``portbench/metrics/`` names its cells' path, structure and kernels and
calls one of these. Each returns None where it finds nothing to read."""

from __future__ import annotations

from . import bounds


def bases_per_s(ctx, path: str) -> float | None:
    """Bases of every read of the window's passes over the whole window."""
    if ctx.cell.path != path or ctx.window_s <= 0:
        return None
    return ctx.bases / ctx.window_s


def idle_share(ctx, path: str) -> float | None:
    """Per cent of the traced window in which the device ran nothing: 1 -
    busy / window, busy the union of the profiler's device rows, averaged
    over the cards."""
    if ctx.cell.path != path or ctx.busy_s <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def scatter_share(ctx, structure: str, kernels: tuple[str, ...]):
    """Per cent of the roofline of a scatter into ``structure``'s cells on
    the resident path: every emitted bucket index read once and each cell a
    batch touches read and written once, over the window's passes, over
    the device time of ``kernels``."""
    if (ctx.cell.path != "resident" or ctx.cell.structure != structure
            or ctx.trace is None):
        return None
    cfg = ctx.config
    updates = cfg["num_hashes"] * cfg["reads"] * bounds.windows(
        cfg["read_length"], cfg["k"])
    nbytes = ctx.passes * bounds.scatter_bytes(updates, ctx.distinct_touched())
    return bounds.share(nbytes, ctx.trace.seconds_of(kernels), ctx.card)
