"""Plain reference of a count-min sketch of the reads' k-mers.

Row i of the sketch counts the low ``width_log2`` bits of hash h_i of every
valid window, exactly, in int32. After ``p`` passes over the reads the
program's rows must equal ``p`` times one pass's rows, counter for counter:
the number compared is the count of counters that differ, limit 0.
"""

from __future__ import annotations

import torch

from portbench.core import nthash_ref as ref

#: The configuration's keys at the size the CPU tests run
#: (``tests/small.py``): the rows stay wider than the buckets the reads fill.
SMALL = {"width_log2": 14}


def zeros(ctx) -> torch.Tensor:
    cfg = ctx.config
    return torch.zeros((cfg["num_hashes"], 1 << cfg["width_log2"]),
                       dtype=torch.int32, device=ctx.device)


def add_pass(ctx, state: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """Count one pass over the reads into ``state``."""
    cfg = ctx.config
    return ref.row_counts(ctx.codes, cfg["k"], cfg["num_hashes"],
                          cfg["width_log2"], bits=bits, out=state)


def expected(ctx) -> torch.Tensor:
    """One pass's rows."""
    return add_pass(ctx, zeros(ctx))


def compare(ctx, state: torch.Tensor, one_pass: torch.Tensor,
            passes: int) -> dict:
    one_pass.mul_(passes)
    off = int((state != one_pass).sum())
    return {"counters_off": {"value": off, "limit": 0}}


def describe(ctx, state: torch.Tensor) -> str:
    nonzero = (state != 0).sum(dim=1).tolist()
    return (f"sketch {tuple(state.shape)}: distinct counters a row "
            f"{nonzero}, largest count {int(state.max())}")


def distinct_touched(ctx) -> int:
    """(row, counter) pairs each batch of one pass touches, summed over
    the batches."""
    cfg = ctx.config
    seen = torch.zeros(1 << cfg["width_log2"], dtype=torch.bool,
                       device=ctx.device)
    total = 0
    for batch in ctx.batches():
        bk =[ref.window_buckets(part, cfg["k"], cfg["num_hashes"],
                                 cfg["width_log2"])
              for part in ref.blocks(batch, 1 << 16)]
        for i in range(cfg["num_hashes"]):
            seen.zero_()
            for b in bk:
                seen[b[i]] = True
            total += int(seen.sum())
    return total
