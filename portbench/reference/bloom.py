"""Plain reference of a packed Bloom filter of the reads' k-mers.

Every hash h_0..h_{H-1} of every valid window sets the bit of its low
``width_log2`` bits, in the filter's word layout (``nthash_ref.pack_words``).
The driver builds the filter anew each pass, so the program's words after
the window must equal one pass's words: the number compared is the count of
words that differ, limit 0.
"""

from __future__ import annotations

import torch

from portbench.core import nthash_ref as ref

#: The configuration's keys at the size the CPU tests run
#: (``tests/small.py``): the filter stays wider than the bits the reads set.
SMALL = {"width_log2": 18}


def zeros(ctx) -> torch.Tensor:
    return torch.zeros((1 << ctx.config["width_log2"]) // ref.PACK,
                       dtype=torch.int32, device=ctx.device)


def add_pass(ctx, state: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """Set one pass's bits in ``state``."""
    cfg = ctx.config
    present = ref.presence(ctx.codes, cfg["k"], cfg["num_hashes"],
                           cfg["width_log2"], bits=bits)
    state |= ref.pack_words(present)
    return state


def expected(ctx) -> torch.Tensor:
    return add_pass(ctx, zeros(ctx))


def compare(ctx, state: torch.Tensor, one_pass: torch.Tensor,
            passes: int) -> dict:
    off = int((state != one_pass).sum())
    return {"words_off": {"value": off, "limit": 0}}


def describe(ctx, state: torch.Tensor) -> str:
    x = state.to(torch.int64) & 0xFFFFFFFF
    ones = sum(int(((x >> s) & 1).sum()) for s in range(ref.PACK))
    return (f"filter of {state.numel() * ref.PACK} bits: {ones} set, fill "
            f"ratio {ones / (state.numel() * ref.PACK)}")


def distinct_touched(ctx) -> int:
    """Words each batch of one pass touches, summed over the batches."""
    cfg = ctx.config
    seen = torch.zeros((1 << cfg["width_log2"]) // ref.PACK,
                       dtype=torch.bool, device=ctx.device)
    total = 0
    for batch in ctx.batches():
        seen.zero_()
        for part in ref.blocks(batch, 1 << 16):
            bk = ref.window_buckets(part, cfg["k"], cfg["num_hashes"],
                                    cfg["width_log2"])
            seen[ref.word_of(bk.reshape(-1))] = True
        total += int(seen.sum())
    return total
