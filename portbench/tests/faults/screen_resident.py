"""Faults of the resident screening driver's timed path, planted where the
seed kernel's buckets reach the probe (``bloom.hits_from_buckets``, which
``bloom.screen_reads`` calls once a batch): the counts left unchanged;
only the first half of the batch's reads probed; or one bucket of a window
that hits moved to a bucket whose bit the filter does not hold, so that the
count of its read drops by one."""

import torch

from nthash_tpu_torch.models import bloom as bloom_mod
from nthash_tpu_torch.ops.hist_kernel import bit_index, word_index


def unset_bucket(words: torch.Tensor) -> int:
    """A bucket whose bit is not set in ``words``."""
    q = int((words != -1).nonzero()[0])
    word = int(words[q]) & 0xFFFFFFFF
    s = next(b for b in range(32) if not word >> b & 1)
    return (q >> 7 << 12) | (s << 7) | (q & 127)


def moved(bf, buckets, num_hashes):
    """The buckets with one bucket of seed 0's first hitting window moved
    to a bucket the filter does not hold (a copy)."""
    planes = [p.clone() for p in buckets]
    first = planes[:num_hashes]
    width = bf.width
    hit = torch.ones_like(first[0], dtype=torch.bool)
    for b in first:
        inside = (b >= 0) & (b < width)
        c = torch.where(inside, b, 0).to(torch.int64)
        hit &= inside & (((bf.words[word_index(c)] >> bit_index(c)) & 1) != 0)
    w, r = (int(i) for i in hit.nonzero()[0])
    first[0][w, r] = unset_bucket(bf.words)
    return planes


def plant(monkeypatch, cell, fault):
    orig = bloom_mod.hits_from_buckets

    def half(bf, buckets, *, out, **kw):
        n = out.shape[1] // 2
        out[:, :n] += orig(bf, [b[:, :n] for b in buckets], **kw)
        return out

    planted = {
        "unchanged": lambda bf, buckets, *, out, **kw: out,
        "half": half,
        "altered": lambda bf, buckets, **kw: orig(
            bf, moved(bf, buckets, kw["num_hashes"]), **kw),
    }
    monkeypatch.setattr(bloom_mod, "hits_from_buckets", planted[fault])
