"""Faults of the resident host screening driver's timed path, planted where
the seed kernel's wide (int64) buckets reach the probe
(``bloom.hits_from_buckets``, which ``bloom.screen_reads`` calls once a
batch), as the screening plan plants them: the counts left unchanged; only
the first half of the batch's reads probed; or one bucket of a window that
hits moved to a bucket whose bit the filter does not hold, so that the
count of its read drops by one. Each planted call first checks that the
buckets are the wide ones."""

import torch

from nthash_tpu_torch.models import bloom as bloom_mod
from portbench.tests.faults.screen_resident import moved


def wide(fn):
    """``fn``, once the buckets are checked to be int64."""
    def planted(bf, buckets, **kw):
        if any(b.dtype != torch.int64 for b in buckets):
            raise AssertionError("the host screening path probes int64 "
                                 "buckets")
        return fn(bf, buckets, **kw)
    return planted


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
    monkeypatch.setattr(bloom_mod, "hits_from_buckets", wide(planted[fault]))
