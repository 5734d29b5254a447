"""Faults of the resident Bloom driver's timed path:
``insert_from_buckets`` returns the filter unchanged or sets the bits of
half of the batch's reads; or the hash kernel's first bucket is moved
where the driver calls it."""

from nthash_tpu_torch.models import bloom as bloom_mod
from portbench.core import spec
from portbench.tests.small import altered


def plant(monkeypatch, cell, fault):
    drv = spec.module("drivers", f"{cell.structure}_{cell.path}")
    orig = bloom_mod.insert_from_buckets
    planted = {
        "unchanged": lambda bf, buckets, **kw: bf,
        "half": lambda bf, buckets, **kw: orig(
            bf, [b[:, :b.shape[1] // 2] for b in buckets], **kw),
    }
    if fault in planted:
        monkeypatch.setattr(bloom_mod, "insert_from_buckets", planted[fault])
    else:
        monkeypatch.setattr(drv, "hash_kmers_tm_auto",
                            altered(drv.hash_kmers_tm_auto))
