"""Faults of the resident count-min driver's timed path: its
``fused_count_step`` returns the sketch unchanged or counts half of the
batch's reads; or the hash kernel's first bucket is moved where
``pipeline`` calls it."""

from nthash_tpu_torch.models import pipeline
from portbench.core import spec
from portbench.tests.small import altered


def plant(monkeypatch, cell, fault):
    drv = spec.module("drivers", f"{cell.structure}_{cell.path}")
    orig = drv.fused_count_step
    planted = {
        "unchanged": lambda tm, sketch, k: sketch,
        "half": lambda tm, sketch, k: orig(
            tm[:, :tm.shape[1] // 2].contiguous(), sketch, k),
    }
    if fault in planted:
        monkeypatch.setattr(drv, "fused_count_step", planted[fault])
    else:
        monkeypatch.setattr(pipeline, "hash_kmers_tm_auto",
                            altered(pipeline.hash_kmers_tm_auto))
