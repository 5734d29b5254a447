"""Faults of the file driver's timed path: ``dp.fused_count``, each
batch's fused hash->count step under ``count_file``, returns the sketch
unchanged or counts half of the batch's reads; or the hash kernel's first
bucket is moved where ``pipeline`` calls it."""

from nthash_tpu_torch.models import pipeline
from nthash_tpu_torch.parallel import dp
from portbench.tests.small import altered


def plant(monkeypatch, cell, fault):
    orig = dp.fused_count
    planted = {
        "unchanged": lambda codes, sketch, k, mesh=None: sketch,
        "half": lambda codes, sketch, k, mesh=None: orig(
            codes[:codes.shape[0] // 2], sketch, k, mesh),
    }
    if fault in planted:
        monkeypatch.setattr(dp, "fused_count", planted[fault])
    else:
        monkeypatch.setattr(pipeline, "hash_kmers_tm_auto",
                            altered(pipeline.hash_kmers_tm_auto))
