"""Metrics and logging.

Counterpart of ``nthash_tpu/utils/metrics.py``: streaming counters (reads,
windows, valid and skipped k-mers, bytes) kept from host-side ints, and the
package logger with its opt-in stderr handler.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

logger = logging.getLogger("nthash_tpu_torch")


def configure_logging(level: int = logging.INFO) -> None:
    """Opt-in stderr handler matching the reference's [ntHash::...] style."""
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("[ntHash::%(name)s] %(levelname)s: %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level)


@dataclass
class Counters:
    """Streaming pipeline counters. Cheap to update from host-side ints."""

    reads: int = 0
    batches: int = 0
    windows: int = 0
    valid_kmers: int = 0
    skipped_windows: int = 0
    hashes: int = 0
    bytes_in: int = 0
    started_at: float = field(default_factory=time.time)

    def observe_batch(self, *, reads: int, windows: int, valid: int,
                      num_hashes: int = 1, bytes_in: int = 0) -> None:
        self.reads += reads
        self.batches += 1
        self.windows += windows
        self.valid_kmers += valid
        self.skipped_windows += windows - valid
        self.hashes += valid * num_hashes
        self.bytes_in += bytes_in

    @property
    def elapsed(self) -> float:
        return time.time() - self.started_at

    def rates(self) -> dict:
        dt = max(self.elapsed, 1e-9)
        return {
            "reads_per_s": self.reads / dt,
            "kmers_per_s": self.valid_kmers / dt,
            "hashes_per_s": self.hashes / dt,
        }

    def log(self, level: int = logging.INFO) -> None:
        r = self.rates()
        logger.log(
            level,
            "reads=%d batches=%d valid_kmers=%d skipped=%d | "
            "%.3g reads/s %.3g kmers/s %.3g hashes/s",
            self.reads, self.batches, self.valid_kmers, self.skipped_windows,
            r["reads_per_s"], r["kmers_per_s"], r["hashes_per_s"],
        )
