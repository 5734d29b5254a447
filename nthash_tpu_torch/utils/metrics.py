"""Logging.

The package logger with its opt-in stderr handler, as in
``nthash_tpu/utils/metrics.py``. The JAX package's streaming ``Counters``
have no counterpart: the port's per-layer numbers are its spans
(``utils/profiling.span``) on a profiler's timeline, read over a window.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("nthash_tpu_torch")


def configure_logging(level: int = logging.INFO) -> None:
    """Opt-in stderr handler matching the reference's [ntHash::...] style."""
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("[ntHash::%(name)s] %(levelname)s: %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level)
