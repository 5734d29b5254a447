"""Logging for the command line.

Counterpart of the part of ``nthash_tpu/utils/metrics.py`` that ``count``
uses: the package logger and its opt-in stderr handler.
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
