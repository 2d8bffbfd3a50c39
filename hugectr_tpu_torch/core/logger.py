"""Leveled logger (counterpart of hugectr_tpu/core/logger.py).

The level is an argument of `get_logger`, not an environment variable.
"""
from __future__ import annotations

import logging
import sys

_NAME = "hugectr_tpu_torch"


def get_logger(level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "[HCTR-TORCH][%(asctime)s][%(levelname)s] %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        logger.addHandler(handler)
        logger.propagate = False
        logger.setLevel(level)
    return logger
