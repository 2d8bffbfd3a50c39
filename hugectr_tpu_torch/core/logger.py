"""Leveled logger, rank-0 filtering and a wall-clock timer (counterpart of
hugectr_tpu/core/logger.py:25-100).

`get_logger` configures the "hugectr_tpu_torch" logger once: its level from
HCTR_TPU_LOG_LEVEL (ERROR, WARNING, INFO, DEBUG or TRACE; INFO otherwise)
unless the caller passes one, and its sink from HCTR_TPU_LOG_TO_FILE (a
file path; stderr otherwise), as the JAX package reads them. `log_rank0`,
`info`, `warning` and `debug` log only on rank 0 of the initialised
process group: the port runs one process per device, so rank 0 is the JAX
package's process 0 (`jax.process_index()`).
"""
from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional

import torch.distributed as dist

_NAME = "hugectr_tpu_torch"
_LEVELS = {
    "ERROR": logging.ERROR,
    "WARNING": logging.WARNING,
    "INFO": logging.INFO,
    "DEBUG": logging.DEBUG,
    "TRACE": logging.DEBUG,
}


def _process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_logger(level: Optional[int] = None) -> logging.Logger:
    logger = logging.getLogger(_NAME)
    if not logger.handlers:
        path = os.environ.get("HCTR_TPU_LOG_TO_FILE")
        handler = logging.FileHandler(path) if path else logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "[HCTR-TORCH][%(asctime)s][%(levelname)s] %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        logger.addHandler(handler)
        logger.propagate = False
        env = os.environ.get("HCTR_TPU_LOG_LEVEL", "INFO").upper()
        logger.setLevel(level if level is not None else _LEVELS.get(env, logging.INFO))
    return logger


def log_rank0(level: int, msg: str, *args) -> None:
    """Log only on rank 0 (logger.py:64)."""
    if _process_index() == 0:
        get_logger().log(level, msg, *args)


def info(msg: str, *args) -> None:
    log_rank0(logging.INFO, msg, *args)


def warning(msg: str, *args) -> None:
    log_rank0(logging.WARNING, msg, *args)


def debug(msg: str, *args) -> None:
    log_rank0(logging.DEBUG, msg, *args)


class Timer:
    """Wall-clock timer that sums its start/stop intervals (logger.py:82)."""

    def __init__(self):
        self._start: Optional[float] = None
        self._elapsed = 0.0

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self) -> "Timer":
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None
        return self

    def reset(self) -> None:
        self._start = None
        self._elapsed = 0.0

    def elapsed_seconds(self) -> float:
        running = time.perf_counter() - self._start if self._start is not None else 0.0
        return self._elapsed + running
