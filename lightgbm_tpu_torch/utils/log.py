"""Logging for lightgbm_tpu_torch (the PyTorch/CUDA port of lightgbm_tpu).

Mirrors the reference's ``Log::Debug/Info/Warning/Fatal`` with verbosity levels
(reference: include/LightGBM/utils/log.h) and the Python-side logger redirection
hook ``register_logger`` (reference: python-package/lightgbm/basic.py:32-79).
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_logger: Optional[logging.Logger] = None
_verbosity: int = 1  # matches Config.verbosity default (reference: config.h "verbosity = 1")


class LightGBMError(Exception):
    """Error raised by the framework (analog of Log::Fatal's std::runtime_error)."""


def register_logger(logger: logging.Logger) -> None:
    """Redirect all framework log output into a user-supplied ``logging.Logger``."""
    if not isinstance(logger, logging.Logger):
        raise TypeError("logger should be an instance of logging.Logger")
    global _logger
    _logger = logger


def set_verbosity(verbosity: int) -> None:
    global _verbosity
    _verbosity = verbosity


def _emit(level: int, msg: str) -> None:
    if _logger is not None:
        _logger.log(level, msg)
    else:
        print(msg, file=sys.stderr)


def debug(msg: str) -> None:
    if _verbosity >= 2:
        _emit(logging.DEBUG, f"[LightGBM-Torch] [Debug] {msg}")


def info(msg: str) -> None:
    if _verbosity >= 1:
        _emit(logging.INFO, f"[LightGBM-Torch] [Info] {msg}")


def warning(msg: str) -> None:
    if _verbosity >= 0:
        _emit(logging.WARNING, f"[LightGBM-Torch] [Warning] {msg}")


def fatal(msg: str) -> None:
    raise LightGBMError(msg)
