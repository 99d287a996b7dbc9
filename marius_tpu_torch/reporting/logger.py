"""Logging: console + per-level rotating file sinks under <model_dir>/logs/.

Port of ``marius_tpu/reporting/logger.py`` (:28-66; reference
include/reporting/logger.h:18-68): the same format and the same files, on the
logger named ``marius_tpu_torch``, so the two packages never share handlers.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "error": logging.ERROR,
}

logging.addLevelName(5, "TRACE")

_logger: Optional[logging.Logger] = None


def get_logger(model_dir: Optional[str] = None, console_level: str = "info") -> logging.Logger:
    """Create (once) and return the port's logger. With a model_dir, adds
    one rotating file sink per level under <model_dir>/logs/ (logger.h:29-41)."""
    global _logger
    if _logger is not None:
        return _logger
    logger = logging.getLogger("marius_tpu_torch")
    logger.setLevel(5)
    logger.propagate = False

    console = logging.StreamHandler()
    console.setLevel(_LEVELS.get(console_level.lower(), logging.INFO))
    console.setFormatter(logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s",
                                           datefmt="%Y-%m-%d %H:%M:%S"))
    logger.addHandler(console)

    if model_dir:
        log_dir = os.path.join(model_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        fmt = logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s")
        for name, level in _LEVELS.items():
            fh = logging.handlers.RotatingFileHandler(
                os.path.join(log_dir, f"marius_{name}.log"),
                maxBytes=50 * 1024 * 1024, backupCount=2)
            fh.setLevel(level)
            fh.setFormatter(fmt)
            logger.addHandler(fh)

    _logger = logger
    return logger


def reset_logger() -> None:
    global _logger
    if _logger is not None:
        for h in list(_logger.handlers):
            _logger.removeHandler(h)
            h.close()
    _logger = None
