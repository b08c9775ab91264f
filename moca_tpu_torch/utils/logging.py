"""Structured logging, silent inside the hot loop.

Port of moca_tpu/utils/logging.py (`get_logger`): one stderr handler per
named logger, level from MOCA_TPU_LOGLEVEL (default INFO).
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "moca_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("MOCA_TPU_LOGLEVEL", "INFO"))
        logger.propagate = False
    return logger
