"""Logger setup (counterpart of ``vgqa_tpu/utils/log_setup.py``): stdout and
an optional file handler, emitting on rank 0 only."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def setup_logger(
    name: str, save_dir: str = "", rank: int = 0, filename: str = "log.txt"
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if rank > 0:
        logger.addHandler(logging.NullHandler())
        return logger
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
