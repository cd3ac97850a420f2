"""Logging utilities (the port's copy of ``build_logger`` from
modelcompose_tpu/utils/logging.py; reference: modelcompose/utils.py:17-92):
stdout + a daily rotating file handler under LOGDIR."""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys

from ..constants import LOGDIR

_handler = None


def build_logger(logger_name: str, logger_filename: str) -> logging.Logger:
    global _handler
    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")

    root = logging.getLogger()
    if not root.handlers:
        stdout = logging.StreamHandler(sys.stdout)
        stdout.setFormatter(formatter)
        root.addHandler(stdout)
        root.setLevel(logging.INFO)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if _handler is None:
        os.makedirs(LOGDIR, exist_ok=True)
        filename = os.path.join(LOGDIR, logger_filename)
        _handler = logging.handlers.TimedRotatingFileHandler(
            filename, when="D", utc=True)
        _handler.setFormatter(formatter)
    if _handler not in logger.handlers:
        logger.addHandler(_handler)
    return logger
