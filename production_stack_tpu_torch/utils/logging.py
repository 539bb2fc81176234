"""Colored per-module logger (parity with the reference's vllm_router/log.py)."""

from __future__ import annotations

import logging
import os
import sys

_COLORS = {
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[41m",
}
_RESET = "\x1b[0m"


class _Formatter(logging.Formatter):
    def __init__(self, use_color: bool):
        super().__init__()
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        base = (
            f"[{self.formatTime(record, '%Y-%m-%d %H:%M:%S')}] "
            f"{record.levelname} {record.name}: {record.getMessage()}"
        )
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        if self.use_color:
            color = _COLORS.get(record.levelno, "")
            return f"{color}{base}{_RESET}"
        return base


def init_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_Formatter(use_color=sys.stderr.isatty()))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("PSTPU_LOG_LEVEL", "INFO").upper())
        logger.propagate = False
    return logger
