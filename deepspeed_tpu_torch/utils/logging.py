"""Logging utilities.

Port of ``deepspeed_tpu/utils/logging.py``: the package logger and
``warning_once``. The rank-aware helpers (``log_dist``, ``print_rank_0``) come
with the distributed slice of the port (ROADMAP.md A8).
"""

import logging
import os
import sys

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


class LoggerFactory:

    @staticmethod
    def create_logger(name=None, level=logging.INFO):
        if name is None:
            raise ValueError("name for logger cannot be None")
        formatter = logging.Formatter("[%(asctime)s] [%(levelname)s] "
                                      "[%(filename)s:%(lineno)d:%(funcName)s] %(message)s")
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            ch = logging.StreamHandler(stream=sys.stdout)
            ch.setLevel(level)
            ch.setFormatter(formatter)
            logger_.addHandler(ch)
        return logger_


logger = LoggerFactory.create_logger(name="DeepSpeedTPUTorch",
                                     level=log_levels.get(os.environ.get("DSTPU_LOG_LEVEL", "info"), logging.INFO))


def warning_once(message):
    _warned = getattr(warning_once, "_warned", set())
    if message not in _warned:
        _warned.add(message)
        warning_once._warned = _warned
        logger.warning(message)
