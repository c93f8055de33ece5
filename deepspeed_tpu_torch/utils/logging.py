"""Logging utilities.

Port of ``deepspeed_tpu/utils/logging.py``: the package logger,
``warning_once``, ``should_log_le`` and the rank-aware helpers ``log_dist``
and ``print_rank_0`` (the rank is ``torch.distributed``'s, 0 without a
process group).
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


def _process_index():
    import torch.distributed as tdist
    return tdist.get_rank() if tdist.is_available() and tdist.is_initialized() else 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the listed ranks (None or [-1]: all)."""
    my_rank = _process_index()
    if ranks is None or len(ranks) == 0 or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def print_rank_0(message):
    if _process_index() == 0:
        print(message, flush=True)


def should_log_le(max_log_level_str):
    if not isinstance(max_log_level_str, str):
        raise ValueError("max_log_level_str must be a string")
    max_log_level_str = max_log_level_str.lower()
    if max_log_level_str not in log_levels:
        raise ValueError(f"{max_log_level_str} is not one of the `logging` levels")
    return logger.getEffectiveLevel() <= log_levels[max_log_level_str]
