"""Logging facade (≈ brpc's src/butil/logging.cc): stream-style
levels, LOG_EVERY_N / LOG_FIRST_N rate limiting, pluggable sink, VLOG with
per-module verbosity — mapped onto the stdlib logging machinery rather than
re-inventing handlers.

A copy of ``brpc_tpu/butil/logging_util.py``; its logger is named
``brpc_tpu_torch`` so that the two packages' lines stay apart in one
process.
"""

from __future__ import annotations

import logging
import sys
import threading
from typing import Callable, Dict, Optional

_logger = logging.getLogger("brpc_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(
        logging.Formatter("%(levelname).1s%(asctime)s %(threadName)s %(filename)s:%(lineno)d] %(message)s",
                          datefmt="%m%d %H:%M:%S")
    )
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)
    _logger.propagate = False

LOG = _logger  # LOG.info / LOG.warning / LOG.error / LOG.fatal≈critical

_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()
_vlog_level = 0


def set_min_log_level(level: int) -> None:
    _logger.setLevel(level)


def set_vlog_level(level: int) -> None:
    global _vlog_level
    _vlog_level = level


def vlog_level() -> int:
    return _vlog_level


def vlog(verbosity: int, msg: str, *args) -> None:
    if verbosity <= _vlog_level:
        _logger.info(msg, *args, stacklevel=2)


def log_every_n(key: str, n: int, level: int, msg: str, *args) -> None:
    with _counters_lock:
        c = _counters.get(key, 0)
        _counters[key] = c + 1
    if c % n == 0:
        _logger.log(level, msg, *args, stacklevel=2)


def log_first_n(key: str, n: int, level: int, msg: str, *args) -> None:
    with _counters_lock:
        c = _counters.get(key, 0)
        if c >= n:
            return
        _counters[key] = c + 1
    _logger.log(level, msg, *args, stacklevel=2)


def add_log_sink(handler: logging.Handler) -> None:
    """Pluggable LogSink (≈ logging::SetLogSink)."""
    _logger.addHandler(handler)


def remove_log_sink(handler: logging.Handler) -> None:
    _logger.removeHandler(handler)
