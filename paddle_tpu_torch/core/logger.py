"""Logging — glog-style formatting over Python logging (the port's own
copy of ``paddle_tpu/core/logger.py``, under the ``paddle_tpu_torch``
logger name)."""

from __future__ import annotations

import logging
import sys

_FMT = "%(levelname).1s %(asctime)s.%(msecs)03d %(name)s] %(message)s"
_DATEFMT = "%m%d %H:%M:%S"

_root = logging.getLogger("paddle_tpu_torch")
if not _root.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(_FMT, _DATEFMT))
    _root.addHandler(_h)
    _root.setLevel(logging.INFO)
    _root.propagate = False


def get_logger(name: str = "paddle_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)


def set_level(level: int | str) -> None:
    _root.setLevel(level)


info = _root.info
warning = _root.warning
error = _root.error
debug = _root.debug
