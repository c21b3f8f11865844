"""TRACE/WARN/ERR logging surface (core/logging.cpp).

Same environment contract as the reference: ``ALSOFT_LOGLEVEL`` 0-3
(disable / error / warn / trace, logging.cpp gLogLevel) and
``ALSOFT_LOGFILE`` redirecting to a file.  Backed by a stdlib logger named
"openal_soft_tpu" so applications can also attach handlers normally.
"""

from __future__ import annotations

import logging as _pylog
import os
import sys

logger = _pylog.getLogger("openal_soft_tpu")

_LEVELS = {0: _pylog.CRITICAL + 10, 1: _pylog.ERROR, 2: _pylog.WARNING,
           3: _pylog.DEBUG}


def _init() -> None:
    try:
        lvl = int(os.environ.get("ALSOFT_LOGLEVEL", "1"))
    except ValueError:
        lvl = 1
    lvl = max(0, min(3, lvl))
    logger.setLevel(_LEVELS[lvl])
    target = os.environ.get("ALSOFT_LOGFILE")
    if target:
        handler: _pylog.Handler = _pylog.FileHandler(target)
    else:
        handler = _pylog.StreamHandler(sys.stderr)
    handler.setFormatter(_pylog.Formatter("[ALSOFT] (%(levelname)s) %(message)s"))
    logger.addHandler(handler)
    logger.propagate = False


_init()


def trace(msg: str, *args) -> None:
    logger.debug(msg, *args)


def warn(msg: str, *args) -> None:
    logger.warning(msg, *args)


def err(msg: str, *args) -> None:
    logger.error(msg, *args)
