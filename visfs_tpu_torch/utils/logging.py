"""Severity logger with rotating file + console sinks (a copy of
visfs_tpu.utils.logging for the port, which imports nothing of visfs_tpu).

Mirrors the reference utilite Logger (utilite/src/Log.cpp:87-138): severity
levels DEBUG/INFO/WARN/ERROR/FATAL (System/LogLevel 0,1,2,3,5), rotating
file sink (50 MB per file, 10 files) under a configurable folder, optional
console sink — built on the stdlib logging stack instead of boost::log.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from pathlib import Path

_LEVELS = {0: logging.DEBUG, 1: logging.INFO, 2: logging.WARNING,
           3: logging.ERROR, 5: logging.CRITICAL}

_FMT = "[%(asctime)s][%(levelname)s][%(name)s] %(message)s"


def make_logger(level: int = 1, on_console: bool = False,
                folder: str = "~/.VISFS/logs",
                name: str = "visfs") -> logging.Logger:
    """Configure and return the engine logger (Logger::Logger equivalent).

    level: reference System/LogLevel code (0 DEBUG .. 5 FATAL).
    """
    logger = logging.getLogger(name)
    logger.setLevel(_LEVELS.get(level, logging.INFO))
    logger.handlers.clear()
    logger.propagate = False

    folder_path = Path(os.path.expanduser(folder))
    try:
        folder_path.mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            folder_path / "visfs.log",
            maxBytes=50 * 1024 * 1024,  # 50 MB rotation (Log.cpp:97)
            backupCount=10,  # 10 files (Log.cpp:98)
        )
        fh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(fh)
    except OSError:
        on_console = True  # fall back to console if folder is unwritable

    if on_console:
        ch = logging.StreamHandler()
        ch.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(ch)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger
