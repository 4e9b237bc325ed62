"""Logging bootstrap — the logback.xml analog (a copy of
``omero_ms_pixel_buffer_tpu/utils/logging_setup.py``, the PyTorch port's
own: it imports nothing of the JAX package).

Reference behavior: stdout appender by default (the in-jar
logback.xml); the shipped dist config switches to a daily-rolling file
with 7-day retention (src/dist/conf/logback.xml:10-19), overridable
via ``-Dlogback.configurationFile``. Here: stdout by default, rolling
file when ``logging.file`` is configured, level from ``logging.level``.
"""

from __future__ import annotations

import logging
import logging.handlers
import os

from .config import LoggingConfig

FORMAT = "%(asctime)s %(levelname).1s [%(name)s] (%(threadName)s) %(message)s"


def configure_logging(cfg: LoggingConfig) -> None:
    level = getattr(logging, cfg.level.upper(), logging.INFO)
    handlers: list = []
    if cfg.file:
        os.makedirs(os.path.dirname(cfg.file) or ".", exist_ok=True)
        handlers.append(
            logging.handlers.TimedRotatingFileHandler(
                cfg.file,
                when="midnight",
                backupCount=cfg.retention_days,
                encoding="utf-8",
            )
        )
    else:
        handlers.append(logging.StreamHandler())
    logging.basicConfig(
        level=level, format=FORMAT, handlers=handlers, force=True
    )
