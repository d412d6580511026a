"""Leveled logging, the `RT_LOG_{DEBUG,INFO,WARNING,ERROR}` analogue.

The reference implements a printf-style leveled logger
(`Core/Utils/Logger.h:8-25`, `Core/Utils/Logger.cpp`).  This framework
wraps Python's stdlib logging with the same four levels and a compact
single-line format, so library code logs uniformly whether driven from the
CLI, tests, or a multi-host launcher (where the process index is prefixed).
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGER_NAME = "raytracer_tpu"
_configured = False


def _configure() -> logging.Logger:
    global _configured
    logger = logging.getLogger(_LOGGER_NAME)
    if _configured:
        return logger
    _configured = True
    level_name = os.environ.get("RT_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level_name, logging.INFO))
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        prefix = ""
        try:  # multi-host: prefix the jax process index
            import jax

            if jax.process_count() > 1:
                prefix = f"[host {jax.process_index()}] "
        except Exception:
            pass
        handler.setFormatter(
            logging.Formatter(f"%(asctime)s {prefix}%(levelname).1s %(message)s",
                              datefmt="%H:%M:%S")
        )
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def log_debug(fmt: str, *args) -> None:
    _configure().debug(fmt, *args)


def log_info(fmt: str, *args) -> None:
    _configure().info(fmt, *args)


def log_warning(fmt: str, *args) -> None:
    _configure().warning(fmt, *args)


def log_error(fmt: str, *args) -> None:
    _configure().error(fmt, *args)


def set_level(level: str) -> None:
    _configure().setLevel(getattr(logging, level.upper()))
