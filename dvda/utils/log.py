"""Structured logging for the framework.

The reference logs with bare ``fprintf(stderr, …)`` at parse-failure sites
(SURVEY §5).  The rebuild routes everything through a standard
:mod:`logging` logger (``dvda``) with levels, so embedders control
verbosity; decode-integrity events (parity/CRC mismatches, dropped frames)
log at WARNING to mirror the reference's stderr messages.
"""

from __future__ import annotations

import logging

__all__ = ["logger", "configure"]

logger = logging.getLogger("dvda")


def configure(level: str | int | None = None) -> None:
    """Attach a stderr handler; level from arg or ``DVDA_LOG``."""
    if level is None:
        from ..config import env_log_level

        level = env_log_level()
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.WARNING)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(name)s %(levelname)s: %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level)
