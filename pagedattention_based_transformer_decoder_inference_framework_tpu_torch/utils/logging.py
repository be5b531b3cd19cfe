"""Structured logging wired to the runtime config.

:func:`setup_logging` reads ``RuntimeConfig.log_level`` and
``enable_logging``; the scheduler logs request lifecycle events
(:func:`log_event`) with ids and errors as JSON lines.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Any, Dict, Optional

from ..config import RuntimeConfig

LOGGER_NAME = "pagedattention_torch"


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "msg": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if extra:
            out.update(extra)
        return json.dumps(out)


def setup_logging(runtime: Optional[RuntimeConfig] = None,
                  json_lines: bool = True) -> logging.Logger:
    runtime = runtime or RuntimeConfig()
    logger = logging.getLogger(LOGGER_NAME)
    logger.handlers.clear()
    if not runtime.enable_logging:
        logger.addHandler(logging.NullHandler())
        logger.disabled = True
        return logger
    logger.disabled = False
    handler = logging.StreamHandler(sys.stderr)
    if json_lines:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(getattr(logging, runtime.log_level.upper(),
                            logging.INFO))
    return logger


def get_logger() -> logging.Logger:
    return logging.getLogger(LOGGER_NAME)


def log_event(msg: str, level: int = logging.INFO, **fields: Any) -> None:
    get_logger().log(level, msg, extra={"fields": fields})
