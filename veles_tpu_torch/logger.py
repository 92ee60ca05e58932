"""Class-scoped logging (counterpart of ``veles_tpu/logger.py``): every
framework object mixes in :class:`Logger` and gets a logger named after
its class."""

from __future__ import annotations

import logging
from typing import Any


class Logger:
    """Mixin granting ``self.logger`` plus debug/info/... helpers."""

    @property
    def logger(self) -> logging.Logger:
        return logging.getLogger(type(self).__name__)

    def debug(self, msg: str, *args: Any) -> None:
        self.logger.debug(msg, *args)

    def info(self, msg: str, *args: Any) -> None:
        self.logger.info(msg, *args)

    def warning(self, msg: str, *args: Any) -> None:
        self.logger.warning(msg, *args)

    def error(self, msg: str, *args: Any) -> None:
        self.logger.error(msg, *args)

    def exception(self, msg: str = "Error", *args: Any) -> None:
        self.logger.exception(msg, *args)
