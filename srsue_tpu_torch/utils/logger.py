"""Layered logging: the port's copy of ``srsue_tpu/utils/logger.py`` (its
reference), unchanged -- per-service levels, hex dumps, TTI stamping
(reference: ue/hdr/common/log.h:56-115 log_filter + async logger thread).

The reference's dedicated writer thread + boost ring buffer is a
threading artifact; Python's logging already buffers/handles IO. What is
preserved: per-layer loggers with independent levels, the
"[layer] [LVL] [tti] msg + hexdump" format, and the hex-limit knob.
"""

from __future__ import annotations

import logging
import sys


class TtiFilter(logging.Filter):
    """Injects the current TTI (stepped by the MAC/receiver loop)."""

    def __init__(self):
        super().__init__()
        self.tti = 0

    def step(self, tti: int) -> None:
        self.tti = tti

    def filter(self, record):
        record.tti = self.tti
        return True


_tti_filter = TtiFilter()


def step_tti(tti: int) -> None:
    _tti_filter.step(tti)


def get_logger(layer: str, level: str = "warning",
               hex_limit: int = 32) -> "LayerLog":
    return LayerLog(layer, level, hex_limit)


class LayerLog:
    LEVELS = {"none": 100, "error": 40, "warning": 30, "info": 20, "debug": 10}

    def __init__(self, layer: str, level: str, hex_limit: int):
        self.layer = layer
        self.hex_limit = hex_limit
        self.log = logging.getLogger(f"srsue.{layer}")
        self.log.setLevel(self.LEVELS[level])
        if not self.log.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                logging.Formatter("[%(name)-10s] [%(levelname).1s] [%(tti)5d] %(message)s")
            )
            h.addFilter(_tti_filter)
            self.log.addHandler(h)
            self.log.propagate = False

    def set_level(self, level: str) -> None:
        self.log.setLevel(self.LEVELS[level])

    def _hex(self, data: bytes) -> str:
        h = data[: self.hex_limit].hex(" ")
        more = "..." if len(data) > self.hex_limit else ""
        return f" [{len(data)}B: {h}{more}]"

    def error(self, msg, *a, hex: bytes | None = None):
        self.log.error(msg % a if a else msg + (self._hex(hex) if hex else ""))

    def warning(self, msg, *a, hex: bytes | None = None):
        self.log.warning(msg % a if a else msg + (self._hex(hex) if hex else ""))

    def info(self, msg, *a, hex: bytes | None = None):
        self.log.info(msg % a if a else msg + (self._hex(hex) if hex else ""))

    def debug(self, msg, *a, hex: bytes | None = None):
        self.log.debug(msg % a if a else msg + (self._hex(hex) if hex else ""))
