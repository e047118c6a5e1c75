"""Timestamped run logger.

Equivalent of the reference's ``utils/log.py:17`` Logger: prints to stdout and
appends to ``<output_dir>/output.log``; dumps the resolved config to
``cfg.yaml``; a module-level singleton is reachable via :func:`get_logger`.
A copy of ``quantize_tpu/utils/log.py``.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Any

_logger: "Logger | None" = None


def get_logger() -> "Logger":
    global _logger
    if _logger is None:
        _logger = Logger(None)
    return _logger


class Logger:
    def __init__(self, output_dir: str | None, filename: str = "output.log"):
        global _logger
        self.output_dir = output_dir
        self.path = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self.path = os.path.join(output_dir, filename)
        _logger = self

    def info(self, *msg: Any) -> None:
        line = " ".join(str(m) for m in msg)
        stamped = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {line}"
        print(stamped, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(stamped + "\n")

    def warning(self, *msg: Any) -> None:
        self.info("WARNING:", *msg)

    def error(self, *msg: Any) -> None:
        line = " ".join(str(m) for m in msg)
        stamped = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] ERROR: {line}"
        print(stamped, file=sys.stderr, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(stamped + "\n")

    def dump_config(self, cfg, filename: str = "cfg.yaml") -> None:
        if self.output_dir:
            cfg.dump_yaml(os.path.join(self.output_dir, filename))
