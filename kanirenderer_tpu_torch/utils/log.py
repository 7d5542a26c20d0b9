"""Minimal leveled logging.

The reference logs with bare ``println!`` (no levels, no files — SURVEY §5.5);
this gives the same ergonomics plus levels and an env switch:
``KANI_LOG=debug|info|warn|error`` (default info).
"""

from __future__ import annotations

import os
import sys
import time

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}
_t0 = time.monotonic()


def _threshold() -> int:
    return _LEVELS.get(os.environ.get("KANI_LOG", "info").lower(), 20)


def _emit(level: str, msg: str, *args) -> None:
    if _LEVELS[level] < _threshold():
        return
    text = msg % args if args else msg
    print(f"[{time.monotonic() - _t0:8.3f}s {level:5s}] {text}",
          file=sys.stderr if level in ("warn", "error") else sys.stdout)


def debug(msg: str, *args) -> None:
    _emit("debug", msg, *args)


def info(msg: str, *args) -> None:
    _emit("info", msg, *args)


def warn(msg: str, *args) -> None:
    _emit("warn", msg, *args)


def error(msg: str, *args) -> None:
    _emit("error", msg, *args)
