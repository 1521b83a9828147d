"""Structured logging with the reference's [INFO]/[WARN]/[FAIL]/[DBUG]
prefixes (used throughout, e.g. ref src/visual_odometer.cpp:145,291,325),
upgraded with levels and an optional machine-readable JSONL sink.

A copy of the JAX package's `utils/logging.py`."""

from __future__ import annotations

import json
import sys
import time
from typing import Optional

_LEVELS = {"DBUG": 10, "INFO": 20, "WARN": 30, "FAIL": 40}
_min_level = 20
_jsonl_path: Optional[str] = None


def set_level(level: str):
    global _min_level
    _min_level = _LEVELS[level]


def set_jsonl(path: Optional[str]):
    global _jsonl_path
    _jsonl_path = path


def log(level: str, msg: str, **fields):
    if _LEVELS[level] < _min_level:
        return
    print(f"[{level}]: {msg}", file=sys.stderr)
    if _jsonl_path:
        with open(_jsonl_path, "a") as f:
            f.write(json.dumps({"t": time.time(), "level": level,
                                "msg": msg, **fields}) + "\n")


def info(msg, **k):
    log("INFO", msg, **k)


def warn(msg, **k):
    log("WARN", msg, **k)


def fail(msg, **k):
    log("FAIL", msg, **k)


def debug(msg, **k):
    log("DBUG", msg, **k)
