"""Structured logging/error subsystem (the core/error.{h,cpp} + glog
role, ref: main/pbrt.cpp:100-148 FLAGS_*, Warning/Error file-prefixed
messages).

Severity-leveled, caller-file-prefixed messages to stderr with a
process-wide verbosity gate; `fatal` raises (the Error + abort path —
no SIGKILL-on-invariant like iisptrenderrunner.cpp:373, exceptions are
the Python-native equivalent).  The CLI wires --quiet/--verbose
(cli/main.py); library modules call warning/error instead of bare
prints.
"""

from __future__ import annotations

import inspect
import os
import sys
import time

VERBOSE, INFO, WARNING, ERROR = 0, 1, 2, 3
_LEVEL_NAME = {VERBOSE: "V", INFO: "I", WARNING: "W", ERROR: "E"}
_threshold = INFO


class FatalError(RuntimeError):
    """Raised by fatal(): the Error()+abort path of core/error.cpp."""


def set_verbosity(level: int):
    """Minimum severity that prints (VERBOSE..ERROR)."""
    global _threshold
    _threshold = level


def _emit(level: int, msg: str, depth: int = 2):
    if level < _threshold:
        return
    frame = inspect.stack()[depth]
    fname = os.path.basename(frame.filename)
    ts = time.strftime("%H:%M:%S")
    print(f"[{_LEVEL_NAME[level]} {ts} {fname}:{frame.lineno}] {msg}",
          file=sys.stderr, flush=True)


def verbose(msg: str):
    _emit(VERBOSE, msg)


def info(msg: str):
    _emit(INFO, msg)


def warning(msg: str):
    _emit(WARNING, msg)


def error(msg: str):
    _emit(ERROR, msg)


def fatal(msg: str):
    _emit(ERROR, "FATAL: " + msg)
    raise FatalError(msg)


def check(cond: bool, msg: str):
    """Invariant check (the CHECK()/LOG(FATAL) role)."""
    if not cond:
        fatal(msg)
