"""Leveled, structured logging in the style of k8s klog.

The port's copy of the part of ``platform_aware_scheduling_tpu/utils/klog.py``
that the cache and the planner use: ``v(level).info_s(msg, component=..)``
and ``error`` on top of the stdlib ``logging`` module, with the
verbosity set by ``set_verbosity`` or the ``PAS_TPU_LOG_LEVEL`` env var.
"""

from __future__ import annotations

import logging
import os
import sys
import threading

_logger = logging.getLogger("pas_tpu_torch")
_lock = threading.Lock()
_verbosity = int(os.environ.get("PAS_TPU_LOG_LEVEL", "0") or 0)
_configured = False


def _ensure_configured() -> None:
    global _configured
    with _lock:
        if _configured:
            return
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname).1s %(message)s")
        )
        _logger.addHandler(handler)
        _logger.setLevel(logging.INFO)
        _logger.propagate = False
        _configured = True


def set_verbosity(level: int) -> None:
    """Set the global verbosity (the ``--v`` flag of the service mains)."""
    global _verbosity
    _verbosity = int(level)


def _escape_value(value) -> str:
    # structured values render inside double quotes on one line
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
        .replace("\r", "\\r")
    )


def _fmt(msg: str, kv: dict) -> str:
    if not kv:
        return msg
    pairs = " ".join(f'{k}="{_escape_value(v)}"' for k, v in kv.items())
    return f"{msg} {pairs}"


class _Verbose:
    __slots__ = ("_enabled",)

    def __init__(self, enabled: bool):
        self._enabled = enabled

    def info_s(self, msg: str, **kv) -> None:
        if self._enabled:
            _ensure_configured()
            _logger.info(_fmt(msg, kv))


def v(level: int) -> _Verbose:
    return _Verbose(level <= _verbosity)


def error(msg: str, *args) -> None:
    _ensure_configured()
    _logger.error(msg % args if args else msg)
