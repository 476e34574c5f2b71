"""Leveled, structured logging in the style of k8s klog.

The port's copy of the part of ``platform_aware_scheduling_tpu/utils/klog.py``
that the port uses: ``v(level).info_s(msg, component=..)``, ``warning`` and
``error`` on top of the stdlib ``logging`` module, with the verbosity set by
``set_verbosity`` or the ``PAS_TPU_LOG_LEVEL`` env var, and
``request_context`` stamping the serving request's id on every line.
"""

from __future__ import annotations

import contextvars
import logging
import os
import sys
import threading
from contextlib import contextmanager

_logger = logging.getLogger("pas_tpu_torch")
_lock = threading.Lock()
_verbosity = int(os.environ.get("PAS_TPU_LOG_LEVEL", "0") or 0)
_configured = False

# the active request's X-Request-ID, stamped onto every structured line
# emitted while serving it so /debug/traces joins against the logs
_request_id: contextvars.ContextVar = contextvars.ContextVar("pas_request_id", default="")


@contextmanager
def request_context(request_id: str):
    """Scope the current request id: ``info_s`` lines inside the scope
    carry ``request_id="..."``."""
    token = _request_id.set(request_id or "")
    try:
        yield
    finally:
        _request_id.reset(token)


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
    rid = _request_id.get()
    if rid and "request_id" not in kv:
        kv = {**kv, "request_id": rid}
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


def warning(msg: str, *args) -> None:
    _ensure_configured()
    _logger.warning(msg % args if args else msg)


def error(msg: str, *args) -> None:
    _ensure_configured()
    _logger.error(msg % args if args else msg)
