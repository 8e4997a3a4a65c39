"""Leveled logger, the port of ``ncnet_tpu/observability/logging.py``: one
console sink plus a structured tee into the event log.

  * Console: ``info`` renders the message verbatim; ``warning``/``error``
    prefix ``warning: `` / ``error: `` once.  ``sys.stdout`` is looked up per
    call, so pytest's capture and redirections both see the output.
  * Tee: every rendered line is also emitted to the process-global event
    sink as a ``log`` record (``level``, ``logger``, ``msg`` and an optional
    ``kind`` classification); no sink bound, no cost.

``NCNET_TPU_LOG_LEVEL`` (debug|info|warning|error) filters both; default
``info``.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

from ncnet_tpu_torch.observability import events as _events

LOG_LEVEL_ENV = "NCNET_TPU_LOG_LEVEL"

_LEVELS: Dict[str, int] = {"debug": 10, "info": 20, "warning": 30,
                           "error": 40}
_PREFIXES = {"warning": "warning: ", "error": "error: "}


def _threshold() -> int:
    name = os.environ.get(LOG_LEVEL_ENV, "").strip().lower()
    return _LEVELS.get(name, _LEVELS["info"])


class Logger:
    """One named channel.  ``kind`` classifies a line (decode, device,
    timeout, io, quarantine, tier, ...) for the replayed log."""

    def __init__(self, name: str):
        self.name = name

    def _log(self, level: str, msg: str, kind: Optional[str]) -> None:
        if _LEVELS[level] < _threshold():
            return
        sys.stdout.write(_PREFIXES.get(level, "") + msg + "\n")
        fields = {"level": level, "logger": self.name, "msg": msg}
        if kind is not None:
            fields["kind"] = kind
        _events.emit("log", **fields)

    def debug(self, msg: str, kind: Optional[str] = None) -> None:
        self._log("debug", msg, kind)

    def info(self, msg: str, kind: Optional[str] = None) -> None:
        self._log("info", msg, kind)

    def warning(self, msg: str, kind: Optional[str] = None) -> None:
        self._log("warning", msg, kind)

    def error(self, msg: str, kind: Optional[str] = None) -> None:
        self._log("error", msg, kind)


_loggers: Dict[str, Logger] = {}


def get_logger(name: str) -> Logger:
    """The named logger (cached: one object a name)."""
    log = _loggers.get(name)
    if log is None:
        log = _loggers[name] = Logger(name)
    return log
