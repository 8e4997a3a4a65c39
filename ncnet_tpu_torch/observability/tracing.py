"""Hierarchical span tracing, the port of
``ncnet_tpu/observability/tracing.py``.

A span is a named interval with a ``span_id``/``parent_id`` pair, emitted
as ordinary events into the bound
:class:`~ncnet_tpu_torch.observability.events.EventLog`:

  1. Crash visibility: a span emits ``span`` with ``ph="B"`` at entry and
     ``ph="E"`` (with ``dur_s``) at exit, so a process killed mid-span
     leaves the ``B`` on disk.
  2. No cost unbound: entering a span with no sink bound is one ``is None``
     check.
  3. Threads: the parent comes from a per-thread stack, and the thread id
     rides on the ``B`` event.

Span ids are process-unique monotonic ints; consumers key spans by
``(run, span)``.  The JAX module's cross-process trace context (the
traceparent-style header its router and pod carry) has no caller in the
port yet and is not ported.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Optional

from ncnet_tpu_torch.observability import events as _events

_ids = itertools.count(1)  # next() is atomic in CPython; no lock needed
_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span_id() -> Optional[int]:
    """The innermost open span id on this thread, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


class span:
    """``with span("dispatch", step=3): ...`` — one traced interval.

    Emits ``span``/``ph="B"`` on entry and ``span``/``ph="E"`` (carrying the
    monotonic ``dur_s``) on exit; extra keyword fields ride on the ``B``
    event.  Inert (single sink check, no stack traffic) when no event sink
    is bound at entry; if the sink disappears mid-span the ``E`` is dropped
    by ``emit`` and a reader treats the span as unclosed — the same
    degradation as a crash, never an error.
    """

    __slots__ = ("name", "fields", "_id", "_parent", "_t0")

    def __init__(self, name: str, **fields):
        self.name = name
        self.fields = fields
        self._id: Optional[int] = None

    def __enter__(self) -> "span":
        if _events.get_global_sink() is None:
            return self  # inert: _id stays None and __exit__ is one check
        st = _stack()
        self._parent = st[-1] if st else None
        self._id = next(_ids)
        st.append(self._id)
        self._t0 = time.perf_counter()
        _events.emit(
            "span", ph="B", name=self.name, span=self._id,
            parent=self._parent, tid=threading.get_ident(), **self.fields,
        )
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._id is None:
            return
        dur = time.perf_counter() - self._t0
        st = _stack()
        # normally a plain pop; identity removal tolerates a caller that
        # closed spans out of order (telemetry must never raise into the run)
        if st and st[-1] == self._id:
            st.pop()
        elif self._id in st:
            st.remove(self._id)
        fields = {"ph": "E", "name": self.name, "span": self._id,
                  "dur_s": round(dur, 6)}
        if exc_type is not None:
            fields["error"] = exc_type.__name__
        _events.emit("span", **fields)


def traced(name: Optional[str] = None, **fields):
    """Decorator form: ``@traced("pnp_query")`` wraps the call in a span
    (default name: the function's ``__name__``)."""

    def deco(fn):
        span_name = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(span_name, **fields):
                return fn(*args, **kwargs)

        return wrapper

    return deco
