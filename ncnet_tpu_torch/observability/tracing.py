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
``(run, span)``.

A request that crosses processes needs an identity that survives the
wire: :class:`TraceContext`, a traceparent-style triple (``trace_id``, the
sender's ``parent_span``, the ``origin`` host) rendered as one header
string, ``00-<trace_id>-<parent hex>-<origin>``, the JAX package's format.
The service stamps the bare trace id (:func:`normalize_trace`) on every
event a request touches.
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

# the header version; an unknown version parses as no trace (a trace header
# never makes a request fail)
TRACE_VERSION = "00"


class TraceContext:
    """One request identity across processes: ``trace_id`` (32 hex chars),
    the sender's ``parent_span`` (a process-local span id, or None) and the
    ``origin`` host that stamped it."""

    __slots__ = ("trace_id", "parent_span", "origin")

    def __init__(self, trace_id: str, parent_span: Optional[int] = None,
                 origin: Optional[str] = None):
        import socket

        self.trace_id = str(trace_id)
        self.parent_span = parent_span
        self.origin = origin if origin is not None else socket.gethostname()

    def to_header(self) -> str:
        """``00-<trace_id>-<parent_span hex>-<origin>``; the origin rides
        last so a hostname with ``-`` still parses."""
        parent = (f"{self.parent_span:x}"
                  if isinstance(self.parent_span, int) else "0")
        return f"{TRACE_VERSION}-{self.trace_id}-{parent}-{self.origin}"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.to_header()!r})"


def new_trace(origin: Optional[str] = None) -> TraceContext:
    """A fresh trace: 16 random bytes as 32 hex chars, parented to this
    thread's innermost open span (None outside any span)."""
    import os as _os

    return TraceContext(_os.urandom(16).hex(),
                        parent_span=current_span_id(), origin=origin)


def parse_trace(header: Optional[str]) -> Optional[TraceContext]:
    """A :class:`TraceContext` from a header, or None for anything this
    build does not understand (missing, malformed, unknown version).
    Never raises."""
    if not header or not isinstance(header, str):
        return None
    parts = header.split("-", 3)
    if len(parts) != 4 or parts[0] != TRACE_VERSION or not parts[1]:
        return None
    try:
        parent = int(parts[2], 16) or None
    except ValueError:
        return None
    return TraceContext(parts[1], parent_span=parent, origin=parts[3])


def trace_id_of(header: Optional[str]) -> Optional[str]:
    """The trace id out of a header, or None when it does not parse."""
    ctx = parse_trace(header)
    return ctx.trace_id if ctx is not None else None


def adopt_trace(value, origin: Optional[str] = None) -> TraceContext:
    """Stamp or adopt: a caller's context (a :class:`TraceContext`, a
    header or a bare id) becomes the context; anything unusable mints a
    fresh trace.  Always returns a context."""
    if isinstance(value, TraceContext):
        return value
    if value:
        ctx = parse_trace(str(value))
        if ctx is not None:
            return ctx
        return TraceContext(str(value), parent_span=current_span_id(),
                            origin=origin)
    return new_trace(origin)


def normalize_trace(value) -> Optional[str]:
    """The bare trace id out of a :class:`TraceContext`, a header, a bare
    id or nothing; a junk value degrades to itself as an opaque id."""
    if value is None:
        return None
    if isinstance(value, TraceContext):
        return value.trace_id
    s = str(value)
    return trace_id_of(s) or (s or None)


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
