"""Wire data plane for multi-host match serving, the port of
``ncnet_tpu/serving/wire.py``: the same framing byte for byte, so a pod may
mix hosts of both packages.

The replica pool stops at a process boundary: every engine it can route
to hangs off this process's CUDA devices.  A pod has hosts
beyond that, so the fronting router (``serving/router.py``) needs a way to
hand a request to ANOTHER host's ``MatchService`` and get the classified
outcome back — with the same deadline budget and client identity the edge
promised, so the backend's admission control and SLO accounting judge the
request exactly as a local submit would.  This module is that wire:

  * **Framing.**  One binary layout for both directions: ``NCMW`` magic +
    a one-byte schema version + a length-prefixed JSON header + the raw
    array payload.  Requests carry two uint8 ``(H, W, 3)`` images (shapes
    in the header, bytes concatenated); responses carry the ``(5|6, N)``
    float32 match+quality table.  The version byte is checked BEFORE the
    header is parsed — a peer speaking a different wire schema is refused
    with :class:`WireError` (which the router classifies as a backend
    failure), never silently misread.
  * **Deadline propagation.**  The header carries ``budget_s`` — the
    REMAINING deadline budget at send time, not an absolute instant
    (wall clocks on two hosts need not agree; monotonic clocks never do).
    The serving side submits with ``deadline_s=budget_s``, so an edge
    deadline expires as a classified ``DeadlineExceeded`` at whichever
    checkpoint catches it (backend admission, dequeue, fetch, or the
    router's own post-flight check) — never as a silent backend timeout.
  * **Client identity propagation.**  ``client`` rides the header so the
    backend's per-client in-flight caps and SLO attribution see the edge
    client, not an anonymous router.
  * **Outcome totality over HTTP.**  Every response is one of the four
    terminal outcomes: ``result`` (HTTP 200 + table payload),
    ``overloaded`` (429, with machine-readable ``reason`` +
    ``retry_after_s``), ``deadline`` (504, with ``where``), ``quarantined``
    (500, with ``kind`` + ``attempts``).  :func:`decode_response` maps the
    error outcomes back onto the SAME exception classes
    (``serving/request.py``) a local submit raises, so router code cannot
    tell — and need not care — whether a service is in-process or across
    the pod.

Endpoint: ``POST /match`` on the serving introspection server
(``serving/introspect.py``), one request per call, blocking until the
request's terminal outcome.  The server threads per connection
(``ThreadingHTTPServer``), so concurrent in-flight wire requests cost one
parked thread each — the router bounds that with its per-backend depth.
"""

from __future__ import annotations

import http.client
import json
import math
import socket
import struct
import time
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import urlsplit

import numpy as np

from ncnet_tpu_torch.observability import events as obs_events
from ncnet_tpu_torch.serving.request import (
    DeadlineExceeded,
    MatchResult,
    Overloaded,
    RequestQuarantined,
)

# wire schema version: the magic+version prefix is validated before any
# payload is trusted; bump on any framing or header-semantics change so a
# mixed-version pod fails loudly instead of corrupting tables
WIRE_SCHEMA = 1
_MAGIC = b"NCMW"
_HLEN = struct.Struct("<I")

# HTTP status per terminal outcome (the body is authoritative — the status
# exists for generic infrastructure between the tiers: LBs, access logs)
_OUTCOME_STATUS = {"result": 200, "overloaded": 429, "deadline": 504,
                   "quarantined": 500}

# how long past a propagated budget the serving side waits for the settle
# before answering a classified wire-wait timeout.  The ROUTER's per-attempt
# socket ceiling must exceed budget + THIS margin (router.py adds its own
# headroom on top), or the backend's classified 504 — produced between
# budget and budget+margin — could never reach the router by construction
# and every expiring deadline would masquerade as a backend failure.
WIRE_SETTLE_MARGIN_S = 2.0

WIRE_CONTENT_TYPE = "application/x-ncnet-match"

# clock-sync sampling cadence per client connection: one NTP-style offset
# sample (half-RTT from the request/response wall stamps already on the
# wire) per this many seconds, plus every new minimum of the RTT
# (ClockSampler).  Every response CARRIES the stamps; the throttle only
# bounds the event-log fsync traffic.
CLOCK_SYNC_INTERVAL_S = 1.0


def sync_stamps(recv_t: float) -> Dict[str, Any]:
    """The ADDITIVE response-header stamps the clock-sync plane rides on:
    the server's wall clock at request receipt (``recv_t``) and response
    encode (``resp_t``), plus the server's event-log run id (``peer_run``,
    None when no sink is bound) — the node identity the federation's skew
    graph keys corrections by (hostnames collide when a test pod runs
    every process on one machine; run ids never do)."""
    sink = obs_events.get_global_sink()
    return {
        "recv_t": round(recv_t, 6),
        "resp_t": round(obs_events.wall_now(), 6),
        "peer_run": sink.run_id if sink is not None else None,
    }


def emit_clock_sync(peer: str, header: Dict[str, Any],
                    t_send: float, t_recv: float) -> None:
    """One NTP-style offset sample from a completed round trip:
    ``offset_s`` estimates peer_wall − local_wall (positive = the peer's
    clock is ahead), ``rtt_s`` is the wire time with the peer's serve time
    subtracted out.  A response without stamps (an old peer) is a no-op —
    the sync plane is additive end to end."""
    sample = _round_trip(header, t_send, t_recv)
    if sample is None:
        return
    offset, rtt = sample
    obs_events.emit(
        "clock_sync", peer=peer, peer_run=header.get("peer_run"),
        offset_s=offset, rtt_s=rtt)


def _round_trip(header: Dict[str, Any], t_send: float,
                t_recv: float) -> Optional[Tuple[float, float]]:
    """``(offset_s, rtt_s)`` of one round trip as ``clock_sync`` records
    them, or None for a response without stamps."""
    t1, t2 = header.get("recv_t"), header.get("resp_t")
    if not isinstance(t1, (int, float)) or not isinstance(t2, (int, float)):
        return None
    offset = ((float(t1) - t_send) + (float(t2) - t_recv)) / 2.0
    rtt = (t_recv - t_send) - (float(t2) - float(t1))
    return round(offset, 6), round(max(0.0, rtt), 6)


class ClockSampler:
    """Which round trips of one client become ``clock_sync`` events: one
    every ``CLOCK_SYNC_INTERVAL_S``, and besides each round trip whose RTT
    is below every RTT this client emitted before.  The federation keeps
    the minimum-RTT sample of a pair, whose offset error is at most half
    its RTT; a throttle alone keeps only the samples that fall on its
    ticks, and on a loaded host all of those can be slow.  New minima are
    few (about ln n of n round trips), so the fsync traffic stays
    bounded."""

    def __init__(self) -> None:
        self._last_t = -math.inf  # monotonic instant of the last emission
        self._best_rtt = math.inf

    def observe(self, peer: str, header: Dict[str, Any],
                t_send: float, t_recv: float) -> None:
        sample = _round_trip(header, t_send, t_recv)
        if sample is None:
            return
        now = time.monotonic()
        if now - self._last_t < CLOCK_SYNC_INTERVAL_S \
                and sample[1] >= self._best_rtt:
            return
        self._last_t = now
        self._best_rtt = min(self._best_rtt, sample[1])
        emit_clock_sync(peer, header, t_send, t_recv)


class WireError(ValueError):
    """Malformed or wrong-schema wire payload.  The router treats this as
    a backend failure (re-route + failure streak) — a peer we cannot
    understand is as unusable as one that is down."""


def _frame(header: Dict[str, Any], payload: bytes = b"") -> bytes:
    header = dict(header)
    header["schema"] = WIRE_SCHEMA
    hj = json.dumps(header, sort_keys=True).encode("utf-8")
    return _MAGIC + bytes([WIRE_SCHEMA]) + _HLEN.pack(len(hj)) + hj + payload


def _unframe(data: bytes) -> Tuple[Dict[str, Any], bytes]:
    if len(data) < len(_MAGIC) + 1 + _HLEN.size:
        raise WireError(f"wire frame truncated ({len(data)} bytes)")
    if data[:4] != _MAGIC:
        raise WireError(f"bad wire magic {data[:4]!r}")
    version = data[4]
    if version != WIRE_SCHEMA:
        raise WireError(
            f"wire schema {version} != {WIRE_SCHEMA} — refusing a frame "
            "this build does not understand")
    (hlen,) = _HLEN.unpack_from(data, 5)
    start = 5 + _HLEN.size
    if len(data) < start + hlen:
        raise WireError("wire header truncated")
    try:
        header = json.loads(data[start:start + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"unparseable wire header: {e}") from e
    if not isinstance(header, dict):
        raise WireError("wire header is not an object")
    return header, data[start + hlen:]


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------


def encode_request(src: np.ndarray, tgt: np.ndarray, *,
                   client: str = "wire",
                   budget_s: Optional[float] = None,
                   request_id: str = "",
                   stream: Optional[str] = None,
                   trace: Optional[str] = None) -> bytes:
    """One match query as wire bytes.  ``budget_s`` is the REMAINING
    deadline budget (None = no deadline); the receiving service admits
    with exactly this budget, so edge and backend judge the same promise.
    ``stream`` (optional, ADDITIVE — schema-1 peers that predate it never
    read the key) tags the request as one frame of a video stream: the
    backend routes it through its per-stream FIFO session
    (``MatchService.stream_submit``) so consecutive frames reuse temporal
    candidate priors and skip the coarse pass on steady frames.
    ``trace`` (optional, ADDITIVE like ``stream``) is the traceparent
    header (``observability/tracing.py::TraceContext.to_header``) that
    makes the backend's events part of the caller's pod-wide trace; the
    always-present ``sent_t`` wall stamp pairs with the response's
    ``recv_t``/``resp_t`` for NTP-style clock-offset sampling."""
    src = np.ascontiguousarray(src)
    tgt = np.ascontiguousarray(tgt)
    for name, a in (("src", src), ("tgt", tgt)):
        if a.ndim != 3 or a.shape[-1] != 3 or a.dtype != np.uint8:
            raise ValueError(f"{name} must be (H, W, 3) uint8 for the "
                             f"wire, got {a.shape} {a.dtype}")
    header = {
        "src_shape": list(src.shape),
        "tgt_shape": list(tgt.shape),
        "dtype": "uint8",
        "client": str(client),
        "budget_s": (round(float(budget_s), 6)
                     if budget_s is not None else None),
        "request": str(request_id),
        "sent_t": round(obs_events.wall_now(), 6),
    }
    if stream is not None:
        header["stream"] = str(stream)
    if trace is not None:
        header["trace"] = str(trace)
    return _frame(header, src.tobytes() + tgt.tobytes())


def decode_request(data: bytes
                   ) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """Wire bytes → ``(src, tgt, meta)``; raises :class:`WireError` on a
    frame this build must refuse."""
    header, payload = _unframe(data)
    if header.get("dtype") != "uint8":
        raise WireError(f"request dtype {header.get('dtype')!r} != uint8")
    try:
        ss = tuple(int(x) for x in header["src_shape"])
        ts = tuple(int(x) for x in header["tgt_shape"])
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"bad request shapes: {e}") from e
    if len(ss) != 3 or len(ts) != 3 or ss[-1] != 3 or ts[-1] != 3:
        raise WireError(f"bad request shapes {ss}/{ts}")
    n_src = int(np.prod(ss))
    if len(payload) != n_src + int(np.prod(ts)):
        raise WireError(
            f"request payload {len(payload)} bytes != declared "
            f"{n_src + int(np.prod(ts))}")
    src = np.frombuffer(payload, np.uint8, count=n_src).reshape(ss)
    tgt = np.frombuffer(payload, np.uint8, offset=n_src).reshape(ts)
    meta = {
        "client": str(header.get("client", "wire")),
        "budget_s": (float(header["budget_s"])
                     if isinstance(header.get("budget_s"), (int, float))
                     else None),
        "request": str(header.get("request", "")),
        "stream": (str(header["stream"])
                   if header.get("stream") else None),
        "trace": (str(header["trace"])
                  if header.get("trace") else None),
        "sent_t": (float(header["sent_t"])
                   if isinstance(header.get("sent_t"), (int, float))
                   else None),
    }
    return src, tgt, meta


# ---------------------------------------------------------------------------
# responses
# ---------------------------------------------------------------------------


def encode_result(result: MatchResult,
                  extra: Optional[Dict[str, Any]] = None) -> Tuple[int, bytes]:
    """``(http_status, wire bytes)`` for a served table.  ``extra`` merges
    additive header fields (the clock-sync stamps) — old readers ignore
    keys they do not know."""
    table = np.ascontiguousarray(result.table, dtype=np.float32)
    header = {
        "outcome": "result",
        "table_shape": list(table.shape),
        "dtype": "float32",
        "request": result.request_id,
        "bucket": [list(result.bucket[0]), list(result.bucket[1])],
        "wall_ms": round(result.wall_s * 1e3, 3),
        "quality": result.quality,
    }
    if extra:
        header.update(extra)
    return _OUTCOME_STATUS["result"], _frame(header, table.tobytes())


def encode_error(exc: Exception,
                 extra: Optional[Dict[str, Any]] = None) -> Tuple[int, bytes]:
    """``(http_status, wire bytes)`` for a classified terminal rejection.
    Anything that is not one of the serving outcome classes encodes as a
    quarantine-shaped 500 — the wire stays outcome-total even when the
    backend hits an unexpected bug."""
    header: Dict[str, Any] = {"message": str(exc)[:500]}
    if isinstance(exc, Overloaded):
        header.update(outcome="overloaded", reason=exc.reason,
                      retry_after_s=exc.retry_after_s)
    elif isinstance(exc, DeadlineExceeded):
        header.update(outcome="deadline", where=exc.where)
    elif isinstance(exc, RequestQuarantined):
        header.update(outcome="quarantined", kind=exc.kind,
                      attempts=exc.attempts)
    else:
        header.update(outcome="quarantined", kind="internal", attempts=1)
    if extra:
        header.update(extra)
    return _OUTCOME_STATUS[header["outcome"]], _frame(header)


def decode_response(data: bytes) -> MatchResult:
    """Wire response → :class:`MatchResult`, or RAISES the classified
    terminal error exactly as a local ``MatchFuture.result()`` would."""
    header, payload = _unframe(data)
    return _response_from(header, payload)


def _response_from(header: Dict[str, Any], payload: bytes) -> MatchResult:
    outcome = header.get("outcome")
    msg = str(header.get("message", ""))
    if outcome == "overloaded":
        ra = header.get("retry_after_s")
        raise Overloaded(msg or "backend overloaded",
                         reason=str(header.get("reason", "unknown")),
                         retry_after_s=float(ra) if isinstance(
                             ra, (int, float)) else None)
    if outcome == "deadline":
        raise DeadlineExceeded(msg or "deadline expired at the backend",
                               where=str(header.get("where", "backend")))
    if outcome == "quarantined":
        raise RequestQuarantined(
            msg or "backend quarantined the request",
            kind=str(header.get("kind", "unknown")),
            attempts=int(header.get("attempts", 1) or 1))
    if outcome != "result":
        raise WireError(f"unknown wire outcome {outcome!r}")
    if header.get("dtype") != "float32":
        raise WireError(f"result dtype {header.get('dtype')!r} != float32")
    try:
        shape = tuple(int(x) for x in header["table_shape"])
        (sh, sw), (th, tw) = header["bucket"]
        bucket = ((int(sh), int(sw)), (int(th), int(tw)))
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"bad result header: {e}") from e
    n = int(np.prod(shape)) if shape else 0
    if len(payload) != n * 4:
        raise WireError(
            f"result payload {len(payload)} bytes != declared {n * 4}")
    table = np.frombuffer(payload, np.float32).reshape(shape)
    quality = header.get("quality")
    return MatchResult(
        request_id=str(header.get("request", "")),
        table=table,
        quality={str(k): float(v) for k, v in quality.items()}
        if isinstance(quality, dict) else None,
        bucket=bucket,
        wall_s=float(header.get("wall_ms", 0.0)) / 1e3,
    )


# ---------------------------------------------------------------------------
# server side: the /match handler body
# ---------------------------------------------------------------------------


def serve_match(submit: Callable[..., Any], body: bytes, *,
                max_wait_s: float = 600.0,
                stream_submit: Optional[Callable[..., Any]] = None
                ) -> Tuple[int, str, bytes]:
    """Handle one wire request against ``submit`` (a ``MatchService.submit``
    or ``MatchRouter.submit`` — the wire cannot tell tiers apart): decode,
    admit with the propagated budget + client, BLOCK until the terminal
    outcome, encode it.  Returns ``(status, content_type, payload)`` for
    the HTTP handler.  ``max_wait_s`` bounds the wait for budget-less
    requests only — a budgeted request settles by its own deadline (plus a
    small margin for the settle itself).

    A ``stream``-tagged request routes through ``stream_submit``
    (``MatchService.stream_submit``) when the fronted service provides one
    — the per-stream FIFO session that carries temporal priors across
    frames.  A host without a streaming plane (a router) serves the frame
    as an ordinary request: correct, just never coarse-skipped.

    Every response — result or classified rejection — carries the
    clock-sync stamps (:func:`sync_stamps`): ``recv_t`` is taken HERE,
    before the decode, so the stamped serve interval covers everything the
    peer's half-RTT estimate must exclude.
    """
    recv_t = obs_events.wall_now()
    try:
        src, tgt, meta = decode_request(body)
    except WireError as e:
        # deliberate 400 override of the quarantine-shaped body's 500:
        # the frame itself was unserviceable, a caller error
        _, payload = encode_error(RequestQuarantined(
            f"unserviceable wire request: {e}", kind="wire", attempts=1),
            extra=sync_stamps(recv_t))
        return 400, WIRE_CONTENT_TYPE, payload
    budget = meta["budget_s"]
    # the trace rides into the fronted tier as a keyword only when the
    # peer sent one: an untraced request reaches `submit` with the exact
    # pre-trace signature, so wrapped/legacy submits keep working
    tr = {"trace": meta["trace"]} if meta.get("trace") else {}
    try:
        if meta.get("stream") and stream_submit is not None:
            result = stream_submit(
                meta["stream"], src, tgt, deadline_s=budget,
                client=meta["client"], **tr).result
        else:
            fut = submit(src, tgt, deadline_s=budget,
                         client=meta["client"], **tr)
            result = fut.result(
                timeout=(budget + WIRE_SETTLE_MARGIN_S)
                if budget is not None else max_wait_s)
    except TimeoutError:
        # only reachable when the serving side failed to settle within its
        # own budget (or the budget-less cap): answer a classified timeout,
        # never hold the connection forever
        status, payload = encode_error(DeadlineExceeded(
            "request did not settle within the wire wait bound",
            where="wire_wait"), extra=sync_stamps(recv_t))
        return status, WIRE_CONTENT_TYPE, payload
    except (Overloaded, DeadlineExceeded, RequestQuarantined) as e:
        status, payload = encode_error(e, extra=sync_stamps(recv_t))
        return status, WIRE_CONTENT_TYPE, payload
    except Exception as e:  # noqa: BLE001 — the wire stays outcome-total
        status, payload = encode_error(e, extra=sync_stamps(recv_t))
        return status, WIRE_CONTENT_TYPE, payload
    status, payload = encode_result(result, extra=sync_stamps(recv_t))
    return status, WIRE_CONTENT_TYPE, payload


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------


class MatchClient:
    """One persistent HTTP/1.1 connection to a backend's ``/match``.

    NOT thread-safe — the router pools one client per concurrent attempt
    per backend.  Transport failures (refused, reset, hung socket past the
    timeout) raise their native ``OSError``/``http.client`` exceptions with
    the connection closed, so the next :meth:`match` reconnects; classified
    serving outcomes raise the ``serving/request.py`` exception classes via
    :func:`decode_response`.
    """

    def __init__(self, base_url: str, timeout_s: float = 30.0):
        parts = urlsplit(base_url if "//" in base_url
                         else f"http://{base_url}")
        if not parts.hostname or not parts.port:
            raise ValueError(f"backend url needs host:port, got {base_url!r}")
        self.base_url = f"http://{parts.hostname}:{parts.port}"
        self._host = parts.hostname
        self._port = int(parts.port)
        self.timeout_s = float(timeout_s)
        self._conn: Optional[http.client.HTTPConnection] = None
        self._clock = ClockSampler()

    def _connection(self, timeout: float) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self._host, self._port, timeout=timeout)
        elif self._conn.sock is not None:
            self._conn.sock.settimeout(timeout)
        else:
            self._conn.timeout = timeout
        return self._conn

    def match(self, src: np.ndarray, tgt: np.ndarray, *,
              client: str = "wire", budget_s: Optional[float] = None,
              request_id: str = "", stream: Optional[str] = None,
              trace: Optional[str] = None,
              timeout_s: Optional[float] = None) -> MatchResult:
        """One wire round trip.  ``timeout_s`` bounds the WHOLE attempt at
        the socket level (send + the backend's serve + the response read) —
        the hung-socket backstop the router relies on to keep a wedged host
        from absorbing its workers.  ``trace`` propagates the caller's
        traceparent header; each round trip also yields one NTP-style
        clock-offset sample against this peer, which ``ClockSampler``
        may emit as a ``clock_sync`` event."""
        from ncnet_tpu_torch.utils import faults

        # the multi-host chaos seam: injected backend death / socket hang
        # without needing a real process to kill (the chaos suite also
        # kills real processes; this hook covers the in-process tests)
        faults.backend_fault_hook(self.base_url, "send")
        body = encode_request(src, tgt, client=client, budget_s=budget_s,
                              request_id=request_id, stream=stream,
                              trace=trace)
        conn = self._connection(timeout_s if timeout_s is not None
                                else self.timeout_s)
        t_send = obs_events.wall_now()
        try:
            conn.request("POST", "/match", body=body,
                         headers={"Content-Type": WIRE_CONTENT_TYPE})
            resp = conn.getresponse()
            data = resp.read()
        except (OSError, http.client.HTTPException, socket.timeout):
            self.close()  # the connection state is unknowable: reconnect
            raise
        t_recv = obs_events.wall_now()
        header, payload = _unframe(data)
        self._clock.observe(self.base_url, header, t_send, t_recv)
        return _response_from(header, payload)

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — closing a dead socket
                pass

    def __enter__(self) -> "MatchClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
