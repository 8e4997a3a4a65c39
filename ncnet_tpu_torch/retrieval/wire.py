"""Retrieval wire plane: ``POST /retrieve`` on the NCMW framing, the port
of ``ncnet_tpu/retrieval/wire.py``: the same frames byte for byte, so
shards and coordinators of both packages talk to each other.

The match wire (``serving/wire.py``) carries image pairs to one backend;
the retrieval wire carries a query's POOLED coarse descriptor to many
shard hosts and their scored pano lists back.  Same versioned ``NCMW``
framing (magic + schema byte checked before anything is trusted), same
``budget_s`` remaining-deadline contract, same outcome-total HTTP mapping
onto the ``serving/request.py`` exception classes — so coordinator code
cannot tell, and need not care, whether a shard is in-process or across
the pod.

One addition the match wire does not need: the RESULT payload carries a
sha256 checksum in its header.  A shard's answer is a small JSON document
(scores + the consulted-pano accounting that feeds the coverage contract)
— silent corruption of one score would reorder a shortlist with no
downstream integrity check to catch it, so the client verifies the digest
and refuses a mismatch as :class:`~ncnet_tpu_torch.serving.wire.WireError`
(= shard failure → the coordinator re-routes those panos to a replica).
The ``shard_bitflip_urls`` chaos hook flips a response byte client-side to
prove exactly that path.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import socket
from typing import Any, Callable, Dict, Optional, Sequence, Tuple
from urllib.parse import urlsplit

import numpy as np

from ncnet_tpu_torch.observability import events as obs_events
from ncnet_tpu_torch.serving.request import (
    DeadlineExceeded,
    Overloaded,
    RequestQuarantined,
)
from ncnet_tpu_torch.serving.wire import (
    _frame,
    _unframe,
    _OUTCOME_STATUS,
    WIRE_SETTLE_MARGIN_S,
    ClockSampler,
    WireError,
    sync_stamps,
)

RETRIEVE_CONTENT_TYPE = "application/x-ncnet-retrieve"

__all__ = [
    "RETRIEVE_CONTENT_TYPE",
    "RetrieveClient",
    "decode_retrieve_request",
    "decode_retrieve_response",
    "encode_retrieve_request",
    "encode_retrieve_response",
    "serve_retrieve",
]


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------


def encode_retrieve_request(desc: np.ndarray, *,
                            panos: Optional[Sequence[str]] = None,
                            topk: Optional[int] = None,
                            client: str = "wire",
                            budget_s: Optional[float] = None,
                            request_id: str = "",
                            probe: bool = False,
                            trace: Optional[str] = None) -> bytes:
    """One retrieval query as wire bytes.  ``panos`` scopes the sweep to a
    subset of the receiver's assigned panos (the coordinator's scatter
    plan / failover re-dispatch); None = score everything assigned.
    ``probe=True`` marks the coordinator's resurrection probe — answered
    through the full data plane without scoring anything.  ``trace`` is
    the additive pod-trace header (old shards ignore the key losslessly);
    ``sent_t`` always rides so responses can carry the NTP-style clock
    stamps back (``serving/wire.py::sync_stamps``)."""
    d = np.ascontiguousarray(np.asarray(desc, dtype=np.float32).ravel())
    header = {
        "kind": "retrieve",
        "dim": int(d.shape[0]),
        "dtype": "float32",
        "panos": ([str(p) for p in panos] if panos is not None else None),
        "topk": (int(topk) if topk is not None else None),
        "client": str(client),
        "budget_s": (round(float(budget_s), 6)
                     if budget_s is not None else None),
        "request": str(request_id),
        "probe": bool(probe),
        "sent_t": round(obs_events.wall_now(), 6),
    }
    if trace:
        header["trace"] = str(trace)
    return _frame(header, d.tobytes())


def decode_retrieve_request(data: bytes
                            ) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Wire bytes → ``(descriptor, meta)``; raises :class:`WireError` on a
    frame this build must refuse."""
    header, payload = _unframe(data)
    if header.get("kind") != "retrieve":
        raise WireError(f"not a retrieve frame: kind={header.get('kind')!r}")
    if header.get("dtype") != "float32":
        raise WireError(f"descriptor dtype {header.get('dtype')!r} != "
                        "float32")
    try:
        dim = int(header["dim"])
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"bad descriptor dim: {e}") from e
    if dim < 1 or len(payload) != dim * 4:
        raise WireError(f"descriptor payload {len(payload)} bytes != "
                        f"declared {dim * 4}")
    desc = np.frombuffer(payload, np.float32, count=dim)
    panos = header.get("panos")
    meta = {
        "panos": ([str(p) for p in panos]
                  if isinstance(panos, list) else None),
        "topk": (int(header["topk"])
                 if isinstance(header.get("topk"), (int, float)) else None),
        "client": str(header.get("client", "wire")),
        "budget_s": (float(header["budget_s"])
                     if isinstance(header.get("budget_s"), (int, float))
                     else None),
        "request": str(header.get("request", "")),
        "probe": bool(header.get("probe", False)),
        "trace": (str(header["trace"])
                  if isinstance(header.get("trace"), str) else None),
        "sent_t": (float(header["sent_t"])
                   if isinstance(header.get("sent_t"), (int, float))
                   else None),
    }
    return desc, meta


# ---------------------------------------------------------------------------
# responses
# ---------------------------------------------------------------------------


def encode_retrieve_response(answer: Dict[str, Any],
                             extra: Optional[Dict[str, Any]] = None
                             ) -> Tuple[int, bytes]:
    """``(http_status, wire bytes)`` for a shard's (or coordinator's)
    answer document.  The document travels as canonical JSON payload with
    its sha256 in the header — the integrity seal the client verifies.
    ``extra`` merges additive header fields (the clock-sync stamps);
    the seal covers the payload only, so stamps stay out of the digest."""
    payload = json.dumps(answer, sort_keys=True).encode("utf-8")
    header = {
        "outcome": "result",
        "kind": "retrieve",
        "sha256": hashlib.sha256(payload).hexdigest(),
    }
    if extra:
        header.update(extra)
    return _OUTCOME_STATUS["result"], _frame(header, payload)


def encode_retrieve_error(exc: Exception,
                          extra: Optional[Dict[str, Any]] = None
                          ) -> Tuple[int, bytes]:
    """Classified terminal rejection — same outcome classes and status
    mapping as the match wire (``serving/wire.py::encode_error``); an
    unexpected exception encodes as a quarantine-shaped 500 so the wire
    stays outcome-total."""
    header: Dict[str, Any] = {"kind": "retrieve",
                              "message": str(exc)[:500]}
    if extra:
        header.update(extra)
    if isinstance(exc, Overloaded):
        header.update(outcome="overloaded", reason=exc.reason,
                      retry_after_s=exc.retry_after_s)
    elif isinstance(exc, DeadlineExceeded):
        header.update(outcome="deadline", where=exc.where)
    elif isinstance(exc, RequestQuarantined):
        header.update(outcome="quarantined", kind_=exc.kind,
                      attempts=exc.attempts)
    else:
        header.update(outcome="quarantined", kind_="internal", attempts=1)
    return _OUTCOME_STATUS[header["outcome"]], _frame(header)


def decode_retrieve_response(data: bytes) -> Dict[str, Any]:
    """Wire response → the answer document, or RAISES the classified
    terminal error exactly as the local call would.  A payload whose
    sha256 does not match its header is a :class:`WireError` — corrupt
    bytes from a shard are a SHARD failure (re-route to a replica), never
    a silently reordered shortlist."""
    header, payload = _unframe(data)
    return _retrieve_response_from(header, payload)


def _retrieve_response_from(header: Dict[str, Any],
                            payload: bytes) -> Dict[str, Any]:
    """The classify-or-return body of :func:`decode_retrieve_response`,
    split out so the client can read the clock-sync stamps off the header
    before the outcome check raises."""
    outcome = header.get("outcome")
    msg = str(header.get("message", ""))
    if outcome == "overloaded":
        ra = header.get("retry_after_s")
        raise Overloaded(msg or "shard overloaded",
                         reason=str(header.get("reason", "unknown")),
                         retry_after_s=float(ra) if isinstance(
                             ra, (int, float)) else None)
    if outcome == "deadline":
        raise DeadlineExceeded(msg or "deadline expired at the shard",
                               where=str(header.get("where", "shard")))
    if outcome == "quarantined":
        raise RequestQuarantined(
            msg or "shard quarantined the request",
            kind=str(header.get("kind_", "unknown")),
            attempts=int(header.get("attempts", 1) or 1))
    if outcome != "result":
        raise WireError(f"unknown retrieve outcome {outcome!r}")
    want = header.get("sha256")
    got = hashlib.sha256(payload).hexdigest()
    if not isinstance(want, str) or want != got:
        raise WireError(
            f"retrieve payload checksum mismatch ({got[:12]}… != declared "
            f"{str(want)[:12]}…) — refusing corrupt scores")
    try:
        answer = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"unparseable retrieve answer: {e}") from e
    if not isinstance(answer, dict):
        raise WireError("retrieve answer is not an object")
    return answer


# ---------------------------------------------------------------------------
# server side: the /retrieve handler body
# ---------------------------------------------------------------------------


def serve_retrieve(retrieve: Callable[..., Dict[str, Any]], body: bytes, *,
                   max_wait_s: float = 600.0) -> Tuple[int, str, bytes]:
    """Handle one wire request against ``retrieve`` (a
    ``ShardService.retrieve`` or ``RetrievalCoordinator.retrieve`` — the
    wire cannot tell tiers apart): decode, call with the propagated budget
    + client + pano scope, encode the answer.  Returns ``(status,
    content_type, payload)`` for the HTTP handler.  ``max_wait_s`` is
    advisory here (the call is synchronous); a budgeted request classifies
    its own :class:`DeadlineExceeded` at the scoring loop's checkpoints."""
    recv_t = obs_events.wall_now()
    try:
        desc, meta = decode_retrieve_request(body)
    except WireError as e:
        # deliberate 400 override, same as the match wire: the frame
        # itself was unserviceable, a caller error
        _, payload = encode_retrieve_error(RequestQuarantined(
            f"unserviceable retrieve request: {e}", kind="wire",
            attempts=1), extra=sync_stamps(recv_t))
        return 400, RETRIEVE_CONTENT_TYPE, payload
    del max_wait_s  # symmetry with serve_match; the call blocks inline
    # additive trace pass-through: only traced requests add the kwarg so a
    # retrieve callable without it keeps working for untraced callers
    tr = {"trace": meta["trace"]} if meta.get("trace") else {}
    try:
        answer = retrieve(
            desc, panos=meta["panos"], topk=meta["topk"],
            budget_s=meta["budget_s"], client=meta["client"],
            request_id=meta["request"], probe=meta["probe"], **tr)
    except (Overloaded, DeadlineExceeded, RequestQuarantined) as e:
        status, payload = encode_retrieve_error(
            e, extra=sync_stamps(recv_t))
        return status, RETRIEVE_CONTENT_TYPE, payload
    except Exception as e:  # noqa: BLE001 — the wire stays outcome-total
        status, payload = encode_retrieve_error(
            e, extra=sync_stamps(recv_t))
        return status, RETRIEVE_CONTENT_TYPE, payload
    status, payload = encode_retrieve_response(
        answer, extra=sync_stamps(recv_t))
    return status, RETRIEVE_CONTENT_TYPE, payload


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------


class RetrieveClient:
    """One persistent HTTP/1.1 connection to a shard's ``/retrieve``.

    NOT thread-safe — the coordinator pools one client per concurrent
    attempt per shard (``ShardBackend.acquire``).  Transport failures
    raise their native exceptions with the connection closed so the next
    call reconnects; classified outcomes raise the ``serving/request.py``
    exception classes via :func:`decode_retrieve_response`.
    """

    def __init__(self, base_url: str, timeout_s: float = 30.0):
        parts = urlsplit(base_url if "//" in base_url
                         else f"http://{base_url}")
        if not parts.hostname or not parts.port:
            raise ValueError(f"shard url needs host:port, got {base_url!r}")
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

    def retrieve(self, desc: np.ndarray, *,
                 panos: Optional[Sequence[str]] = None,
                 topk: Optional[int] = None,
                 client: str = "wire", budget_s: Optional[float] = None,
                 request_id: str = "", probe: bool = False,
                 timeout_s: Optional[float] = None,
                 trace: Optional[str] = None) -> Dict[str, Any]:
        """One wire round trip.  ``timeout_s`` bounds the WHOLE attempt at
        the socket level — the hung-socket backstop that keeps a wedged
        shard from absorbing the coordinator's dispatch slots."""
        from ncnet_tpu_torch.utils import faults

        # the retrieval chaos seam: injected shard death / stalled-peer
        # hang / straggler slowness without a real process to kill (the
        # chaos suite also SIGKILLs real serve_shard processes)
        faults.shard_fault_hook(self.base_url, "send")
        body = encode_retrieve_request(
            desc, panos=panos, topk=topk, client=client, budget_s=budget_s,
            request_id=request_id, probe=probe, trace=trace)
        conn = self._connection(timeout_s if timeout_s is not None
                                else self.timeout_s)
        t_send = obs_events.wall_now()
        try:
            conn.request("POST", "/retrieve", body=body,
                         headers={"Content-Type": RETRIEVE_CONTENT_TYPE})
            resp = conn.getresponse()
            data = resp.read()
        except (OSError, http.client.HTTPException, socket.timeout):
            self.close()  # the connection state is unknowable: reconnect
            raise
        t_recv = obs_events.wall_now()
        # response-corruption chaos seam: a flipped byte here must fail the
        # checksum in decode_retrieve_response, never reorder a shortlist
        data = faults.shard_payload_hook(self.base_url, data)
        header, payload = _unframe(data)
        self._clock.observe(self.base_url, header, t_send, t_recv)
        return _retrieve_response_from(header, payload)

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — closing a dead socket
                pass

    def __enter__(self) -> "RetrieveClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# re-exported for coordinator symmetry with the match tier
SETTLE_MARGIN_S = WIRE_SETTLE_MARGIN_S
