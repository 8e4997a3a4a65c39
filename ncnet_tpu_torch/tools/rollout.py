"""Kick and watch a live model rollout over the serving control plane.

The port of the root ``tools/rollout.py``: the same reading of the same
records, with the same text, JSON and exit codes, on the port's own
modules, so an operator of the port needs no JAX.

The operator-facing half of ``ncnet_tpu_torch/serving/rollout.py``: one
invocation POSTs ``{"checkpoint": ...}`` to a serving host's
``/rollout`` endpoint (``serving/introspect.py`` — the same wire plane
``POST /match`` rides), then polls ``GET /rollout`` until the state
machine reaches a terminal phase, printing each phase transition as it is
observed.  The whole exchange is plain HTTP against the introspection
port, so the tool runs from ANY host that can reach the pod — no shared
filesystem, no in-process access.

The candidate checkpoint path is resolved ON THE SERVING HOST (its
newest-complete version), so pass a path meaningful there.  Judge
knobs (canary fraction, PSI threshold, ...) ride along in the same JSON
body; unset knobs take the ``RolloutConfig`` defaults.

``--watch`` skips the POST and just follows whatever rollout is already
in flight — the second-operator shape, and the recovery shape after this
tool (not the rollout) died mid-watch.

Exit codes mirror the terminal phase so supervisors can script on them:

  * 0 — COMPLETE (promoted; the pod converged on the new version);
  * 2 — ROLLED_BACK (the canary judge or a swap failure auto-rolled the
    pod back to the old version — the pod is consistent, the CANDIDATE
    is what needs attention);
  * 1 — anything else: refusal at staging (the ``IDLE`` terminal, e.g.
    checksum/arch mismatch), an unreachable host, a 4xx/5xx answer, or
    the poll timeout expiring with the rollout still in flight (the
    rollout itself keeps running server-side; re-attach with --watch).

Usage::

    python -m ncnet_tpu_torch.tools.rollout http://host:port ckpts/run42 \
        [--canary-fraction 0.25] [--canary-min-results 16]
        [--psi-threshold 0.25] [--state-path /path/state.json]
        [--poll 0.5] [--timeout 600] [--watch] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Tuple

from ncnet_tpu_torch.observability.tracing import new_trace

TERMINAL_PHASES = ("COMPLETE", "ROLLED_BACK", "IDLE")


def _out(line: str) -> None:
    # this tool's stdout IS its interface (the no-bare-print pin covers
    # it): one timeline line per observed transition, flushed so a
    # supervisor tailing the pipe sees phases as they happen
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _get(url: str, timeout: float) -> Dict[str, Any]:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8"))


def post_rollout(base: str, checkpoint: str, knobs: Dict[str, Any],
                 timeout: float = 10.0) -> Tuple[int, Dict[str, Any]]:
    """``POST /rollout``; returns ``(http_status, parsed_or_error_doc)``.
    202 carries the controller's first status snapshot; 4xx/5xx carry
    ``{"error": <the server's plain-text answer>}``.  The body carries a
    fresh pod trace (additive ``trace`` key — old hosts ignore it), so
    the operator's rollout order shows up in the federated pod trace."""
    body = json.dumps({"checkpoint": checkpoint,
                       "trace": new_trace().to_header(),
                       **knobs}).encode("utf-8")
    req = urllib.request.Request(
        base + "/rollout", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        return e.code, {"error": e.read().decode("utf-8",
                                                 "replace").strip()}


def watch(base: str, poll_s: float, timeout_s: float,
          http_timeout: float = 10.0) -> Optional[Dict[str, Any]]:
    """Poll ``GET /rollout`` until a terminal phase, printing transitions.
    Returns the final status document, or None when the deadline expired
    with the rollout still in flight (it keeps running server-side)."""
    deadline = time.monotonic() + timeout_s
    last_phase = None
    while True:
        try:
            st = _get(base + "/rollout", timeout=http_timeout)
        except Exception as e:  # noqa: BLE001 — a transient poll failure
            # must not abandon a healthy rollout; the deadline bounds it
            _out(f"  (poll failed: {type(e).__name__}: {e})")
            st = None
        if st is not None:
            phase = st.get("phase")
            if phase != last_phase:
                vers = ""
                if st.get("old_version") or st.get("new_version"):
                    vers = (f"  [{st.get('old_version')} -> "
                            f"{st.get('new_version')}]")
                reason = st.get("reason")
                _out(f"-> {phase}{vers}"
                     + (f"  ({reason})" if reason else ""))
                last_phase = phase
            # IDLE is terminal only as a refusal (reason set) or when no
            # controller was ever attached ("candidate" absent): a just-
            # POSTed rollout reads IDLE for an instant before STAGING
            if phase in TERMINAL_PHASES and (
                    phase != "IDLE" or st.get("reason")
                    or "candidate" not in st):
                return st
        if time.monotonic() >= deadline:
            return None
        time.sleep(poll_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Kick a canaried live weight rollout on a serving "
                    "host (POST /rollout) and follow it to its terminal "
                    "phase (exit 0=COMPLETE, 2=ROLLED_BACK, 1=refused/"
                    "error/timeout)")
    ap.add_argument("url", help="serving host base URL (the "
                                "introspection port)")
    ap.add_argument("checkpoint", nargs="?", default=None,
                    help="candidate checkpoint dir or versioned root, as "
                         "seen from the SERVING host (omit with --watch)")
    ap.add_argument("--watch", action="store_true",
                    help="don't POST — follow the rollout already in "
                         "flight (also the recovery path when a previous "
                         "invocation died mid-watch)")
    ap.add_argument("--canary-fraction", type=float, default=None)
    ap.add_argument("--canary-min-results", type=int, default=None)
    ap.add_argument("--canary-timeout-s", type=float, default=None)
    ap.add_argument("--drain-timeout-s", type=float, default=None)
    ap.add_argument("--psi-threshold", type=float, default=None)
    ap.add_argument("--error-rate-margin", type=float, default=None)
    ap.add_argument("--latency-factor", type=float, default=None)
    ap.add_argument("--min-latency-samples", type=int, default=None)
    ap.add_argument("--gc-keep-generations", type=int, default=None)
    ap.add_argument("--state-path", default=None,
                    help="durable version-pointer file on the serving "
                         "host (crash recovery reads it at restart)")
    ap.add_argument("--poll", type=float, default=0.5,
                    help="poll period in seconds (default 0.5)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="give up watching after this many seconds "
                         "(default 600; the rollout keeps running "
                         "server-side — re-attach with --watch)")
    ap.add_argument("--json", action="store_true",
                    help="also emit the final status as one JSON doc")
    args = ap.parse_args(argv)
    base = args.url.rstrip("/")

    if not args.watch:
        if args.checkpoint is None:
            ap.error("a checkpoint is required unless --watch is given")
        knobs = {
            name: getattr(args, name)
            for name in ("canary_fraction", "canary_min_results",
                         "canary_timeout_s", "drain_timeout_s",
                         "psi_threshold", "error_rate_margin",
                         "latency_factor", "min_latency_samples",
                         "state_path", "gc_keep_generations")
            if getattr(args, name) is not None
        }
        try:
            code, doc = post_rollout(base, args.checkpoint, knobs)
        except Exception as e:  # noqa: BLE001 — unreachable host etc.
            _out(f"rollout request failed: {type(e).__name__}: {e}")
            return 1
        if code != 202:
            _out(f"rollout refused by {base} (HTTP {code}): "
                 f"{doc.get('error', doc)}")
            return 1
        _out(f"rollout accepted by {base}: candidate "
             f"{args.checkpoint!r}")

    st = watch(base, args.poll, args.timeout)
    if st is None:
        _out(f"gave up after {args.timeout}s with the rollout still in "
             "flight (it keeps running server-side; re-attach with "
             "--watch)")
        return 1
    if args.json:
        _out(json.dumps(st, indent=2, sort_keys=True))
    phase = st.get("phase")
    if phase == "COMPLETE":
        _out(f"COMPLETE: pod converged on {st.get('new_version')}")
        return 0
    if phase == "ROLLED_BACK":
        _out(f"ROLLED_BACK ({st.get('reason')}): pod restored to "
             f"{st.get('old_version')} — the pod is consistent; the "
             "candidate is what needs attention")
        return 2
    _out(f"terminal phase {phase} ({st.get('reason')})")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
