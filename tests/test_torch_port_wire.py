"""The port's wire data plane (``ncnet_tpu_torch/serving/wire.py``) against
the JAX package's (``ncnet_tpu/serving/wire.py``).

A pod may mix hosts of both packages only if the wire is one wire: for the
same arrays, header fields and exceptions the port's frames are the JAX
package's byte for byte, each package decodes the other's frames into its
own outcome classes, and both refuse a frame of another schema version.
The framing cases of ``tests/test_router.py`` run once with each package.
"""

import numpy as np
import pytest

PKGS = ("jax", "torch")


def load(name):
    if name == "jax":
        from ncnet_tpu.observability import events
        from ncnet_tpu.serving import request, wire
    else:
        from ncnet_tpu_torch.observability import events
        from ncnet_tpu_torch.serving import request, wire
    return wire, request, events


@pytest.fixture(params=PKGS)
def pkg(request):
    return load(request.param)


@pytest.fixture
def frozen_clock(monkeypatch):
    """Both packages' wall clock pinned to one instant: ``encode_request``
    stamps ``sent_t`` with it."""
    for name in PKGS:
        _, _, events = load(name)
        monkeypatch.setattr(events, "wall_now", lambda: 1760000000.123456)


def u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)


REQUESTS = [
    dict(client="cam0", budget_s=0.25, request_id="r9"),
    dict(client="wire", budget_s=None, request_id=""),
    dict(client="edge-7", budget_s=12.3456789, request_id="x",
         stream="s1", trace="00-4bf92f3577b34da6a3ce929d0e0e4736-"
                            "00f067aa0ba902b7-01"),
]


@pytest.mark.parametrize("case", range(len(REQUESTS)))
def test_request_frames_are_byte_identical(frozen_clock, case):
    src, tgt = u8((32, 48, 3), 1), u8((64, 32, 3), 2)
    (wj, _, _), (wt, _, _) = load("jax"), load("torch")
    a = wj.encode_request(src, tgt, **REQUESTS[case])
    b = wt.encode_request(src, tgt, **REQUESTS[case])
    assert a == b
    assert a[:5] == b"NCMW" + bytes([wt.WIRE_SCHEMA])
    # and each package reads the other's frame to the same fields
    for reader, blob in ((wj, b), (wt, a)):
        s2, t2, meta = reader.decode_request(blob)
        assert (s2 == src).all() and (t2 == tgt).all()
        assert meta["client"] == REQUESTS[case]["client"]
        assert meta["sent_t"] == pytest.approx(1760000000.123456)


def result_of(request_mod, quality=True):
    table = np.arange(60, dtype=np.float32).reshape(6, 10) / 7.0
    return request_mod.MatchResult(
        request_id="r1", table=table,
        quality={"score": 0.7, "entropy": 0.25} if quality else None,
        bucket=((32, 32), (64, 32)), wall_s=0.0421234)


@pytest.mark.parametrize("quality", [True, False])
def test_result_frames_are_byte_identical(quality):
    (wj, rj, _), (wt, rt, _) = load("jax"), load("torch")
    extra = {"recv_t": 1.5, "resp_t": 2.25, "peer_run": "run-x"}
    sj, a = wj.encode_result(result_of(rj, quality), extra=extra)
    st, b = wt.encode_result(result_of(rt, quality), extra=extra)
    assert (sj, a) == (st, b) and sj == 200
    for reader, req_mod, blob in ((wj, rj, b), (wt, rt, a)):
        out = reader.decode_response(blob)
        assert isinstance(out, req_mod.MatchResult)
        assert (out.table == result_of(rt).table).all()
        assert out.bucket == ((32, 32), (64, 32))
        assert out.wall_s == pytest.approx(0.042123, abs=1e-6)


def errors(request_mod):
    return [
        (request_mod.Overloaded("full", reason="queue_full",
                                retry_after_s=0.5), 429),
        (request_mod.DeadlineExceeded("late", where="fetch"), 504),
        (request_mod.RequestQuarantined("gone", kind="timeout",
                                        attempts=3), 500),
        (ValueError("surprise"), 500),
    ]


@pytest.mark.parametrize("case", range(4))
def test_error_frames_are_byte_identical_and_cross_decode(case):
    (wj, rj, _), (wt, rt, _) = load("jax"), load("torch")
    (ej, code), (et, _) = errors(rj)[case], errors(rt)[case]
    sj, a = wj.encode_error(ej)
    st, b = wt.encode_error(et)
    assert (sj, a) == (st, b) and sj == code
    # the other package raises its OWN class with the fields intact
    for reader, req_mod, blob in ((wj, rj, b), (wt, rt, a)):
        want = type(errors(req_mod)[case][0])
        if want is ValueError:
            want = req_mod.RequestQuarantined
        with pytest.raises(want) as e:
            reader.decode_response(blob)
        if case == 0:
            assert (e.value.reason, e.value.retry_after_s) == ("queue_full", 0.5)
        elif case == 1:
            assert e.value.where == "fetch"
        elif case == 2:
            assert (e.value.kind, e.value.attempts) == ("timeout", 3)
        else:
            assert e.value.kind == "internal"


def test_wire_request_roundtrip_and_refusal(pkg):
    wire, _, _ = pkg
    src, tgt = u8((32, 32, 3), 1), u8((32, 32, 3), 2)
    blob = wire.encode_request(src, tgt, client="cam0", budget_s=0.25,
                               request_id="r9")
    src2, tgt2, meta = wire.decode_request(blob)
    assert (src2 == src).all() and (tgt2 == tgt).all()
    assert isinstance(meta.pop("sent_t"), float)
    assert meta == {"client": "cam0", "budget_s": 0.25, "request": "r9",
                    "stream": None, "trace": None}
    with pytest.raises(wire.WireError, match="magic"):
        wire.decode_request(b"XXXX" + blob[4:])
    with pytest.raises(wire.WireError, match="payload"):
        wire.decode_request(blob[:-10])
    with pytest.raises(wire.WireError, match="truncated"):
        wire.decode_request(blob[:16])
    hdr = {"src_shape": [4, 4, 3], "tgt_shape": [4, 4, 3],
           "dtype": "uint8", "client": "c", "budget_s": None,
           "request": ""}
    with pytest.raises(wire.WireError, match="payload"):
        wire.decode_request(wire._frame(hdr, b"\x00" * 7))
    with pytest.raises(ValueError, match="uint8"):
        wire.encode_request(src.astype(np.float32), tgt)


@pytest.mark.parametrize("writer", PKGS)
def test_wrong_version_byte_is_refused_by_both(pkg, writer):
    wire, request_mod, _ = pkg
    w, r, _ = load(writer)
    blob = w.encode_request(u8((8, 8, 3), 0), u8((8, 8, 3), 1))
    bad = blob[:4] + bytes([w.WIRE_SCHEMA + 1]) + blob[5:]
    with pytest.raises(wire.WireError, match="schema"):
        wire.decode_request(bad)
    _, res = w.encode_result(result_of(r))
    with pytest.raises(wire.WireError, match="schema"):
        wire.decode_response(res[:4] + bytes([0]) + res[5:])


def test_clock_sync_sample_and_stamps(pkg, monkeypatch):
    """``emit_clock_sync`` turns one round trip's stamps into an NTP-style
    offset sample; a response without stamps is a no-op."""
    wire, _, events = pkg
    seen = []
    monkeypatch.setattr(events, "emit",
                        lambda name, **f: seen.append((name, f)))
    wire.emit_clock_sync("http://p:1", {"recv_t": 101.0, "resp_t": 101.5,
                                        "peer_run": "r"}, 100.0, 102.0)
    wire.emit_clock_sync("http://p:1", {}, 100.0, 102.0)
    assert seen == [("clock_sync", {"peer": "http://p:1", "peer_run": "r",
                                    "offset_s": 0.25, "rtt_s": 1.5})]
    stamps = wire.sync_stamps(5.0)
    assert stamps["recv_t"] == 5.0 and stamps["resp_t"] > 0


def test_clock_sampler_emits_each_new_rtt_minimum(monkeypatch):
    """The port's ``ClockSampler`` emits one round trip an interval and,
    inside the interval, each round trip whose RTT is a new minimum: the
    federation keeps a pair's minimum-RTT sample, so the log holds the
    tightest one the client saw.  A throttle alone (the JAX client's)
    keeps only the interval's first, here the 50 ms one (ROADMAP C5)."""
    wire, _, events = load("torch")
    seen = []
    monkeypatch.setattr(events, "emit",
                        lambda name, **f: seen.append((name, f["rtt_s"])))
    monkeypatch.setattr(wire, "CLOCK_SYNC_INTERVAL_S", 3600.0)
    sampler = wire.ClockSampler()
    stamps = {"recv_t": 100.0, "resp_t": 100.0, "peer_run": "r"}

    def round_trip(rtt, header=stamps):
        sampler.observe("http://p:1", header, 100.0 - rtt / 2,
                        100.0 + rtt / 2)

    for rtt in (0.05, 0.06, 0.03, 0.04, 0.03, 0.02, 0.07):
        round_trip(rtt)
    round_trip(0.001, header={})  # no stamps: no sample
    assert seen == [("clock_sync", 0.05), ("clock_sync", 0.03),
                    ("clock_sync", 0.02)]
    monkeypatch.setattr(wire, "CLOCK_SYNC_INTERVAL_S", 0.0)
    round_trip(0.07)  # the interval has passed: a slower sample again
    assert seen[-1] == ("clock_sync", 0.07) and len(seen) == 4
