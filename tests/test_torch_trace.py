"""Frame-lifecycle tracing on the port (mirrors of ``tests/test_trace.py``):
Chrome-trace export, cross-peer flow correlation and device-memory
accounting; and the checks across packages: the same streams give the same
trace in both, and a port trace merges with a JAX one."""

import gc
import json
import time

import pytest

from bevy_ggrs_tpu import telemetry as jt
from bevy_ggrs_tpu_torch import GgrsRunner, PlayerType, SessionBuilder, SessionState
from bevy_ggrs_tpu_torch import telemetry
from bevy_ggrs_tpu_torch.models import box_game
from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork
from bevy_ggrs_tpu_torch.telemetry import devmem

DT = 1.0 / 60.0


@pytest.fixture(autouse=True)
def _telemetry():
    telemetry.reset()
    telemetry.enable()
    telemetry.configure_flight(enabled=True)
    yield
    telemetry.configure_flight(enabled=True)  # module default
    telemetry.disable()
    telemetry.reset()


def _p2p_pair(latency_hops=0, seed=1, delay=1):
    net = ChannelNetwork(latency_hops=latency_hops, seed=seed)
    socks = [net.endpoint("peer0"), net.endpoint("peer1")]
    runners = []
    for i in range(2):
        app = box_game.make_app(num_players=2, device="cpu")
        b = (SessionBuilder.for_app(app).with_input_delay(delay)
             .add_player(PlayerType.LOCAL, i)
             .add_player(PlayerType.REMOTE, 1 - i, f"peer{1 - i}"))
        runners.append(GgrsRunner(app, b.start_p2p_session(socks[i]),
                                  read_inputs=lambda hs: {h: box_game.keys_to_input()
                                                          for h in hs}))
    return net, runners


def _sync(net, runners, ticks=300):
    for _ in range(ticks):
        net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state() == SessionState.RUNNING for r in runners):
            return
    raise AssertionError("sessions never synchronized")


def _run_flipping(net, runners, ticks=120):
    """Flipping inputs under link latency force attributable
    mispredictions."""
    flip = [0]

    def read_inputs(handles):
        flip[0] += 1
        on = (flip[0] // 7) % 2 == 0
        return {h: box_game.keys_to_input(right=on) for h in handles}

    for r in runners:
        r.read_inputs = read_inputs
    for _ in range(ticks):
        net.deliver()
        for r in runners:
            r.update(DT)


# -- flow correlation ----------------------------------------------------------


def test_p2p_flow_links_rollback_to_blamed_input_send():
    net, runners = _p2p_pair(latency_hops=3)
    _sync(net, runners)
    telemetry.timeline().clear()
    telemetry.flight_recorder().clear()
    _run_flipping(net, runners)

    trace = telemetry.chrome_trace()
    assert telemetry.validate_chrome_trace(trace) == []
    links = telemetry.flows(trace)
    assert links, "latency + flipping inputs must produce flow arrows"

    snap = telemetry.registry().snapshot()
    causes = snap["rollback_cause_total"]["series"]
    total = sum(snap["rollbacks_total"]["series"].values())
    assert total > 0 and sum(causes.values()) == total
    for fl in links:
        send, rb = fl["send"], fl["rollback"]
        assert send["frame"] == rb["to_frame"]
        assert rb["handle"] in send["handles"]
        assert rb["lateness"] >= 1
        assert f"handle={rb['handle']}" in causes
    assert len(links) <= total
    lat = snap["input_lateness_frames"]["series"]
    assert sum(v["count"] for v in lat.values()) == total
    # the counter tracks the runner stamps into each tick entry
    counters = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "C"}
    assert {"rollback_depth", "device_resident_bytes", "pipeline_depth"} <= counters


def test_flow_pairs_validate_and_stamp_ids():
    net, runners = _p2p_pair(latency_hops=3)
    _sync(net, runners)
    telemetry.timeline().clear()
    telemetry.flight_recorder().clear()
    _run_flipping(net, runners, ticks=80)
    trace = telemetry.chrome_trace()
    evs = trace["traceEvents"]
    starts = [e for e in evs if e.get("ph") == "s"]
    ends = [e for e in evs if e.get("ph") == "f"]
    assert len(starts) == len(ends) == len(telemetry.flows(trace))
    for e in ends:
        assert e["bp"] == "e"
    assert telemetry.validate_chrome_trace(trace) == []


def test_two_peer_traces_merge_with_a_cross_pid_flow():
    """Each peer's own trace (as two processes would write them), merged:
    the arrow runs from the blamed peer's send to the victim's rollback."""
    net, runners = _p2p_pair(latency_hops=3)
    _sync(net, runners)
    telemetry.timeline().clear()
    telemetry.flight_recorder().clear()
    _run_flipping(net, runners, ticks=80)
    evs = telemetry.timeline().events()
    ticks = telemetry.flight_recorder().snapshot()

    def peer_trace(i):
        # peer i's own events: its sends carry its local handle, its
        # rollbacks blame the other's
        own = [e for e in evs if (e["kind"] == "input_send" and e["handles"] == [i])
               or (e["kind"] == "rollback" and e["handle"] == 1 - i)]
        return telemetry.chrome_trace(own, ticks, pid=1 + i)

    merged = telemetry.merge_traces(peer_trace(0), peer_trace(1))
    assert telemetry.validate_chrome_trace(merged) == []
    links = telemetry.flows(merged)
    assert links
    pid_of = {}
    for e in merged["traceEvents"]:
        fid = e.get("args", {}).get("flow_id")
        if fid is not None and e.get("ph") == "i":
            pid_of.setdefault(fid, set()).add(e["pid"])
    assert all(len(p) == 2 for p in pid_of.values())


# -- merged cross-peer traces -------------------------------------------------


def _fake_report(pid_epoch, *, rollback=None, input_send=None, addr="peer"):
    """A minimal forensics report: tick flight entries frames 5..10 on a
    private clock epoch, plus optional rollback/input_send events."""
    flight = [{"kind": "tick", "frame": f, "wall_ms": 1.0, "t": pid_epoch + f * 0.016,
               "seq": f} for f in range(5, 11)]
    timeline = []
    if rollback is not None:
        flight.append(dict(rollback, kind="rollback", t=pid_epoch + 10 * 0.016, seq=99))
    if input_send is not None:
        timeline.append(dict(input_send, kind="input_send",
                             t=pid_epoch + input_send["frame"] * 0.016, seq=50))
    return {"kind": "p2p_desync", "addr": addr, "flight_record": flight,
            "timeline_tail": timeline}


def _victim_blamed():
    victim = _fake_report(1000.0, addr="victim",
                          rollback={"to_frame": 7, "from_frame": 10, "depth": 3,
                                    "handle": 1, "lateness": 2,
                                    "cause_kind": "misprediction"})
    blamed = _fake_report(5000.0, addr="blamed",
                          input_send={"frame": 7, "handles": [1], "size": 8})
    return victim, blamed


def test_merge_report_traces_cross_peer_flow_and_clock_alignment():
    victim, blamed = _victim_blamed()
    merged = telemetry.merge_report_traces(victim, blamed)
    assert telemetry.validate_chrome_trace(merged) == []
    assert merged["metadata"]["merged"] is True
    assert merged["metadata"]["aligned_frames"] == 6

    links = telemetry.flows(merged)
    assert len(links) == 1
    fl = links[0]
    assert fl["rollback"]["handle"] == 1
    assert fl["rollback"]["lateness"] == 2
    assert fl["send"]["frame"] == fl["rollback"]["to_frame"] == 7

    evs = merged["traceEvents"]
    assert len({e.get("pid") for e in evs if e.get("ph") == "i"}) == 2
    by_frame = {}
    for e in evs:
        if e.get("ph") == "X" and e.get("name") == "tick":
            by_frame.setdefault(e["args"]["frame"], []).append(e)
    for _f, ticks in by_frame.items():
        assert len(ticks) == 2
        assert abs(ticks[0]["ts"] - ticks[1]["ts"]) < 1.0


def test_traces_equal_across_packages_and_merge_with_a_jax_trace():
    victim, blamed = _victim_blamed()
    assert telemetry.trace_from_report(victim) == jt.trace_from_report(victim)
    assert telemetry.merge_report_traces(victim, blamed) == \
        jt.merge_report_traces(victim, blamed)
    # a port peer's trace against a JAX peer's: one merged view, one arrow
    merged = telemetry.merge_traces(telemetry.trace_from_report(victim, pid=1),
                                    jt.trace_from_report(blamed, pid=2))
    assert merged == jt.merge_traces(jt.trace_from_report(victim, pid=1),
                                     telemetry.trace_from_report(blamed, pid=2))
    assert len(telemetry.flows(merged)) == 1


def test_merge_requires_cross_pid_no_self_blame():
    solo = _fake_report(0.0, rollback={"to_frame": 7, "handle": 1, "lateness": 2},
                        input_send={"frame": 7, "handles": [1], "size": 8})
    merged = telemetry.merge_report_traces(solo, _fake_report(50.0))
    assert telemetry.flows(merged) == []
    single = telemetry.trace_from_report(solo)
    assert len(telemetry.flows(single)) == 1


# -- device-memory accounting -------------------------------------------------


def test_devmem_reconciles_with_snapshot_ring():
    net, runners = _p2p_pair()
    _sync(net, runners)
    for _ in range(30):
        net.deliver()
        for r in runners:
            r.update(DT)
    r = runners[0]
    owner = r._devmem_tag + "/snapshot_ring"
    snap = devmem.snapshot()
    assert r._world_nbytes > 0
    assert snap[owner] == len(r.ring.frames()) * r._world_nbytes
    g = telemetry.registry().gauge("device_resident_bytes", "")
    assert g.value(owner=owner) == snap[owner]
    s = telemetry.summary()
    assert s["device_resident_bytes"][owner] == snap[owner]
    assert s["device_resident_total_bytes"] == sum(snap.values())
    assert snap[r._devmem_tag + "/packed_staging"] > 0
    assert snap["staging/last_commit"] > 0
    c = devmem.census(device="cpu")
    assert c["registered_bytes"] == sum(snap.values())
    assert c["live_bytes"] >= snap[owner]
    assert c["unregistered_bytes"] >= 0


def test_devmem_rows_die_with_the_runner():
    net, runners = _p2p_pair()
    _sync(net, runners)
    tag = runners[0]._devmem_tag
    assert any(o.startswith(tag + "/") for o in devmem.snapshot())
    del runners
    gc.collect()
    assert not any(o.startswith(tag + "/") for o in devmem.snapshot())


def test_devmem_note_works_with_telemetry_off():
    telemetry.disable()
    devmem.note("offline/buf", 4096)
    assert devmem.snapshot()["offline/buf"] == 4096
    assert devmem.total() == 4096
    assert "device_resident_bytes" not in telemetry.registry().snapshot()
    telemetry.enable()
    devmem.note("offline/buf", 8192)
    g = telemetry.registry().gauge("device_resident_bytes", "")
    assert g.value(owner="offline/buf") == 8192


# -- ring truncation accounting ---------------------------------------------------


def test_timeline_drop_and_flight_eviction_exact_counts():
    tl = telemetry.timeline()
    old_maxlen = tl.maxlen
    try:
        tl.set_maxlen(8)
        for i in range(20):
            telemetry.record("stall", frame=i)
        assert len(tl) == 8
        assert tl.dropped == 12
        telemetry.configure_flight(maxlen=4)
        fr = telemetry.flight_recorder()
        for i in range(10):
            fr.record("tick", frame=i, wall_ms=0.1)
        assert len(fr) == 4
        assert fr.evictions == 6
        s = telemetry.summary()
        assert s["timeline_events_dropped"] == 12
        assert s["flight_record_evictions"] == 6
        md = telemetry.chrome_trace()["metadata"]
        assert md["timeline_events_dropped"] == 12
        assert md["flight_record_evictions"] == 6
    finally:
        tl.set_maxlen(old_maxlen)
        telemetry.configure_flight(maxlen=256)


# -- disabled paths -------------------------------------------------------------


def test_disabled_recording_costs_about_an_empty_call():
    """A disabled ``record()`` is one function call and one attribute check.
    Timed against an empty function of the same signature, interleaved and
    best of several rounds, so a loaded host (the suite runs in parallel
    workers) slows both alike; the bound is on the ratio, not on a time."""
    telemetry.disable()
    telemetry.configure_flight(enabled=False)

    def empty(kind, **fields):
        return None

    record = telemetry.record

    def per_call(fn, n=20000):
        t0 = time.perf_counter()
        for i in range(n):
            fn("stall", frame=i)
        return (time.perf_counter() - t0) / n

    best_record = best_empty = float("inf")
    for _ in range(7):
        best_record = min(best_record, per_call(record))
        best_empty = min(best_empty, per_call(empty))
    assert best_record < 3.0 * best_empty, (best_record * 1e6, best_empty * 1e6)
    assert len(telemetry.timeline()) == 0


def test_trace_is_empty_but_valid_when_disabled():
    telemetry.disable()
    telemetry.configure_flight(enabled=False)
    telemetry.timeline().clear()
    telemetry.flight_recorder().clear()
    telemetry.record("stall", frame=1)
    trace = telemetry.chrome_trace()
    assert telemetry.validate_chrome_trace(trace) == []
    assert all(e["ph"] == "M" for e in trace["traceEvents"])
    assert trace["metadata"]["timeline_events_dropped"] == 0
    json.dumps(trace)


# -- surfaces: write_trace, /trace endpoint, the merge of two report files ------


def test_write_trace_roundtrip(tmp_path):
    telemetry.record("stall", frame=3)
    telemetry.flight_recorder().record("tick", frame=3, wall_ms=0.5)
    p = tmp_path / "t.json"
    n = telemetry.write_trace(str(p))
    loaded = json.loads(p.read_text())
    assert len(loaded["traceEvents"]) == n
    assert telemetry.validate_chrome_trace(loaded) == []
    names = {e["name"] for e in loaded["traceEvents"]}
    assert {"tick", "stall"} <= names


def test_trace_endpoint_serves_bounded_json():
    import urllib.request

    fr = telemetry.flight_recorder()
    for i in range(40):
        telemetry.record("stall", frame=i)
        fr.record("tick", frame=i, wall_ms=0.2)
    ex = telemetry.start_http_exporter(port=0)
    try:
        body = urllib.request.urlopen(f"http://127.0.0.1:{ex.port}/trace?n=10",
                                      timeout=10).read()
        trace = json.loads(body)
        assert telemetry.validate_chrome_trace(trace) == []
        ticks = [e for e in trace["traceEvents"] if e.get("ph") == "X" and e["name"] == "tick"]
        assert len(ticks) == 10
    finally:
        ex.close()


def test_merge_reports_and_their_trace(tmp_path):
    # the replay tool's merge-reports CLI is the JAX package's tooling
    # (ROADMAP A7); the port calls merge_reports and merge_report_traces
    def write(name, checksums, frames=None):
        p = tmp_path / name
        telemetry.write_desync_report("p2p_desync", path=str(p), checksums=checksums,
                                      frames=[max(checksums)] if frames is None else frames)
        return str(p)

    a, b = write("a.json", {1: 10, 2: 20}), write("b.json", {1: 10, 2: 21})
    m = telemetry.merge_reports(a, b)
    assert m["first_divergent_frame"] == 2
    with open(a) as fa, open(b) as fb:
        trace = telemetry.merge_report_traces(json.load(fa), json.load(fb))
    assert telemetry.validate_chrome_trace(trace) == []
    c, d = write("c.json", {5: 1}, frames=[]), write("d.json", {5: 1}, frames=[])
    assert telemetry.merge_reports(c, d)["first_divergent_frame"] is None
