"""The fleet's telemetry federation on the port (``fleet/observe.py``),
held against the JAX package's.

Mirrors of ``tests/test_fleet_observe.py`` on the port: series rings, SLO
burn / hysteresis / dedup semantics, heartbeat digest suppression over
loopback, the federated HTTP surface (``/fleet`` + fleet-wide ``/qos`` +
``worker=``-labeled ``/metrics``) and the N-way trace merge with fleet
wire-event alignment and migration flow arrows (the port's
``telemetry/trace.py``).  Across the packages: one heartbeat sequence with
explicit clocks gives the same alert transitions, snapshots and
``/metrics`` text in both observers, and the default SLOs are equal."""


import dataclasses
import json
import time
import urllib.request

import pytest

from bevy_ggrs_tpu import fleet as JF
from bevy_ggrs_tpu import telemetry as jtel
from bevy_ggrs_tpu_torch import telemetry
from bevy_ggrs_tpu_torch.fleet import (
    FleetObserver,
    FleetScheduler,
    FleetWorker,
    SLO,
    start_fleet_exporter,
)
from bevy_ggrs_tpu_torch.fleet import protocol as P
from bevy_ggrs_tpu_torch.telemetry.trace import merge_traces, validate_chrome_trace


def _hb(qos_by_lobby, frame=0):
    """Synthetic worker heartbeat stats carrying the given lobby QoS map."""
    return {
        "capacity": 4,
        "lobbies": {lid: {"frame": frame, "state": "running"}
                    for lid in qos_by_lobby},
        "lobby_qos_score": dict(qos_by_lobby),
        "shard_imbalance_ratio": 1.0,
        "device_resident_bytes": 1024,
    }


@pytest.fixture()
def tel():
    telemetry.reset()
    telemetry.enable()
    yield
    telemetry.disable()
    telemetry.reset()


# -- series rings -----------------------------------------------------------


def test_series_ring_window_rate_and_bounds():
    from bevy_ggrs_tpu_torch.fleet.observe import SeriesRing

    r = SeriesRing(capacity=4)
    assert r.last() is None and r.window(10.0) == [] \
        and r.rate(10.0) is None
    for i in range(6):  # overflows the 4-slot ring
        r.add(float(i), float(i * 10))
    assert len(r) == 4
    assert r.last() == (5.0, 50.0)
    # window is tail-referenced when now is omitted
    assert r.window(1.0) == [(4.0, 40.0), (5.0, 50.0)]
    assert r.window(0.5, now=5.0) == [(5.0, 50.0)]
    # rate: (50-20)/(5-2) over the full retained window
    assert r.rate(10.0) == pytest.approx(10.0)
    assert r.rate(0.5, now=5.0) is None  # one sample spans no interval
    assert r.tail(2) == [[4.0, 40.0], [5.0, 50.0]]


def test_observer_window_and_rate_query_surface(tel):
    obs = FleetObserver(slos=[])
    obs.ingest_heartbeat("w0", _hb({"L0": 80.0}, frame=0), now=0.0)
    obs.ingest_heartbeat("w0", _hb({"L0": 80.0}, frame=60), now=1.0)
    assert obs.window("lobby", "L0", "frame", 10.0, now=1.0) == \
        [(0.0, 0.0), (1.0, 60.0)]
    # frame rate == fps of the hosted lobby, derivable at the scheduler
    assert obs.rate("lobby", "L0", "frame", 10.0, now=1.0) == \
        pytest.approx(60.0)
    assert obs.rate("worker", "w0", "qos_floor", 10.0, now=1.0) == \
        pytest.approx(0.0)
    assert obs.window("worker", "nope", "qos_floor", 10.0) == []


# -- SLO burn semantics ------------------------------------------------------


def test_qos_slo_fires_only_after_sustained_breach(tel):
    slo = SLO("qos_floor", "qos_floor", 50.0,
              burn_window_s=1.0, resolve_window_s=1.0)
    obs = FleetObserver(slos=[slo])
    # one bad sample is NOT an incident
    obs.ingest_heartbeat("w0", _hb({"L0": 10.0}), now=0.0)
    assert obs.evaluate(0.0) == []  # breach observed, burn window not met
    obs.ingest_heartbeat("w0", _hb({"L0": 90.0}), now=0.4)
    assert obs.evaluate(0.4) == []  # recovered: burn clock resets
    assert obs.active_alerts() == []

    # a sustained breach fires exactly once
    fired = []
    for t in (2.0, 2.5, 3.0, 3.5, 4.0):
        obs.ingest_heartbeat("w0", _hb({"L0": 10.0}), now=t)
        fired += obs.evaluate(t)
    assert [e.state for e in fired] == ["fire"]
    ev = fired[0]
    assert (ev.slo_id, ev.subject, ev.signal) == \
        ("qos_floor", "L0", "qos_floor")
    assert ev.t == 3.0  # burn window satisfied a full 1.0s after 2.0
    assert len(obs.active_alerts()) == 1

    # hysteresis: recovery must stay clean for resolve_window_s
    resolved = []
    for t in (5.0, 5.5, 6.0):
        obs.ingest_heartbeat("w0", _hb({"L0": 90.0}), now=t)
        resolved += obs.evaluate(t)
    assert [e.state for e in resolved] == ["resolve"]
    assert resolved[0].t == 6.0
    assert obs.active_alerts() == []
    # the counter carries one fire and one resolve, never one per tick
    series = telemetry.summary()["metrics"]["fleet_alerts_total"]["series"]
    assert series == {"slo=qos_floor,state=fire": 1,
                      "slo=qos_floor,state=resolve": 1}


def test_liveness_slo_fire_and_resolve(tel):
    obs = FleetObserver()  # default slos: liveness gap 1.5s
    obs.ingest_liveness("w0", now=0.0)
    assert obs.evaluate(1.0) == []  # gap 1.0 < 1.5
    fired = obs.evaluate(2.0)  # gap 2.0 > 1.5 — the gap IS the sustain
    assert [(e.slo_id, e.state) for e in fired] == \
        [("heartbeat_liveness", "fire")]
    assert fired[0].value == pytest.approx(2.0)
    # dedup: further breaching ticks emit nothing
    assert obs.evaluate(2.5) == []
    assert obs.evaluate(3.0) == []
    # heartbeat returns; resolve only after a clean resolve window
    obs.ingest_liveness("w0", now=3.2)
    assert obs.evaluate(3.3) == []
    resolved = obs.evaluate(4.4)
    assert [(e.slo_id, e.state) for e in resolved] == \
        [("heartbeat_liveness", "resolve")]
    history = obs.alert_history()
    assert [a["state"] for a in history] == ["fire", "resolve"]


def test_migration_downtime_slo_event_triggered(tel):
    obs = FleetObserver()  # default ceiling 2000 ms
    obs.note_migration("L0", 120.0, now=0.0)
    assert obs.evaluate(0.1) == []  # under the ceiling
    obs.note_migration("L0", 3500.0, now=5.0)
    fired = obs.evaluate(5.0)  # one blown ceiling IS the incident
    assert [(e.slo_id, e.subject, e.state) for e in fired] == \
        [("migration_downtime", "L0", "fire")]
    assert fired[0].value == pytest.approx(3500.0)
    # the event ages out of breach, then hysteresis resolves
    assert obs.evaluate(5.5) == []
    resolved = []
    for t in (6.5, 7.5, 8.5):
        resolved += obs.evaluate(t)
    assert [e.state for e in resolved] == ["resolve"]


def test_forget_worker_force_resolves_active_alerts(tel):
    obs = FleetObserver()
    obs.ingest_liveness("w0", now=0.0)
    assert len(obs.evaluate(5.0)) == 1  # liveness fire
    emitted = obs.forget_worker("w0", now=6.0)
    assert [(e.slo_id, e.state) for e in emitted] == \
        [("heartbeat_liveness", "resolve")]
    assert obs.active_alerts() == []
    assert obs.evaluate(7.0) == []  # the dead worker never alerts again


# -- heartbeat digest suppression -------------------------------------------


def test_protocol_heartbeat_seq_roundtrip():
    msg = P.decode(P.encode_heartbeat_seq("w0", 77, "ab12cd34ef56ab78"))
    assert msg is not None and msg.kind == P.T_HEARTBEAT_SEQ
    assert (msg.a, msg.seq, msg.b) == ("w0", 77, "ab12cd34ef56ab78")
    # digest is canonical: key order does not matter, values do
    s1 = {"capacity": 2, "lobbies": {"a": {"frame": 1}}}
    s2 = {"lobbies": {"a": {"frame": 1}}, "capacity": 2}
    assert P.stats_digest(s1) == P.stats_digest(s2)
    assert P.stats_digest(s1) != P.stats_digest(
        {"capacity": 2, "lobbies": {"a": {"frame": 2}}})
    # round-trip stable: digesting the decoded JSON matches the original
    hb = P.decode(P.encode_heartbeat("w0", s1))
    assert P.stats_digest(hb.obj) == P.stats_digest(s1)


def test_heartbeat_suppression_over_loopback(tel):
    sched = FleetScheduler(worker_timeout_s=30.0)
    w = FleetWorker("w0", sched.local_addr, capacity=1, heartbeat_s=0.02,
                    device="cpu")
    try:
        w.register()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and "w0" not in sched.workers:
            sched.poll()
            w.poll()
            time.sleep(0.002)
        assert "w0" in sched.workers
        counter = telemetry.registry().counter(
            "fleet_heartbeat_suppressed_total", "")
        # idle worker -> unchanged stats -> seq-only liveness heartbeats
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and counter.value() < 5:
            sched.poll()
            w.poll()
            time.sleep(0.002)
        assert counter.value() >= 5
        wi = sched.workers["w0"]
        # the scheduler accepted them: digest pinned to the held stats,
        # liveness fresh even though no full payload arrived recently
        assert wi.stats_digest == P.stats_digest(wi.stats)
        assert time.monotonic() - wi.last_seen < 1.0
        # and the observer's gap series kept sampling on liveness beats
        gaps = sched.observer.window("worker", "w0", "heartbeat_gap_ms",
                                     span_s=60.0)
        assert len(gaps) >= 5
    finally:
        w.close()
        sched.close()


# -- federated HTTP surface --------------------------------------------------


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read()
        return r.headers.get("Content-Type", ""), body


def test_fleet_exporter_routes_and_one_schema(tel):
    obs = FleetObserver(slos=[])
    obs.ingest_heartbeat("wA", _hb({"L0": 91.0, "L1": 33.0}), now=1.0,
                         assigned_slots=2)
    obs.ingest_heartbeat("wB", _hb({"L2": 55.0}), now=1.1, assigned_slots=1)
    obs.set_topology({"workers": {"wA": {"capacity": 4},
                                  "wB": {"capacity": 4}},
                      "lobbies": {}, "events": []})
    exp = start_fleet_exporter(obs, port=0, worst_n=2)
    try:
        base = f"http://127.0.0.1:{exp.port}"
        ctype, body = _get(base + "/fleet")
        assert "json" in ctype
        fleet = json.loads(body)
        assert fleet["schema"] == "fleet/v1"
        assert set(fleet["workers"]) == {"wA", "wB"}
        assert fleet["workers"]["wA"]["capacity"] == 4  # topology merged in
        assert fleet["workers"]["wA"]["series"]["assigned_slots"] == [[1.0, 2.0]]
        assert fleet["lobbies"]["L1"]["worker"] == "wA"
        # ONE schema: the HTTP payload is the CLI payload
        snap = obs.fleet_snapshot()
        assert set(snap) == set(fleet)
        assert set(snap["workers"]) == set(fleet["workers"])
        # fleet-wide /qos overrides the single-process route: worst-first
        _, body = _get(base + "/qos")
        qos = json.loads(body)
        assert qos["schema"] == "fleet-qos/v1"
        assert [r["lobby"] for r in qos["worst_lobbies"]] == ["L1", "L2"]
        assert qos["worst_lobbies"][0]["worker"] == "wA"
        # federated /metrics: worker-labeled gauges in one scrape
        _, body = _get(base + "/metrics")
        text = body.decode("utf-8")
        assert 'fleet_worker_qos_floor{worker="wA"}' in text
        assert 'fleet_worker_qos_floor{worker="wB"}' in text
        assert 'fleet_lobby_qos_score{lobby="L1",worker="wA"}' in text
    finally:
        exp.close()


def test_fleet_snapshot_serves_alerts(tel):
    obs = FleetObserver()
    obs.ingest_liveness("w0", now=0.0)
    obs.evaluate(5.0)  # liveness fire
    snap = obs.fleet_snapshot(now=5.0)
    active = snap["alerts"]["active"]
    assert [(a["slo_id"], a["subject"], a["state"]) for a in active] == \
        [("heartbeat_liveness", "w0", "fire")]
    assert snap["alerts"]["recent"][-1]["state"] == "fire"
    assert obs.fleet_qos()["active_alerts"] == active


# -- N-way trace merge -------------------------------------------------------


def _instant(name, ts, **args):
    return {"name": name, "ph": "i", "ts": ts, "pid": 1, "tid": 1,
            "s": "t", "cat": "timeline", "args": args}


def _meta(pid, label):
    return {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": label}}


def test_merge_traces_three_way_fleet_alignment():
    # scheduler clock is the reference; workers run on shifted clocks and
    # share NO tick frames with it — alignment must come from the matched
    # fleet_wire send/completion pairs
    gap_us = 150.0      # true CKPT -> RESUME_OK downtime on a shared clock
    drop_delay = 50.0   # wA's loosest pair
    place_delay = 30.0  # each worker's tightest pair: the alignment error
    sched = {"traceEvents": [
        _meta(1, "scheduler"),
        _instant("fleet_wire", 1000.0, op="PLACE", lid="L1", track="scheduler"),
        _instant("fleet_wire", 2000.0, op="PLACE", lid="L2", track="scheduler"),
        _instant("fleet_wire", 5000.0, op="CKPT", lid="L1", track="scheduler"),
        _instant("fleet_wire", 5010.0, op="RESUME", lid="L1", track="scheduler"),
        _instant("fleet_wire", 9000.0, op="DROP", lid="L1", track="scheduler"),
        _instant("fleet_alert", 9500.0, slo="migration_downtime",
                 subject="L1", state="fire", track="scheduler"),
    ], "metadata": {"part": "sched"}}
    # worker A (migration source): clock +500000us ahead of the scheduler
    wa = {"traceEvents": [
        _meta(1, "worker:wA"),
        _instant("fleet_wire", 501000.0 + place_delay, op="PLACE_OK",
                 lid="L1", track="worker:wA"),
        _instant("fleet_wire", 509000.0 + drop_delay, op="DROP_RECV",
                 lid="L1", track="worker:wA"),
    ], "metadata": {"part": "wA"}}
    # worker B (migration destination): clock +100000us ahead; its own
    # PLACE_OK pins its clock to within place_delay, so the migration
    # completion keeps its true relative position
    wb = {"traceEvents": [
        _meta(1, "worker:wB"),
        _instant("fleet_wire", 102000.0 + place_delay, op="PLACE_OK",
                 lid="L2", track="worker:wB"),
        _instant("fleet_wire", 100000.0 + 5000.0 + gap_us, op="RESUME_OK",
                 lid="L1", track="worker:wB"),
    ], "metadata": {"part": "wB"}}

    merged = merge_traces(sched, wa, wb)
    assert validate_chrome_trace(merged) == []
    evs = merged["traceEvents"]
    pids = {e["pid"] for e in evs}
    assert len(pids) == 3  # one lane per participant
    md = merged["metadata"]
    assert md["participants"] == 3 and len(md["parts"]) == 3
    assert md["aligned_frames"] == 0  # no tick frames — wire-pair path

    by_op = {(e["args"]["op"], e["args"]["lid"]): e for e in evs
             if e.get("ph") == "i" and e["name"] == "fleet_wire"}
    # completions landed after their sends on the merged clock, within
    # the alignment error bound (the smallest send->completion delay)
    for lid in ("L1", "L2"):
        assert by_op[("PLACE_OK", lid)]["ts"] >= by_op[("PLACE", lid)]["ts"]
    assert by_op[("RESUME_OK", "L1")]["ts"] >= by_op[("RESUME", "L1")]["ts"]
    assert by_op[("DROP_RECV", "L1")]["ts"] - by_op[("DROP", "L1")]["ts"] \
        <= drop_delay

    # the migration arrow: CKPT (scheduler pid) -> RESUME_OK (worker pid),
    # spanning the downtime gap up to the alignment error
    flows = [e for e in evs if e.get("cat") == "fleet_flow"]
    mig = [e for e in flows if e["name"] == "migration"]
    assert len(mig) == 2
    start = next(e for e in mig if e["ph"] == "s")
    end = next(e for e in mig if e["ph"] == "f")
    assert start["id"] == end["id"] and start["pid"] != end["pid"]
    span = end["ts"] - start["ts"]
    assert span > 0 and abs(span - gap_us) <= place_delay
    # both placements draw cross-pid PLACE->PLACE_OK arrows too
    place = [e for e in flows if e["name"] == "place"]
    assert len(place) == 4
    place_starts = {e["id"]: e for e in place if e["ph"] == "s"}
    for e in place:
        if e["ph"] == "f":
            assert e["pid"] != place_starts[e["id"]]["pid"]

    # the alert instant stays on the reference clock, inside the incident
    alert = next(e for e in evs if e.get("ph") == "i"
                 and e["name"] == "fleet_alert")
    assert alert["ts"] == 9500.0
    assert alert["pid"] == by_op[("CKPT", "L1")]["pid"]


def test_merge_traces_two_peer_metadata_still_carries_ab():
    a = {"traceEvents": [_instant("fleet_wire", 10.0, op="PLACE", lid="x",
                                  track="scheduler")],
         "metadata": {"who": "a"}}
    b = {"traceEvents": [_instant("fleet_wire", 20.0, op="PLACE_OK", lid="x",
                                  track="worker:w")],
         "metadata": {"who": "b"}}
    merged = merge_traces(a, b)
    md = merged["metadata"]
    assert md["a"] == {"who": "a"} and md["b"] == {"who": "b"}
    assert md["participants"] == 2
    assert validate_chrome_trace(merged) == []


# -- against the JAX package ---------------------------------------------------

def _script():
    """A heartbeat script with explicit clocks: a QoS dip that sustains, a
    liveness gap, a blown migration ceiling, recoveries, a forgotten
    worker.  Each step is (method, args)."""
    steps = [("ingest_heartbeat", ("w0", _hb({"L0": 90.0, "L1": 70.0}, 0), 0.0, 2)),
             ("ingest_heartbeat", ("w1", _hb({"L2": 95.0}, 0), 0.1, 1))]
    for i, t in enumerate((0.5, 1.0, 1.5, 2.0, 2.5)):
        steps.append(("ingest_heartbeat", ("w0", _hb({"L0": 20.0, "L1": 70.0}, 30 * i), t, 2)))
        steps.append(("ingest_liveness", ("w1", t)))
        steps.append(("evaluate", (t,)))
    steps.append(("note_migration", ("L2", 3500.0, 2.6)))
    steps.append(("evaluate", (2.6,)))
    for t in (3.0, 3.5, 4.0, 4.5, 5.0, 6.0):
        steps.append(("ingest_heartbeat", ("w0", _hb({"L0": 95.0, "L1": 70.0}, 200), t, 2)))
        steps.append(("evaluate", (t,)))
    steps.append(("evaluate", (8.0,)))  # w1 silent since 2.5: liveness fires
    steps.append(("forget_worker", ("w1", 9.0)))
    steps.append(("evaluate", (9.5,)))
    return steps


def _run(obs):
    out = []
    for method, args in _script():
        got = getattr(obs, method)(*args)
        if method in ("evaluate", "forget_worker"):
            out.append([dataclasses.asdict(e) for e in got])
    return out


def test_slo_transitions_equal_across_packages():
    jtel.reset()
    jtel.enable()
    telemetry.reset()
    telemetry.enable()
    try:
        jo, to = JF.FleetObserver(), FleetObserver()
        jt, tt = _run(jo), _run(to)
        assert tt == jt
        fired = {(e["slo_id"], e["subject"]) for tick in tt for e in tick
                 if e["state"] == "fire"}
        # w0's last beat is at 6.0, so the tick at 8.0 fires its liveness too
        assert fired == {("qos_floor", "L0"), ("migration_downtime", "L2"),
                         ("heartbeat_liveness", "w0"), ("heartbeat_liveness", "w1")}
        assert to.alert_history() == jo.alert_history()
        assert to.active_alerts() == jo.active_alerts()
        assert to.fleet_snapshot(now=9.5) == jo.fleet_snapshot(now=9.5)
        assert to.fleet_qos() == jo.fleet_qos()
        assert to.window("lobby", "L0", "frame", 10.0, now=6.0) == \
            jo.window("lobby", "L0", "frame", 10.0, now=6.0)
        assert to.rate("lobby", "L0", "frame", 10.0, now=6.0) == \
            jo.rate("lobby", "L0", "frame", 10.0, now=6.0)
        assert telemetry.registry().render_prometheus() == \
            jtel.registry().render_prometheus()
    finally:
        jtel.disable()
        jtel.reset()
        telemetry.disable()
        telemetry.reset()


def test_default_slos_and_schemas_equal_across_packages():
    from bevy_ggrs_tpu.fleet import observe as jobs
    from bevy_ggrs_tpu_torch.fleet import default_slos, observe as tobs

    assert [dataclasses.asdict(s) for s in default_slos()] == \
        [dataclasses.asdict(s) for s in JF.default_slos()]
    kw = dict(qos_floor=40.0, qos_burn_window_s=2.0, downtime_ceiling_ms=500.0,
              liveness_gap_s=0.5, resolve_window_s=3.0)
    assert [dataclasses.asdict(s) for s in default_slos(**kw)] == \
        [dataclasses.asdict(s) for s in JF.default_slos(**kw)]
    for name in ("FLEET_SCHEMA", "FLEET_QOS_SCHEMA", "SERIES_CAPACITY", "ALERT_HISTORY"):
        assert getattr(tobs, name) == getattr(jobs, name)
