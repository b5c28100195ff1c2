"""Network-layer observability on the port (mirrors of
``tests/test_netstats.py``): the NetStatsSampler, rollback-cause
attribution, QoS scoring and the cross-peer forensics merge; and a mixed
pair, a JAX peer against a port peer with an injected offset, whose two
reports (one per package) merge to the first divergent frame."""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest

import bevy_ggrs_tpu as J
from bevy_ggrs_tpu import telemetry as jt
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.snapshot.lazy import materialize as j_materialize
from bevy_ggrs_tpu_torch import GgrsRunner, PlayerType, SessionBuilder, SessionState
from bevy_ggrs_tpu_torch import telemetry
from bevy_ggrs_tpu_torch.models import box_game, fixed_point
from bevy_ggrs_tpu_torch.session.channel import ChannelNetwork
from bevy_ggrs_tpu_torch.session.events import NetworkStats
from bevy_ggrs_tpu_torch.session.requests import LoadRequest
from bevy_ggrs_tpu_torch.session.synctest import SyncTestSession
from bevy_ggrs_tpu_torch.session.time_sync import TimeSync
from bevy_ggrs_tpu_torch.snapshot.lazy import wrap_single_checksum
from bevy_ggrs_tpu_torch.telemetry.netstats import NetStatsSampler
from bevy_ggrs_tpu_torch.telemetry.qos import qos_score, qos_snapshot
from tests.test_torch_p2p import make_peer

DT = 1.0 / 60.0


@pytest.fixture(autouse=True)
def _telemetry():
    for pkg in (telemetry, jt):
        pkg.reset()
        pkg.configure_forensics(None)
    telemetry.enable()
    yield
    for pkg in (telemetry, jt):
        pkg.disable()
        pkg.reset()
        pkg.configure_forensics(None)


class _FakeSession:
    """Minimal session surface for sampler unit tests."""

    def __init__(self, stats_by_handle):
        self.stats_by_handle = stats_by_handle
        self.calls = 0

    def remote_player_handles(self):
        return sorted(self.stats_by_handle)

    def network_stats(self, handle):
        self.calls += 1
        return self.stats_by_handle[handle]

    def frames_ahead(self):
        return 2


# -- sampler ----------------------------------------------------------------


def test_sampler_disabled_is_one_boolean_check():
    s = _FakeSession({1: NetworkStats(ping_ms=10.0)})
    sampler = NetStatsSampler(s, every=0)
    assert not sampler.enabled
    for _ in range(100):
        sampler.poll()
    assert sampler._n == 0
    assert s.calls == 0
    assert sampler.samples == 0
    assert "netstats_samples_total" not in telemetry.registry().snapshot()


def test_sampler_cadence_and_families():
    s = _FakeSession({
        1: NetworkStats(ping_ms=42.0, send_queue_len=3, kbps_sent=8.5,
                        local_frames_behind=2, remote_frames_behind=-1),
    })
    sampler = NetStatsSampler(s, every=5)
    for _ in range(25):
        sampler.poll()
    assert sampler.samples == 5
    snap = telemetry.registry().snapshot()
    assert snap["peer_send_queue"]["series"]["handle=1"] == 3
    assert snap["peer_kbps"]["series"]["handle=1"] == 8.5
    behind = snap["peer_frames_behind"]["series"]
    assert behind["handle=1,side=local"] == 2
    assert behind["handle=1,side=remote"] == -1
    assert snap["frame_advantage"]["series"]["handle=1"] == 2
    assert snap["time_sync_warmup"]["series"]["handle=1"] == 0
    ping = snap["peer_ping_ms"]["series"]["handle=1"]
    assert ping["count"] == 5 and ping["sum"] == pytest.approx(5 * 42.0)
    assert snap["netstats_samples_total"]["series"][""] == 5


def test_sampler_skips_non_live_silently():
    s = _FakeSession({0: NetworkStats(is_live=False), 1: NetworkStats(ping_ms=5.0)})
    sampler = NetStatsSampler(s, every=1)
    sampler.poll()
    series = telemetry.registry().snapshot()["peer_ping_ms"]["series"]
    assert "handle=1" in series and "handle=0" not in series


def test_sampler_env_cadence(monkeypatch):
    monkeypatch.setenv("BGT_NETSTATS_EVERY", "7")
    assert NetStatsSampler(_FakeSession({})).every == 7
    monkeypatch.setenv("BGT_NETSTATS_EVERY", "0")
    assert not NetStatsSampler(_FakeSession({})).enabled
    monkeypatch.setenv("BGT_NETSTATS_EVERY", "junk")
    assert NetStatsSampler(_FakeSession({})).every == 60


# -- a port pair ------------------------------------------------------------


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


def test_network_stats_zeroed_for_non_live_handles():
    net, runners = _p2p_pair()
    s = runners[0].session
    st = s.network_stats(0)
    assert not st.is_live and st.ping_ms == 0.0 and st.send_queue_len == 0
    assert not s.network_stats(99).is_live
    assert s.network_stats(1).is_live
    addr = s.remote_handle_addr[1]
    s.endpoints[addr].disconnected = True
    assert not s.network_stats(1).is_live
    assert s.time_sync_for(1) is None
    assert s.remote_player_handles() == [1]
    # set_session attached a sampler at the JAX package's default cadence
    assert isinstance(runners[0]._netstats, NetStatsSampler)
    assert runners[0]._netstats.every == 60


def test_p2p_attribution_blames_remote_and_sums_match():
    net, runners = _p2p_pair(latency_hops=3)
    _sync(net, runners)
    flip = [0]

    def read_inputs(handles):
        flip[0] += 1
        on = (flip[0] // 7) % 2 == 0
        return {h: box_game.keys_to_input(right=on) for h in handles}

    for r in runners:
        r.read_inputs = read_inputs
        r._netstats = NetStatsSampler(r.session, every=8)
    for _ in range(120):
        net.deliver()
        for r in runners:
            r.update(DT)
    snap = telemetry.registry().snapshot()
    total = sum(snap["rollbacks_total"]["series"].values())
    causes = snap["rollback_cause_total"]["series"]
    assert total > 0, "latency + flipping inputs must force rollbacks"
    assert sum(causes.values()) == total == sum(r.rollbacks for r in runners)
    assert set(causes) <= {"handle=0", "handle=1"}
    # the always-on Counter agrees with the family, handle by handle
    for h in (0, 1):
        assert causes.get(f"handle={h}", 0) == sum(r.rollbacks_by_cause.get(h, 0)
                                                   for r in runners)
    lat = snap["input_lateness_frames"]["series"]
    assert sum(v["count"] for v in lat.values()) == total
    assert all(v["sum"] >= v["count"] for v in lat.values())
    assert "peer_ping_ms" in snap and "netstats_samples_total" in snap
    assert "ping_ms" in snap and "input_latency_frames" in snap  # per-tick mirror
    rb_entries = telemetry.flight_recorder().snapshot("rollback")
    assert rb_entries and all(e.get("handle") in (0, 1) and e.get("lateness", 0) >= 1
                              for e in rb_entries)


def test_synctest_rollbacks_attributed_as_resim():
    s = SyncTestSession(num_players=1, check_distance=2)
    causes = []
    for _ in range(6):
        s.add_local_input(0, np.uint8(0))
        for r in s.advance_frame():
            if isinstance(r, LoadRequest):
                causes.append(r.cause)
    assert causes, "check_distance>0 must emit structural rollbacks"
    for c in causes:
        assert c is not None
        assert c.handle == "resim" and c.kind == "resim"
        assert c.lateness == 2 and not c.mismatch


def test_causeless_load_attributed_to_unknown():
    net, runners = _p2p_pair()
    _sync(net, runners)
    r = runners[0]
    for _ in range(4):
        net.deliver()
        for x in runners:
            x.update(DT)
    target = max(r.ring.frames())
    r._load(target, None)  # a replay path: no cause attached
    snap = telemetry.registry().snapshot()
    causes = snap["rollback_cause_total"]["series"]
    total = sum(snap["rollbacks_total"]["series"].values())
    assert causes.get("handle=unknown", 0) >= 1
    assert sum(causes.values()) == total
    assert r.rollbacks_by_cause["unknown"] == 1


# -- TimeSync warmup ---------------------------------------------------------


def test_time_sync_warmup_and_one_sided_estimate():
    ts = TimeSync()
    assert not ts.warmed_up()
    assert ts.frames_ahead() == 0
    for f in range(10):
        ts.note_local(f + 4, f)
    assert not ts.warmed_up()
    assert ts.frames_ahead() == 2
    ts.note_remote(-4)
    assert ts.warmed_up()
    assert ts.frames_ahead() == 4


# -- QoS ---------------------------------------------------------------------


def test_qos_score_monotone_bounded_and_equal_to_jax():
    base = qos_score(0, 0, 0, 0)
    assert base == 100.0
    pts = [(0, 0, 0, 0), (60, 0.1, 0.01, 10.0), (300, 1.0, 0.5, 100.0)]
    for p in pts:
        s0 = qos_score(*p)
        assert s0 == jt.qos_score(*p)
        for axis in range(4):
            worse = list(p)
            worse[axis] = worse[axis] * 2 + 1
            assert qos_score(*worse) < s0
        assert 0.0 < s0 <= 100.0
    assert qos_score(-50, 0, 0, 0) == 100.0


def test_qos_snapshot_reads_registry_and_serves_json():
    telemetry.count("rollbacks_total", 5)
    telemetry.count("ticks_total", 100)
    telemetry.count("readback_forced_total", 1)
    telemetry.count("readback_harvested_total", 9)
    snap = qos_snapshot()
    d = snap["lobbies"]["default"]
    assert d["inputs"]["rollback_rate"] == pytest.approx(0.05)
    assert d["inputs"]["forced_readback_rate"] == pytest.approx(0.1)
    assert 0 < d["score"] < 100
    ex = telemetry.start_http_exporter(port=0)
    try:
        served = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{ex.port}/qos", timeout=10).read())
        assert served["lobby_qos_score"]["default"] == d["score"]
        assert served["scales"]["worst_ping_ms"] > 0
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{ex.port}/metrics", timeout=10).read().decode()
        assert "lobby_qos_score" in text
    finally:
        ex.close()


def test_qos_per_lobby_scores():
    telemetry.count("ticks_total", 100)
    telemetry.count("rollbacks_total", 2, lobby=0)
    telemetry.count("rollbacks_total", 40, lobby=1)
    snap = qos_snapshot()
    assert set(snap["lobby_qos_score"]) == {"0", "1"}
    assert snap["lobby_qos_score"]["0"] > snap["lobby_qos_score"]["1"]


# -- cross-peer forensics merge ----------------------------------------------


def _write_report(tmp_path, name, checksums, comp, flight):
    p = tmp_path / name
    telemetry.write_desync_report("p2p_desync", frames=[max(checksums)], path=str(p),
                                  checksums=checksums)
    rep = json.loads(p.read_text())
    rep["component_checksums"] = comp
    rep["flight_record"] = flight
    p.write_text(json.dumps(rep))
    return str(p)


def test_merge_reports_first_divergent_frame(tmp_path):
    a = _write_report(
        tmp_path, "a.json", {8: 100, 9: 101, 10: 102, 11: 103},
        {"position": 1, "velocity": 2},
        [{"kind": "tick", "frame": 9, "wall_ms": 1.5},
         {"kind": "rollback", "to_frame": 9, "depth": 2, "handle": 1,
          "lateness": 2, "cause_kind": "misprediction"}])
    b = _write_report(
        tmp_path, "b.json", {9: 101, 10: 999, 11: 998, 12: 997},
        {"position": 1, "velocity": 7}, [{"kind": "tick", "frame": 10, "wall_ms": 1.1}])
    m = telemetry.merge_reports(a, b)
    assert m["first_divergent_frame"] == 10
    assert m["divergent_frames"] == [10, 11]
    assert m["common_frames"] == 3
    assert m["checksums_at_divergence"] == {"a": 102, "b": 999}
    assert m["component_diff"] == ["velocity"]
    assert m["rollbacks"]["a"][0]["handle"] == 1
    assert [e["frame"] for e in m["tick_context"]["a"]] == [9]
    assert [e["frame"] for e in m["tick_context"]["b"]] == [10]
    assert m == jt.merge_reports(a, b)  # the JAX package's merge reads them alike


def test_merge_reports_agreeing_windows(tmp_path):
    cs = {5: 1, 6: 2}
    a = _write_report(tmp_path, "a.json", cs, None, [])
    b = _write_report(tmp_path, "b.json", cs, None, [])
    m = telemetry.merge_reports(a, b)
    assert m["first_divergent_frame"] == 6
    assert m["divergent_frames"] == []


def test_desync_report_carries_frame_checksums(tmp_path):
    p = tmp_path / "r.json"
    telemetry.write_desync_report("p2p_desync", frames=[3], path=str(p),
                                  checksums={3: 7, 4: 8})
    rep = json.loads(p.read_text())
    assert rep["checksums"] == {"3": 7, "4": 8}
    assert set(rep) == set(json.loads(open(jt.write_desync_report(
        "p2p_desync", frames=[3], path=str(p) + ".jax", checksums={3: 7})).read()))


def test_merge_reports_of_divergent_files(tmp_path):
    # the replay tool's merge-reports CLI belongs to the JAX package's
    # tooling (ROADMAP A7): the port's merge is called directly
    a = _write_report(tmp_path, "a.json", {1: 10, 2: 20}, None, [])
    b = _write_report(tmp_path, "b.json", {1: 10, 2: 21}, None, [])
    m = telemetry.merge_reports(a, b)
    assert m["first_divergent_frame"] == 2
    assert m["checksums_at_divergence"] == {"a": 20, "b": 21}


# -- a JAX peer against a port peer, both writing reports ----------------------


def _desynced(runner):
    # each package raises its own DesyncDetected class
    return any(type(e).__name__ == "DesyncDetected" for e in runner.events)


def _ring_world(runner, frame, port):
    stored = runner.ring.peek(frame)[0]
    if port:
        from bevy_ggrs_tpu_torch.runner import _stored_world

        return _stored_world(stored)
    return j_materialize(stored)


def test_mixed_pair_reports_merge_to_first_divergent_frame(tmp_path):
    """fixed_point is integer math, so a JAX peer and a port peer agree bit
    for bit until the port peer's ``pos`` is offset; each package writes
    its own report, and the merge of the two names the first divergent
    frame.  The per-component parts agree across the packages on a frame
    both rings hold from before the offset, and differ in ``pos`` alone
    after it."""
    telemetry.disable()
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    telemetry.configure_forensics(str(port_dir))
    jt.configure_forensics(str(jax_dir))
    net = ChannelNetwork(latency_hops=3, seed=2)
    socks = [net.endpoint("p0"), net.endpoint("p1")]
    import bevy_ggrs_tpu_torch as T

    # peer 0 (the port) predicts its remote's constant input perfectly and
    # never rolls the offset away; peer 1 (JAX) rolls back on peer 0's flips
    port = make_peer(T, fixed_point, 0, socks[0], timeout=30.0)
    ref = make_peer(J, j_fixed_point, 1, socks[1], timeout=30.0, device=None)
    runners = [port, ref]
    for _ in range(100):
        net.deliver()
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state().value == "running" for r in runners):
            break
    for _ in range(40):
        net.deliver()
        for r in runners:
            r.update(DT)
    shared = sorted(set(port.ring.frames()) & set(ref.ring.frames()))
    before = shared[0]
    want = jt.component_checksums(ref.app.reg, _ring_world(ref, before, False))
    assert telemetry.component_checksums(port.app.reg,
                                         _ring_world(port, before, True)) == want
    w = port.world
    port.world = dataclasses.replace(w, comps={**w.comps, "pos": w.comps["pos"] + 1})
    port._world_checksum = wrap_single_checksum(port.app.checksum_fn(port.world))
    offset_frame = port.frame
    for _ in range(60):
        net.deliver()
        for r in runners:
            r.update(DT)
        if all(_desynced(r) for r in runners):
            break
    assert all(_desynced(r) for r in runners)
    port_reports = sorted(port_dir.glob("desync_p2p_desync_*.json"))
    jax_reports = sorted(jax_dir.glob("desync_p2p_desync_*.json"))
    assert port_reports and jax_reports, "each package writes its own report"
    prep = json.loads(port_reports[0].read_text())
    jrep = json.loads(jax_reports[0].read_text())
    assert set(prep) == set(jrep)
    assert set(prep["component_checksums"]) == set(jrep["component_checksums"])
    m = telemetry.merge_reports(str(jax_reports[0]), str(port_reports[0]))
    assert m == jt.merge_reports(str(jax_reports[0]), str(port_reports[0]))
    first = m["first_divergent_frame"]
    # the live frame's save comes at the next tick, so the offset frame's
    # own checksum already carries the offset
    assert first is not None and first >= offset_frame
    cs_j, cs_p = (({int(f): v for f, v in rep["checksums"].items()}) for rep in (jrep, prep))
    common = sorted(set(cs_j) & set(cs_p))
    assert first == next(f for f in common if cs_j[f] != cs_p[f])
    # after the offset, a frame both rings hold differs in pos alone
    after = max(set(port.ring.frames()) & set(ref.ring.frames()))
    got = telemetry.component_checksums(port.app.reg, _ring_world(port, after, True))
    want = jt.component_checksums(ref.app.reg, _ring_world(ref, after, False))
    assert {k for k in got if got[k] != want[k]} == {"pos"}
