"""Tick-phase latency attribution on the port (mirrors of
``tests/test_phases.py``): histogram percentiles, the guarded phase timers
(disabled-path cost, enabled-path series), the always-on flight recorder
(ring bound, dump, desync embedding, reconciliation) and the runner's
wiring; and the cross-package checks: the same ``PHASES`` catalog, equal
percentiles and ``phase_breakdown`` on the same inputs."""

import json
import time

import numpy as np
import pytest

from bevy_ggrs_tpu import telemetry as jt
from bevy_ggrs_tpu_torch import telemetry
from tests.test_torch_synctest import inject_divergence, make_counter_app, make_runner


def _clean():
    for pkg in (telemetry, jt):
        pkg.disable()
        pkg.reset()
        pkg.configure_forensics(None)
        pkg.configure_flight(maxlen=256, enabled=True)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    _clean()
    yield
    _clean()


# --------------------------------------------------- the catalog, both sides


def test_phase_catalog_equals_jax():
    assert telemetry.PHASES == jt.PHASES
    assert isinstance(telemetry.PHASES, tuple)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentiles_and_breakdown_equal_across_packages(seed):
    rng = np.random.default_rng(seed)
    values = (rng.lognormal(0.0, 2.0, 300)).tolist()
    for pkg in (telemetry, jt):
        pkg.enable()
        h = pkg.registry().histogram("lat_ms", "l", buckets=pkg.LATENCY_MS_BUCKETS)
        for v in values:
            h.observe(v, peer=1)
    ph = telemetry.registry().histogram("lat_ms", "l", buckets=telemetry.LATENCY_MS_BUCKETS)
    pj = jt.registry().histogram("lat_ms", "l", buckets=jt.LATENCY_MS_BUCKETS)
    for q in (0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ph.percentile(q, peer=1) == pj.percentile(q, peer=1)
    assert ph.percentiles(peer=1) == pj.percentiles(peer=1)
    series = ph.snapshot(peer=1)
    assert (telemetry.percentile_from_buckets(telemetry.LATENCY_MS_BUCKETS, series, 0.75)
            == jt.percentile_from_buckets(jt.LATENCY_MS_BUCKETS, series, 0.75))
    entries = [
        {"kind": "tick", "wall_ms": float(w), "unattributed_ms": float(u),
         "phases": {name: float(v) for name, v in zip(telemetry.PHASES, row) if v > 0.2}}
        for w, u, row in zip(rng.uniform(1, 5, 120), rng.uniform(0, 0.3, 120),
                             rng.uniform(0, 1, (120, len(telemetry.PHASES))))
    ] + [{"kind": "rollback", "depth": 3}]
    bd = telemetry.phase_breakdown(entries)
    assert bd == jt.phase_breakdown(entries)
    assert telemetry.format_phase_table(bd) == jt.format_phase_table(bd)
    assert list(bd)[-2:] == ["(unattributed)", "(wall)"]


# ------------------------------------------------- histogram percentiles


def test_percentile_from_buckets_uniform():
    telemetry.enable()
    h = telemetry.registry().histogram("lat_ms", "l", buckets=telemetry.LATENCY_MS_BUCKETS)
    for i in range(1, 101):
        h.observe(i / 10.0)
    p50 = h.percentile(0.5)
    p95 = h.percentile(0.95)
    assert 4.0 <= p50 <= 6.0, p50
    assert 8.5 <= p95 <= 10.0, p95
    ps = h.percentiles()
    assert set(ps) == {"p50", "p95", "p99"}
    assert ps["p50"] == p50


def test_percentile_overflow_clamps_to_last_bound():
    telemetry.enable()
    h = telemetry.registry().histogram("big_ms", "b", buckets=(1.0, 2.0))
    h.observe(50.0)
    assert h.percentile(0.5) == 2.0


def test_percentile_empty_series_is_none():
    telemetry.enable()
    h = telemetry.registry().histogram("empty_ms", "e", buckets=(1.0,))
    assert h.percentile(0.5) is None


def test_summary_derived_latency_percentiles():
    telemetry.enable()
    ps = telemetry.PhaseSet(owner="solo")
    for _ in range(5):
        ps.begin_tick()
        with ps.phase("wave_dispatch"):
            pass
        ps.end_tick(frame=1)
    derived = telemetry.summary()["derived"]["latency_ms"]
    (key, row), = [(k, v) for k, v in derived["tick_phase_ms"].items()
                   if "wave_dispatch" in k]
    assert row["count"] == 5
    assert row["p50"] is not None and row["p50"] >= 0


# ------------------------------------------------------------ phase timers


def test_phase_timers_populate_histogram_series():
    telemetry.enable()
    ps = telemetry.PhaseSet(owner="solo")
    ps.begin_tick()
    with ps.phase("rollback_load"):
        time.sleep(0.001)
    ps.note_rollback(3)
    ps.end_tick(frame=7)
    h = telemetry.registry().histogram("tick_phase_ms", "",
                                       buckets=telemetry.LATENCY_MS_BUCKETS)
    s = h.snapshot(phase="rollback_load", owner="solo")
    assert s["count"] == 1
    assert s["sum"] >= 1.0  # slept 1ms
    wall = telemetry.registry().histogram(
        "tick_wall_ms", "", buckets=telemetry.LATENCY_MS_BUCKETS).snapshot(owner="solo")
    assert wall["count"] == 1
    (entry,) = telemetry.flight_recorder().snapshot("tick")
    assert entry["rollbacks"] == 1 and entry["rollback_depth"] == 3


def test_phase_unknown_name_raises():
    ps = telemetry.PhaseSet()
    with pytest.raises(KeyError):
        ps.phase("made_up_phase")


def test_phase_totals_reconcile():
    ps = telemetry.PhaseSet(owner="solo")
    for _ in range(10):
        ps.begin_tick()
        with ps.phase("session_step"):
            pass
        with ps.phase("wave_dispatch"):
            pass
        ps.end_tick()
    t = ps.totals()
    assert t["ticks"] == 10
    attributed = sum(t["phase_seconds"].values())
    assert attributed == pytest.approx(t["attributed_seconds"], abs=1e-5)
    assert t["wall_seconds"] == pytest.approx(
        t["attributed_seconds"] + t["unattributed_seconds"], abs=1e-5)


def test_idle_update_phase_time_does_not_leak():
    """An update that steps no frame runs phases but ends no tick: its
    phase time must not land in the next recorded tick (the JAX
    ``PhaseSet`` carries it over, ROADMAP queue C)."""
    ps = telemetry.PhaseSet(owner="solo")
    ps.begin_tick()
    with ps.phase("net_poll"):
        time.sleep(0.005)  # an idle poll: no end_tick follows
    ps.begin_tick()
    with ps.phase("net_poll"):
        pass
    ps.end_tick(frame=1)
    (entry,) = telemetry.flight_recorder().snapshot("tick")
    assert entry["phases"].get("net_poll", 0.0) < 1.0
    assert sum(entry["phases"].values()) <= entry["wall_ms"]
    t = ps.totals()
    assert t["attributed_seconds"] <= t["wall_seconds"]


def test_phase_timers_disabled_path_is_cheap():
    # flight off + telemetry off: entering a phase is one boolean check.
    # Held against an empty context manager's cost in the same loop shape,
    # interleaved and best of several, so a loaded host shifts both alike
    telemetry.configure_flight(enabled=False)
    ps = telemetry.PhaseSet(owner="solo")
    p1, p2 = ps.phase("net_poll"), ps.phase("wave_dispatch")

    class Empty:
        __slots__ = ()

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    e1, e2 = Empty(), Empty()
    ps.begin_tick()
    assert ps._on is False

    def cycle(a, b, n=5000):
        t0 = time.perf_counter()
        for _ in range(n):
            with a:
                pass
            with b:
                pass
        return time.perf_counter() - t0

    best_phase = best_empty = float("inf")
    for _ in range(7):
        best_phase = min(best_phase, cycle(p1, p2))
        best_empty = min(best_empty, cycle(e1, e2))
    # one attribute check per enter and per exit on top of the empty
    # manager; a perf_counter or dict hit on the disabled path is 3x
    assert best_phase < 3.0 * best_empty, (best_phase, best_empty)
    ps.end_tick()
    assert ps.ticks == 0
    assert len(telemetry.flight_recorder()) == 0
    assert telemetry.registry().metrics() == []


def test_phase_timers_flight_only_no_registry_families():
    ps = telemetry.PhaseSet(owner="solo")
    ps.begin_tick()
    with ps.phase("store_save"):
        pass
    ps.end_tick(frame=3)
    assert telemetry.registry().metrics() == []
    entries = telemetry.flight_recorder().snapshot("tick")
    assert len(entries) == 1
    assert entries[0]["frame"] == 3
    assert "store_save" in entries[0]["phases"]


# -------------------------------------------------------- flight recorder


def test_flight_ring_bound_and_clear():
    fr = telemetry.flight_recorder()
    fr.set_maxlen(8)
    for i in range(20):
        fr.record("tick", i=i)
    assert len(fr) == 8
    assert [e["i"] for e in fr.snapshot()] == list(range(12, 20))
    assert fr.evictions == 12
    fr.clear()
    assert len(fr) == 0


def test_flight_reconciliation_invariant():
    ps = telemetry.PhaseSet(owner="solo")
    for _ in range(5):
        ps.begin_tick()
        with ps.phase("wave_dispatch"):
            time.sleep(0.0005)
        with ps.phase("store_save"):
            pass
        ps.end_tick()
    for e in telemetry.flight_recorder().snapshot("tick"):
        total = sum(e["phases"].values()) + e["unattributed_ms"]
        assert total == pytest.approx(e["wall_ms"], abs=0.01)


def test_dump_flight_record(tmp_path):
    fr = telemetry.flight_recorder()
    fr.record("tick", wall_ms=1.0)
    path = tmp_path / "flight.json"
    telemetry.dump_flight_record(str(path))
    data = json.loads(path.read_text())
    assert data["maxlen"] == fr.maxlen
    assert data["events"][0]["kind"] == "tick"


def test_flight_disabled_records_nothing():
    telemetry.configure_flight(enabled=False)
    fr = telemetry.flight_recorder()
    fr.record("tick", x=1)
    assert len(fr) == 0


def test_desync_report_embeds_flight_record(tmp_path):
    # telemetry NEVER enabled: the report's flight_record section still
    # holds the recent tick history and the rollback entries
    telemetry.configure_forensics(str(tmp_path))
    runner, _, mismatches = make_runner(make_counter_app(), check_distance=2)
    for _ in range(6):
        runner.tick()
    inject_divergence(runner)
    for _ in range(6):
        runner.tick()
    assert mismatches, "corruption never tripped the synctest comparison"
    reports = sorted(tmp_path.glob("desync_synctest_mismatch_*.json"))
    assert reports
    rep = json.loads(reports[0].read_text())
    ticks = [e for e in rep["flight_record"] if e["kind"] == "tick"]
    assert ticks, "no tick entries in the embedded flight record"
    assert "phases" in ticks[-1] and "wall_ms" in ticks[-1]
    rollbacks = [e for e in rep["flight_record"] if e["kind"] == "rollback"]
    assert rollbacks and all(e["handle"] == "resim" for e in rollbacks)
    # the registry stayed off: pre-bound families exist, none has a series
    assert not any(fam["series"] for fam in rep["metrics"].values())


def test_phase_breakdown_exact_percentiles():
    entries = [
        {"kind": "tick", "wall_ms": float(i), "unattributed_ms": 0.0,
         "phases": {"wave_dispatch": float(i)}}
        for i in range(1, 101)
    ]
    bd = telemetry.phase_breakdown(entries)
    assert bd["wave_dispatch"]["count"] == 100
    assert bd["wave_dispatch"]["p50"] == pytest.approx(50.5)
    assert bd["(wall)"]["p99"] == pytest.approx(99.01)
    table = telemetry.format_phase_table(bd)
    assert "wave_dispatch" in table and "p50" in table


# ------------------------------------------------------- timeline dropped


def test_timeline_dropped_counter_and_summary():
    telemetry.enable()
    tl = telemetry.Timeline(maxlen=4)
    for i in range(7):
        tl.record("ev", i=i)
    assert len(tl) == 4
    assert tl.dropped == 3
    assert telemetry.registry().counter("timeline_events_dropped_total", "").value() == 3
    tl.clear()
    assert tl.dropped == 0
    assert "timeline_events_dropped" in telemetry.summary()


# -------------------------------------------------- prometheus escaping


def test_prometheus_label_value_escaping():
    telemetry.enable()
    telemetry.count("esc_total", peer='a"b\\c\nd')
    text = telemetry.registry().render_prometheus()
    assert 'peer="a\\"b\\\\c\\nd"' in text


def test_prometheus_histogram_exposition():
    telemetry.enable()
    ps = telemetry.PhaseSet(owner="solo")
    ps.begin_tick()
    with ps.phase("net_poll"):
        pass
    ps.end_tick()
    text = telemetry.registry().render_prometheus()
    assert "tick_phase_ms_bucket{" in text
    assert 'le="+Inf"' in text
    assert "tick_phase_ms_sum{" in text
    assert "tick_phase_ms_count{" in text


# ------------------------------------------------------- runner wiring


def test_runner_stats_phases_and_compile():
    runner, _, _ = make_runner(make_counter_app(), check_distance=2)
    for _ in range(10):
        runner.tick()
    st = runner.stats()
    assert st["phases"]["ticks"] == 10
    assert st["phases"]["unattributed_pct"] < 50.0
    assert "wave_dispatch" in st["phases"]["phase_seconds"]
    assert st["compile_ms"], "first dispatches were not timed"
    assert all(v > 0 for v in st["compile_ms"].values())
    compiles = telemetry.flight_recorder().snapshot("compile")
    assert {f"{e['program']}_k{e['k']}" for e in compiles} == set(st["compile_ms"])


def test_packed_staging_attributed_to_stage_inputs():
    """The packed single-upload path keeps its host staging work under
    ``stage_inputs``, and the totals reconcile."""
    runner, _, mismatches = make_runner(make_counter_app())
    for _ in range(12):
        runner.tick()
    assert mismatches == []
    st = runner.stats()
    assert st["packed"], "runner did not take the packed path"
    t = st["phases"]
    assert t["phase_seconds"].get("stage_inputs", 0.0) > 0.0
    attributed = sum(t["phase_seconds"].values())
    assert attributed == pytest.approx(t["attributed_seconds"], abs=1e-5)
    assert t["wall_seconds"] == pytest.approx(
        t["attributed_seconds"] + t["unattributed_seconds"], abs=1e-5)


def test_idle_updates_leave_the_flight_ring_alone():
    runner, _, _ = make_runner(make_counter_app())
    runner.update(0.0)  # sub-frame delta: nothing stepped
    assert telemetry.flight_recorder().snapshot("tick") == []
    runner.tick()
    (entry,) = telemetry.flight_recorder().snapshot("tick")
    assert entry["owner"] == "solo" and entry["frame"] == runner.frame
    assert entry["device_bytes"] == telemetry.devmem.total() > 0
    assert entry["pipeline_depth"] >= 0
