"""The port's telemetry package held against the JAX package's: registry
semantics, timeline ordering across a forced rollback, desync forensics
reports, the Prometheus exporter (mirrors of ``tests/test_telemetry.py``),
and the cross-package checks: ``/metrics`` text byte-equal for the same
registry operations, the same families and deterministic values on a
``fixed_point`` SyncTest, ``component_checksums`` equal on the same world,
and the devmem ring row equal to the JAX runner's."""

import dataclasses
import glob
import json
import urllib.request

import numpy as np
import pytest

import bevy_ggrs_tpu as J
from bevy_ggrs_tpu import telemetry as jt
from bevy_ggrs_tpu.models import box_game as j_box_game
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu_torch import GgrsRunner, SyncTestSession
from bevy_ggrs_tpu_torch import telemetry
from bevy_ggrs_tpu_torch.models import box_game, fixed_point
from bevy_ggrs_tpu_torch.telemetry import forensics as t_forensics
from tests.test_torch_checksum import build_pair
from tests.test_torch_synctest import make_counter_app, make_runner


def _clean():
    for pkg in (telemetry, jt):
        pkg.disable()
        pkg.reset()
        pkg.configure_forensics(None)
        pkg.configure_flight(maxlen=256, enabled=True)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    # the registries, timelines and flight rings are process globals of
    # each package: isolate every test, both packages
    _clean()
    yield
    _clean()


def _inject(runner, app):
    """Poke checksummed state behind the session's back."""
    w = runner.world
    runner.world = dataclasses.replace(
        w, comps={**w.comps, "counter": w.comps["counter"] + 1000})
    value = telemetry_checksum(app, runner.world)
    runner._world_checksum = lambda: value


def telemetry_checksum(app, world):
    from bevy_ggrs_tpu_torch.snapshot.checksum import checksum_to_int

    return checksum_to_int(app.checksum_fn(world))


# ---------------------------------------------------------------- registry


def test_counter_semantics_with_labels():
    telemetry.enable()
    telemetry.count("widgets_total", help="widgets")
    telemetry.count("widgets_total", 4, kind="blue")
    telemetry.count("widgets_total", kind="blue")
    c = telemetry.registry().counter("widgets_total", "widgets")
    assert c.value() == 1
    assert c.value(kind="blue") == 5
    snap = telemetry.registry().snapshot()
    assert snap["widgets_total"]["kind"] == "counter"
    assert snap["widgets_total"]["series"]["kind=blue"] == 5


def test_histogram_buckets_and_sum():
    telemetry.enable()
    for v in (0, 1, 1, 5, 100):
        telemetry.observe("depth", v, help="d", buckets=(0, 1, 4, 8))
    s = telemetry.registry().histogram("depth", "d", buckets=(0, 1, 4, 8)).snapshot()
    assert s["count"] == 5
    assert s["sum"] == 107
    # per-bucket (non-cumulative); 100 overflows every bucket -> count only
    assert s["buckets"] == [1, 2, 0, 1]


def test_gauge_and_kind_conflict():
    telemetry.enable()
    telemetry.gauge_set("depth_now", 3, help="g")
    assert telemetry.registry().gauge("depth_now", "g").value() == 3
    with pytest.raises(TypeError):
        telemetry.registry().counter("depth_now", "not a gauge")


def test_finalizer_during_a_locked_update_does_not_deadlock():
    """A collection that starts inside a registry update (any allocation
    there can start one) runs a dead runner's finalizer, which zeroes its
    devmem gauge on the same thread.  In a subprocess, so a deadlock fails
    the test at its timeout instead of hanging the session."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import gc, weakref\n"
        "from bevy_ggrs_tpu_torch import telemetry\n"
        "telemetry.enable()\n"
        "telemetry.devmem.note('dead_runner/world', 64)\n"
        "class Owner: pass\n"
        "owner = Owner(); owner.cycle = owner  # only the collector frees it\n"
        "weakref.finalize(owner, telemetry.devmem.forget_scope, 'dead_runner')\n"
        "del owner\n"
        "with telemetry.registry()._lock:  # where Gauge.set holds it\n"
        "    gc.collect()\n"
        "assert 'dead_runner/world' not in telemetry.devmem.snapshot()\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def test_disabled_is_noop():
    assert not telemetry.enabled()
    telemetry.count("never_total")
    telemetry.observe("never_hist", 1)
    telemetry.gauge_set("never_gauge", 1)
    telemetry.record("never_event")
    assert telemetry.registry().snapshot() == {}
    assert telemetry.timeline().tail(10) == []


def test_prometheus_rendering_cumulative():
    telemetry.enable()
    telemetry.count("ticks_total", 3, help="ticks")
    for v in (0, 2, 9):
        telemetry.observe("lat", v, help="lat", buckets=(1, 4))
    text = telemetry.registry().render_prometheus()
    assert "# TYPE ticks_total counter" in text
    assert "ticks_total 3" in text
    assert 'lat_bucket{le="1"} 1' in text
    assert 'lat_bucket{le="4"} 2' in text
    assert 'lat_bucket{le="+Inf"} 3' in text
    assert "lat_sum 11" in text
    assert "lat_count 3" in text


def test_registries_are_separate_per_package():
    telemetry.enable()
    telemetry.count("port_only_total")
    assert jt.registry() is not telemetry.registry()
    assert not jt.enabled() and jt.registry().snapshot() == {}


# ---------------------------------------------- /metrics across packages


def _registry_ops(pkg):
    """One sequence of registry operations: counters with labels needing
    escaping, gauges, histograms on every bucket family, a float sum."""
    pkg.enable()
    pkg.count("ticks_total", 3, help="session ticks stepped")
    pkg.count("rollback_cause_total", help="blame", handle=1)
    pkg.count("rollback_cause_total", 2, help="blame", handle="unknown")
    pkg.count("esc_total", peer='a"b\\c\nd', help="line\nbreak \\ slash")
    pkg.gauge_set("ping_ms", 12.5, "round-trip ping", peer=1)
    pkg.gauge_set("device_resident_bytes", 4096.0, "bytes", owner="solo0/snapshot_ring")
    for v in (0, 1, 3, 7, 40):
        pkg.observe("rollback_depth", v, "frames rolled back")
    for v in (0.003, 0.4, 2.2, 17.0, 1500.0):
        pkg.observe("tick_phase_ms", v, "phase ms", buckets=pkg.LATENCY_MS_BUCKETS,
                    phase="wave_dispatch", owner="solo")
    for v in (0.07, 3.0):
        pkg.observe("svc_ms", v, "svc", buckets=pkg.MS_BUCKETS, path="hit")
    return pkg.registry().render_prometheus()


def test_metrics_text_byte_equal_across_packages():
    port, ref = _registry_ops(telemetry), _registry_ops(jt)
    assert port.encode() == ref.encode()
    assert telemetry.registry().snapshot() == jt.registry().snapshot()
    assert telemetry.summary()["metrics"] == jt.summary()["metrics"]


# ---------------------------------------------- timeline across a rollback


def test_timeline_orders_rollbacks_and_spans():
    telemetry.enable()
    runner, _, mismatches = make_runner(make_counter_app(), check_distance=2)
    for _ in range(8):
        runner.tick()
    assert not mismatches
    events = telemetry.timeline().tail(10_000)
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    rollbacks = telemetry.timeline().events("rollback")
    assert rollbacks, "synctest check_distance=2 must roll back"
    for ev in rollbacks:
        assert ev["to_frame"] < ev["from_frame"]
        assert ev["depth"] == ev["from_frame"] - ev["to_frame"]
    span_names = {e["name"] for e in telemetry.timeline().events("span")}
    assert {"SaveWorld", "LoadWorld", "AdvanceWorld", "HandleRequests"} <= span_names
    s = telemetry.summary()
    assert s["enabled"] and s["derived"]["rollbacks_total"] == len(rollbacks)
    assert s["derived"]["rollbacks_total"] == runner.rollbacks


def test_export_jsonl_round_trips(tmp_path):
    telemetry.enable()
    telemetry.record("alpha", x=1)
    telemetry.record("beta", y="z")
    out = tmp_path / "tl.jsonl"
    n = telemetry.export_jsonl(str(out))
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert n == len(lines) == 2
    assert [line["kind"] for line in lines] == ["alpha", "beta"]


# -------------------------------------------------------------- forensics


def test_desync_report_on_injected_mismatch(tmp_path):
    telemetry.enable()
    telemetry.configure_forensics(str(tmp_path))
    app = make_counter_app()
    runner, _, mismatches = make_runner(app, check_distance=2)
    for _ in range(4):
        runner.tick()
    _inject(runner, app)
    for _ in range(6):
        runner.tick()
    assert mismatches
    reports = glob.glob(str(tmp_path / "desync_synctest_mismatch_*.json"))
    assert reports, "forensics dir configured -> a report must be written"
    rep = json.loads(open(reports[0]).read())
    assert rep["kind"] == "synctest_mismatch"
    assert rep["frames"]
    assert "counter" in rep["component_checksums"]
    assert "__entities__" in rep["component_checksums"]
    assert rep["timeline_tail"], "report embeds the recent timeline"
    assert telemetry.registry().counter(
        "checksum_mismatch_total", "").value(kind="synctest") > 0
    assert telemetry.validate_chrome_trace(rep["trace_slice"]) == []


def test_no_report_without_forensics_dir(tmp_path):
    telemetry.enable()
    assert telemetry.forensics_dir() is None
    assert telemetry.write_desync_report("synctest_mismatch") is None
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", ["float32", "int32", "bfloat16", "bool", "uint32"])
def test_component_checksums_equal_across_packages(name):
    """Every component's, resource's and the entity part, from the port's
    one-fold computation, equal to the JAX package's per-part passes on the
    same world (despawned rows, missing columns, a present and an absent
    resource)."""
    jreg, jw, treg, tw = build_pair(name, seed=11)
    port = t_forensics.component_checksums(treg, tw)
    ref = jt.component_checksums(jreg, jw)
    assert list(port) == list(ref)
    assert port == ref
    assert set(port) == {"col", "id", "res:env", "res:gone", "__entities__"}


def test_component_checksums_name_the_changed_component():
    app = fixed_point.make_app(device="cpu")
    w = app.init_state()
    base = t_forensics.component_checksums(app.reg, w)
    moved = dataclasses.replace(w, comps={**w.comps, "pos": w.comps["pos"] + 1})
    diff = {k for k, v in t_forensics.component_checksums(app.reg, moved).items()
            if base[k] != v}
    assert diff == {"pos"}


# ------------------------------------------------------------- prometheus


def test_http_exporter_scrape():
    telemetry.enable()
    telemetry.count("scraped_total", 7, help="scrape me")
    exporter = telemetry.start_http_exporter(port=0)
    try:
        url = f"http://127.0.0.1:{exporter.port}/metrics"
        with urllib.request.urlopen(url, timeout=5) as resp:
            body = resp.read().decode()
            ctype = resp.headers["Content-Type"]
        assert ctype.startswith("text/plain; version=0.0.4")
        assert "scraped_total 7" in body
    finally:
        exporter.close()


# ------------------------------------ the SyncTest's families, both packages


def _flip_inputs(holder):
    def read_inputs(handles):
        frame = holder[0].frame
        return {h: np.uint8((frame // 7 + h) % 16) for h in handles}
    return read_inputs


def _synctest_snapshot(pkg, runner_cls, session_cls, app):
    pkg.reset()
    pkg.enable()
    session = session_cls(num_players=app.num_players, check_distance=7)
    holder = []
    runner = runner_cls(app, session, read_inputs=_flip_inputs(holder))
    holder.append(runner)
    for _ in range(120):
        runner.tick()
    pkg.disable()
    return pkg.registry().snapshot()


# Families whose values differ between the packages by design, with the
# reason; each is held to its kind and label keys all the same.
VALUE_ALLOWLIST = {
    # the port donates whenever the runner alone holds the live world; the
    # JAX runner also declines donation when a leading save would need the
    # pre-dispatch buffer (eager torch reuses no donated storage, so the
    # port's leading save may ring it): the port donates one more dispatch
    "donated_dispatches_total":
        "donation rule: the port also donates when a leading save rings the world",
    # one observation per (kind, depth) variant's first dispatch: the
    # donation rule above makes the port's first k=8 dispatch a donated one
    "program_compile_ms": "its variants follow the donation rule",
}
# Readback accounting, whose families and values differ by design: the port
# reads each runner's checksum batches per owner (a CPU batch's rows are
# host memory and read at once, never forced), the JAX package pulls every
# pending batch in one transfer, harvested or forced as its async copies
# happen to be ready; each family is held to its kind where both have it
READBACK_ALLOWLIST = {
    "readback_harvested_total": "per-owner batch reads against one fused pull",
    "readback_forced_total": "the port's CPU batches never force a read",
    "host_blocked_seconds": "follows readback_forced_total",
}
# timing families: kinds, label keys and observation counts compared
TIMED = {"tick_phase_ms", "tick_wall_ms", "tick_unattributed_ms",
         "program_compile_ms", "rollback_service_ms"}
# batches in flight at the last harvest: when an async copy lands is the
# host's timing, not the game's (kind and label keys compared)
IN_FLIGHT = {"pipeline_depth"}


def test_fixed_point_synctest_families_equal_across_packages():
    ref = _synctest_snapshot(jt, J.GgrsRunner, J.SyncTestSession, j_fixed_point.make_app())
    port = _synctest_snapshot(telemetry, GgrsRunner, SyncTestSession,
                              fixed_point.make_app(device="cpu"))
    missing = set(ref) - set(port) - set(READBACK_ALLOWLIST)
    extra = set(port) - set(ref) - set(READBACK_ALLOWLIST)
    assert not missing and not extra, (missing, extra)
    checked = 0
    for name, fam in port.items():
        want = ref.get(name)
        if want is None:
            continue  # a readback family the JAX run did not record
        assert (fam["kind"], fam["help"]) == (want["kind"], want["help"]), name
        assert set(fam["series"]) == set(want["series"]), name
        if name in VALUE_ALLOWLIST or name in READBACK_ALLOWLIST or name in IN_FLIGHT:
            continue
        for key, val in fam["series"].items():
            if name in TIMED:
                assert val["count"] == want["series"][key]["count"], (name, key)
            else:
                assert val == want["series"][key], (name, key)
        checked += 1
    assert checked >= 15
    assert port["rollbacks_total"]["series"][""] > 100


# --------------------------------------------- devmem rows across packages


def test_devmem_ring_row_equals_jax_runners():
    def make(pkg, mod, session_cls, **kw):
        app = mod.make_app(**kw)
        session = session_cls(num_players=app.num_players, check_distance=3)
        runner = pkg(app, session)
        for _ in range(12):
            runner.tick()
        return runner

    jr = make(J.GgrsRunner, j_box_game, J.SyncTestSession)
    tr = make(GgrsRunner, box_game, SyncTestSession, device="cpu")
    jrow = jt.devmem.snapshot()[jr._devmem_tag + "/snapshot_ring"]
    trow = telemetry.devmem.snapshot()[tr._devmem_tag + "/snapshot_ring"]
    assert tr._world_nbytes == jr._world_nbytes > 0
    assert len(tr.ring.frames()) == len(jr.ring.frames())
    assert trow == jrow == len(tr.ring.frames()) * tr._world_nbytes


def test_census_strict_on_the_cpu():
    runner, _, _ = make_runner(make_counter_app(), check_distance=2)
    for _ in range(6):
        runner.tick()
    c = telemetry.devmem.census(strict=True, device="cpu")
    assert c["registered_bytes"] == telemetry.devmem.total() > 0
    assert c["live_bytes"] >= c["registered_bytes"] and c["live_arrays"] > 0
    # a row noting bytes nobody holds makes the registry stale
    telemetry.devmem.note("stale/row", c["live_bytes"] + 1)
    with pytest.raises(RuntimeError, match="stale"):
        telemetry.devmem.census(strict=True, device="cpu")
