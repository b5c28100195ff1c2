"""The port's native C++ session core, against Python peers of both packages.

Mirrors tests/test_native.py.  ``bevy_ggrs_tpu_torch.session.native``
builds ``native/ggrs_core/ggrs_core.cc`` itself, into the port's
``_build/`` directory, and binds it with ctypes.  A port
``NativeP2PSession`` peer plays a port ``P2PSession`` peer and a JAX
``P2PSession`` peer over loopback UDP, both sides on ``fixed_point``
(integer math, so the checksums are exact: tolerance 0), with checksums
compared every frame; both must reach RUNNING and play with no
``DesyncDetected`` and equal checksums at the frames both rings hold.
The pairs run at input delay 0.  The native peer steps first in each
tick, on a clock 10% fast that its run-slow (x1.1) holds level with the
Python peer, so it advances each frame before the Python peer has sent
that frame's input: it predicts, mispredicts at each flip of the Python
peer's input, and the runner serves the core's ``LoadRequest``s.
The tests skip only where ``g++`` is absent; a failed build fails them."""

import shutil
import time

import numpy as np
import pytest

import bevy_ggrs_tpu as J
import bevy_ggrs_tpu_torch as T
from bevy_ggrs_tpu.models import fixed_point as j_fixed_point
from bevy_ggrs_tpu.snapshot.checksum import checksum_to_int as j_checksum_to_int
from bevy_ggrs_tpu_torch.models import fixed_point
from bevy_ggrs_tpu_torch.session import native
from bevy_ggrs_tpu_torch.session.events import DesyncDetected

DT = 1.0 / 60.0


@pytest.fixture(scope="module")
def core():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the native core cannot be built")
    return native.load_library()


def flipping(holder):
    def read_inputs(handles):
        return {h: np.uint8(1 << ((holder[0].frame // 7 + h) % 4)) for h in handles}
    return read_inputs


def builder(pkg, app, i, peer_addr):
    return (pkg.SessionBuilder.for_app(app)
            .with_input_delay(0)
            .with_desync_detection_mode(pkg.DesyncDetection.on(1))
            .with_disconnect_timeout(30.0)
            .with_disconnect_notify_delay(10.0)
            .add_player(pkg.PlayerType.LOCAL, i)
            .add_player(pkg.PlayerType.REMOTE, 1 - i, peer_addr))


def runner(pkg, app, session):
    holder = []
    r = pkg.GgrsRunner(app, session, read_inputs=flipping(holder))
    holder.append(r)
    return r


def native_vs_python(pkg, py_app):
    """A port native peer (handle 0) and a Python peer of ``pkg`` (handle 1)
    over loopback UDP."""
    sock = pkg.UdpNonBlockingSocket(0, host="127.0.0.1")
    py_port = sock.local_addr[1]
    app = fixed_point.make_app(device="cpu")
    nat = builder(T, app, 0, ("127.0.0.1", py_port)).start_p2p_session_native(local_port=0)
    py = builder(pkg, py_app, 1, ("127.0.0.1", nat.local_port())).start_p2p_session(sock)
    return [runner(T, app, nat), runner(pkg, py_app, py)], sock


def sync_all(runners):
    for _ in range(2000):
        for r in runners:
            r.update(0.0)
        if all(r.session.current_state().value == "running" for r in runners):
            return
        time.sleep(0.001)
    raise AssertionError("sessions never synchronized")


def confirmed_checksums(r):
    """Record ``r``'s checksum ref at each frame it confirms."""
    seen = {}

    def on_confirmed(frame):
        entry = r.ring.peek(frame)
        if entry is not None:
            seen.setdefault(frame, entry[1])

    r.on_confirmed = on_confirmed
    return seen


def as_int(r, ref):
    return ref() if isinstance(r, T.GgrsRunner) else j_checksum_to_int(ref)


def play_in_sync(runners, frames):
    """Sync, play ``frames`` ticks, and hold the peers' confirmed checksums
    equal at every frame both recorded.  ``runners[0]`` is the native peer:
    it must roll back, blaming its remote, with one resim per frame."""
    seen = [confirmed_checksums(r) for r in runners]
    sync_all(runners)
    for _ in range(frames):
        runners[0].update(DT * 1.1)  # the fast clock: one step ahead
        runners[1].update(DT)
    for r in runners:
        assert r.frame >= frames - 10
        assert not [e for e in r.events if isinstance(e, DesyncDetected)]
    nat = runners[0]
    assert nat.rollbacks > 5 and set(nat.rollbacks_by_cause) == {1}
    assert nat.rollback_frames >= nat.rollbacks
    assert nat.resims == nat.frame  # one resim per tick, rollback or not
    shared = sorted(set(seen[0]) & set(seen[1]))
    assert len(shared) > frames // 2
    a, b = ([as_int(r, s[f]) for f in shared] for r, s in zip(runners, seen))
    assert a == b


def test_core_builds_into_the_port_build_dir(core):
    lib = native.build_library()
    assert lib.parent == native.BUILD_DIR and lib.exists()
    assert native.native_available()


def test_port_native_peer_plays_port_python_peer(core):
    runners, sock = native_vs_python(T, fixed_point.make_app(device="cpu"))
    try:
        play_in_sync(runners, 120)
        assert min(r.session.confirmed_frame() for r in runners) > 60
    finally:
        sock.close()


def test_port_native_peer_plays_jax_python_peer(core):
    runners, sock = native_vs_python(J, j_fixed_point.make_app())
    try:
        play_in_sync(runners, 120)
    finally:
        sock.close()


def test_port_native_spectator_follows_a_python_host(core):
    socks = [T.UdpNonBlockingSocket(0, host="127.0.0.1") for _ in range(2)]
    ports = [s.local_addr[1] for s in socks]
    app_spec = fixed_point.make_app(device="cpu")
    spec = T.SessionBuilder.for_app(app_spec).start_spectator_session_native(
        ("127.0.0.1", ports[0]), local_port=0)
    hosts = []
    for i in range(2):
        app = fixed_point.make_app(device="cpu")
        b = builder(T, app, i, ("127.0.0.1", ports[1 - i]))
        if i == 0:
            b.add_player(T.PlayerType.SPECTATOR, 2, ("127.0.0.1", spec.local_port()))
        hosts.append(runner(T, app, b.start_p2p_session(socks[i])))
    spec_runner = T.GgrsRunner(app_spec, spec)
    host_checks = confirmed_checksums(hosts[0])
    everyone = hosts + [spec_runner]
    try:
        sync_all(everyone)
        matched = 0
        for _ in range(90):
            for r in everyone:
                r.update(DT)
            if spec_runner.frame in host_checks:
                assert spec_runner.checksum == host_checks[spec_runner.frame]()
                matched += 1
        assert spec_runner.frame > 40 and matched > 20
        assert spec_runner.rollbacks == 0
    finally:
        for s in socks:
            s.close()
