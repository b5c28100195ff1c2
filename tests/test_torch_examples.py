"""Smoke tests of the port's example CLIs (``examples_torch/``) and its room
server (``scripts/torch_room_server.py``), as subprocesses on the CPU
(``BGT_PLATFORM=cpu``).  Mirrors the seven cases of
``tests/test_examples.py``, asserting the lines those assert; the crowd
twin runs as two gloo ranks that rendezvous through a file in
``tmp_path`` (no TCP port).  Besides: with no platform set, a twin asks
for the card, which raises here (a twin never falls back to the CPU).

Every process gets a timeout and is killed when it, or a peer, fails."""

import os
import re
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("BGT_PLATFORM", "JAX_PLATFORMS", "RANK", "WORLD_SIZE")}
    env.update(BGT_PLATFORM="cpu", OMP_NUM_THREADS="1", **extra)
    return env


def run_example(args, env=None, timeout=TIMEOUT_S):
    return subprocess.run([sys.executable] + args, cwd=REPO, env=env or _env(),
                          capture_output=True, text=True, timeout=timeout)


def _popen(args, env=None):
    return subprocess.Popen([sys.executable] + args, cwd=REPO, env=env or _env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(procs, timeout=TIMEOUT_S):
    """Every process's output; kills them all on a failure or timeout."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _ports(n):
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_box_game_synctest_example():
    r = run_example(["examples_torch/box_game_synctest.py", "--frames", "60",
                     "--check-distance", "3"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "no mismatches" in r.stdout
    assert r.stdout.startswith("device: cpu")


def test_particles_example_synctest():
    r = run_example(["examples_torch/particles_stress.py", "--rate", "10", "--ttl", "20",
                     "--synctest", "--check-distance", "2", "--frames", "40"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "live particles" in r.stdout
    assert int(re.search(r"(\d+) live particles", r.stdout).group(1)) > 0


def test_box_game_p2p_pair_example():
    ports = _ports(2)
    procs = [_popen(["examples_torch/box_game_p2p.py", "--local-port", str(ports[i]),
                     "--players"]
                    + (["local", f"127.0.0.1:{ports[1]}"] if i == 0
                       else [f"127.0.0.1:{ports[0]}", "local"])
                    + ["--frames", "120"]) for i in range(2)]
    outs = _finish(procs)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    assert all("done at frame" in o for o in outs), outs[0][-500:]


def test_pong_example_synctest():
    r = run_example(["examples_torch/pong_p2p.py", "--synctest", "--frames", "60",
                     "--check-distance", "2"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "score" in r.stdout


def test_crowd_multichip_example_on_two_ranks(tmp_path):
    """The crowd twin as two gloo ranks (``RANK``/``WORLD_SIZE`` set, as
    torchrun sets them), rendezvous through a file: both ranks run the
    sharded resim and the speculative fan-out and agree on the checksum."""
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [_popen(["examples_torch/crowd_multichip.py", "--per-team", "256",
                     "--frames", "16", "--spec-axis", "1", "--init-method", init],
                    env=_env(RANK=str(r), WORLD_SIZE="2")) for r in range(2)]
    outs = _finish(procs)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        assert "speculative fan-out" in out
        assert "ranks: 2" in out and "'data': 2" in out
    sums = [re.search(r"checksum (0x[0-9a-f]+)", o).group(1) for o in outs]
    assert sums[0] == sums[1]


def test_crowd_multichip_example_one_process():
    """With no launcher the twin is a one-rank group on its device."""
    r = run_example(["examples_torch/crowd_multichip.py", "--per-team", "128",
                     "--frames", "8"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "ranks: 1" in r.stdout and "speculative fan-out" in r.stdout


def test_spectator_cli_follows_host_pair():
    ports = _ports(3)
    host = _popen(["examples_torch/box_game_p2p.py", "--local-port", str(ports[0]),
                   "--players", "local", f"127.0.0.1:{ports[1]}",
                   "--spectators", f"127.0.0.1:{ports[2]}", "--frames", "120"])
    peer = _popen(["examples_torch/box_game_p2p.py", "--local-port", str(ports[1]),
                   "--players", f"127.0.0.1:{ports[0]}", "local", "--frames", "120"])
    spec = _popen(["examples_torch/box_game_spectator.py", "--local-port", str(ports[2]),
                   "--host", f"127.0.0.1:{ports[0]}", "--frames", "60"])
    s_out, h_out, _p_out = _finish([spec, host, peer])
    assert spec.returncode == 0, s_out[-2000:]
    assert "frame" in s_out
    assert host.returncode == 0, h_out[-2000:]


def test_box_game_room_example_pair():
    """Room server process and two players that find each other by room
    name and finish with the same checksum."""
    port = _ports(1)[0]
    server = _popen(["scripts/torch_room_server.py", "--port", str(port),
                     "--host", "127.0.0.1"])
    try:
        procs = [_popen(["examples_torch/box_game_room.py", "--server",
                         f"127.0.0.1:{port}", "--room", "smoke", "--frames", "90",
                         "--peer-id", name]) for name in ("alice", "bob")]
        outs = _finish(procs)
    finally:
        server.kill()
        server.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    sums = [re.search(r"checksum (0x[0-9a-f]+)", o) for o in outs]
    assert all(sums), outs[0][-500:]
    assert sums[0].group(1) == sums[1].group(1)


def test_twins_default_to_the_card():
    """No platform set means the card: without one a twin raises, and it
    never runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = _env()
    env.pop("BGT_PLATFORM")
    r = run_example(["examples_torch/box_game_synctest.py", "--frames", "2"], env=env)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
