"""The port's tooling twins on the CPU, each as a subprocess:
``scripts/torch_e2e_p2p_check.py`` (two runners over real loopback UDP,
its lockstep and staggered phases) prints its OK line, and
``scripts/torch_parity_check.py`` (``fixed_point``'s 12 checksums on the
device and on the CPU) exits 0."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(script: str, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, str(ROOT / "scripts" / script), *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)


def test_e2e_p2p_check_over_loopback_udp():
    res = _run("torch_e2e_p2p_check.py", "--device", "cpu", "--ticks", "60")
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert lines[0].startswith("RUNNING after") and lines[0].endswith("on cpu")
    assert lines[-1] == "E2E P2P OK"


def test_parity_check_exits_zero():
    res = _run("torch_parity_check.py", "--device", "cpu")
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "fixed-point parity (cpu vs cpu): EXACT MATCH" in res.stdout
