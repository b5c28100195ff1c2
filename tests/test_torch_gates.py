"""The repo's own gates over the PyTorch port: ``python -m scripts.lint``
(the determinism, purity and shape rules) reports no error in
``bevy_ggrs_tpu_torch``, and ``scripts/docs_check.py``'s check finds no
undocumented module, class, function or method there."""

import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "bevy_ggrs_tpu_torch"


def test_lint_reports_no_error_in_the_port():
    res = subprocess.run([sys.executable, "-m", "scripts.lint", "bevy_ggrs_tpu_torch"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "(0 errors," in res.stdout, res.stdout[-3000:]


def test_docs_check_finds_nothing_in_the_port():
    spec = importlib.util.spec_from_file_location("docs_check", ROOT / "scripts" / "docs_check.py")
    docs_check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(docs_check)
    files = sorted(p for p in PORT.rglob("*.py") if "_build" not in p.parts)
    assert len(files) > 50
    problems = [p for f in files for p in docs_check.check_file(str(f))]
    assert problems == []
