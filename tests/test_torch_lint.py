"""The repo's linter and static analyzer over the port, by path.

``tools/lint.py`` must be clean over ``k8s_operator_libs_tpu_torch`` and
``chip_smoke.py``. ``tools/analyze.py`` runs over the port against the
baseline the port keeps (``k8s_operator_libs_tpu_torch/analyze_baseline.json``;
the repo's own baseline is the JAX package's): no finding outside it, no
stale entry in it, and no unhandled state (STM203) in the port's state
machine now that it runs the quarantine arc.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
BASELINE = REPO / "k8s_operator_libs_tpu_torch" / "analyze_baseline.json"
#: The findings the baseline keeps, each with its reason there.
BASELINED = ["EXC401", "EXC401", "KEY301"]


def _run(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True,
                          timeout=120)


@pytest.fixture(scope="module")
def analysis() -> dict:
    proc = _run("tools/analyze.py", "k8s_operator_libs_tpu_torch", "--baseline", str(BASELINE),
                "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout)


def test_lint_is_clean_over_the_port_and_chip_smoke():
    proc = _run("tools/lint.py", "k8s_operator_libs_tpu_torch", "chip_smoke.py")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint clean" in proc.stdout + proc.stderr


def test_analyze_finds_nothing_outside_the_ports_baseline(analysis):
    assert analysis["findings"] == []
    assert analysis["stale_baseline_entries"] == []
    assert sorted(f["code"] for f in analysis["baselined"]) == BASELINED


def test_no_state_of_the_port_machine_is_left_unhandled(analysis):
    """STM203 (a state ``apply_state`` has no handler for) was the
    ``quarantined`` state's until the quarantine arc was ported."""
    found = analysis["findings"] + analysis["baselined"]
    assert not [f for f in found if f["code"].startswith("STM")]


def test_every_baseline_entry_says_why():
    entries = json.loads(BASELINE.read_text())["suppressions"]
    assert sorted(e["code"] for e in entries) == BASELINED
    for entry in entries:
        assert entry["fingerprint"].startswith("k8s_operator_libs_tpu_torch/")
        assert entry["justification"] and "TODO" not in entry["justification"]
