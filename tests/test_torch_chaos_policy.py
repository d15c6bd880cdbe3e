"""The port's chaos harness against the JAX package's: the policy matrix,
and ``chip_smoke.py``'s chaos phase rehearsed on the CPU.

``tests/test_chaos.py``'s two policy cases (``TestCorpus``), run with the
JAX harness and then with the port's, every schedule's port run held to
the JAX run of the same schedule as in
``tests/test_torch_chaos_points.py``, and each cell of the matrix's
summary equal to the JAX cell. A file of its own, the matrix being the
longest case of the port's chaos tests.
"""

from __future__ import annotations

import json

import pytest

from test_torch_chaos_corpus import _both_corpora, _same_corpus
from test_torch_chaos_points import PKGS, _clean_registries  # noqa: F401


def test_policy_matrix_zero_budget_violations():
    """Every shipped policy composition over two seeds: no budget
    violation, every cell converged, each cell equal to the JAX one."""
    jax_summary, summary = _both_corpora(
        "run_policy_matrix", range(2), pools=4, workers=2, shards=2)
    assert summary["compositions"] == 5
    assert summary["schedules_explored"] == 10
    assert summary["budget_violations"] == 0, summary
    assert summary["invariant_violations"] == 0, summary
    assert summary["not_converged"] == 0
    assert set(summary["cells"]) == {
        "default", "maintenance-window", "cost-tiers",
        "default+maintenance-window", "cost-tiers+maintenance-window",
    }
    assert set(jax_summary["cells"]) == set(summary["cells"])
    for cell, jax_cell in jax_summary["cells"].items():
        _same_corpus(jax_cell, summary["cells"][cell])


def test_policy_rides_the_schedule_json():
    texts = {}
    for name, pkg in PKGS.items():
        cfg = pkg.chaos.ChaosConfig(pools=4, workers=2, shards=2,
                                    policy=("default", "maintenance-window"))
        text = pkg.chaos.generate_schedule(7, cfg).to_json()
        again = pkg.chaos.FaultSchedule.from_json(text)
        assert again.config.policy == ("default", "maintenance-window")
        assert again.to_json() == text
        texts[name] = text
    assert texts["port"] == texts["jax"]


def test_chip_smoke_chaos_phase_on_the_cpu(capsys, monkeypatch):
    """``chip_smoke.py``'s chaos phase as the card machine runs it: the
    port's command twice as a child, a corpus of three seeds over the
    wire path and one seed run twice, with no violation and neither JAX
    nor PyYAML imported. The phase's 60 s budget is the card machine's;
    here, beside the other test files' workers, it is four times that."""
    from test_torch_cuda import chip_smoke_module

    smoke = chip_smoke_module()
    monkeypatch.setattr(smoke, "CHAOS_BUDGET_S", 4 * smoke.CHAOS_BUDGET_S)
    info = smoke.chaos_phase("cpu")
    (line,) = [json.loads(ln)["chaos"] for ln in capsys.readouterr().out.splitlines()
               if ln.startswith('{"chaos"')]
    assert line["corpus"]["schedules_explored"] == 3
    assert sorted(line["corpus"]["seeds"]) == ["0", "1", "2"]
    assert line["determinism"]["deterministic_replay"] is True
    assert line["imported"] == {"corpus": [], "determinism": []}
    assert line["rc"] == {"corpus": 0, "determinism": 0}
    assert info["corpus"]["invariant_violations"] == 0


def test_chip_smoke_chaos_phase_fails_on_a_forbidden_import(monkeypatch):
    """A child that ends with the JAX package in ``sys.modules`` fails the
    phase, though its runs are clean."""
    from test_torch_cuda import chip_smoke_module

    smoke = chip_smoke_module()
    monkeypatch.setattr(smoke, "CHAOS_CHILD", "import k8s_operator_libs_tpu\n" + smoke.CHAOS_CHILD)
    monkeypatch.setattr(smoke, "CHAOS_RUNS", tuple(
        (label, (*args, "--pools", "4", "--shards", "2")) for label, args in smoke.CHAOS_RUNS))
    with pytest.raises(AssertionError, match="imported \\['k8s_operator_libs_tpu'\\]"):
        smoke.chaos_phase("cpu")
