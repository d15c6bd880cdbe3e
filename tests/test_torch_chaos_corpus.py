"""The port's chaos harness against the JAX package's: determinism, the
seeded corpus, the policy matrix, and the port's ``chaos_run`` command.

Each case of ``tests/test_chaos.py``'s ``TestDeterminism`` and
``TestCorpus`` runs with the JAX harness and then with the port's, one
after the other (each package has its own ``utils.faultpoints`` and
``utils.tracing``). Every schedule's run on the port is held to the JAX
run of the same schedule, as in ``tests/test_torch_chaos_points.py``: the
schedule's bytes, the step trace, the fires, the violations (all zero),
convergence, the completeness aborts, the asynchronous points engaged and
the final digest; the run-twice cases run the port twice. With the
tracer installed, the port's normalized span export equals the JAX one's
byte for byte. The command's cases run it as a process, with ``jax``,
the JAX package, the repository's ``tools``, torch and PyYAML
unimportable: a schedule file the JAX command wrote replays to the JAX
run's final digest, and the exit status follows the invariants.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from k8s_operator_libs_tpu.testing import chaos as jax_chaos
from k8s_operator_libs_tpu.utils import tracing as jax_tracing
from k8s_operator_libs_tpu_torch.testing import chaos as port_chaos
from k8s_operator_libs_tpu_torch.utils import tracing as port_tracing
from test_torch_chaos_points import PKGS, _clean_registries, assert_same_run  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

#: The fields of a corpus summary that do not depend on the host's speed.
CORPUS_FIELDS = ("schedules_explored", "invariant_violations", "not_converged",
                 "fault_points_fired", "completeness_aborts", "failing_seeds",
                 "violations_by_kind")


def _both_corpora(run: str, seeds: range, **config):
    """``run`` (``run_corpus`` or ``run_policy_matrix``) with the JAX
    harness, then the port's; every seed's port run equal to the JAX run
    of its schedule. Returns the two summaries."""
    results = {}
    summaries = {}
    for name, pkg in PKGS.items():
        results[name] = []
        summaries[name] = getattr(pkg.chaos, run)(
            seeds, pkg.chaos.ChaosConfig(**config), on_result=results[name].append)
    assert len(results["port"]) == len(results["jax"])
    for jax_result, port_result in zip(results["jax"], results["port"]):
        assert_same_run(jax_result, port_result)
    return summaries["jax"], summaries["port"]


def _same_corpus(jax_summary, port_summary) -> None:
    for name in CORPUS_FIELDS:
        assert port_summary[name] == jax_summary[name], name


# ---------------------------------------------------------------------------
# TestDeterminism
# ---------------------------------------------------------------------------


def test_schedule_json_round_trip_is_byte_stable():
    texts = {}
    for name, pkg in PKGS.items():
        cfg = pkg.chaos.ChaosConfig(pools=8, workers=2, shards=4)
        text = pkg.chaos.generate_schedule(42, cfg).to_json()
        assert pkg.chaos.FaultSchedule.from_json(text).to_json() == text
        assert pkg.chaos.generate_schedule(42, cfg).to_json() == text
        assert pkg.chaos.generate_schedule(43, cfg).to_json() != text
        texts[name] = text
    assert texts["port"] == texts["jax"]
    # A file of either package loads in the other's.
    assert port_chaos.FaultSchedule.from_json(texts["jax"]).to_json() == texts["jax"]


def test_run_twice_same_trace_same_final_state():
    """Same seed, same schedule JSON, same step trace, same final digest:
    the port twice, each run equal to the JAX run."""
    jax_result = jax_chaos.run_seed(11, jax_chaos.ChaosConfig(pools=8, workers=2, shards=4))
    first, second = (
        port_chaos.run_seed(11, port_chaos.ChaosConfig(pools=8, workers=2, shards=4))
        for _ in range(2)
    )
    for result in (first, second):
        assert_same_run(jax_result, result)
        assert result.converged


def test_run_twice_same_span_trace_bytes():
    """With the tracer installed (``chaos_run --trace-json``), the port's
    normalized span export is the same bytes run to run, and the same
    bytes as the JAX harness's: times from the ChaosClock, ids renumbered
    in content order, spans after the clock retired cut off."""
    def traced_blob(chaos, tracing) -> bytes:
        schedule = chaos.generate_schedule(5, chaos.ChaosConfig(pools=6, workers=2, shards=2))
        tracer = tracing.Tracer()
        tracing.install_tracer(tracer)
        try:
            result = chaos.run_schedule(schedule)
        finally:
            tracing.clear_tracer()
        assert result.converged and not result.total_violations
        return tracer.export_bytes(end_before=tracing.CHAOS_EXPORT_CUTOFF)

    jax_blob = traced_blob(jax_chaos, jax_tracing)
    first = traced_blob(port_chaos, port_tracing)
    second = traced_blob(port_chaos, port_tracing)
    assert first.count(b"\n") == second.count(b"\n") > 50
    assert first == second
    assert first == jax_blob


# ---------------------------------------------------------------------------
# TestCorpus
# ---------------------------------------------------------------------------


def test_seeded_corpus_holds_every_invariant():
    jax_summary, summary = _both_corpora(
        "run_corpus", range(4), pools=8, workers=2, shards=4)
    _same_corpus(jax_summary, summary)
    assert summary["schedules_explored"] == 4
    assert summary["invariant_violations"] == 0, summary
    assert summary["not_converged"] == 0
    assert summary["fault_points_fired"], "no fault ever fired"


@pytest.mark.slow
def test_wider_corpus_with_hub():
    jax_summary, summary = _both_corpora(
        "run_corpus", range(8), pools=12, workers=2, shards=4, hub=True)
    _same_corpus(jax_summary, summary)
    assert summary["invariant_violations"] == 0, summary
    assert summary["not_converged"] == 0


def test_checkpoint_restart_schedule_no_spurious_escalation():
    """A worker killed mid checkpoint arc and restarted re-enters through
    the durable epoch: no escalation, on the port as on JAX."""
    results = []
    for pkg in PKGS.values():
        c = pkg.chaos
        schedule = c.FaultSchedule(
            seed=0,
            config=c.ChaosConfig(pools=4, workers=2, shards=2, checkpoint=True,
                                 fault_window=30),
            faults=[c.FaultSpec(step=8, point="worker_kill", duration=12, target="w0",
                                param="restart")],
        )
        results.append(c.run_schedule(schedule))
    assert_same_run(*results)
    for result in results:
        assert result.converged
        assert result.violations["checkpoint_spurious_escalations"] == 0
        assert result.total_violations == 0


def test_completeness_aborts_are_counted_not_silent():
    jax_result = jax_chaos.run_seed(0, jax_chaos.ChaosConfig(pools=8, workers=2, shards=4))
    result = port_chaos.run_seed(0, port_chaos.ChaosConfig(pools=8, workers=2, shards=4))
    assert_same_run(jax_result, result)
    assert "completeness_races_unbounded" in result.violations
    assert result.completeness_aborts >= 0


# ---------------------------------------------------------------------------
# The port's command
# ---------------------------------------------------------------------------

#: Run the port's command with these modules unimportable.
BLOCKED = ("jax", "jaxlib", "k8s_operator_libs_tpu", "tools", "torch", "yaml")


def port_command(*args: str, timeout: float = 240) -> tuple[int, dict, str]:
    """Run ``python -m k8s_operator_libs_tpu_torch.tools.chaos_run`` with
    :data:`BLOCKED` unimportable; returns its exit status, its last line
    (None when it is no JSON object) and its standard error."""
    code = (
        "import runpy, sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = ['chaos_run', *{list(args)!r}]\n"
        "runpy.run_module('k8s_operator_libs_tpu_torch.tools.chaos_run', run_name='__main__')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    return proc.returncode, last, proc.stderr


def test_jax_commands_schedule_replays_on_the_ports_command(tmp_path):
    """``tools/chaos_run.py --seed 17 --schedule-json`` (the JAX command,
    at its default 64 pools) writes a schedule; the port's ``--replay`` of
    that file reaches the JAX run's final digest, with the same summary."""
    path = tmp_path / "seed-17.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "tools.chaos_run", "--seed", "17", "--schedule-json", str(path),
         "--quiet"], cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    jax_summary = json.loads(proc.stdout.strip().splitlines()[-1])
    rc, summary, err = port_command("--replay", str(path), "--quiet")
    assert rc == 0, err[-2000:]
    assert summary["final_digest"] == jax_summary["final_digest"]
    for name in ("seed", "converged", "steps", "violations", "fired", "completeness_aborts"):
        assert summary[name] == jax_summary[name], name
    assert port_chaos.FaultSchedule.from_json(path.read_text()).config.pools == 64


def _all_workers_killed(tmp_path) -> str:
    """A schedule that takes every worker for good at step 2 and stops at
    step 12: the roll cannot converge."""
    c = port_chaos
    schedule = c.FaultSchedule(
        seed=0,
        config=c.ChaosConfig(pools=2, workers=2, shards=2, max_steps=12),
        faults=[c.FaultSpec(step=2, point="worker_kill", target=w, param="perma")
                for w in ("w0", "w1")],
    )
    path = tmp_path / "all-killed.json"
    path.write_text(schedule.to_json())
    return str(path)


@pytest.mark.parametrize("case", [
    "replay-not-converged", "seed-determinism", "corpus", "policy-matrix",
    "corpus-with-verify", "matrix-with-policy", "no-mode",
])
def test_ports_command_flags_and_exit_status(case, tmp_path):
    """Nonzero on a planted non-convergence, zero on clean runs, 2 on
    flags that do not go together; the last line is one JSON summary."""
    small = ["--pools", "4", "--shards", "2", "--quiet"]
    if case == "replay-not-converged":
        rc, summary, _ = port_command("--replay", _all_workers_killed(tmp_path), "--quiet")
        assert rc == 1
        assert summary["converged"] is False
        assert summary["violations"]["not_converged"] == 1
        assert summary["fired"] == {"worker_kill": 2}
        assert summary["steps"] == 12
    elif case == "seed-determinism":
        schedule = tmp_path / "seed-3.json"
        trace = tmp_path / "seed-3.jsonl"
        rc, summary, err = port_command("--seed", "3", "--verify-determinism", "--schedule-json",
                                        str(schedule), "--trace-json", str(trace), *small)
        assert rc == 0, err[-2000:]
        assert summary["deterministic_replay"] is True
        assert summary["total_violations"] == 0 and summary["converged"]
        assert summary["trace_spans"] == trace.read_bytes().count(b"\n") > 0
        expected = port_chaos.generate_schedule(
            3, port_chaos.ChaosConfig(pools=4, shards=2)).to_json()
        assert schedule.read_text() == expected
    elif case == "corpus":
        rc, summary, err = port_command("--seeds", "2", "--start-seed", "4", "--hub", *small)
        assert rc == 0, err[-2000:]
        assert summary["schedules_explored"] == 2
        assert summary["invariant_violations"] == 0 and summary["failing_seeds"] == []
        assert [json.loads(line)["seed"] for line in err.splitlines()
                if line.startswith("{")] == [4, 5]
    elif case == "policy-matrix":
        rc, summary, err = port_command("--seeds", "1", "--policy-matrix", *small)
        assert rc == 0, err[-2000:]
        assert summary["compositions"] == 5 and summary["budget_violations"] == 0
    else:
        argv = {
            "corpus-with-verify": ("--seeds", "2", "--verify-determinism"),
            "matrix-with-policy": ("--seeds", "1", "--policy-matrix", "--policy", "cost-tiers"),
            "no-mode": (),
        }[case]
        rc, summary, err = port_command(*argv, *small)
        assert rc == 2 and summary is None
        assert "error:" in err
