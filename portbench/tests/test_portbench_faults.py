"""Runs of the cells on the CPU (the gate's plain versions in a gloo
world), with the look for a card skipped: sound, they come out correct;
with the timed path broken underneath, ``correct`` comes out false. One
test for each fault a cell can have: an answer altered where it is
produced (K1's product, K2's output), a step that returns its state
unchanged (the burn-in's update, the state machine's pass), and half of
the batch left out (the burn-in's loss taken over the rest). Then the
roll's guarantees, held by the checker on a small pool."""

from __future__ import annotations

import copy
import json
import subprocess
import sys

import pytest

from portbench import checks, run, spec
from portbench.drivers import gate as gate_driver
from portbench.drivers import roll as roll_driver
from portbench.record import Run
from portbench.reference.guarantees import RollChecker

#: The roll cell, built and measured but held out of BENCHMARK.json.
ROLL = "gpu_pool_roll.roll"


def _context(cell_name: str, seconds: float = 2.0, shrink: bool = True) -> run.Context:
    cell, config = _cell(cell_name)
    config = copy.deepcopy(config)
    if shrink and "cluster" in config:
        config["cluster"]["other_nodes"], config["cluster"]["pool_nodes"] = 12, 4
    return run.Context(cell=cell, config=config, traffic=spec.traffic(cell["traffic"]),
                       seed=2**31 + 77, seconds=seconds, trace=False, cards=1, device="cpu")


def _cell(cell_name: str) -> tuple[dict, dict]:
    """A cell of BENCHMARK.json, or the roll cell held out of it (PERF.md),
    from its configuration's file; and its configuration."""
    bench = spec.load_benchmark()
    if cell_name != ROLL:
        cell = spec.cell(bench, cell_name)
        return cell, spec.config(bench, cell)
    config = json.loads((spec.PACKAGE / "configs" / "gpu_pool_roll.json").read_text())
    return {"name": ROLL, "config": "gpu_pool_roll", "traffic": "roll", "chips": 1}, config


def _correct(ctx: run.Context) -> tuple[bool, dict]:
    outcome = spec.driver(ctx.config["system"]).run_cell(ctx)
    return checks.verdict(outcome.numbers, outcome.limits)


# -- faults planted in the world's rank process (sent by name) -------------

def _state_unchanged() -> bool:
    from k8s_operator_libs_tpu_torch.models import burnin

    burnin.sgd_update = lambda params, grads, lr: params
    return True


def _half_batch() -> bool:
    from k8s_operator_libs_tpu_torch.models import burnin

    full = burnin._full_batch

    def half(tokens):
        batch = full(tokens)
        if batch is None:
            return None
        return {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}

    burnin._full_batch = half
    return True


@pytest.fixture
def plant_in_rank(monkeypatch):
    """Plant ``fault`` in the gate's rank once its world has formed."""

    def plant(fault):
        warm = gate_driver.warm

        def warm_then_plant(gate, probes, batteries):
            gate._get_world(gate.world_devices()).run(fault)
            warm(gate, probes, batteries)

        monkeypatch.setattr(gate_driver, "warm", warm_then_plant)

    return plant


def _altered(fn, delta: float):
    def altered(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out.view(-1)[0] += delta
        return out

    return altered


def test_a_sound_gate_run_is_correct():
    ok, table = _correct(_context("gpu_node_gate.revalidate"))
    assert ok, table


def test_k1_product_altered(monkeypatch):
    from k8s_operator_libs_tpu_torch.ops import matmul

    # 0.1 on one element: below the probe's own tolerance (1e-2 sqrt(K)),
    # above the benchmark's limit.
    monkeypatch.setattr(matmul, "matmul_reference", _altered(matmul.matmul_reference, 0.1))
    ok, table = _correct(_context("gpu_node_gate.revalidate"))
    assert not ok and table["k1_rel_err"]["value"] > table["k1_rel_err"]["limit"]


def test_k2_output_altered(monkeypatch):
    from k8s_operator_libs_tpu_torch.ops import flash_attention

    monkeypatch.setattr(flash_attention, "flash_attention_reference",
                        _altered(flash_attention.flash_attention_reference, 0.25))
    ok, table = _correct(_context("gpu_node_gate.revalidate"))
    assert not ok and table["k2_rel_err"]["value"] > table["k2_rel_err"]["limit"]


def test_k1_chain_link_altered(monkeypatch):
    """Only the chain's links altered (B / sqrt(n) is the only operand
    under 1): the probe's own check passes, the chain's comparison not."""
    from k8s_operator_libs_tpu_torch.ops import matmul

    plain = matmul.matmul_reference

    def link_altered(a, b):
        out = plain(a, b)
        if float(b.float().abs().max()) < 1:
            out = out.clone()
            out.view(-1)[0] += out.abs().max()
        return out

    monkeypatch.setattr(matmul, "matmul_reference", link_altered)
    ok, table = _correct(_context("gpu_node_gate.revalidate"))
    assert table["k1_rel_err"]["value"] <= table["k1_rel_err"]["limit"]
    assert not ok
    assert table["k1_chain_rel_err"]["value"] > table["k1_chain_rel_err"]["limit"]


def test_k2_timed_calls_altered(monkeypatch):
    """The flash probe's checked call sound and its three timed calls
    altered: every call is compared, so ``correct`` is false."""
    from k8s_operator_libs_tpu_torch.ops import flash_attention

    plain = flash_attention.flash_attention_reference
    calls = {"n": 0}

    def timed_altered(*args, **kwargs):
        calls["n"] += 1
        out = plain(*args, **kwargs)
        if calls["n"] % 4 != 1:
            out = out.clone()
            out.view(-1)[0] += 0.25
        return out

    monkeypatch.setattr(flash_attention, "flash_attention_reference", timed_altered)
    ok, table = _correct(_context("gpu_node_gate.revalidate"))
    assert not ok and table["k2_rel_err"]["value"] > table["k2_rel_err"]["limit"]
    assert table["verdicts_not_ok"]["value"] == 0


def test_a_probe_that_goes_round_the_seeded_inputs_is_named(monkeypatch):
    """A flash probe that makes its own q, k, v (as a cache of them in the
    port would) stops the run with the name the benchmark relies on."""
    from k8s_operator_libs_tpu_torch.ops import flash_attention, probe_harness
    from k8s_operator_libs_tpu_torch.tpu import health

    probe = health.flash_attention_probe

    def own_inputs(*args, **kwargs):
        seeded = flash_attention.host_qkv
        flash_attention.host_qkv = probe_harness.host_qkv
        try:
            return probe(*args, **kwargs)
        finally:
            flash_attention.host_qkv = seeded

    monkeypatch.setattr(health, "flash_attention_probe", own_inputs)
    with pytest.raises(gate_driver.HookError, match="host_qkv"):
        _correct(_context("gpu_node_gate.revalidate"))


def test_burnin_state_unchanged(plant_in_rank):
    plant_in_rank(_state_unchanged)
    ok, table = _correct(_context("gpu_node_gate.revalidate"))
    assert not ok and table["burnin_drop_err"]["value"] > table["burnin_drop_err"]["limit"]


def test_burnin_half_batch(plant_in_rank):
    plant_in_rank(_half_batch)
    ok, table = _correct(_context("gpu_node_gate.revalidate"))
    assert not ok and table["burnin_loss_err"]["value"] > table["burnin_loss_err"]["limit"]


def test_a_sound_roll_is_correct():
    ok, table = _correct(_context(ROLL, seconds=4.0))
    assert ok, table


def test_roll_pass_returns_state_unchanged(monkeypatch):
    from k8s_operator_libs_tpu_torch.upgrade import ClusterUpgradeStateManager

    apply_state = ClusterUpgradeStateManager.apply_state
    calls = {"n": 0}

    def stuck(self, state, policy):
        # The pool settles at the first version (the set-up's passes);
        # after the window's bump no pass moves a node.
        calls["n"] += 1
        if calls["n"] <= 2:
            return apply_state(self, state, policy)
        return None

    monkeypatch.setattr(ClusterUpgradeStateManager, "apply_state", stuck)
    ok, table = _correct(_context(ROLL, seconds=4.0))
    assert not ok
    assert table["longest_stall_passes"]["value"] > table["longest_stall_passes"]["limit"]


def test_roll_gate_answer_altered(monkeypatch):
    from k8s_operator_libs_tpu_torch.ops import matmul

    monkeypatch.setattr(matmul, "matmul_reference", _altered(matmul.matmul_reference, 0.1))
    ok, table = _correct(_context(ROLL, seconds=4.0))
    assert not ok and table["k1_rel_err"]["value"] > table["k1_rel_err"]["limit"]


def test_the_roll_builds_its_cluster_before_torch():
    """``before_torch`` builds the whole cluster with neither torch nor
    NumPy loaded, and freezes it out of the collector."""
    code = (
        "import json, sys, types, portbench.drivers.roll as roll\n"
        "from portbench import spec\n"
        "config = json.loads((spec.PACKAGE / 'configs' / 'gpu_pool_roll.json').read_text())\n"
        "ctx = types.SimpleNamespace(config=config, seed=2**31 + 5, notes={}, prepared=None)\n"
        "roll.before_torch(ctx)\n"
        "print(sorted({'torch', 'numpy'} & set(sys.modules)), len(ctx.prepared.pool),\n"
        "      ctx.notes['gc_frozen_objects'] > 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "64", "True"]


# -- the roll's guarantees -------------------------------------------------

def test_checker_flags_each_broken_guarantee():
    checker = RollChecker(max_parallel=1, max_unavailable=16)
    idle = {"a": ("upgrade-done", False), "b": ("upgrade-done", False)}
    checker.observe(0.0, idle, {"a": "v1", "b": "v1"}, "v1")
    checker.observe(1.0, {"a": ("cordon-required", True), "b": ("cordon-required", True)},
                    {"a": "v1", "b": "v1"}, "v2")
    assert checker.violations == {"more_in_upgrade_than_max_parallel": 1,
                                  "more_cordoned_than_allowed": 1}
    checker.verdict("a", True, 1.5)
    checker.observe(2.0, {"a": ("upgrade-done", False), "b": ("upgrade-done", False)},
                    {"a": "v1", "b": "v2"}, "v2")
    # a: a verdict, but its driver pod is not at the target; b: no verdict.
    assert checker.violations["driver_not_at_target"] == 1
    assert checker.violations["uncordoned_before_verdict"] == 1
    assert checker.unfinished() == 0 and len(checker.ended) == 2
    for t in (3.0, 4.0, 5.0):
        checker.observe(t, {"a": ("upgrade-done", False), "b": ("upgrade-done", False)},
                        {"a": "v2", "b": "v2"}, "v2")
    assert checker.longest_stall == 3


def _small_roll(policy_override: dict) -> roll_driver.Roll:
    config = copy.deepcopy(_cell(ROLL)[1])
    config["cluster"]["other_nodes"], config["cluster"]["pool_nodes"] = 12, 4
    config["upgrade_policy"].update(policy_override)
    roll = roll_driver.Roll(config, seed=5, validation_hook=lambda node: True, run=Run())
    roll.one_pass(count_stall=False)
    assert roll.settled()
    return roll


def test_a_small_pool_rolls_within_its_guarantees():
    roll = _small_roll({})
    try:
        roll.bump()
        for _ in range(200):
            roll.one_pass()
            if roll.settled():
                break
        assert roll.settled()
        checker = roll.checker
        assert checker.violation_count() == 0 and checker.unfinished() == 0
        assert sorted(r.node for r in checker.ended) == sorted(roll.pool)
        assert all(r.ok for r in checker.ended)
    finally:
        roll.close()


def test_a_wider_roll_than_the_policy_breaks_a_guarantee():
    """The manager given maxParallelUpgrades 2 while the checker holds the
    configuration's 1: the checker sees two nodes out at once."""
    roll = _small_roll({"maxParallelUpgrades": 2, "maxUnavailable": "100%"})
    try:
        roll.checker.max_parallel = 1
        roll.bump()
        for _ in range(100):
            roll.one_pass()
            if roll.settled():
                break
        assert roll.checker.violation_count() > 0
    finally:
        roll.close()
