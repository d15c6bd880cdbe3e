"""The JAX machine's own specs, run on the port's state machine.

The in-place scenarios of ``tests/test_state_machine.py`` and
``tests/test_state_machine_parity.py``, each named after its JAX
counterpart (``<file>::<class>::<test>`` in its docstring or ids), with
the checks of the two files that test the same thing merged into the
cases of one parametrised test. Each runs on the port's machine over the
JAX package's in-memory cluster, so it is held to the JAX spec it
transcribes; ``tests/test_torch_state_manager.py`` holds the two machines
to each other pass by pass. The requestor spec of the parity file
(``TestDualModeCoexistence``) is the last case here; the requestor mode's
own specs run against the JAX machine in ``tests/test_torch_requestor.py``.
"""

from __future__ import annotations

import pytest

from builders import make_node, make_pod
from k8s_operator_libs_tpu.kube import FakeCluster, Node, Pod
from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from k8s_operator_libs_tpu_torch.upgrade import (
    BuildStateError,
    ClusterUpgradeStateManager,
    DeviceClass,
    RequestorOptions,
    TaskRunner,
    UpgradeKeys,
    UpgradeState,
    enable_requestor_mode,
)

KEYS = UpgradeKeys(DeviceClass.nvidia("gpu"))
NS = "driver-ns"
LABELS = {"app": "driver"}


def policy(**doc):
    """A policy document, autoUpgrade on unless given."""
    return DriverUpgradePolicySpec.from_dict({"autoUpgrade": True, **doc})


def manager(cluster):
    return ClusterUpgradeStateManager(cluster, DeviceClass.nvidia("gpu"), runner=TaskRunner(inline=True))


def make_harness(node_count=1, node_states=None, cordoned=(), not_ready=(),
                 readiness_steps=0):
    """Cluster, DaemonSet simulator and manager, as the JAX specs' own."""
    cluster = FakeCluster()
    for i in range(node_count):
        labels = {}
        if node_states and node_states[i]:
            labels[KEYS.state_label] = node_states[i]
        cluster.create(
            make_node(f"node-{i}", labels=labels, unschedulable=i in cordoned, ready=i not in not_ready)
        )
    sim = DaemonSetSimulator(
        cluster, name="driver", namespace=NS, match_labels=LABELS, readiness_steps=readiness_steps
    )
    sim.settle()
    return cluster, sim, manager(cluster)


def orphan_harness(node_state="", annotations=None):
    """A node with only an orphaned driver pod, no DaemonSet at all."""
    cluster = FakeCluster()
    labels = {KEYS.state_label: node_state} if node_state else {}
    cluster.create(make_node("node-0", labels=labels, annotations=annotations))
    orphan = Pod.new("orphan-driver", namespace=NS)
    orphan.labels.update(LABELS)
    orphan.node_name = "node-0"
    orphan.phase = "Running"
    orphan.status["conditions"] = [{"type": "Ready", "status": "True"}]
    cluster.create(orphan)
    return cluster, manager(cluster)


def state_of(cluster, name="node-0"):
    return cluster.get("Node", name).labels.get(KEYS.state_label, "")


def states(cluster):
    return {n.name: n.labels.get(KEYS.state_label, "") for n in cluster.list("Node")}


def count(cluster, value):
    return list(states(cluster).values()).count(value)


def one_pass(mgr, pol):
    mgr.apply_state(mgr.build_state(NS, LABELS), pol)


def run_until_done(cluster, sim, mgr, pol, max_passes=20):
    for i in range(max_passes):
        sim.step()
        one_pass(mgr, pol)
        sim.step()
        if all(s == "upgrade-done" for s in states(cluster).values()):
            return i + 1
    raise AssertionError(f"did not converge: {states(cluster)}")


def annotate(cluster, name, key, value="true"):
    cluster.patch("Node", name, patch={"metadata": {"annotations": {key: value}}})


def cordon(cluster, name):
    cluster.patch("Node", name, patch={"spec": {"unschedulable": True}})


# ----------------------------------------------------------------------
# build_state
# ----------------------------------------------------------------------


def test_buckets_by_state_label():
    """test_state_machine.py::TestBuildState::test_buckets_by_state_label"""
    _, _, mgr = make_harness(3, ["", "upgrade-required", "upgrade-done"])
    state = mgr.build_state(NS, LABELS)
    assert len(state.nodes_in(UpgradeState.UNKNOWN)) == 1
    assert len(state.nodes_in(UpgradeState.UPGRADE_REQUIRED)) == 1
    assert len(state.nodes_in(UpgradeState.DONE)) == 1


def test_unscheduled_pods_error():
    """test_state_machine.py::TestBuildState::test_unscheduled_pods_error"""
    cluster, _, mgr = make_harness(2)
    cluster.patch("DaemonSet", "driver", NS, patch={"status": {"desiredNumberScheduled": 5}})
    with pytest.raises(BuildStateError, match="should not have unscheduled pods"):
        mgr.build_state(NS, LABELS)


def test_orphaned_pods_included():
    """test_state_machine.py::TestBuildState::test_orphaned_pods_included"""
    cluster, _, mgr = make_harness(1)
    orphan = Pod.new("orphan-driver", namespace=NS)
    orphan.labels.update(LABELS)
    orphan.node_name = "node-0"
    orphan.phase = "Running"
    cluster.create(orphan)
    state = mgr.build_state(NS, LABELS)
    assert any(ns.is_orphaned_pod() for entries in state.node_states.values() for ns in entries)


def test_pending_pod_without_node_skipped():
    """test_state_machine.py::TestBuildState::test_pending_pod_without_node_skipped"""
    cluster, _, mgr = make_harness(1)
    floater = Pod.new("floating", namespace=NS)
    floater.labels.update(LABELS)
    floater.phase = "Pending"
    cluster.create(floater)
    assert mgr.get_total_managed_nodes(mgr.build_state(NS, LABELS)) == 1


# ----------------------------------------------------------------------
# apply_state's guards and the classification of done and unknown nodes
# ----------------------------------------------------------------------


def test_none_state_raises():
    """test_state_machine.py::TestApplyStateGuards::test_none_state_raises"""
    _, _, mgr = make_harness()
    with pytest.raises(ValueError):
        mgr.apply_state(None, policy())


def test_auto_upgrade_disabled_is_noop():
    """test_state_machine.py::TestApplyStateGuards::test_auto_upgrade_disabled_is_noop"""
    cluster, sim, mgr = make_harness(1)
    sim.set_template_hash("rev-2")
    state = mgr.build_state(NS, LABELS)
    mgr.apply_state(state, policy(autoUpgrade=False))
    assert state_of(cluster) == ""
    mgr.apply_state(state, None)
    assert state_of(cluster) == ""


def test_unknown_synced_becomes_done():
    """test_state_machine.py::TestDoneOrUnknown::test_unknown_synced_becomes_done"""
    cluster, _, mgr = make_harness(1)
    one_pass(mgr, policy())
    assert state_of(cluster) == "upgrade-done"


def test_unknown_outofsync_advances_one_stage_per_pass():
    """test_state_machine.py::TestDoneOrUnknown::test_unknown_outofsync_advances_one_stage_per_pass"""
    cluster, sim, mgr = make_harness(1)
    sim.set_template_hash("rev-2")
    for expected in ("upgrade-required", "cordon-required", "wait-for-jobs-required"):
        one_pass(mgr, policy())
        assert state_of(cluster) == expected
    assert cluster.get("Node", "node-0").unschedulable


def test_done_outofsync_returns_to_upgrade_required():
    """test_state_machine.py::TestDoneOrUnknown::test_done_outofsync_returns_to_upgrade_required"""
    cluster, sim, mgr = make_harness(1, ["upgrade-done"])
    sim.set_template_hash("rev-2")
    one_pass(mgr, policy(maxParallelUpgrades=0, maxUnavailable=0))
    assert state_of(cluster) == "upgrade-required"


def test_initially_cordoned_node_tracked():
    """test_state_machine.py::TestDoneOrUnknown::test_initially_cordoned_node_tracked"""
    cluster, sim, mgr = make_harness(1)
    cordon(cluster, "node-0")
    sim.set_template_hash("rev-2")
    one_pass(mgr, policy())
    assert cluster.get("Node", "node-0").annotations.get(KEYS.initial_state_annotation) == "true"


@pytest.mark.parametrize(
    "bucket",
    [
        pytest.param("", id="test_state_machine.py::test_safe_load_wait_triggers_upgrade"),
        pytest.param(
            "upgrade-done",
            id="test_state_machine_parity.py::test_done_node_with_safe_load_annotation_reenters_flow",
        ),
    ],
)
def test_safe_load_wait_triggers_upgrade(bucket):
    """test_state_machine.py::TestDoneOrUnknown::test_safe_load_wait_triggers_upgrade and
    test_state_machine_parity.py::TestDoneBucketSafeLoad::test_done_node_with_safe_load_annotation_reenters_flow"""
    cluster, _, mgr = make_harness(1, [bucket])
    annotate(cluster, "node-0", KEYS.safe_driver_load_annotation)
    one_pass(mgr, policy(maxParallelUpgrades=0, maxUnavailable=0))
    assert state_of(cluster) == "upgrade-required"


def test_upgrade_requested_annotation():
    """test_state_machine.py::TestDoneOrUnknown::test_upgrade_requested_annotation"""
    cluster, _, mgr = make_harness(1)
    annotate(cluster, "node-0", KEYS.upgrade_requested_annotation)
    pol = policy(maxParallelUpgrades=0, maxUnavailable=0)
    one_pass(mgr, pol)
    assert state_of(cluster) == "upgrade-required"
    one_pass(mgr, pol)
    assert KEYS.upgrade_requested_annotation not in cluster.get("Node", "node-0").annotations


# ----------------------------------------------------------------------
# The budget
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "nodes, max_parallel, max_unavailable, cordons",
    [
        pytest.param(4, 1, "100%", 1, id="test_state_machine.py::test_max_parallel_one"),
        pytest.param(
            4, 0, "100%", 4,
            id="test_state_machine.py::test_max_parallel_zero_unlimited+"
            "test_state_machine_parity.py::test_max_parallel_zero_unavailable_100pct_schedules_all",
        ),
        pytest.param(
            4, 0, "25%", 1, id="test_state_machine.py::test_max_unavailable_clamps_parallel"
        ),
        pytest.param(
            4, 0, "50%", 2,
            id="test_state_machine_parity.py::test_max_parallel_zero_unavailable_50pct_schedules_half",
        ),
    ],
)
def test_budget_of_pending_nodes(nodes, max_parallel, max_unavailable, cordons):
    """test_state_machine.py::TestBudget and
    test_state_machine_parity.py::TestBudgetCombinations: every node pending."""
    cluster, sim, mgr = make_harness(nodes, ["upgrade-required"] * nodes)
    sim.set_template_hash("rev-2")
    one_pass(mgr, policy(maxParallelUpgrades=max_parallel, maxUnavailable=max_unavailable))
    assert count(cluster, "cordon-required") == cordons
    assert count(cluster, "upgrade-required") == nodes - cordons


@pytest.mark.parametrize(
    "max_unavailable, cordons",
    [
        pytest.param(1, 0, id="test_state_machine.py::test_already_unavailable_node_zeroes_budget"),
        pytest.param(
            "50%", 1, id="test_state_machine_parity.py::test_not_ready_nodes_count_as_unavailable"
        ),
    ],
)
def test_not_ready_node_takes_budget(max_unavailable, cordons):
    """test_state_machine.py::TestBudget::test_already_unavailable_node_zeroes_budget and
    test_state_machine_parity.py::TestBudgetCombinations::test_not_ready_nodes_count_as_unavailable"""
    cluster, sim, mgr = make_harness(4, ["upgrade-required"] * 4, not_ready=(3,))
    sim.set_template_hash("rev-2")
    state = mgr.build_state(NS, LABELS)
    mgr.inplace.process_upgrade_required_nodes(
        state, policy(maxParallelUpgrades=0, maxUnavailable=max_unavailable)
    )
    assert count(cluster, "cordon-required") == cordons


def test_50pct_with_already_unavailable_upgraded_nodes():
    """test_state_machine_parity.py::TestBudgetCombinations::test_50pct_with_already_unavailable_upgraded_nodes"""
    cluster, sim, mgr = make_harness(
        8, ["upgrade-required"] * 4 + ["upgrade-done"] * 4, cordoned=(4, 5)
    )
    sim.set_template_hash("rev-2")
    state = mgr.build_state(NS, LABELS)
    mgr.inplace.process_upgrade_required_nodes(
        state, policy(maxParallelUpgrades=0, maxUnavailable="50%")
    )
    assert count(cluster, "cordon-required") == 2


def test_manually_cordoned_bypasses_budget():
    """test_state_machine.py::TestBudget::test_manually_cordoned_bypasses_budget"""
    cluster, sim, mgr = make_harness(2, ["upgrade-required"] * 2)
    sim.set_template_hash("rev-2")
    cordon(cluster, "node-1")
    one_pass(mgr, policy(maxParallelUpgrades=0, maxUnavailable=1))
    assert state_of(cluster, "node-1") == "cordon-required"
    assert state_of(cluster, "node-0") == "upgrade-required"


def test_skip_label():
    """test_state_machine.py::TestBudget::test_skip_label"""
    cluster, sim, mgr = make_harness(2, ["upgrade-required"] * 2)
    sim.set_template_hash("rev-2")
    cluster.patch("Node", "node-0", patch={"metadata": {"labels": {KEYS.skip_label: "true"}}})
    one_pass(mgr, policy(maxParallelUpgrades=0, maxUnavailable="100%"))
    assert state_of(cluster, "node-0") == "upgrade-required"
    assert state_of(cluster, "node-1") == "cordon-required"


# ----------------------------------------------------------------------
# The middle states
# ----------------------------------------------------------------------


def test_wait_for_jobs_with_selector_waits():
    """test_state_machine.py::TestMiddleStates::test_wait_for_jobs_with_selector_waits"""
    cluster, sim, mgr = make_harness(1, ["wait-for-jobs-required"])
    cluster.create(make_pod("job-1", node_name="node-0", controlled=True, labels={"job": "batch"}))
    pol = policy(waitForCompletion={"podSelector": "job=batch"})
    one_pass(mgr, pol)
    assert state_of(cluster) == "wait-for-jobs-required"
    cluster.patch("Pod", "job-1", NS, patch={"status": {"phase": "Succeeded"}})
    one_pass(mgr, pol)
    assert state_of(cluster) == "pod-deletion-required"
    run_until_done(cluster, sim, mgr, pol)


def test_pod_deletion_state_with_filter():
    """test_state_machine.py::TestMiddleStates::test_pod_deletion_state_with_filter"""
    cluster, sim, mgr = make_harness(1, ["pod-deletion-required"])
    mgr.with_pod_deletion_enabled(lambda p: p.labels.get("evict") == "yes")
    cluster.create(make_pod("victim", node_name="node-0", controlled=True, labels={"evict": "yes"}))
    pol = policy(podDeletion={})
    one_pass(mgr, pol)
    assert cluster.get_or_none("Pod", "victim", NS) is None
    assert state_of(cluster) == "pod-restart-required"
    run_until_done(cluster, sim, mgr, pol)


def test_drain_enabled_evicts_workloads():
    """test_state_machine.py::TestMiddleStates::test_drain_enabled_evicts_workloads"""
    cluster, _, mgr = make_harness(1, ["drain-required"])
    cluster.create(make_pod("workload", node_name="node-0", controlled=True))
    one_pass(mgr, policy(drain={"enable": True}))
    assert cluster.get_or_none("Pod", "workload", NS) is None
    assert state_of(cluster) == "pod-restart-required"


@pytest.mark.parametrize(
    "filter_, expected",
    [
        pytest.param(None, False, id="test_pod_deletion_enable_requires_filter"),
        pytest.param(lambda p: True, True, id="filter-given"),
    ],
)
def test_pod_deletion_enable_requires_filter(filter_, expected):
    """test_state_machine_parity.py::TestPolicyDisabledStages::test_pod_deletion_enable_requires_filter"""
    cluster, _, mgr = make_harness(1, ["pod-deletion-required"])
    mgr.with_pod_deletion_enabled(filter_)
    assert mgr.is_pod_deletion_enabled() is expected
    one_pass(mgr, policy())
    assert state_of(cluster) == ("pod-restart-required" if expected else "drain-required")


def test_pod_deletion_disabled_passes_straight_through():
    """test_state_machine_parity.py::TestPolicyDisabledStages::test_pod_deletion_disabled_passes_straight_through"""
    cluster, _, mgr = make_harness(1, ["pod-deletion-required"])
    victim = Pod.new("workload", namespace="default")
    victim.node_name = "node-0"
    victim.phase = "Running"
    cluster.create(victim)
    one_pass(mgr, policy())
    assert state_of(cluster) == "drain-required"
    assert cluster.get_or_none("Pod", "workload", "default") is not None


def test_drain_disabled_goes_to_pod_restart():
    """test_state_machine_parity.py::TestPolicyDisabledStages::test_drain_disabled_goes_to_pod_restart"""
    cluster, _, mgr = make_harness(1, ["drain-required"])
    one_pass(mgr, policy(drain={"enable": False}))
    assert state_of(cluster) == "pod-restart-required"


def test_drain_spec_reaches_drain_manager():
    """test_state_machine_parity.py::TestPolicyDisabledStages::test_drain_spec_reaches_drain_manager"""
    cluster, _, mgr = make_harness(1, ["drain-required"])
    seen = {}

    def capture(config):
        seen["spec"] = config.spec
        seen["nodes"] = [n.name for n in config.nodes]

    mgr.common.drain_manager.schedule_nodes_drain = capture
    one_pass(mgr, policy(drain={
        "enable": True, "force": True, "timeoutSeconds": 42,
        "deleteEmptyDir": True, "podSelector": "app=heavy",
    }))
    spec = seen["spec"]
    assert (spec.force, spec.timeout_seconds, spec.delete_empty_dir, spec.pod_selector) == (
        True, 42, True, "app=heavy"
    )
    assert seen["nodes"] == ["node-0"]


@pytest.mark.parametrize(
    "bucket, target, attribute",
    [
        pytest.param("drain-required", "drain_manager", "schedule_nodes_drain",
                     id="test_drain_manager_error_fails_the_pass"),
        pytest.param("cordon-required", "cordon_manager", "cordon",
                     id="test_cordon_failure_fails_the_pass"),
        pytest.param("uncordon-required", "cordon_manager", "uncordon",
                     id="test_uncordon_failure_fails_the_pass"),
    ],
)
def test_manager_failure_fails_the_pass(bucket, target, attribute):
    """test_state_machine_parity.py::TestManagerFailurePropagation: a
    manager's error aborts the pass and leaves the node where it was."""
    cluster, _, mgr = make_harness(1, [bucket])
    if bucket == "uncordon-required":
        cordon(cluster, "node-0")

    def boom(_):
        raise RuntimeError("apiserver unavailable")

    setattr(getattr(mgr.common, target), attribute, boom)
    with pytest.raises(RuntimeError):
        one_pass(mgr, policy(drain={"enable": True}))
    assert state_of(cluster) == bucket


# ----------------------------------------------------------------------
# The driver pod's restart and validation
# ----------------------------------------------------------------------


def test_stale_pod_restarted_and_resynced():
    """test_state_machine.py::TestPodRestartAndValidation::test_stale_pod_restarted_and_resynced"""
    cluster, sim, mgr = make_harness(1, ["pod-restart-required"])
    sim.set_template_hash("rev-2")
    one_pass(mgr, policy())
    assert cluster.get_or_none("Pod", sim.pod_name("node-0"), NS) is None
    sim.step()
    one_pass(mgr, policy())
    assert state_of(cluster) == "uncordon-required"
    one_pass(mgr, policy())
    assert state_of(cluster) == "upgrade-done"


def test_failing_pod_goes_failed():
    """test_state_machine.py::TestPodRestartAndValidation::test_failing_pod_goes_failed"""
    cluster, sim, mgr = make_harness(1, ["pod-restart-required"])
    cluster.patch("Pod", sim.pod_name("node-0"), NS, patch={"status": {
        "phase": "Running",
        "containerStatuses": [{"name": "driver", "ready": False, "restartCount": 11}],
    }})
    one_pass(mgr, policy())
    assert state_of(cluster) == "upgrade-failed"


def test_validation_enabled_routes_through_validation():
    """test_state_machine.py::TestPodRestartAndValidation::test_validation_enabled_routes_through_validation"""
    cluster, _, mgr = make_harness(1, ["pod-restart-required"])
    outcomes = iter([False, True])
    mgr.with_validation_enabled(validation_hook=lambda node: next(outcomes))
    for expected in ("validation-required", "validation-required", "uncordon-required",
                     "upgrade-done"):
        one_pass(mgr, policy())
        assert state_of(cluster) == expected


def test_safe_load_unblocked_at_pod_restart():
    """test_state_machine.py::TestPodRestartAndValidation::test_safe_load_unblocked_at_pod_restart"""
    cluster, _, mgr = make_harness(1, ["pod-restart-required"])
    annotate(cluster, "node-0", KEYS.safe_driver_load_annotation)
    one_pass(mgr, policy())
    assert KEYS.safe_driver_load_annotation not in cluster.get("Node", "node-0").annotations


def test_terminating_stale_pod_not_restarted():
    """test_state_machine_parity.py::TestPodRestartEdgeCases::test_terminating_stale_pod_not_restarted"""
    cluster, sim, mgr = make_harness(1, ["pod-restart-required"])
    sim.set_template_hash("rev-2")
    pod_name = sim.pod_name("node-0")
    cluster.patch("Pod", pod_name, NS, patch={"metadata": {
        "deletionTimestamp": "2026-07-29T00:00:00Z", "finalizers": ["test/keep"],
    }})
    one_pass(mgr, policy())
    assert cluster.get_or_none("Pod", pod_name, NS) is not None
    assert state_of(cluster) == "pod-restart-required"


def test_up_to_date_pod_not_restarted():
    """test_state_machine_parity.py::TestPodRestartEdgeCases::test_up_to_date_pod_not_restarted"""
    cluster, sim, mgr = make_harness(1, ["pod-restart-required"])
    pod_name = sim.pod_name("node-0")
    uid = cluster.get("Pod", pod_name, NS).uid
    one_pass(mgr, policy())
    assert cluster.get("Pod", pod_name, NS).uid == uid
    assert state_of(cluster) == "uncordon-required"


def test_in_sync_not_ready_pod_waits():
    """test_state_machine_parity.py::TestPodRestartEdgeCases::test_in_sync_not_ready_pod_waits"""
    cluster, sim, mgr = make_harness(1, ["pod-restart-required"])
    cluster.patch("Pod", sim.pod_name("node-0"), NS, patch={"status": {"containerStatuses": [
        {"name": "driver", "ready": False, "restartCount": 1}
    ]}})
    one_pass(mgr, policy())
    assert state_of(cluster) == "pod-restart-required"


# ----------------------------------------------------------------------
# Uncordon and recovery
# ----------------------------------------------------------------------


def test_uncordon_required_completes():
    """test_state_machine.py::TestUncordonAndRecovery::test_uncordon_required_completes"""
    cluster, _, mgr = make_harness(1, ["uncordon-required"])
    cordon(cluster, "node-0")
    one_pass(mgr, policy())
    assert state_of(cluster) == "upgrade-done"
    assert not cluster.get("Node", "node-0").unschedulable


def test_initially_cordoned_stays_cordoned():
    """test_state_machine.py::TestUncordonAndRecovery::test_initially_cordoned_stays_cordoned"""
    cluster, _, mgr = make_harness(1, ["pod-restart-required"])
    cluster.patch("Node", "node-0", patch={
        "spec": {"unschedulable": True},
        "metadata": {"annotations": {KEYS.initial_state_annotation: "true"}},
    })
    one_pass(mgr, policy())
    node = cluster.get("Node", "node-0")
    assert node.labels[KEYS.state_label] == "upgrade-done"
    assert node.unschedulable
    assert KEYS.initial_state_annotation not in node.annotations


@pytest.mark.parametrize(
    "bump, expected",
    [
        pytest.param(False, ["uncordon-required", "upgrade-done"],
                     id="test_failed_node_autorecovers_when_in_sync"),
        pytest.param(True, ["upgrade-failed"], id="test_failed_node_stays_failed_when_out_of_sync"),
    ],
)
def test_failed_node_recovery(bump, expected):
    """test_state_machine.py::TestUncordonAndRecovery::test_failed_node_autorecovers_when_in_sync
    and ::test_failed_node_stays_failed_when_out_of_sync"""
    cluster, sim, mgr = make_harness(1, ["upgrade-failed"])
    if bump:
        sim.set_template_hash("rev-2")
    for state in expected:
        one_pass(mgr, policy())
        assert state_of(cluster) == state


def test_validation_failed_node_revalidates_instead_of_uncordoning():
    """test_state_machine.py::TestUncordonAndRecovery::test_validation_failed_node_revalidates_instead_of_uncordoning"""
    cluster, _, mgr = make_harness(1, ["upgrade-failed"])
    mgr.with_validation_enabled(validation_hook=lambda node: False)
    annotate(cluster, "node-0", KEYS.validation_failed_annotation)
    one_pass(mgr, policy())
    assert state_of(cluster) == "validation-required"


def test_validation_failed_node_without_validation_recovers():
    """The other side of test_validation_failed_node_revalidates_instead_of_uncordoning:
    with validation off, the failure mark does not hold the node back."""
    cluster, _, mgr = make_harness(1, ["upgrade-failed"])
    annotate(cluster, "node-0", KEYS.validation_failed_annotation)
    one_pass(mgr, policy())
    assert state_of(cluster) == "uncordon-required"


def test_validation_failed_node_uncordons_after_gate_passes():
    """test_state_machine.py::TestUncordonAndRecovery::test_validation_failed_node_uncordons_after_gate_passes"""
    cluster, _, mgr = make_harness(1, ["upgrade-failed"])
    mgr.with_validation_enabled(validation_hook=lambda node: True)
    annotate(cluster, "node-0", KEYS.validation_failed_annotation)
    for _ in range(3):
        one_pass(mgr, policy())
    assert state_of(cluster) == "upgrade-done"
    assert KEYS.validation_failed_annotation not in cluster.get("Node", "node-0").annotations


# ----------------------------------------------------------------------
# Orphaned driver pods
# ----------------------------------------------------------------------


def test_orphan_unknown_not_moved_to_upgrade_required():
    """test_state_machine_parity.py::TestOrphanedPodFlows::test_orphan_unknown_not_moved_to_upgrade_required"""
    cluster, mgr = orphan_harness()
    one_pass(mgr, policy())
    assert state_of(cluster) == "upgrade-done"


def test_orphan_with_upgrade_requested_goes_upgrade_required():
    """test_state_machine_parity.py::TestOrphanedPodFlows::test_orphan_with_upgrade_requested_goes_upgrade_required"""
    cluster, mgr = orphan_harness(annotations={KEYS.upgrade_requested_annotation: "true"})
    one_pass(mgr, policy())
    assert state_of(cluster) == "upgrade-required"


def test_orphan_upgrade_required_cordons_and_clears_annotation():
    """test_state_machine_parity.py::TestOrphanedPodFlows::test_orphan_upgrade_required_cordons_and_clears_annotation"""
    cluster, mgr = orphan_harness(
        "upgrade-required", annotations={KEYS.upgrade_requested_annotation: "true"}
    )
    one_pass(mgr, policy())
    assert state_of(cluster) == "cordon-required"
    assert KEYS.upgrade_requested_annotation not in cluster.get("Node", "node-0").annotations


def test_orphan_pod_restarted_at_pod_restart_stage():
    """test_state_machine_parity.py::TestOrphanedPodFlows::test_orphan_pod_restarted_at_pod_restart_stage"""
    cluster, mgr = orphan_harness("pod-restart-required")
    one_pass(mgr, policy())
    assert cluster.get_or_none("Pod", "orphan-driver", NS) is None


# ----------------------------------------------------------------------
# Rolls end to end, and the counters
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "nodes, max_parallel, max_unavailable, bound",
    [
        pytest.param(3, 1, "100%", 1, id="test_three_nodes_serial"),
        pytest.param(8, 2, "100%", 2, id="test_eight_nodes_parallel_two"),
        pytest.param(4, 0, "50%", 2, id="test_unlimited_parallel_bounded_by_unavailable"),
    ],
)
def test_rolling_upgrade_bounds_unavailability(nodes, max_parallel, max_unavailable, bound):
    """test_state_machine.py::TestEndToEndRollingUpgrade: a roll converges
    with at most ``bound`` nodes out of service at once."""
    cluster, sim, mgr = make_harness(nodes)
    sim.set_template_hash("rev-2")
    pol = policy(maxParallelUpgrades=max_parallel, maxUnavailable=max_unavailable)
    most = 0
    for _ in range(40):
        sim.step()
        one_pass(mgr, pol)
        most = max(most, sum(
            1 for n in cluster.list("Node") if Node(n.raw).unschedulable or not Node(n.raw).is_ready()
        ))
        sim.step()
        if count(cluster, "upgrade-done") == nodes and sim.all_pods_ready_and_current():
            break
    else:
        raise AssertionError(f"rolling upgrade did not converge: {states(cluster)}")
    assert most == bound if max_parallel == 1 else most <= bound


def test_with_drain_and_workloads():
    """test_state_machine.py::TestEndToEndRollingUpgrade::test_with_drain_and_workloads"""
    cluster, sim, mgr = make_harness(2)
    for i in range(2):
        cluster.create(make_pod(f"wl-{i}", node_name=f"node-{i}", controlled=True))
    sim.set_template_hash("rev-2")
    run_until_done(cluster, sim, mgr, policy(
        maxParallelUpgrades=1, maxUnavailable="100%", drain={"enable": True}
    ), max_passes=30)
    assert cluster.get_or_none("Pod", "wl-0", NS) is None


def test_idempotent_when_everything_done():
    """test_state_machine.py::TestEndToEndRollingUpgrade::test_idempotent_when_everything_done"""
    cluster, _, mgr = make_harness(2)
    one_pass(mgr, policy())
    before = (states(cluster), {n.name: n.resource_version for n in cluster.list("Node")})
    one_pass(mgr, policy())
    assert (states(cluster), {n.name: n.resource_version for n in cluster.list("Node")}) == before


def test_counters():
    """test_state_machine.py::TestMetrics::test_counters"""
    _, _, mgr = make_harness(
        5, ["", "upgrade-done", "upgrade-required", "drain-required", "upgrade-failed"]
    )
    state = mgr.build_state(NS, LABELS)
    assert mgr.get_total_managed_nodes(state) == 5
    assert mgr.get_upgrades_in_progress(state) == 2
    assert mgr.get_upgrades_done(state) == 1
    assert mgr.get_upgrades_failed(state) == 1
    assert mgr.get_upgrades_pending(state) == 1


def test_inplace_node_mid_flight_continues_under_requestor_mode():
    """test_state_machine_parity.py::TestDualModeCoexistence::
    test_inplace_node_mid_flight_continues_under_requestor_mode: enabling
    the requestor mode strands no node the in-place flow already began."""
    cluster, sim, mgr = make_harness(node_states=["cordon-required"])
    enable_requestor_mode(
        mgr,
        RequestorOptions(
            use_maintenance_operator=True, requestor_id="tpu.operator.dev",
            namespace="maintenance-ns",
        ),
    )
    one_pass(mgr, policy())
    # The common cordon step still ran for the node in flight...
    assert state_of(cluster) == "wait-for-jobs-required"
    assert cluster.get("Node", "node-0").unschedulable
    # ...and no NodeMaintenance object was made for it.
    assert cluster.list("NodeMaintenance") == []
