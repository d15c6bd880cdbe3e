"""The port's requestor mode, held pass by pass against the JAX machine's.

Two in-memory clusters of the JAX package are built alike. Cluster A is
rolled by the JAX ``ClusterUpgradeStateManager`` in the requestor mode,
its client the cluster itself, and its NodeMaintenance objects worked by
the JAX ``MaintenanceOperatorSimulator``. Cluster B is rolled by the
port's manager over the port's ``RestClient`` and a ``LocalApiServer``
serving B, its objects worked by the port's simulator over that client.
Both machines use inline task runners and one virtual clock installed in
both packages' ``utils.faultpoints``. Before each pass the JAX
``DaemonSetSimulator`` ticks and the maintenance operator steps; after it
the DaemonSet ticks again. After every pass these must be equal on A and
B: every node's state label, cordon bit and upgrade annotations, every
NodeMaintenance object's spec, Ready condition, finalizers and whether
its deletion began, the pods, the snapshot's counters, and whether the
pass raised.

The scenarios are the cases of ``tests/test_requestor.py``,
``tests/test_post_maintenance.py`` and
``tests/test_maintenance_operator_e2e.py``, each named after its JAX
counterpart, and: two operators sharing an object, a custom prefix, a
simulator restarted mid-maintenance, the post-maintenance hook done, not
done, crashed and timed out, the budget with and without
``use_post_maintenance``, and a mid-roll handoff between the machines
both ways. The port's simulator is held to the JAX one step by step, and
the pure parts (options, predicates) are compared on equal inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional

import pytest

from builders import make_node, make_pod
from k8s_operator_libs_tpu.api import DriverUpgradePolicySpec as JaxPolicy
from k8s_operator_libs_tpu.kube import ApiError as JaxApiError
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube import NodeMaintenance as JaxNodeMaintenance
from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator
from k8s_operator_libs_tpu.kube.sim import MaintenanceOperatorSimulator as JaxOperator
from k8s_operator_libs_tpu.upgrade import ClusterUpgradeStateManager as JaxManager
from k8s_operator_libs_tpu.upgrade import DeviceClass as JaxDeviceClass
from k8s_operator_libs_tpu.upgrade import RequestorNodeStateManager as JaxRequestor
from k8s_operator_libs_tpu.upgrade import RequestorOptions as JaxOptions
from k8s_operator_libs_tpu.upgrade import TaskRunner as JaxRunner
from k8s_operator_libs_tpu.upgrade import condition_changed_predicate as jax_condition_changed
from k8s_operator_libs_tpu.upgrade import enable_requestor_mode as jax_enable
from k8s_operator_libs_tpu.upgrade import requestor_id_predicate as jax_requestor_id
from k8s_operator_libs_tpu.utils import faultpoints as jax_faultpoints
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from k8s_operator_libs_tpu_torch.kube.client import ApiError
from k8s_operator_libs_tpu_torch.kube.objects import NodeMaintenance
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.kube.sim import MaintenanceOperatorSimulator
from k8s_operator_libs_tpu_torch.upgrade import (
    DEFAULT_NODE_MAINTENANCE_NAME_PREFIX,
    ClusterUpgradeStateManager,
    DeviceClass,
    NodeUpgradeState,
    RequestorNodeStateManager,
    RequestorOptions,
    StateOptions,
    TaskRunner,
    UpgradeKeys,
    condition_changed_predicate,
    enable_requestor_mode,
    requestor_id_predicate,
)
from k8s_operator_libs_tpu_torch.upgrade.consts import MAINTENANCE_STATES, UpgradeState
from k8s_operator_libs_tpu_torch.utils import faultpoints

NS = "gpu-operator"
LABELS = {"app": "nvidia-driver-daemonset"}
MAINT_NS = "maintenance-ns"
KEYS = UpgradeKeys(DeviceClass.nvidia("gpu"))
KEY_PREFIX = f"{KEYS.device.domain}/{KEYS.device.driver}-driver-"
OLD, NEW = "550.54.15", "560.35.03"
OWNER = "gpu.operator.dev"
NIC = "nic.operator.dev"


class Clock:
    """A virtual wall clock both packages' durable deadlines read."""

    def __init__(self, start: float = 1_760_000_000.0) -> None:
        self.now = start

    def wall(self) -> float:
        return self.now


@pytest.fixture
def clock():
    c = Clock()
    jax_faultpoints.install_clock(c)
    faultpoints.install_clock(c)
    try:
        yield c
    finally:
        jax_faultpoints.clear_clock()
        faultpoints.clear_clock()


def node_name(i: int) -> str:
    return f"node-{i}"


def policy(max_parallel=0, max_unavailable="100%", **extra) -> dict:
    return {
        "autoUpgrade": True,
        "maxParallelUpgrades": max_parallel,
        "maxUnavailable": max_unavailable,
        **extra,
    }


DRAIN = {"drain": {"enable": True, "force": True, "timeoutSeconds": 120}}


@dataclass
class Scenario:
    """One requestor-mode roll, set up alike on both clusters."""

    policy: dict
    nodes: int = 1
    #: Initial state label of each node ("" for none).
    node_states: tuple = ()
    #: node -> annotations set before the roll.
    annotations: dict = field(default_factory=dict)
    cordoned: tuple = ()
    skip: tuple = ()
    #: Nodes running a controller-owned workload pod.
    workloads: tuple = ()
    #: RequestorOptions fields beyond the mode and the namespace.
    opts: dict = field(default_factory=dict)
    #: ``hook_factory()`` -> one post-maintenance hook per cluster, shared
    #: by both machines of that cluster.
    hook_factory: Optional[Callable] = None
    #: "sim": the maintenance operator's simulator; "flip": Ready set on
    #: every object at once, as the JAX unit specs do; "none".
    operator: str = "sim"
    #: ``setup(side)`` after the pool settled, before the bump.
    setup: Optional[Callable] = None
    #: ``before(pass_index, side, machine)`` before each pass.
    before: Optional[Callable] = None
    #: ``done(side)``: the roll is over; default: every node not skipped
    #: done and uncordoned, no object left, the driver pods current.
    done: Optional[Callable] = None
    bump: bool = True
    tick_s: float = 10.0
    max_passes: int = 60


class Side:
    """One cluster with its DaemonSet, its maintenance operator, its API
    server and both machines in the requestor mode."""

    def __init__(self, sc: Scenario, stack: contextlib.ExitStack, operator: str) -> None:
        self.sc = sc
        self.cluster = FakeCluster()
        for i in range(sc.nodes):
            name = node_name(i)
            labels = {}
            if i < len(sc.node_states) and sc.node_states[i]:
                labels[KEYS.state_label] = sc.node_states[i]
            if name in sc.skip:
                labels[KEYS.skip_label] = "true"
            self.cluster.create(
                make_node(name, labels=labels, annotations=sc.annotations.get(name),
                          unschedulable=name in sc.cordoned)
            )
        self.sim = DaemonSetSimulator(
            self.cluster, name=LABELS["app"], namespace=NS, match_labels=LABELS,
            initial_hash=OLD,
        )
        self.sim.settle()
        for name in sc.workloads:
            self.cluster.create(
                make_pod(f"workload-{name}", namespace="default", node_name=name,
                         labels={"app": "training"}, controlled=True)
            )
        server = stack.enter_context(LocalApiServer(cluster=self.cluster))
        self.rest = RestClient(RestConfig(server=server.url))
        self.operator_kind = operator
        self.operator = self.new_operator()
        self.hook = sc.hook_factory() if sc.hook_factory is not None else None
        self.opts = {
            "jax": JaxOptions(use_maintenance_operator=True, requestor_id=OWNER,
                              namespace=MAINT_NS, post_maintenance_hook=self.hook, **sc.opts),
            "port": RequestorOptions(use_maintenance_operator=True, requestor_id=OWNER,
                                     namespace=MAINT_NS, post_maintenance_hook=self.hook,
                                     **sc.opts),
        }
        self.machines = {
            "jax": jax_enable(
                JaxManager(self.cluster, JaxDeviceClass.nvidia("gpu"), runner=JaxRunner(inline=True)),
                self.opts["jax"],
            ),
            "port": enable_requestor_mode(
                ClusterUpgradeStateManager(
                    self.rest, DeviceClass.nvidia("gpu"), runner=TaskRunner(inline=True)
                ),
                self.opts["port"],
            ),
        }
        self.policies = {
            "jax": JaxPolicy.from_dict(sc.policy),
            "port": DriverUpgradePolicySpec.from_dict(sc.policy),
        }
        if sc.setup is not None:
            sc.setup(self)
        if sc.bump:
            self.sim.set_template_hash(NEW)

    def new_operator(self):
        """The maintenance operator of this side (A: the JAX simulator on
        the cluster, B: the port's over the REST client)."""
        if self.operator_kind == "jax":
            return JaxOperator(self.cluster, namespace=MAINT_NS)
        return MaintenanceOperatorSimulator(self.rest, namespace=MAINT_NS)

    def work_objects(self) -> None:
        if self.sc.operator == "sim":
            self.operator.step()
        elif self.sc.operator == "flip":
            for obj in self.cluster.list("NodeMaintenance", namespace=MAINT_NS):
                if obj.raw["metadata"].get("deletionTimestamp") is None:
                    mark_ready(self.cluster, obj.raw["metadata"]["name"])

    def one_pass(self, machine: str) -> dict:
        self.sim.step()
        self.work_objects()
        mgr, pol = self.machines[machine], self.policies[machine]
        state = mgr.build_state(NS, LABELS)
        total = mgr.get_total_managed_nodes(state)
        out = {
            "total": total,
            "in_progress": mgr.get_upgrades_in_progress(state),
            "done": mgr.get_upgrades_done(state),
            "failed": mgr.get_upgrades_failed(state),
            "pending": mgr.get_upgrades_pending(state),
            "available": mgr.common.get_upgrades_available(
                state, pol.max_parallel_upgrades, pol.resolved_max_unavailable(total)
            ),
            "maintenance_objects_read": sum(
                ns.node_maintenance is not None for b in state.node_states.values() for ns in b
            ),
        }
        try:
            mgr.apply_state(state, pol)
            out["raised"] = False
        except (ApiError, JaxApiError):
            out["raised"] = True
        self.sim.step()
        return out

    def observe(self) -> dict:
        nodes = {}
        for n in self.cluster.list("Node"):
            meta = n.raw["metadata"]
            nodes[n.name] = (
                (meta.get("labels") or {}).get(KEYS.state_label, ""),
                bool((n.raw.get("spec") or {}).get("unschedulable", False)),
                {k: v for k, v in (meta.get("annotations") or {}).items()
                 if k.startswith(KEY_PREFIX)},
            )
        objects = {}
        for obj in self.cluster.list("NodeMaintenance", namespace=MAINT_NS):
            meta = obj.raw["metadata"]
            objects[meta["name"]] = {
                "spec": obj.raw.get("spec") or {},
                "conditions": [
                    (c.get("type"), c.get("status"), c.get("reason"))
                    for c in (obj.raw.get("status") or {}).get("conditions") or []
                ],
                "finalizers": list(meta.get("finalizers") or []),
                "deleting": meta.get("deletionTimestamp") is not None,
            }
        pods = sorted(
            (p.namespace, p.name, p.labels.get("controller-revision-hash", ""), p.phase)
            for p in self.cluster.list("Pod")
        )
        return {"nodes": nodes, "objects": objects, "pods": pods}

    def states(self) -> dict[str, str]:
        return {name: obs[0] for name, obs in self.observe()["nodes"].items()}

    def settled(self) -> bool:
        if self.sc.done is not None:
            return self.sc.done(self)
        obs = self.observe()
        rolled = all(
            state == "upgrade-done" and not cordoned
            for name, (state, cordoned, _) in obs["nodes"].items()
            if name not in self.sc.skip
        )
        return rolled and not obs["objects"] and self.sim.all_pods_ready_and_current()


def mark_ready(cluster, name: str) -> None:
    """The external operator's Ready, set directly (the JAX unit specs'
    stand-in)."""
    cluster.patch(
        "NodeMaintenance", name, MAINT_NS,
        patch={"status": {"conditions": [{"type": "Ready", "status": "True", "reason": "Ready"}]}},
    )


@dataclass
class Twin:
    a: Side
    b: Side
    trajectory: list
    passes: list


def run_twin(sc: Scenario, clock: Clock, schedule: Callable[[int], str] = lambda p: "port") -> Twin:
    """Roll A with the JAX machine and B with ``schedule(pass)``'s,
    comparing after every pass."""
    with contextlib.ExitStack() as stack:
        a, b = Side(sc, stack, "jax"), Side(sc, stack, "port")
        trajectory, passes = [], []
        for p in range(sc.max_passes):
            clock.now += sc.tick_s
            machine = schedule(p)
            if sc.before is not None:
                sc.before(p, a, "jax")
                sc.before(p, b, machine)
            out_a = a.one_pass("jax")
            out_b = b.one_pass(machine)
            assert out_a == out_b, f"pass {p}"
            obs_a, obs_b = a.observe(), b.observe()
            assert obs_a == obs_b, f"pass {p}"
            trajectory.append(obs_b)
            passes.append(out_b)
            if a.settled() and b.settled():
                return Twin(a, b, trajectory, passes)
        raise AssertionError(f"no end in {sc.max_passes} passes: {b.observe()}")


def seen_states(twin: Twin) -> set:
    return {obs[0] for step in twin.trajectory for obs in step["nodes"].values()}


def first_step_in(twin: Twin, state: str, node: str = "node-0") -> dict:
    return next(step for step in twin.trajectory if step["nodes"][node][0] == state)


def _only(obs: dict) -> dict:
    ((_, nm),) = obs["objects"].items()
    return nm


# ----------------------------------------------------------------------
# Setups and per-pass actions
# ----------------------------------------------------------------------


def _requestor_mode(*names):
    return {name: {KEYS.requestor_mode_annotation: "true"} for name in names}


def _object(requestor_id, additional=()):
    """node-0's object of the shared prefix, owned by ``requestor_id``."""
    def setup(side: Side) -> None:
        nm = NodeMaintenance.new(f"{DEFAULT_NODE_MAINTENANCE_NAME_PREFIX}-node-0", namespace=MAINT_NS)
        nm.requestor_id = requestor_id
        nm.node_name = "node-0"
        if additional:
            nm.additional_requestors = list(additional)
        side.cluster.create(JaxNodeMaintenance(nm.raw))
    return setup


def _owned_object(side: Side) -> None:
    """The object the requestor itself made for node-0 (its policy's)."""
    req = side.machines["port"].requestor
    nm = req.new_node_maintenance(node_name(0), side.policies["port"])
    side.cluster.create(JaxNodeMaintenance(nm.raw))


def _recording_hook():
    calls = []

    def hook(node):
        calls.append((node.name, bool(node.unschedulable)))
        return True

    hook.calls = calls
    return hook


def _done_on_attempt(n):
    def factory():
        attempts = {"n": 0}

        def hook(node):
            attempts["n"] += 1
            return attempts["n"] >= n

        hook.attempts = attempts
        return hook
    return factory


def _crash_once():
    calls = {"n": 0}

    def hook(node):
        calls["n"] += 1
        if calls["n"] < 2:
            raise RuntimeError("warm-up hiccup")
        return True

    hook.calls = calls
    return hook


def _fail_first_delete(side: Side) -> None:
    armed = {"on": True}

    def fail_once(verb, kind, payload):
        if armed["on"]:
            armed["on"] = False
            raise JaxApiError("transient")

    side.cluster.add_reactor("delete", "NodeMaintenance", fail_once)


def _restart_operator_at(k):
    def before(p, side, machine):
        if p == k:
            side.operator = side.new_operator()
    return before


def _second_requestor_joins(join_at, leave_at):
    """A second operator (NIC firmware) joins node-0's object at pass
    ``join_at`` and leaves it at ``leave_at``, through the requestor of the
    machine that runs the pass."""
    def before(p, side, machine):
        if p not in (join_at, leave_at):
            return
        if machine == "jax":
            nic = JaxRequestor(side.cluster, side.machines["jax"].common,
                               JaxOptions(use_maintenance_operator=True, requestor_id=NIC,
                                          namespace=MAINT_NS))
        else:
            nic = RequestorNodeStateManager(
                side.rest, side.machines["port"].common,
                RequestorOptions(use_maintenance_operator=True, requestor_id=NIC,
                                 namespace=MAINT_NS),
            )
        ns = NodeUpgradeState(node=None, driver_pod=None, driver_daemonset=None)
        ns.node = side.cluster.get("Node", node_name(0))
        ns.node_maintenance = nic.get_node_maintenance_obj(node_name(0))
        assert ns.node_maintenance is not None
        if p == join_at:
            nic.create_or_update_node_maintenance(ns, side.policies[machine])
        else:
            nic.delete_or_update_node_maintenance(ns)
    return before


def _states_are(**wanted):
    def done(side: Side) -> bool:
        states = side.states()
        return all(states[name.replace("_", "-")] == s for name, s in wanted.items())
    return done


def _after_passes(n):
    def done(side: Side) -> bool:
        side.passes_seen = getattr(side, "passes_seen", 0) + 1
        return side.passes_seen >= n
    return done


SCENARIOS = {
    # tests/test_requestor.py
    "TestUpgradeRequiredFlow::test_creates_cr_and_moves_to_maintenance_required": Scenario(
        policy(**DRAIN), node_states=("upgrade-required",), operator="none",
        done=_after_passes(2),
    ),
    "TestUpgradeRequiredFlow::test_skip_label_respected": Scenario(
        policy(**DRAIN), node_states=("upgrade-required",), skip=("node-0",),
        done=_after_passes(3),
    ),
    "TestMaintenanceRequiredFlow::test_ready_condition_advances_to_pod_restart": Scenario(
        policy(**DRAIN), node_states=("upgrade-required",), operator="flip",
    ),
    "TestMaintenanceRequiredFlow::test_missing_cr_requeues_to_upgrade_required": Scenario(
        policy(**DRAIN), node_states=("node-maintenance-required",),
    ),
    "TestUncordonFlow::test_owner_deletes_cr_on_completion": Scenario(
        policy(**DRAIN), node_states=("uncordon-required",), cordoned=("node-0",),
        annotations=_requestor_mode("node-0"), setup=_owned_object, bump=False,
    ),
    "TestUncordonFlow::test_inplace_node_unaffected_by_requestor_uncordon": Scenario(
        policy(**DRAIN), node_states=("uncordon-required",), cordoned=("node-0",), bump=False,
    ),
    "TestSharedRequestorProtocol::test_second_requestor_appends_to_additional": Scenario(
        policy(**DRAIN), setup=_object(NIC),
        done=_states_are(node_0="upgrade-done"),
    ),
    "TestSharedRequestorProtocol::test_append_is_idempotent": Scenario(
        policy(**DRAIN), setup=_object(NIC, additional=(OWNER,)),
        done=_states_are(node_0="upgrade-done"),
    ),
    "TestSharedRequestorProtocol::test_non_owner_removes_itself_on_completion": Scenario(
        policy(**DRAIN), node_states=("uncordon-required",), bump=False,
        annotations=_requestor_mode("node-0"),
        setup=_object(NIC, additional=(OWNER,)),
        done=_states_are(node_0="upgrade-done"),
    ),
    "TestSharedRequestorProtocol::test_custom_prefix_creates_own_cr": Scenario(
        policy(**DRAIN), opts={"node_maintenance_name_prefix": "my-prefix"},
        setup=_object(NIC), done=_states_are(node_0="upgrade-done"),
    ),
    "TestEndToEndRequestorUpgrade::test_full_roll_with_simulated_maintenance_operator": Scenario(
        policy(**DRAIN), nodes=3, operator="flip",
    ),
    "TestPredicates::test_cr_cleanup_failure_leaves_node_resumable": Scenario(
        policy(**DRAIN), node_states=("uncordon-required",), bump=False,
        annotations=_requestor_mode("node-0"),
        setup=lambda side: (_owned_object(side), _fail_first_delete(side)),
    ),
    # tests/test_post_maintenance.py
    "TestFlow::test_nodes_pass_through_post_maintenance": Scenario(
        policy(**DRAIN), nodes=2, opts={"use_post_maintenance": True},
        hook_factory=_recording_hook,
    ),
    "TestFlow::test_disabled_knob_skips_the_state": Scenario(
        policy(**DRAIN), nodes=2, hook_factory=_recording_hook,
    ),
    "TestFlow::test_not_done_hook_retries_then_completes": Scenario(
        policy(**DRAIN), opts={"use_post_maintenance": True}, hook_factory=_done_on_attempt(3),
    ),
    "TestFlow::test_timeout_fails_the_node": Scenario(
        policy(**DRAIN), opts={"use_post_maintenance": True, "post_maintenance_timeout_seconds": 0},
        hook_factory=lambda: (lambda node: False), done=_states_are(node_0="upgrade-failed"),
    ),
    "TestFlow::test_hook_crash_counts_as_not_done": Scenario(
        policy(**DRAIN), opts={"use_post_maintenance": True}, hook_factory=_crash_once,
    ),
    "TestBudgetAccounting::test_maintenance_states_count_as_in_progress_with_knob": Scenario(
        policy(1, "100%", drain={"enable": True, "force": True}), nodes=2,
        opts={"use_post_maintenance": True}, operator="none", done=_after_passes(8),
    ),
    "TestBudgetAccounting::test_base_mode_keeps_reference_quirk": Scenario(
        policy(1, "100%", drain={"enable": True, "force": True}), nodes=2,
        operator="none", done=_after_passes(8),
    ),
    # tests/test_maintenance_operator_e2e.py
    "TestFullLifecycle::test_roll_through_real_operator": Scenario(
        policy(**DRAIN), nodes=3, workloads=("node-0", "node-1", "node-2"),
    ),
    "TestFullLifecycle::test_cr_carries_drain_spec_from_policy": Scenario(
        policy(**DRAIN), done=lambda side: bool(side.observe()["objects"]),
    ),
    "TestFullLifecycle::test_operator_is_restartable_mid_maintenance": Scenario(
        policy(**DRAIN), workloads=("node-0",), before=_restart_operator_at(3),
    ),
    "TestSharedRequestor::test_second_requestor_joins_and_owner_releases": Scenario(
        policy(**DRAIN), before=_second_requestor_joins(2, 3),
    ),
    # Beyond the JAX specs
    "budget-parallel-1-with-post-maintenance": Scenario(
        policy(1, "100%", **DRAIN), nodes=4, workloads=("node-1", "node-3"),
        opts={"use_post_maintenance": True}, hook_factory=_recording_hook,
    ),
    "budget-unavailable-2-with-post-maintenance": Scenario(
        policy(0, 2, **DRAIN), nodes=5, cordoned=("node-4",),
        opts={"use_post_maintenance": True},
    ),
    "budget-parallel-1-base-mode": Scenario(policy(1, "100%", **DRAIN), nodes=4),
    "wait-for-pod-completion": Scenario(
        policy(waitForCompletion={"podSelector": "app=training"}, **DRAIN), nodes=2,
        workloads=("node-1",),
        before=lambda p, side, m: p == 6 and side.cluster.patch(
            "Pod", "workload-node-1", "default", patch={"status": {"phase": "Succeeded"}}
        ),
    ),
    "cordoned-before-roll": Scenario(policy(**DRAIN), nodes=2, cordoned=("node-1",)),
    "upgrade-requested-annotation": Scenario(
        policy(**DRAIN), nodes=2, bump=False,
        annotations={"node-1": {KEYS.upgrade_requested_annotation: "true"}},
    ),
    "pod-deletion-filters-reach-the-object": Scenario(
        policy(podDeletion={"force": True}, **DRAIN),
        opts={"pod_eviction_filters": [{"byResourceNameRegex": "nvidia.com/gpu"}]},
        done=lambda side: bool(side.observe()["objects"]),
    ),
    "inplace-node-mid-flight": Scenario(
        policy(**DRAIN), nodes=2, node_states=("drain-required", ""),
    ),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_requestor_equals_jax_requestor_after_every_pass(name, clock):
    twin = run_twin(SCENARIOS[name], clock)
    final = twin.trajectory[-1]
    for n in SCENARIOS[name].skip:
        assert final["nodes"][n][0] == "upgrade-required"
        assert not final["objects"]


# ----------------------------------------------------------------------
# What each scenario is about, read on the port's cluster
# ----------------------------------------------------------------------


def test_object_is_created_from_the_policy(clock):
    twin = run_twin(
        SCENARIOS["TestUpgradeRequiredFlow::test_creates_cr_and_moves_to_maintenance_required"],
        clock,
    )
    state, _, annotations = twin.trajectory[0]["nodes"]["node-0"]
    assert state == "node-maintenance-required"
    assert KEYS.requestor_mode_annotation in annotations
    nm = twin.trajectory[0]["objects"]["tpu-operator-node-0"]
    assert nm["spec"]["requestorID"] == OWNER and nm["spec"]["nodeName"] == "node-0"
    assert nm["spec"]["drainSpec"]["timeoutSeconds"] == 120
    assert nm["spec"]["drainSpec"]["force"] is True
    assert "nodeHealth" not in nm["spec"]  # no telemetry: "unmeasured"


def test_flipped_ready_goes_to_pod_restart_and_the_roll_cleans_up(clock):
    twin = run_twin(
        SCENARIOS["TestMaintenanceRequiredFlow::test_ready_condition_advances_to_pod_restart"],
        clock,
    )
    states = [step["nodes"]["node-0"][0] for step in twin.trajectory]
    i = states.index("node-maintenance-required")
    assert states[i + 1] == "pod-restart-required"
    assert "post-maintenance-required" not in states


def test_missing_object_requeues(clock):
    twin = run_twin(
        SCENARIOS["TestMaintenanceRequiredFlow::test_missing_cr_requeues_to_upgrade_required"],
        clock,
    )
    assert twin.trajectory[0]["nodes"]["node-0"][0] == "upgrade-required"
    assert "node-maintenance-required" in seen_states(twin)


def test_owner_releases_before_done_and_the_operator_uncordons(clock):
    twin = run_twin(SCENARIOS["TestUncordonFlow::test_owner_deletes_cr_on_completion"], clock)
    first = twin.trajectory[0]
    state, cordoned, annotations = first["nodes"]["node-0"]
    assert state == "upgrade-done" and KEYS.requestor_mode_annotation not in annotations
    # The in-place flow skipped the node: the operator uncordons it, so
    # it is still cordoned until the operator has finalized its object.
    assert cordoned
    assert _only(first)["deleting"]
    assert not twin.trajectory[-1]["nodes"]["node-0"][1]


def test_inplace_node_finishes_in_place(clock):
    twin = run_twin(
        SCENARIOS["TestUncordonFlow::test_inplace_node_unaffected_by_requestor_uncordon"], clock
    )
    assert twin.trajectory[0]["nodes"]["node-0"][:2] == ("upgrade-done", False)
    assert all(not step["objects"] for step in twin.trajectory)


@pytest.mark.parametrize(
    "name, additional",
    [
        ("TestSharedRequestorProtocol::test_second_requestor_appends_to_additional", [OWNER]),
        ("TestSharedRequestorProtocol::test_append_is_idempotent", [OWNER]),
    ],
)
def test_joining_another_operators_object(name, additional, clock):
    twin = run_twin(SCENARIOS[name], clock)
    joined = _only(first_step_in(twin, "node-maintenance-required"))
    assert joined["spec"]["requestorID"] == NIC
    assert joined["spec"]["additionalRequestors"] == additional
    # At the end the non-owner leaves; the owner's object stays.
    final = _only(twin.trajectory[-1])
    assert final["spec"]["additionalRequestors"] == [] and not final["deleting"]


def test_an_append_already_made_writes_nothing(clock):
    sc = dataclasses.replace(
        SCENARIOS["TestSharedRequestorProtocol::test_append_is_idempotent"], operator="none"
    )
    with contextlib.ExitStack() as stack:
        side = Side(sc, stack, "port")
        before = side.cluster.get("NodeMaintenance", "tpu-operator-node-0", MAINT_NS).raw
        side.one_pass("port")
        side.one_pass("port")
        assert side.states()["node-0"] == "node-maintenance-required"
        after = side.cluster.get("NodeMaintenance", "tpu-operator-node-0", MAINT_NS).raw
        assert after == before


def test_non_owner_removes_itself_and_keeps_the_object(clock):
    twin = run_twin(
        SCENARIOS["TestSharedRequestorProtocol::test_non_owner_removes_itself_on_completion"],
        clock,
    )
    nm = _only(twin.trajectory[0])
    assert nm["spec"]["additionalRequestors"] == [] and not nm["deleting"]


def test_a_custom_prefix_makes_its_own_object(clock):
    twin = run_twin(SCENARIOS["TestSharedRequestorProtocol::test_custom_prefix_creates_own_cr"], clock)
    objects = first_step_in(twin, "node-maintenance-required")["objects"]
    assert set(objects) == {"tpu-operator-node-0", "my-prefix-node-0"}
    assert objects["my-prefix-node-0"]["spec"]["requestorID"] == OWNER
    assert "additionalRequestors" not in objects["tpu-operator-node-0"]["spec"]
    final = twin.trajectory[-1]["objects"]
    assert final["my-prefix-node-0"]["deleting"] and not final["tpu-operator-node-0"]["deleting"]


def test_a_failed_release_is_retried(clock):
    twin = run_twin(SCENARIOS["TestPredicates::test_cr_cleanup_failure_leaves_node_resumable"], clock)
    assert twin.passes[0]["raised"]
    assert twin.trajectory[0]["nodes"]["node-0"][0] == "uncordon-required"
    assert twin.trajectory[1]["nodes"]["node-0"][0] == "upgrade-done"


def test_post_maintenance_runs_the_hook_on_drained_nodes(clock):
    twin = run_twin(SCENARIOS["TestFlow::test_nodes_pass_through_post_maintenance"], clock)
    assert "post-maintenance-required" in seen_states(twin)
    for side in (twin.a, twin.b):
        assert sorted(side.hook.calls) == [("node-0", True), ("node-1", True)]
    for _, cordoned, annotations in twin.trajectory[-1]["nodes"].values():
        assert not cordoned and KEYS.post_maintenance_start_annotation not in annotations


def test_without_post_maintenance_the_hook_never_runs(clock):
    twin = run_twin(SCENARIOS["TestFlow::test_disabled_knob_skips_the_state"], clock)
    assert "post-maintenance-required" not in seen_states(twin)
    assert twin.a.hook.calls == twin.b.hook.calls == []


def test_a_hook_not_done_is_asked_again(clock):
    twin = run_twin(SCENARIOS["TestFlow::test_not_done_hook_retries_then_completes"], clock)
    assert twin.a.hook.attempts == twin.b.hook.attempts == {"n": 3}
    states = [step["nodes"]["node-0"] for step in twin.trajectory]
    # The pass that entered the state, then two refusals: the durable
    # clock started on the first and went with the done.
    waiting = [s for s in states if s[0] == "post-maintenance-required"]
    assert len(waiting) == 3
    assert [KEYS.post_maintenance_start_annotation in s[2] for s in waiting] == [False, True, True]
    last = max(i for i, s in enumerate(states) if s[0] == "post-maintenance-required")
    assert states[last + 1][0] == "pod-restart-required"
    assert KEYS.post_maintenance_start_annotation not in states[last + 1][2]


def test_a_hook_that_times_out_fails_the_node_with_the_validation_marker(clock):
    twin = run_twin(SCENARIOS["TestFlow::test_timeout_fails_the_node"], clock)
    state, cordoned, annotations = twin.trajectory[-1]["nodes"]["node-0"]
    assert state == "upgrade-failed" and cordoned
    assert KEYS.post_maintenance_start_annotation not in annotations
    assert annotations[KEYS.validation_failed_annotation] == "true"


def test_a_crashing_hook_is_asked_again(clock):
    twin = run_twin(SCENARIOS["TestFlow::test_hook_crash_counts_as_not_done"], clock)
    assert twin.a.hook.calls == twin.b.hook.calls == {"n": 2}


def _most_in_maintenance(twin: Twin) -> int:
    return max(
        sum(obs[0] in MAINTENANCE_STATES for obs in step["nodes"].values())
        for step in twin.trajectory
    )


def test_post_maintenance_counts_the_maintenance_states_in_the_budget(clock):
    twin = run_twin(
        SCENARIOS["TestBudgetAccounting::test_maintenance_states_count_as_in_progress_with_knob"],
        clock,
    )
    assert _most_in_maintenance(twin) == 1
    assert twin.passes[-1]["in_progress"] == 1 and twin.passes[-1]["total"] == 2


def test_the_base_mode_leaves_the_pace_to_the_operator(clock):
    twin = run_twin(SCENARIOS["TestBudgetAccounting::test_base_mode_keeps_reference_quirk"], clock)
    assert _most_in_maintenance(twin) == 2
    assert twin.passes[-1]["total"] == 0 and twin.passes[-1]["in_progress"] == 0


def test_a_budgeted_roll_keeps_one_node_out_at_a_time(clock):
    twin = run_twin(SCENARIOS["budget-parallel-1-with-post-maintenance"], clock)
    assert max(sum(obs[1] for obs in step["nodes"].values()) for step in twin.trajectory) == 1
    assert [name for name, _ in twin.b.hook.calls] == sorted(name for name, _ in twin.b.hook.calls)


def test_the_operator_does_the_node_work(clock):
    twin = run_twin(SCENARIOS["TestFullLifecycle::test_roll_through_real_operator"], clock)
    cordoned = {n for step in twin.trajectory for n, obs in step["nodes"].items() if obs[1]}
    assert cordoned == {"node-0", "node-1", "node-2"}
    objects = {name for step in twin.trajectory for name in step["objects"]}
    assert objects == {f"tpu-operator-node-{i}" for i in range(3)}
    reasons = {c[2] for step in twin.trajectory for nm in step["objects"].values()
               for c in nm["conditions"]}
    assert reasons == {"Cordon", "WaitForPodCompletion", "Draining", "Ready"}
    assert not any(pod[0] == "default" for pod in twin.trajectory[-1]["pods"])


def test_the_object_carries_the_drain_spec(clock):
    twin = run_twin(SCENARIOS["TestFullLifecycle::test_cr_carries_drain_spec_from_policy"], clock)
    nm = _only(twin.trajectory[-1])
    assert nm["spec"]["drainSpec"] == {
        "force": True, "podSelector": "", "timeoutSeconds": 120, "deleteEmptyDir": False,
    }


def test_pod_eviction_filters_reach_the_object(clock):
    twin = run_twin(SCENARIOS["pod-deletion-filters-reach-the-object"], clock)
    nm = _only(twin.trajectory[-1])
    assert nm["spec"]["drainSpec"]["podEvictionFilters"] == [{"byResourceNameRegex": "nvidia.com/gpu"}]


def test_a_restarted_operator_carries_on(clock):
    twin = run_twin(SCENARIOS["TestFullLifecycle::test_operator_is_restartable_mid_maintenance"], clock)
    reasons = [
        nm["conditions"][0][2] for step in twin.trajectory[:4]
        for nm in step["objects"].values() if nm["conditions"]
    ]
    assert reasons[-1] not in ("", "Pending", "Ready")  # restarted mid-maintenance
    assert not twin.trajectory[-1]["nodes"]["node-0"][1]


def test_a_second_requestor_joins_leaves_and_the_owner_releases(clock):
    twin = run_twin(
        SCENARIOS["TestSharedRequestor::test_second_requestor_joins_and_owner_releases"], clock
    )
    additional = [
        step["objects"]["tpu-operator-node-0"]["spec"].get("additionalRequestors")
        for step in twin.trajectory if step["objects"]
    ]
    assert [NIC] in additional and additional[-1] == []
    assert _only(twin.trajectory[2])["spec"]["requestorID"] == OWNER


def test_a_node_cordoned_before_the_roll_is_released_through_its_object(clock):
    """The requestor branch of ``update_node_to_uncordon_or_done_state``:
    a node in the requestor mode that began cordoned goes to uncordon,
    not straight to done, so its object is released; its initial-state
    marker goes on that step."""
    twin = run_twin(SCENARIOS["cordoned-before-roll"], clock)
    states = [step["nodes"]["node-1"] for step in twin.trajectory]
    assert KEYS.initial_state_annotation in states[0][2]
    i = next(k for k, s in enumerate(states) if s[0] == "uncordon-required")
    assert KEYS.initial_state_annotation not in states[i][2]
    assert states[i + 1][0] == "upgrade-done"


def test_an_inplace_node_mid_flight_finishes_in_place(clock):
    twin = run_twin(SCENARIOS["inplace-node-mid-flight"], clock)
    objects = {name for step in twin.trajectory for name in step["objects"]}
    assert objects == {"tpu-operator-node-1"}
    assert "wait-for-jobs-required" not in seen_states(twin)


@pytest.mark.parametrize("k", [2, 5, 9])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_one_machine_finishes_the_others_requestor_roll(first, k, clock):
    """B runs ``first``'s machine for ``k`` passes and the other's after,
    in the requestor mode with post-maintenance; every pass equals the
    JAX-only roll on A."""
    second = "port" if first == "jax" else "jax"
    sc = Scenario(
        policy(1, "50%", **DRAIN), nodes=3, workloads=("node-0", "node-2"),
        opts={"use_post_maintenance": True}, hook_factory=_done_on_attempt(2),
    )
    twin = run_twin(sc, clock, schedule=lambda p: first if p < k else second)
    assert len(twin.trajectory) > k
    assert "post-maintenance-required" in seen_states(twin)


def test_a_settled_pool_reads_each_nodes_object(clock):
    sc = Scenario(policy(**DRAIN), nodes=3, bump=False)
    with contextlib.ExitStack() as stack:
        side = Side(sc, stack, "port")
        side.one_pass("port")  # unknown -> done
        for _ in range(2):
            side.one_pass("port")
            stats = side.machines["port"].last_pass_stats
            assert stats.writes_issued == 0 and stats.writes_skipped == 0
            assert stats.reads_issued == 3 + 3  # the snapshot's LISTs, a GET a node


# ----------------------------------------------------------------------
# The simulator, the client and the pure parts
# ----------------------------------------------------------------------


def test_port_simulator_equals_jax_simulator_step_by_step():
    """The same object, node and workload on two clusters; each simulator
    steps its own the same number of times, then finalizes."""
    sides = []
    with contextlib.ExitStack() as stack:
        for kind in ("jax", "port"):
            cluster = FakeCluster()
            cluster.create(make_node("node-0"))
            cluster.create(make_pod("train-0", namespace="default", node_name="node-0",
                                    labels={"app": "training"}, controlled=True))
            cluster.create(make_pod("job-0", namespace="default", node_name="node-0",
                                    labels={"job": "batch"}, controlled=True))
            nm = NodeMaintenance.new("tpu-operator-node-0", namespace=MAINT_NS)
            nm.requestor_id, nm.node_name = OWNER, "node-0"
            nm.spec["waitForPodCompletion"] = {"podSelector": "job=batch", "timeoutSeconds": 0}
            nm.spec["drainSpec"] = {"force": True, "podSelector": "app=training"}
            cluster.create(JaxNodeMaintenance(nm.raw))
            if kind == "jax":
                operator = JaxOperator(cluster, namespace=MAINT_NS)
            else:
                server = stack.enter_context(LocalApiServer(cluster=cluster))
                operator = MaintenanceOperatorSimulator(
                    RestClient(RestConfig(server=server.url)), namespace=MAINT_NS
                )
            sides.append((cluster, operator))

        def observe(cluster):
            obj = cluster.get_or_none("NodeMaintenance", "tpu-operator-node-0", MAINT_NS)
            nm = None
            if obj is not None:
                meta = obj.raw["metadata"]
                nm = (obj.raw.get("spec"), (obj.raw.get("status") or {}).get("conditions"),
                      meta.get("finalizers"), meta.get("deletionTimestamp") is not None)
            node = cluster.get("Node", "node-0")
            pods = sorted(p.name for p in cluster.list("Pod", namespace="default"))
            return nm, bool(node.raw["spec"].get("unschedulable")), pods

        history = []
        for step in range(9):
            if step == 5:
                for cluster, _ in sides:
                    cluster.patch("Pod", "job-0", "default", patch={"status": {"phase": "Succeeded"}})
            if step == 7:
                for cluster, _ in sides:
                    cluster.delete("NodeMaintenance", "tpu-operator-node-0", MAINT_NS)
            for _, operator in sides:
                operator.step()
            (a, b) = [observe(cluster) for cluster, _ in sides]
            assert a == b, f"step {step}"
            history.append(b)
    reasons = [h[0][1][0]["reason"] for h in history[:7]]
    assert reasons == ["Cordon", "WaitForPodCompletion", "WaitForPodCompletion",
                       "WaitForPodCompletion", "WaitForPodCompletion", "Draining", "Ready"]
    assert history[6][2] == ["job-0"]  # the drain took the selected pod only
    assert history[7][0] is None and not history[7][1]  # finalized, uncordoned


def test_rest_client_serves_node_maintenance_with_finalizers():
    cluster = FakeCluster()
    with LocalApiServer(cluster=cluster) as server:
        rest = RestClient(RestConfig(server=server.url))
        nm = NodeMaintenance.new("tpu-operator-node-0", namespace=MAINT_NS)
        nm.requestor_id, nm.node_name = OWNER, "node-0"
        made = rest.create(nm)
        assert isinstance(made, NodeMaintenance) and made.requestor_id == OWNER
        assert made.finalizers == [] and "finalizers" not in made.raw["metadata"]
        made.finalizers = ["x"]
        made.additional_requestors = [NIC]
        rest.update(made)
        rest.patch("NodeMaintenance", nm.name, MAINT_NS, patch={
            "status": {"conditions": [{"type": "Ready", "status": "True", "reason": "Ready"}]}})
        got = rest.get("NodeMaintenance", nm.name, MAINT_NS)
        assert got.is_ready() and got.ready_reason() == "Ready"
        assert got.additional_requestors == [NIC] and got.finalizers == ["x"]
        assert [o.name for o in rest.list("NodeMaintenance", namespace=MAINT_NS)] == [nm.name]
        rest.delete("NodeMaintenance", nm.name, MAINT_NS)
        held = rest.get("NodeMaintenance", nm.name, MAINT_NS)
        assert held.deletion_timestamp is not None  # the finalizer holds it
        held.finalizers = []
        rest.update(held)
        assert rest.get_or_none("NodeMaintenance", nm.name, MAINT_NS) is None
        assert cluster.get_or_none("NodeMaintenance", nm.name, MAINT_NS) is None


def test_node_maintenance_views_equal_the_jax_views():
    raw = {
        "metadata": {"name": "tpu-operator-n", "finalizers": ["f"]},
        "spec": {"requestorID": "a", "additionalRequestors": ["b"], "nodeName": "n",
                 "nodeHealth": {"score": 40, "trend": "degrading",
                                "worstLinks": [{"peer": "m", "verdict": "slow"}]}},
        "status": {"conditions": [{"type": "Ready", "status": "False", "reason": "Draining"}]},
    }
    import copy

    port, jax = NodeMaintenance(copy.deepcopy(raw)), JaxNodeMaintenance(copy.deepcopy(raw))
    for attr in ("requestor_id", "additional_requestors", "node_name", "node_health",
                 "worst_links", "finalizers"):
        assert getattr(port, attr) == getattr(jax, attr), attr
    assert port.is_ready() == jax.is_ready() and port.ready_reason() == jax.ready_reason()
    assert (port.KIND, port.API_VERSION) == (jax.KIND, jax.API_VERSION)
    empty = NodeMaintenance({"metadata": {"name": "x"}})
    assert empty.finalizers == [] and empty.additional_requestors == [] and empty.worst_links == []
    assert empty.raw == {"metadata": {"name": "x"}, "apiVersion": port.API_VERSION,
                         "kind": port.KIND}  # reads inserted nothing


PREDICATE_CASES = [
    ({"status": {"conditions": [{"type": "Ready", "status": "False"}]}, "metadata": {}},
     {"status": {"conditions": [{"type": "Ready", "status": "True"}]}, "metadata": {}}),
    ({"status": {"conditions": [{"type": "A", "status": "True"}, {"type": "B", "status": "False"}]},
      "metadata": {}},
     {"status": {"conditions": [{"type": "B", "status": "False"}, {"type": "A", "status": "True"}]},
      "metadata": {}}),
    ({"status": {}, "metadata": {"finalizers": ["x"]}},
     {"status": {}, "metadata": {"deletionTimestamp": 123.0}}),
    ({"status": {}, "metadata": {"finalizers": ["x"]}},
     {"status": {}, "metadata": {"finalizers": ["x"], "deletionTimestamp": 123.0}}),
    (None, {"metadata": {}}),
    ({"metadata": {}}, None),
    ({"status": {"conditions": [{"type": "Ready", "status": "True", "reason": "A"}]}},
     {"status": {"conditions": [{"type": "Ready", "status": "True", "reason": "B"}]}}),
]


@pytest.mark.parametrize("old, new", PREDICATE_CASES)
def test_condition_changed_predicate_equals_jax(old, new):
    assert condition_changed_predicate(old, new) == jax_condition_changed(old, new)


@pytest.mark.parametrize("who", ["a", "b", "c", ""])
def test_requestor_id_predicate_equals_jax(who):
    for obj in ({"spec": {"requestorID": "a", "additionalRequestors": ["b"]}}, {}, {"spec": {}}):
        assert requestor_id_predicate(obj, who) == jax_requestor_id(obj, who)


ENV_CASES = {
    "unset": {},
    "enabled": {"MAINTENANCE_OPERATOR_ENABLED": "true"},
    "all-set": {
        "MAINTENANCE_OPERATOR_ENABLED": "true",
        "MAINTENANCE_OPERATOR_POST_MAINTENANCE": "true",
        "MAINTENANCE_OPERATOR_REQUESTOR_ID": "me",
        "MAINTENANCE_OPERATOR_REQUESTOR_NAMESPACE": "ns1",
        "MAINTENANCE_OPERATOR_NODE_MAINTENANCE_PREFIX": "pfx",
    },
    "set-but-empty": {
        "MAINTENANCE_OPERATOR_ENABLED": "",
        "MAINTENANCE_OPERATOR_REQUESTOR_ID": "",
        "MAINTENANCE_OPERATOR_REQUESTOR_NAMESPACE": "",
        "MAINTENANCE_OPERATOR_NODE_MAINTENANCE_PREFIX": "",
    },
    "not-true": {"MAINTENANCE_OPERATOR_ENABLED": "True",
                 "MAINTENANCE_OPERATOR_POST_MAINTENANCE": "1"},
}


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_options_from_env_equal_jax(case, monkeypatch):
    for key in ENV_CASES["all-set"]:
        monkeypatch.delenv(key, raising=False)
    for key, value in ENV_CASES[case].items():
        monkeypatch.setenv(key, value)
    port, jax = RequestorOptions.from_env(), JaxOptions.from_env()
    fields = ("use_maintenance_operator", "use_post_maintenance", "requestor_id", "namespace",
              "node_maintenance_name_prefix", "pod_eviction_filters", "post_maintenance_hook",
              "post_maintenance_timeout_seconds")
    assert {f: getattr(port, f) for f in fields} == {f: getattr(jax, f) for f in fields}
    assert port.to_state_options().use_maintenance_operator == port.use_maintenance_operator


@pytest.fixture
def pool():
    cluster = FakeCluster()
    for i in range(2):
        cluster.create(make_node(node_name(i)))
    DaemonSetSimulator(cluster, name=LABELS["app"], namespace=NS, match_labels=LABELS).settle()
    return cluster


def _manager(cluster, **kwargs):
    return ClusterUpgradeStateManager(
        cluster, DeviceClass.nvidia("gpu"), runner=TaskRunner(inline=True), **kwargs
    )


def test_enable_rejects_a_disabled_mode_without_changing_the_manager(pool):
    mgr = _manager(pool)
    options = mgr.options
    with pytest.raises(ValueError):
        enable_requestor_mode(mgr, RequestorOptions(use_maintenance_operator=False))
    assert mgr.options is options and mgr.requestor is None
    assert not mgr.common.count_maintenance_states
    with pytest.raises(ValueError):
        RequestorNodeStateManager(pool, mgr.common, RequestorOptions())


@pytest.mark.parametrize("post", [False, True])
def test_enable_keeps_the_other_options_and_sets_the_budget_mode(pool, post):
    mgr = _manager(pool, options=StateOptions(apply_width=3))
    opts = RequestorOptions(use_maintenance_operator=True, use_post_maintenance=post)
    assert enable_requestor_mode(mgr, opts) is mgr
    assert mgr.options.use_maintenance_operator and mgr.options.apply_width == 3
    assert isinstance(mgr.requestor, RequestorNodeStateManager) and mgr.requestor.opts is opts
    assert mgr.common.count_maintenance_states is post


def test_a_requestor_runs_only_with_the_option(pool):
    requestor = RequestorNodeStateManager(
        pool, _manager(pool).common,
        RequestorOptions(use_maintenance_operator=True, namespace=MAINT_NS),
    )
    on = _manager(pool, options=StateOptions(use_maintenance_operator=True), requestor=requestor)
    off = _manager(pool, requestor=requestor)
    for mgr, reads in ((on, 2), (off, 0)):
        assert mgr.requestor is requestor
        mgr.build_state(NS, LABELS)
        assert mgr.last_pass_stats.reads_issued == 3 + reads


def test_sick_links_are_empty_without_telemetry():
    from k8s_operator_libs_tpu_torch.upgrade import ClusterUpgradeState

    state = ClusterUpgradeState()
    assert state.sick_links_of("node-0") == [] and state.health_of("node-0") is None


@pytest.mark.parametrize("bucket", [UpgradeState.NODE_MAINTENANCE_REQUIRED,
                                    UpgradeState.POST_MAINTENANCE_REQUIRED])
@pytest.mark.parametrize("post", [False, True])
def test_the_maintenance_states_count_only_with_post_maintenance(pool, bucket, post):
    mgr = _manager(pool)
    enable_requestor_mode(mgr, RequestorOptions(use_maintenance_operator=True,
                                                use_post_maintenance=post, namespace=MAINT_NS))
    pool.patch("Node", node_name(1), patch={"metadata": {"labels": {KEYS.state_label: str(bucket)}}})
    state = mgr.build_state(NS, LABELS)
    assert [ns.node.name for ns in state.nodes_in(bucket)] == [node_name(1)]
    assert mgr.get_total_managed_nodes(state) == (2 if post else 1)
    assert mgr.get_upgrades_in_progress(state) == (1 if post else 0)


# ----------------------------------------------------------------------
# chip_smoke.py's requestor roll, rehearsed on the CPU
# ----------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_dict_client_holds_a_deleted_object_until_its_finalizers_go():
    smoke = _chip_smoke()
    client = smoke.DictClient()
    nm = NodeMaintenance.new("tpu-operator-n", namespace=MAINT_NS)
    client.create(nm)
    client.delete("NodeMaintenance", nm.name, MAINT_NS)  # no finalizer: gone at once
    assert client.list("NodeMaintenance", namespace=MAINT_NS) == []
    made = client.create(nm)
    made.finalizers = ["f"]
    client.update(made)
    client.delete("NodeMaintenance", nm.name, MAINT_NS)
    held = client.get("NodeMaintenance", nm.name, MAINT_NS)
    assert isinstance(held, NodeMaintenance) and held.deletion_timestamp
    held.finalizers = ["f", "g"]
    held.raw["metadata"].pop("deletionTimestamp")  # an update cannot clear the mark
    held = client.update(held)
    assert held.deletion_timestamp
    client.patch("NodeMaintenance", nm.name, MAINT_NS, patch={"metadata": {"finalizers": ["g"]}})
    held = client.get("NodeMaintenance", nm.name, MAINT_NS)
    held.finalizers = []
    client.update(held)
    assert client.list("NodeMaintenance", namespace=MAINT_NS) == []


def test_chip_smoke_requestor_roll_runs_on_the_cpu_with_a_stub_hook(monkeypatch):
    """The requestor phase's pool, machine, operator stand-in, kubelet and
    pass loop (``roll_pool``, ``RollKubelet``, ``drive_roll`` over
    ``DictClient``), with node labels that need no card, validation off
    and a hook that only records: both nodes roll through both
    maintenance states and end done and uncordoned by the finalizer, with
    no object or workload left."""
    from k8s_operator_libs_tpu_torch.kube.objects import Pod
    from k8s_operator_libs_tpu_torch.parallel import topology

    smoke = _chip_smoke()
    monkeypatch.setattr(topology, "local_gpu_labels", lambda: {
        "nvidia.com/gpu.present": "true", "nvidia.com/gpu.count": "1",
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
    })
    monkeypatch.setattr(smoke, "ROLL_PASS_INTERVAL_S", 0.0)
    client = smoke.DictClient()
    installer = smoke.roll_pool(client, smoke.REQUESTOR_NODES)
    mgr = ClusterUpgradeStateManager(client, DeviceClass.nvidia("gpu"), runner=TaskRunner(inline=True))
    calls = []
    enable_requestor_mode(mgr, RequestorOptions(
        use_maintenance_operator=True, use_post_maintenance=True, namespace=smoke.MAINTENANCE_NS,
        post_maintenance_hook=lambda node: calls.append((node.name, node.unschedulable)) or True,
    ))
    operator = MaintenanceOperatorSimulator(client, namespace=smoke.MAINTENANCE_NS)
    kubelet = smoke.RollKubelet(client, installer, smoke.REQUESTOR_NODES, "", {}, {})
    run = smoke.drive_roll(
        "requestor_roll", client, mgr, installer, kubelet, before_apply=operator.step,
        after_apply=lambda: not client.list("NodeMaintenance", namespace=smoke.MAINTENANCE_NS),
    )
    assert sorted(calls) == [(name, True) for name in smoke.REQUESTOR_NODES]
    for trajectory in run["trajectories"].values():
        states = [step[1] for step in trajectory]
        assert {"node-maintenance-required", "post-maintenance-required"} <= set(states)
        assert states[-1] == "upgrade-done"
    pods = client.list("Pod")
    assert sorted(p.name for p in pods) == sorted(
        f"{installer.name}-{name}" for name in smoke.REQUESTOR_NODES
    )
    assert all(Pod(p.raw).controller_revision_hash() == smoke.ROLL_VERSIONS[1] for p in pods)
