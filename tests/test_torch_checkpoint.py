"""The port's checkpoint arc, held pass by pass against the JAX machine's.

Two in-memory clusters of the JAX package are built alike. Cluster A is
rolled by the JAX ``ClusterUpgradeStateManager``, its client the cluster
itself, its training pods played by the JAX
``CheckpointingWorkloadSimulator``. Cluster B is rolled by the port's
manager over the port's ``RestClient`` and a ``LocalApiServer`` serving B,
its training pods played by the port's simulator over that client. Both
machines use inline task runners, record their events, and read one
virtual clock installed in both packages' ``utils.faultpoints``. A pass
is the JAX drive's: the workload ticks, the driver DaemonSet ticks, one
pass of the machine, the DaemonSet again. After every pass, and after
every direct call of a manager, these must be equal on A and B: every
node's state label, cordon bit and upgrade annotations, every pod's phase,
revision and upgrade annotations, every WorkloadCheckpoint object's spec,
the simulators' lost, total and restarted steps (each job's and the sum),
the events' messages, the eight checkpoint fields of ``PassStats``, the
checkpoint managers' ``totals()`` and whether the pass raised.

The scenarios are the cases of ``tests/test_checkpoint_drain.py``, each
named after its JAX counterpart (its gauge family, ``UpgradeMetrics``, is
not in the port yet: ROADMAP A15), and: the wait for jobs with a selector,
finished and timed out, pod deletion on, and one machine finishing the
other's arc, both ways. The port's simulator is held to the JAX one tick
by tick, and the contract's pure parts (the spec, the object's step) are
compared on equal inputs.
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass
from typing import Callable, Optional, Union

import pytest

from builders import make_node, make_pod
from k8s_operator_libs_tpu.api import CheckpointSpec as JaxCheckpointSpec
from k8s_operator_libs_tpu.api import DriverUpgradePolicySpec as JaxPolicy
from k8s_operator_libs_tpu.api.upgrade_v1alpha1 import (
    make_workload_checkpoint as jax_make_workload_checkpoint,
)
from k8s_operator_libs_tpu.api.upgrade_v1alpha1 import (
    workload_checkpoint_step as jax_workload_checkpoint_step,
)
from k8s_operator_libs_tpu.kube import ApiError as JaxApiError
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube import Node as JaxNode
from k8s_operator_libs_tpu.kube.objects import KubeObject as JaxKubeObject
from k8s_operator_libs_tpu.kube.sim import CheckpointingWorkloadSimulator as JaxWorkload
from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator
from k8s_operator_libs_tpu.tpu.slice_gate import _GANG_CONSUMER_STATES as JAX_GANG_STATES
from k8s_operator_libs_tpu.upgrade import ClusterUpgradeStateManager as JaxManager
from k8s_operator_libs_tpu.upgrade import DeviceClass as JaxDeviceClass
from k8s_operator_libs_tpu.upgrade import TaskRunner as JaxRunner
from k8s_operator_libs_tpu.upgrade import UpgradeKeys as JaxKeys
from k8s_operator_libs_tpu.upgrade import UpgradeState as JaxState
from k8s_operator_libs_tpu.utils import faultpoints as jax_faultpoints
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import (
    WORKLOAD_CHECKPOINT_API_VERSION,
    WORKLOAD_CHECKPOINT_KIND,
    CheckpointSpec,
    DriverUpgradePolicySpec,
    make_workload_checkpoint,
    workload_checkpoint_name,
    workload_checkpoint_step,
)
from k8s_operator_libs_tpu_torch.kube.client import ApiError
from k8s_operator_libs_tpu_torch.kube.objects import KubeObject, Node
from k8s_operator_libs_tpu_torch.kube.rest import RESOURCES, RestClient, RestConfig
from k8s_operator_libs_tpu_torch.kube.sim import CheckpointingWorkloadSimulator
from k8s_operator_libs_tpu_torch.models.burnin import BurninConfig
from k8s_operator_libs_tpu_torch.tpu.slice_gate import _GANG_CONSUMER_STATES
from k8s_operator_libs_tpu_torch.upgrade import (
    RESTORE_VERIFY_TIMEOUT_SECONDS,
    ClusterUpgradeStateManager,
    DeviceClass,
    TaskRunner,
    UpgradeKeys,
    UpgradeState,
)
from k8s_operator_libs_tpu_torch.utils import faultpoints
from test_torch_cuda import check_save_restore_replay, chip_smoke_module, save_restore_replay

NS = "gpu-operator"
LABELS = {"app": "nvidia-driver-daemonset"}
TRAIN_NS = "training"
TRAIN_SELECTOR = "app=trainer"
KEYS = UpgradeKeys(DeviceClass.nvidia("gpu"))
JAX_KEYS = JaxKeys(JaxDeviceClass.nvidia("gpu"))
KEY_PREFIX = f"{KEYS.device.domain}/{KEYS.device.driver}-driver-"
OLD, NEW = "550.54.15", "560.35.03"

#: The PassStats fields of the arc: the pass's own, then the lifetime ones.
PASS_FIELDS = (
    "checkpoint_nodes_waiting",
    "checkpoint_requests_issued",
    "checkpoint_completions",
    "checkpoint_escalations",
)
LIFETIME_FIELDS = (
    "checkpoint_escalations_total",
    "checkpoints_completed_total",
    "checkpoint_restores_verified_total",
    "checkpoint_restore_escalations_total",
)


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


def checkpoint_policy(timeout_seconds=300, enable=True, **extra) -> dict:
    """The JAX tests' policy: every node at once, a forced drain, and the
    arc on ``app=trainer`` (``extra``: more checkpoint keys, or top-level
    keys where they are policy keys)."""
    doc = {
        "autoUpgrade": True,
        "maxParallelUpgrades": 0,
        "maxUnavailable": "100%",
        "drain": {"enable": True, "force": True, "timeoutSeconds": 30},
    }
    for key in ("waitForCompletion", "podDeletion"):
        if key in extra:
            doc[key] = extra.pop(key)
    if enable:
        doc["checkpoint"] = {
            "enable": True, "podSelector": TRAIN_SELECTOR, "timeoutSeconds": timeout_seconds,
            **extra,
        }
    return doc


class Recorder:
    def __init__(self) -> None:
        self.events: list[tuple] = []

    def eventf(self, obj, event_type, reason, fmt, *args) -> None:
        self.events.append((obj.name, event_type, reason, fmt % args if args else fmt))


@dataclass
class Scenario:
    """One cluster's make-up, alike on both sides."""

    nodes: int = 1
    ack_delay: int = 1
    nonacking: tuple = ()
    #: Delete the pods ``app=trainer`` before the drain (their own bucket).
    pod_deletion: bool = False
    #: Validate with an in-controller hook that passes (its calls kept).
    validation_hook: bool = False
    #: Batch pods ``app=batch`` on these nodes, for the wait for jobs.
    batch_jobs: tuple = ()


class Side:
    """One cluster with its DaemonSet, its API server, its training jobs'
    simulator (A: the JAX one on the cluster, B: the port's over the REST
    client) and both machines."""

    def __init__(self, sc: Scenario, stack: contextlib.ExitStack, role: str) -> None:
        self.role = role
        self.cluster = FakeCluster()
        for i in range(sc.nodes):
            self.cluster.create(make_node(node_name(i)))
        self.sim = DaemonSetSimulator(
            self.cluster, name=LABELS["app"], namespace=NS, match_labels=LABELS,
            initial_hash=OLD,
        )
        self.sim.settle()
        for name in sc.batch_jobs:
            self.cluster.create(make_pod(f"batch-{name}", namespace="default", node_name=name,
                                         labels={"app": "batch"}, controlled=True))
        server = stack.enter_context(LocalApiServer(cluster=self.cluster))
        self.rest = RestClient(RestConfig(server=server.url))
        if role == "jax":
            self.workload = JaxWorkload(
                self.cluster, JAX_KEYS, namespace=TRAIN_NS, nonacking=sc.nonacking,
                ack_delay_steps=sc.ack_delay,
            )
        else:
            self.workload = CheckpointingWorkloadSimulator(
                self.rest, KEYS, namespace=TRAIN_NS, nonacking=sc.nonacking,
                ack_delay_steps=sc.ack_delay,
            )
        self.recorder = Recorder()
        self.hook_calls: list[str] = []
        self.machines = {"jax": self.new_machine("jax"), "port": self.new_machine("port")}
        for mgr in self.machines.values():
            if sc.pod_deletion:
                mgr.with_pod_deletion_enabled(lambda pod: pod.labels.get("app") == "trainer")
            if sc.validation_hook:
                mgr.with_validation_enabled(
                    validation_hook=lambda node: self.hook_calls.append(node.name) or True
                )

    def new_machine(self, machine: str):
        if machine == "jax":
            return JaxManager(self.cluster, JaxDeviceClass.nvidia("gpu"),
                              runner=JaxRunner(inline=True), recorder=self.recorder)
        return ClusterUpgradeStateManager(self.rest, DeviceClass.nvidia("gpu"),
                                          runner=TaskRunner(inline=True), recorder=self.recorder)

    # -- what a machine reads -------------------------------------------------
    def node(self, machine: str, name: str = "node-0"):
        if machine == "jax":
            return JaxNode(self.cluster.get("Node", name).raw)
        return Node(self.rest.get("Node", name).raw)

    def cm(self, machine: str):
        return self.machines[machine].common.checkpoint_manager

    @staticmethod
    def spec(machine: str, **kwargs):
        cls = JaxCheckpointSpec if machine == "jax" else CheckpointSpec
        return cls(enable=True, pod_selector=TRAIN_SELECTOR, **kwargs)

    @staticmethod
    def state(machine: str, state: str):
        return JaxState(state) if machine == "jax" else UpgradeState(state)

    def set_node(self, machine: str, name: str = "node-0", state: Optional[str] = None,
                 **annotations) -> None:
        """Through the machine's own provider, as the JAX tests do."""
        provider = self.machines[machine].provider
        for key, value in annotations.items():
            provider.change_node_upgrade_annotation(self.node(machine, name), key, value)
        if state is not None:
            provider.change_node_upgrade_state(self.node(machine, name), self.state(machine, state))

    # -- one pass -------------------------------------------------------------
    def one_pass(self, machine: str, policy: dict, workload: bool = True) -> dict:
        if workload:
            self.workload.step()
        self.sim.step()
        mgr = self.machines[machine]
        pol = (JaxPolicy if machine == "jax" else DriverUpgradePolicySpec).from_dict(policy)
        state = mgr.build_state(NS, LABELS)
        try:
            mgr.apply_state(state, pol)
            raised = False
        except (ApiError, JaxApiError):
            raised = True
        self.sim.step()
        stats = mgr.last_pass_stats
        return {
            "raised": raised,
            "pass": {f: getattr(stats, f) for f in PASS_FIELDS},
            "lifetime": {f: getattr(stats, f) for f in LIFETIME_FIELDS},
        }

    # -- what is compared -----------------------------------------------------
    def totals(self) -> dict:
        """Both machines' checkpoint totals, summed: a roll that one machine
        began and the other finished counts once."""
        jax, port = self.cm("jax").totals(), self.cm("port").totals()
        return {k: jax[k] + port[k] for k in jax}

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
        pods = sorted(
            (p.namespace, p.name, p.labels.get("controller-revision-hash", ""), p.phase,
             bool(p.raw["metadata"].get("deletionTimestamp")),
             tuple(sorted((k, v) for k, v in p.annotations.items() if k.startswith(KEY_PREFIX))))
            for p in self.cluster.list("Pod")
        )
        checkpoints = {
            f"{o.namespace}/{o.name}": o.raw.get("spec")
            for o in self.cluster.list(WORKLOAD_CHECKPOINT_KIND)
        }
        jobs = {
            name: (w.step, w.running, w.restarts, w.lost_steps)
            for name, w in sorted(self.workload._workloads.items())
        }
        return {
            "nodes": nodes,
            "pods": pods,
            "checkpoints": checkpoints,
            "jobs": jobs,
            "steps": (self.workload.lost_steps(), self.workload.total_steps(),
                      self.workload.restarts()),
            "events": list(self.recorder.events),
            "totals": self.totals(),
            "hook_calls": list(self.hook_calls),
        }

    def states(self) -> dict:
        return {name: obs[0] for name, obs in self.observe()["nodes"].items()}

    def settled(self) -> bool:
        obs = self.observe()
        return all(
            state == "upgrade-done" and not cordoned for state, cordoned, _ in obs["nodes"].values()
        ) and self.sim.all_pods_ready_and_current()


class Twin:
    """A (JAX machine, JAX simulator) and B (``machine``'s, the port's
    simulator), compared after every step."""

    def __init__(self, sc: Scenario, clock: Clock, stack: contextlib.ExitStack) -> None:
        self.sc = sc
        self.clock = clock
        self.a, self.b = Side(sc, stack, "jax"), Side(sc, stack, "port")
        self.trajectory: list[dict] = []
        self.passes: list[dict] = []

    def compare(self, what: str) -> dict:
        obs_a, obs_b = self.a.observe(), self.b.observe()
        assert obs_a == obs_b, what
        return obs_b

    def act(self, fn: Callable, machine: str = "port"):
        """``fn(side, machine)`` on A with the JAX machine and on B with
        ``machine``; equal returns and equal clusters after."""
        out_a, out_b = fn(self.a, "jax"), fn(self.b, machine)
        assert out_a == out_b, (out_a, out_b)
        self.compare(f"after {getattr(fn, '__name__', fn)}")
        return out_b

    def workload_step(self) -> None:
        self.a.workload.step()
        self.b.workload.step()
        self.compare("workload step")

    def one_pass(self, policy: dict, machine: str = "port", workload: bool = True,
                 tick_s: float = 10.0) -> dict:
        self.clock.now += tick_s
        p = len(self.passes)
        out_a = self.a.one_pass("jax", policy, workload)
        out_b = self.b.one_pass(machine, policy, workload)
        assert out_a["raised"] == out_b["raised"], f"pass {p}"
        assert out_a["pass"] == out_b["pass"], f"pass {p}"
        self.passes.append({"machine": machine, **out_b})
        if self.machines_used() == {machine}:  # one machine's lifetime so far
            assert out_a["lifetime"] == out_b["lifetime"], f"pass {p}"
        self.trajectory.append(self.compare(f"pass {p}"))
        return out_b

    def machines_used(self) -> set:
        return {p["machine"] for p in self.passes}

    def roll(self, policy: Union[dict, Callable[[int], dict]],
             schedule: Callable[[int], str] = lambda p: "port",
             after: Optional[Callable[[int, Side], None]] = None,
             tick_s: float = 10.0, max_passes: int = 60) -> int:
        """Passes until both sides settled, then three workload ticks (the
        evicted jobs come back and restore), as the JAX drive does."""
        for p in range(max_passes):
            pol = policy(p) if callable(policy) else policy
            self.one_pass(pol, machine=schedule(p), tick_s=tick_s)
            if after is not None:
                after(p, self.a)
                after(p, self.b)
                self.compare(f"after pass {p}")
            if self.a.settled() and self.b.settled():
                for _ in range(3):
                    self.workload_step()
                return p + 1
        raise AssertionError(f"no end in {max_passes} passes: {self.b.observe()['nodes']}")

    def seen_states(self) -> set:
        return {obs[0] for step in self.trajectory for obs in step["nodes"].values()}

    def totals(self) -> dict:
        return self.b.totals()


@pytest.fixture
def twin_of(clock):
    with contextlib.ExitStack() as stack:
        yield lambda sc=Scenario(): Twin(sc, clock, stack)


def rolled(twin: Twin, policy=None, **kwargs) -> Twin:
    """Bump the driver on both sides and roll."""
    twin.a.sim.set_template_hash(NEW)
    twin.b.sim.set_template_hash(NEW)
    twin.roll(policy if policy is not None else checkpoint_policy(), **kwargs)
    return twin


def state_of(side: Side, name: str = "node-0") -> str:
    return side.states()[name]


def ann(side: Side, name: str = "node-0") -> dict:
    return side.observe()["nodes"][name][2]


# ----------------------------------------------------------------------
# TestHappyArc
# ----------------------------------------------------------------------


def test_roll_passes_through_checkpoint_required(twin_of):
    twin = rolled(twin_of(Scenario(nodes=2)))
    assert "checkpoint-required" in twin.seen_states()
    totals = twin.totals()
    assert totals["completions"] == 2
    assert totals["escalations"] == 0
    assert totals["restores_verified"] == 2


@pytest.mark.parametrize("ack_delay", [1, 3])
def test_drain_gated_until_ack(twin_of, ack_delay):
    """A slow acker holds its node in checkpoint-required while its pod is
    still alive: no eviction before the ack."""
    gated = {"jax": 0, "port": 0}

    def after(p, side):
        if state_of(side) == "checkpoint-required":
            pod = side.workload.workload("node-0").pod_name
            assert side.cluster.get_or_none("Pod", pod, TRAIN_NS) is not None
            gated[side.role] += 1

    twin = rolled(twin_of(Scenario(ack_delay=ack_delay)), after=after)
    assert gated["jax"] == gated["port"] >= ack_delay - 1
    assert gated["port"] >= (2 if ack_delay == 3 else 1)
    w = twin.b.workload.workload("node-0")
    assert w.restarts == 1
    assert 0 <= w.lost_steps <= ack_delay


def test_lost_steps_strictly_fewer_than_full_restart(twin_of):
    lost = {}
    for mode in ("baseline", "checkpointed"):
        twin = twin_of(Scenario(nodes=2))
        for _ in range(10):
            twin.workload_step()  # a history worth losing
        rolled(twin, checkpoint_policy(enable=mode == "checkpointed"))
        lost[mode] = twin.b.workload.lost_steps()
    assert lost["checkpointed"] < lost["baseline"]
    assert lost["baseline"] >= 20


def test_arc_annotations_cleaned_up_at_done(twin_of):
    twin = rolled(twin_of())
    for key in (
        KEYS.checkpoint_start_annotation,
        KEYS.checkpoint_manifest_annotation,
        KEYS.checkpoint_escalated_annotation,
        KEYS.restore_verify_start_annotation,
    ):
        assert key not in ann(twin.b), key


def test_restore_verified_before_uncordon(twin_of):
    """The restore gate passes while the node is still cordoned: it runs in
    the validation bucket, before the uncordon."""
    twin = twin_of()
    verified = {"jax": [], "port": []}
    for side in (twin.a, twin.b):
        for mgr in side.machines.values():
            real = mgr.common.checkpoint_manager.restore_gate

            def spy(node, real=real, side=side):
                ok = real(node)
                if ok:
                    raw = side.cluster.get("Node", node.name).raw
                    verified[side.role].append(bool((raw.get("spec") or {}).get("unschedulable")))
                return ok

            mgr.common.validation_manager.restore_gate = spy
    rolled(twin)
    assert verified["jax"] == verified["port"]
    assert verified["port"] and all(verified["port"])


# ----------------------------------------------------------------------
# TestEpochIdempotency
# ----------------------------------------------------------------------


def test_reentry_reuses_epoch_and_issues_no_duplicate_requests(twin_of):
    twin = twin_of()
    twin.workload_step()  # the training pod exists

    def coordinate(side, machine):
        side.cm(machine).coordinate(side.node(machine), side.spec(machine, timeout_seconds=300),
                                    side.state(machine, "drain-required"))

    for _ in range(3):  # three passes aborted and tried again
        twin.act(coordinate)
    assert twin.totals()["requests"] == 1
    epoch = ann(twin.b)[KEYS.checkpoint_start_annotation]
    pod = twin.b.rest.get("Pod", twin.b.workload.workload("node-0").pod_name, TRAIN_NS)
    assert pod.raw["metadata"]["annotations"][KEYS.checkpoint_request_annotation] == epoch


def test_stale_ack_from_previous_epoch_does_not_count(twin_of):
    twin = twin_of()
    twin.workload_step()

    def stale_ack(side, machine):
        side.cluster.patch("Pod", side.workload.workload("node-0").pod_name, TRAIN_NS, patch={
            "metadata": {"annotations": {KEYS.checkpoint_complete_annotation: "999"}}})

    def coordinate(side, machine):
        side.cm(machine).coordinate(side.node(machine), side.spec(machine, timeout_seconds=300),
                                    side.state(machine, "drain-required"))

    twin.act(stale_ack)
    twin.act(coordinate)
    assert state_of(twin.b) == ""  # not advanced
    assert twin.totals()["completions"] == 0


# ----------------------------------------------------------------------
# TestDeadlineEscalation
# ----------------------------------------------------------------------


def test_nonacking_workload_escalates_and_roll_completes(twin_of):
    twin = rolled(twin_of(Scenario(nodes=2, nonacking=("node-0",))),
                  checkpoint_policy(timeout_seconds=5), tick_s=2.0)
    totals = twin.totals()
    assert totals["escalations"] == 1
    assert totals["completions"] == 1
    wedged, acked = (twin.b.workload.workload(n) for n in ("node-0", "node-1"))
    assert wedged.lost_steps > 0
    assert acked.lost_steps < wedged.lost_steps
    assert any("escalated - plain drain" in e[3] for e in twin.b.recorder.events)


def _two_victims(side, machine):
    for name in ("acker", "wedged"):
        side.cluster.create(make_pod(name, namespace=TRAIN_NS, node_name="node-0",
                                     labels={"app": "trainer"}))


def _ack(pod: str, step: int):
    """``pod`` writes its checkpoint object and acks the node's epoch."""
    def ack(side, machine):
        epoch = side.node(machine).annotations[KEYS.checkpoint_start_annotation]
        side.cluster.create(JaxKubeObject(jax_make_workload_checkpoint(
            pod, TRAIN_NS, "node-0", step=step, request_id=epoch)))
        side.cluster.patch("Pod", pod, TRAIN_NS, patch={"metadata": {"annotations": {
            KEYS.checkpoint_complete_annotation: epoch,
            KEYS.checkpoint_step_annotation: str(step),
        }}})
    return ack


def _coordinate(timeout_seconds: int, fresh: bool = False):
    """One ``coordinate`` of node-0 into drain-required; ``fresh``: by a
    new manager, as after a controller's restart."""
    def coordinate(side, machine):
        cm = side.new_machine(machine).common.checkpoint_manager if fresh else side.cm(machine)
        cm.coordinate(side.node(machine), side.spec(machine, timeout_seconds=timeout_seconds),
                      side.state(machine, "drain-required"))
        return cm.totals()
    return coordinate


def test_escalation_records_partial_manifest(twin_of, clock):
    """Two victims on one node, one acks, one is wedged: the escalated
    manifest still carries the acker's checkpoint."""
    twin = twin_of()
    twin.act(_two_victims)
    twin.act(_coordinate(5))
    twin.act(_ack("acker", 7))
    clock.now += 6  # past the deadline
    twin.act(_coordinate(5))
    assert state_of(twin.b) == "drain-required"
    assert ann(twin.b)[KEYS.checkpoint_escalated_annotation] == "true"
    assert json.loads(ann(twin.b)[KEYS.checkpoint_manifest_annotation]) == {f"{TRAIN_NS}/acker": 7}
    assert twin.totals()["escalations"] == 1


def test_restart_past_deadline_with_full_acks_does_not_escalate(twin_of, clock):
    """A controller restarted after every ack came, and after the deadline,
    completes the gate through the durable epoch."""
    twin = twin_of()

    def victim(side, machine):
        side.cluster.create(make_pod("victim", namespace=TRAIN_NS, node_name="node-0",
                                     labels={"app": "trainer"}))

    twin.act(victim)
    twin.act(_coordinate(5))
    twin.act(_ack("victim", 9))
    clock.now += 600
    totals = twin.act(_coordinate(5, fresh=True))
    assert totals["escalations"] == 0 and totals["completions"] == 1
    assert state_of(twin.b) == "drain-required"
    annotations = ann(twin.b)
    assert KEYS.checkpoint_escalated_annotation not in annotations
    assert json.loads(annotations[KEYS.checkpoint_manifest_annotation]) == {f"{TRAIN_NS}/victim": 9}
    assert KEYS.checkpoint_start_annotation not in annotations


@pytest.mark.parametrize("machines", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_disabled_spec_advances_parked_nodes(twin_of, machines):
    """The arc withdrawn in the middle: a node held in checkpoint-required
    goes on to the eviction path with its clock cleared; across the two
    machines too."""
    twin = twin_of()
    twin.workload_step()
    twin.act(lambda side, m: side.set_node(m, state="checkpoint-required"))
    twin.one_pass(checkpoint_policy(), machine=machines[0], workload=False)
    assert KEYS.checkpoint_start_annotation in ann(twin.b)
    twin.one_pass(checkpoint_policy(enable=False), machine=machines[1], workload=False)
    assert state_of(twin.b) == "drain-required"
    assert KEYS.checkpoint_start_annotation not in ann(twin.b)


def test_verify_restore_false_skips_verification(twin_of):
    def delete_checkpoints(p, side):
        for o in side.cluster.list(WORKLOAD_CHECKPOINT_KIND, namespace=TRAIN_NS):
            side.cluster.delete(WORKLOAD_CHECKPOINT_KIND, o.name, TRAIN_NS)

    twin = rolled(twin_of(), checkpoint_policy(verifyRestore=False), after=delete_checkpoints)
    totals = twin.totals()
    assert totals["completions"] == 1
    assert totals["restores_verified"] == 0
    assert totals["restore_escalations"] == 0
    assert KEYS.checkpoint_manifest_annotation not in ann(twin.b)


def test_restore_deferral_does_not_burn_validation_clock(twin_of):
    twin = twin_of(Scenario(validation_hook=True))
    twin.act(lambda side, m: side.set_node(m, **{
        KEYS.checkpoint_manifest_annotation: json.dumps({f"{TRAIN_NS}/ghost": 5}),
        KEYS.validation_start_annotation: "1",
    }))
    passed = twin.act(lambda side, m: side.machines[m].common.validation_manager.validate(
        side.node(m)))
    assert passed is False
    annotations = ann(twin.b)
    assert KEYS.validation_start_annotation not in annotations
    assert KEYS.validation_failed_annotation not in annotations
    assert twin.b.hook_calls == []


def test_no_eligible_pods_completes_trivially(twin_of):
    twin = twin_of()
    twin.act(lambda side, m: side.set_node(m, state="checkpoint-required"))
    twin.one_pass(checkpoint_policy(), workload=False)
    assert state_of(twin.b) == "drain-required"
    assert twin.totals()["completions"] == 1


# ----------------------------------------------------------------------
# TestRestoreVerifiedUncordon
# ----------------------------------------------------------------------


def _manifest(manifest):
    value = manifest if isinstance(manifest, str) else json.dumps(manifest)
    return lambda side, m: side.set_node(m, **{KEYS.checkpoint_manifest_annotation: value})


def _restore_gate(side, machine):
    return side.cm(machine).restore_gate(side.node(machine))


def test_missing_checkpoint_defers_then_degrades(twin_of, clock):
    twin = twin_of()
    twin.act(_manifest({f"{TRAIN_NS}/ghost": 5}))
    assert twin.act(_restore_gate) is False
    assert twin.act(_restore_gate) is False
    clock.now += RESTORE_VERIFY_TIMEOUT_SECONDS + 1
    assert twin.act(_restore_gate) is True
    totals = twin.totals()
    assert totals["restore_escalations"] == 1
    assert totals["restores_verified"] == 0
    assert KEYS.checkpoint_manifest_annotation not in ann(twin.b)


def test_checkpoint_older_than_manifest_defers(twin_of):
    twin = twin_of()
    def checkpoint_at_3(side, machine):
        side.cluster.create(JaxKubeObject(
            jax_make_workload_checkpoint("victim", TRAIN_NS, "node-0", step=3)))

    def checkpoint_again_at_9(side, machine):
        side.cluster.patch(WORKLOAD_CHECKPOINT_KIND, workload_checkpoint_name("victim"),
                           TRAIN_NS, patch={"spec": {"step": 9}})

    twin.act(checkpoint_at_3)
    twin.act(_manifest({f"{TRAIN_NS}/victim": 9}))
    assert twin.act(_restore_gate) is False
    twin.act(checkpoint_again_at_9)
    assert twin.act(_restore_gate) is True
    assert twin.totals()["restores_verified"] == 1


@pytest.mark.parametrize("manifest", ["not-json", "[1, 2]"])
def test_corrupt_manifest_clears_and_proceeds(twin_of, manifest):
    twin = twin_of()
    twin.act(_manifest(manifest))
    assert twin.act(_restore_gate) is True
    assert KEYS.checkpoint_manifest_annotation not in ann(twin.b)


def test_failed_recovery_routes_through_restore_gate(twin_of):
    """A failed node with a manifest recovers through the validation
    bucket, where the restore gate verifies and retires the manifest."""
    twin = twin_of()
    twin.workload_step()

    def settle_driver(side, machine):
        side.sim.step()

    twin.act(settle_driver)

    def checkpointed_then_failed(side, machine):
        node = side.node(machine)
        side.machines[machine].common.cordon_manager.cordon(node)
        pod = side.workload.workload("node-0").pod_name
        side.cluster.create(JaxKubeObject(jax_make_workload_checkpoint(
            pod, TRAIN_NS, "node-0", step=4)))
        side.set_node(machine, state="upgrade-failed", **{
            KEYS.checkpoint_manifest_annotation: json.dumps({f"{TRAIN_NS}/{pod}": 4})})

    twin.act(checkpointed_then_failed)
    twin.one_pass(checkpoint_policy(), workload=False)
    assert state_of(twin.b) == "validation-required"
    twin.one_pass(checkpoint_policy(), workload=False)
    assert KEYS.checkpoint_manifest_annotation not in ann(twin.b)
    assert twin.totals()["restores_verified"] == 1


def test_manifest_routes_pod_restart_through_validation_bucket(twin_of):
    twin = twin_of()
    assert not twin.b.machines["port"].is_validation_enabled()
    rolled(twin)
    assert "validation-required" in twin.seen_states()
    assert twin.totals()["restores_verified"] == 1


# ----------------------------------------------------------------------
# TestObservability (the gauge family waits for UpgradeMetrics, A15)
# ----------------------------------------------------------------------


def test_pass_stats_count_the_arc(twin_of):
    twin = twin_of()
    twin.workload_step()
    twin.act(lambda side, m: side.set_node(m, state="checkpoint-required"))
    out = twin.one_pass(checkpoint_policy(), workload=False)
    assert out["pass"]["checkpoint_requests_issued"] == 1
    assert out["pass"]["checkpoint_nodes_waiting"] == 1
    out = twin.one_pass(checkpoint_policy())  # the workload acks first
    assert out["pass"]["checkpoint_completions"] == 1
    assert out["pass"]["checkpoint_nodes_waiting"] == 0
    assert out["lifetime"]["checkpoints_completed_total"] == 1


@pytest.mark.parametrize(
    "annotations, wanted",
    [
        ({KEYS.checkpoint_manifest_annotation: json.dumps({f"{TRAIN_NS}/victim": 3})},
         "Scheduling checkpoint-coordinated drain of the node"),
        ({KEYS.checkpoint_escalated_annotation: "true"},
         "Scheduling drain of the node (checkpoint deadline escalated - plain drain)"),
        ({}, "Scheduling drain of the node"),
    ],
    ids=["coordinated", "escalated", "plain"],
)
def test_drain_event_distinguishes_flavors(twin_of, annotations, wanted):
    twin = twin_of()
    twin.act(lambda side, m: side.set_node(m, state="drain-required", **annotations))
    twin.one_pass(checkpoint_policy(), workload=False)
    assert wanted in [e[3] for e in twin.b.recorder.events]


# ----------------------------------------------------------------------
# TestCrossFileStateEnumerations
# ----------------------------------------------------------------------


def test_checkpoint_required_is_a_gang_consumer_state():
    assert str(UpgradeState.CHECKPOINT_REQUIRED) in _GANG_CONSUMER_STATES
    assert _GANG_CONSUMER_STATES == JAX_GANG_STATES


# ----------------------------------------------------------------------
# Beyond the JAX file: the wait for jobs, pod deletion, the handoffs
# ----------------------------------------------------------------------


def test_wait_for_jobs_with_a_selector_routes_through_the_arc(twin_of):
    """The batch job on node-0 finishes after pass 5: the wait's completion
    path goes on to checkpoint-required."""
    def finish_job(p, side):
        if p == 5:
            side.cluster.patch("Pod", "batch-node-0", "default",
                               patch={"status": {"phase": "Succeeded"}})

    twin = rolled(twin_of(Scenario(batch_jobs=("node-0",))),
                  checkpoint_policy(waitForCompletion={"podSelector": "app=batch"}),
                  after=finish_job)
    states = [step["nodes"]["node-0"][0] for step in twin.trajectory]
    assert states[5] == "wait-for-jobs-required"  # held by the job
    assert states.index("checkpoint-required") == 6
    assert twin.totals()["completions"] == 1


def test_wait_for_jobs_timeout_routes_through_the_arc(twin_of):
    """A job that never finishes: the wait's timeout path goes on to
    checkpoint-required too."""
    twin = rolled(
        twin_of(Scenario(batch_jobs=("node-0",))),
        checkpoint_policy(waitForCompletion={"podSelector": "app=batch", "timeoutSeconds": 25}),
    )
    assert "checkpoint-required" in twin.seen_states()
    assert twin.totals()["completions"] == 1


def test_pod_deletion_follows_the_arc(twin_of):
    """With pod deletion on, the arc hands the node to pod deletion, which
    deletes the checkpointed training pod before the drain."""
    twin = rolled(twin_of(Scenario(pod_deletion=True)),
                  checkpoint_policy(podDeletion={"force": True, "timeoutSeconds": 30}))
    states = [step["nodes"]["node-0"][0] for step in twin.trajectory]
    i = states.index("checkpoint-required")
    assert "pod-deletion-required" in states[i:]
    assert twin.totals()["restores_verified"] == 1
    assert twin.b.workload.workload("node-0").restarts == 1


@pytest.mark.parametrize("k", [2, 4, 6])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_one_machine_finishes_the_others_arc(twin_of, first, k):
    """B runs ``first``'s machine for ``k`` passes and the other's after:
    every pass equals the JAX-only roll on A, and the two machines' totals
    on B add up to A's."""
    second = "port" if first == "jax" else "jax"
    twin = rolled(twin_of(Scenario(nodes=2, ack_delay=2)),
                  schedule=lambda p: first if p < k else second)
    assert twin.machines_used() == {"jax", "port"}
    assert twin.totals()["restores_verified"] == 2
    assert twin.b.workload.lost_steps() < twin.b.workload.total_steps()


# ----------------------------------------------------------------------
# The simulators, the kind and the contract's pure parts
# ----------------------------------------------------------------------


def test_port_simulator_equals_jax_simulator_tick_by_tick(twin_of):
    """Requests, acks (delayed), an eviction, a cordon and the reschedule,
    written by hand on both clusters: the two simulators keep equal."""
    twin = twin_of(Scenario(nodes=2, ack_delay=2, nonacking=("node-1",)))

    def request(epoch):
        def fn(side, machine):
            for node in ("node-0", "node-1"):
                side.cluster.patch("Pod", side.workload.workload(node).pod_name, TRAIN_NS,
                                   patch={"metadata": {"annotations": {
                                       KEYS.checkpoint_request_annotation: epoch}}})
        return fn

    def evict(side, machine):
        side.cluster.patch("Node", "node-0", patch={"spec": {"unschedulable": True}})
        side.cluster.delete("Pod", side.workload.workload("node-0").pod_name, TRAIN_NS)

    def uncordon(side, machine):
        side.cluster.patch("Node", "node-0", patch={"spec": {"unschedulable": False}})

    for action in [None, None, request("100"), None, None, None, evict, None, None, uncordon,
                   None, None, request("200"), None, None]:
        if action is not None:
            twin.act(action)
        twin.workload_step()
    w = twin.b.workload.workload("node-0")
    assert w.restarts == 1 and w.base_step > 0
    assert w.lost_steps == twin.a.workload.workload("node-0").lost_steps > 0
    assert twin.b.observe()["checkpoints"].keys() == {f"{TRAIN_NS}/train-node-0-checkpoint"}


def test_rest_client_serves_workload_checkpoints():
    cluster = FakeCluster()
    with LocalApiServer(cluster=cluster) as server:
        rest = RestClient(RestConfig(server=server.url))
        rest.create(KubeObject(make_workload_checkpoint("p", TRAIN_NS, "node-0", step=4)))
        got = rest.get(WORKLOAD_CHECKPOINT_KIND, workload_checkpoint_name("p"), TRAIN_NS)
        assert workload_checkpoint_step(got.raw) == 4
        assert cluster.get(WORKLOAD_CHECKPOINT_KIND, "p-checkpoint", TRAIN_NS).raw["spec"] == \
            got.raw["spec"]
        assert [o.name for o in rest.list(WORKLOAD_CHECKPOINT_KIND, namespace=TRAIN_NS)] == \
            ["p-checkpoint"]
    assert RESOURCES[WORKLOAD_CHECKPOINT_KIND] == (
        WORKLOAD_CHECKPOINT_API_VERSION, "workloadcheckpoints", True)


@pytest.mark.parametrize(
    "raw",
    [
        make_workload_checkpoint("p", TRAIN_NS, "n", step=7, request_id="12"),
        {"spec": {"step": "11"}},
        {"spec": {"step": "eleven"}},
        {"spec": {"step": None}},
        {"spec": None},
        {},
    ],
    ids=["made", "string", "malformed", "none", "no-spec", "empty"],
)
def test_workload_checkpoint_step_equals_jax(raw):
    assert workload_checkpoint_step(raw) == jax_workload_checkpoint_step(raw)
    if raw.get("spec") is None or raw["spec"].get("step") in (None, "eleven"):
        assert workload_checkpoint_step(raw) == -1


def test_workload_checkpoint_objects_equal_jax():
    args = ("pod-a", TRAIN_NS, "node-0")
    assert make_workload_checkpoint(*args, step=3, request_id="9") == \
        jax_make_workload_checkpoint(*args, step=3, request_id="9")


# ----------------------------------------------------------------------
# TestSpecValidation
# ----------------------------------------------------------------------


def test_round_trip():
    doc = checkpoint_policy(timeout_seconds=120)
    restored = DriverUpgradePolicySpec.from_dict(DriverUpgradePolicySpec.from_dict(doc).to_dict())
    assert restored.checkpoint.timeout_seconds == 120
    assert restored.checkpoint.verify_restore is True
    assert restored.to_dict() == JaxPolicy.from_dict(doc).to_dict()


@pytest.mark.parametrize(
    "doc",
    [{"enable": True, "podSelector": "app=x", "timeoutSeconds": 0},
     {"enable": True, "podSelector": "app=x", "timeoutSeconds": -5},
     {"enable": True}],
    ids=["zero-deadline", "negative-deadline", "enabled-without-selector"],
)
def test_invalid_specs_are_rejected_like_jax(doc):
    with pytest.raises(ValueError):
        JaxCheckpointSpec.from_dict(doc)
    with pytest.raises(ValueError):
        CheckpointSpec.from_dict(doc)


def test_enabled_without_selector_rejected():
    with pytest.raises(ValueError):
        CheckpointSpec(enable=True)
    assert CheckpointSpec().pod_selector == ""


def test_absent_checkpoint_key_keeps_legacy_shape():
    d = DriverUpgradePolicySpec(auto_upgrade=True).to_dict()
    assert "checkpoint" not in d
    assert DriverUpgradePolicySpec.from_dict(d).checkpoint is None


# ----------------------------------------------------------------------
# chip_smoke.py's checkpoint_roll phase, rehearsed on the CPU
# ----------------------------------------------------------------------

#: The trainer's model at a width the CPU takes in milliseconds.
SMALL = BurninConfig(vocab=64, d_model=32, n_heads=2, d_ff=64, n_layers=1, seq_len=16, batch=2)


def test_trainer_saves_restores_and_replays_on_the_cpu(tmp_path):
    """The card test's trainer, at a small width on the CPU: the steps
    trained again are the simulator's lost steps, and the restore equals
    the save (parameters and first loss); on the CPU every step trained
    again repeats its first loss too."""
    workload, trainer = save_restore_replay("cpu", SMALL, tmp_path)
    check_save_restore_replay(workload, trainer)
    assert all(not job.replay_loss_diffs for job in trainer.jobs.values())


def test_chip_smoke_checkpoint_roll_runs_on_the_cpu(monkeypatch, tmp_path):
    """The checkpoint phase's pool, machine, simulator, trainer, kubelet and
    pass loop (``roll_pool``, ``checkpoint_roll``, ``check_checkpoint_roll``
    over ``DictClient``), with node labels that need no card, validation
    off and the trainer on the CPU at a small width: both nodes go through
    the arc, their checkpoints verified and their jobs restored."""
    from k8s_operator_libs_tpu_torch.parallel import topology

    smoke = chip_smoke_module()
    monkeypatch.setattr(topology, "local_gpu_labels", lambda: {
        "nvidia.com/gpu.present": "true", "nvidia.com/gpu.count": "1",
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
    })
    monkeypatch.setattr(smoke, "ROLL_PASS_INTERVAL_S", 0.0)
    nodes = smoke.CHECKPOINT_NODES
    client = smoke.DictClient()
    installer = smoke.roll_pool(client, nodes)
    recorder = smoke.EventLog()
    mgr = ClusterUpgradeStateManager(client, DeviceClass.nvidia("gpu"),
                                     runner=TaskRunner(inline=True), recorder=recorder)
    workload = CheckpointingWorkloadSimulator(client, mgr.keys, namespace=smoke.TRAINING_NS,
                                              name="trainer")
    trainer = smoke.Trainer(client, workload, mgr.keys, SMALL, "cpu", smoke.TRAINER_SEED,
                            str(tmp_path), nodes)
    kubelet = smoke.RollKubelet(client, installer, nodes, "", {}, {})
    run = smoke.checkpoint_roll(client, mgr, installer, kubelet, workload, trainer)
    summary = smoke.check_checkpoint_roll(run, nodes, mgr, workload, trainer, recorder.events)
    assert summary["restarts"] == 2 and 0 < summary["lost_steps"] == summary["retrained_steps"]
    assert summary["pass_stats_summed"]["checkpoint_completions"] == 2
    assert summary["pass_stats_lifetime"]["checkpoint_restores_verified_total"] == 2
    assert sorted(p.name for p in client.list("Pod")) == sorted(
        [f"{installer.name}-{n}" for n in nodes] + [f"trainer-{n}" for n in nodes]
    )
