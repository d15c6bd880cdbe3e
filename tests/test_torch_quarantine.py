"""The port's quarantine arc, held pass by pass against the JAX machine's.

Two in-memory clusters of the JAX package are built alike: GPU nodes, a
driver DaemonSet settled on them. Cluster A is reconciled by the JAX
``ClusterUpgradeStateManager`` over the cluster itself, its health read by
the JAX ``HealthSource``. Cluster B is reconciled by the port's manager
over the port's ``RestClient`` and a ``LocalApiServer`` serving B, its
health read by the port's ``HealthSource`` over that client; B also has a
JAX machine with its own JAX ``HealthSource``, for the cases where one
machine finishes an arc the other began. The same NodeHealthReports are
published into both clusters by the JAX ``ReportPublisher``. One virtual
clock feeds every quarantine manager's ``_now``, both packages'
``utils.faultpoints`` and the publishers, and the tests advance it past
the backoff and hand-off deadlines: no case sleeps for a clock.

Before each pass every health source must hold its cluster's reports as
they are, and all sources of both clusters must have counted the same
number of report updates (a bounded wait of at most ``SYNC_S`` seconds that
fails with what it saw). After each pass these must be equal on A and B: every
node's state label, cordon bit and upgrade annotations (the three
quarantine clocks among them), the events' messages, the quarantine
managers' ``totals()``, the pass's ``state.node_health`` (score, trend,
checks and links of each node) and whether the pass raised.

The cases are those of ``tests/test_quarantine.py``, each named after its
JAX counterpart, ``TestQuarantineLinkAware`` of
``tests/test_link_health.py`` on the virtual clock, and one machine
finishing the other's arc, both ways.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import pytest

from builders import make_node
from k8s_operator_libs_tpu.api import DriverUpgradePolicySpec as JaxPolicy
from k8s_operator_libs_tpu.api.telemetry_v1alpha1 import (
    parse_node_health as jax_parse_node_health,
)
from k8s_operator_libs_tpu.kube import ApiError as JaxApiError
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube import Node as JaxNode
from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator
from k8s_operator_libs_tpu.tpu.monitor import ReportPublisher as JaxReportPublisher
from k8s_operator_libs_tpu.upgrade import ClusterUpgradeStateManager as JaxManager
from k8s_operator_libs_tpu.upgrade import DeviceClass as JaxDeviceClass
from k8s_operator_libs_tpu.upgrade import TaskRunner as JaxRunner
from k8s_operator_libs_tpu.upgrade import UpgradeState as JaxState
from k8s_operator_libs_tpu.upgrade import consts as jax_consts
from k8s_operator_libs_tpu.utils import faultpoints as jax_faultpoints
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from k8s_operator_libs_tpu_torch.kube.client import ApiError
from k8s_operator_libs_tpu_torch.kube.objects import Node
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.upgrade import (
    ClusterUpgradeStateManager,
    DeviceClass,
    TaskRunner,
    UpgradeKeys,
    UpgradeState,
)
from k8s_operator_libs_tpu_torch.upgrade import consts
from k8s_operator_libs_tpu_torch.utils import faultpoints

NS = "driver-ns"
LABELS = {"app": "driver"}
KEYS = UpgradeKeys(DeviceClass.nvidia("gpu"))
KEY_PREFIX = f"{KEYS.device.domain}/{KEYS.device.driver}-driver-"
QUARANTINED = str(UpgradeState.QUARANTINED)
#: Seconds a health source may take to see a report write.
SYNC_S = 5.0
#: Past a one-second reprobe backoff on the virtual clock.
PAST_BACKOFF_S = 2.0

SICK = {"ok": True, "latency_s": 5.0, "gbytes_per_s": 1.0}
HEALTHY = {"ok": True, "latency_s": 0.001, "gbytes_per_s": 42.0}
BAD_METRICS = {"ring_gbytes_per_s": 1.0, "probe_latency_s": 120.0}
GOOD_METRICS = {"ring_gbytes_per_s": 45.0, "probe_latency_s": 2.0}


class Clock:
    """The virtual clock every quarantine manager, durable deadline and
    publisher reads."""

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


def quarantine_policy(max_unavailable="25%", max_parallel=0, **spec) -> dict:
    """The JAX tests' ``policy_with_quarantine``, as a policy document."""
    doc = {"enable": True, "unhealthyScore": 50.0, "recoveryScore": 70.0,
           "reprobeBackoffSeconds": 1}
    camel = {"unhealthy_score": "unhealthyScore", "recovery_score": "recoveryScore",
             "reprobe_backoff_seconds": "reprobeBackoffSeconds",
             "max_backoff_seconds": "maxBackoffSeconds",
             "handoff_after_seconds": "handoffAfterSeconds"}
    doc.update({camel[k]: v for k, v in spec.items()})
    return {"autoUpgrade": True, "maxParallelUpgrades": max_parallel,
            "maxUnavailable": max_unavailable, "quarantine": doc}


#: Auto-upgrade on, no quarantine spec.
NO_QUARANTINE = {"autoUpgrade": True, "maxParallelUpgrades": 0, "maxUnavailable": "100%"}


class Recorder:
    def __init__(self) -> None:
        self.events: list[tuple] = []

    def eventf(self, obj, event_type, reason, fmt, *args) -> None:
        self.events.append((obj.name, event_type, reason, fmt % args if args else fmt))


def health_view(node_health) -> Optional[dict]:
    """``state.node_health`` as plain values: score, trend, checks, links."""
    if node_health is None:
        return None
    return {
        name: (h.score, h.trend, dict(h.checks), sorted(
            (peer, link.latency_s, link.gbytes_per_s, link.verdict, tuple(link.window))
            for peer, link in h.links.items()
        ))
        for name, h in node_health.items()
    }


class Side:
    """One cluster with its DaemonSet, its API server, its machines (A: the
    JAX one; B: the port's over the REST client, and a JAX one) and each
    machine's health source."""

    def __init__(self, nodes: int, role: str, clock: Clock, stack: contextlib.ExitStack,
                 telemetry: bool = True) -> None:
        self.role = role
        self.clock = clock
        self.cluster = FakeCluster()
        for i in range(nodes):
            self.cluster.create(make_node(f"node-{i}"))
        self.sim = DaemonSetSimulator(self.cluster, name="driver", namespace=NS,
                                      match_labels=LABELS)
        self.sim.settle()
        server = stack.enter_context(LocalApiServer(cluster=self.cluster))
        self.rest = RestClient(RestConfig(server=server.url))
        self.recorder = Recorder()
        self.machines = {"jax": JaxManager(self.cluster, JaxDeviceClass.nvidia("gpu"),
                                           runner=JaxRunner(inline=True),
                                           recorder=self.recorder)}
        if role == "port":
            self.machines["port"] = ClusterUpgradeStateManager(
                self.rest, DeviceClass.nvidia("gpu"), runner=TaskRunner(inline=True),
                recorder=self.recorder,
            )
        self.sources = {}
        for name, mgr in self.machines.items():
            mgr.common.quarantine_manager._now = clock.wall
            if telemetry:
                self.sources[name] = mgr.with_health_telemetry()
                stack.callback(self.sources[name].stop)
        self.last_machine = "jax"

    # -- what the tests do to a cluster ---------------------------------------
    def publish(self, node: str, checks: dict, metrics: dict, links=None) -> None:
        written = JaxReportPublisher(self.cluster, node, heartbeat_seconds=0.0,
                                     now=self.clock.wall).publish(checks, metrics, links=links)
        assert written

    def delete_report(self, node: str) -> None:
        self.cluster.delete("NodeHealthReport", node)

    def node(self, machine: str, name: str):
        if machine == "jax":
            return JaxNode(self.cluster.get("Node", name).raw)
        return Node(self.rest.get("Node", name).raw)

    def update_node(self, name: str, fn) -> None:
        node = JaxNode(self.cluster.get("Node", name).raw)
        fn(node)
        self.cluster.update(node)

    def seen(self) -> dict:
        return {name: source.updates for name, source in self.sources.items()}

    def caught_up(self) -> bool:
        """Every source holds the cluster's reports as they are now."""
        want = health_view({
            o.name: jax_parse_node_health(o.raw) for o in self.cluster.list("NodeHealthReport")
        })
        return all(health_view(src.snapshot()) == want for src in self.sources.values())

    # -- one pass ---------------------------------------------------------------
    def one_pass(self, machine: str, policy: dict) -> dict:
        self.last_machine = machine
        mgr = self.machines[machine]
        pol = (JaxPolicy if machine == "jax" else DriverUpgradePolicySpec).from_dict(policy)
        state = mgr.build_state(NS, LABELS)
        try:
            mgr.apply_state(state, pol)
            raised = False
        except (ApiError, JaxApiError):
            raised = True
        return {"raised": raised, "health": health_view(state.node_health)}

    # -- what is compared -------------------------------------------------------
    def totals(self) -> dict:
        """The lifetime counters summed over this side's machines (an arc
        one machine began and the other finished counts once), and the
        gauge of the machine that ran the last pass."""
        each = [mgr.common.quarantine_manager.totals() for mgr in self.machines.values()]
        out = {k: sum(t[k] for t in each) for k in ("entered", "released", "handed_off",
                                                     "budget_denied")}
        last = self.machines[self.last_machine].common.quarantine_manager.totals()
        out["in_quarantine"] = last["in_quarantine"]
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
        return {
            "nodes": nodes,
            "events": [e[3] for e in self.recorder.events],
            "totals": self.totals(),
        }

    def state_of(self, name: str) -> str:
        return self.observe()["nodes"][name][0]


class Twin:
    """A (the JAX machine) and B (the port's, or the JAX one where a case
    says so), compared after every step."""

    def __init__(self, nodes: int, clock: Clock, stack: contextlib.ExitStack,
                 telemetry: bool = True) -> None:
        self.clock = clock
        self.a = Side(nodes, "jax", clock, stack, telemetry)
        self.b = Side(nodes, "port", clock, stack, telemetry)
        self.passes: list[dict] = []

    def sides(self):
        return (self.a, self.b)

    def sync(self) -> None:
        """Every source holds its cluster's reports, and all counted the same
        updates, within ``SYNC_S`` seconds."""
        deadline = time.monotonic() + SYNC_S
        while True:
            seen = {side.role: side.seen() for side in self.sides()}
            counts = {count for side in seen.values() for count in side.values()}
            if len(counts) <= 1 and all(side.caught_up() for side in self.sides()):
                return
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"health sources saw {seen} report updates; caught up: "
                    f"{[side.caught_up() for side in self.sides()]}"
                )
            time.sleep(0.01)

    def compare(self, what: str) -> dict:
        obs_a, obs_b = self.a.observe(), self.b.observe()
        assert obs_a == obs_b, what
        return obs_b

    def publish(self, node: str, bad: bool = True, checks=None, metrics=None, links=None) -> None:
        """The JAX tests' ``publish``: a bad report (a failed check, low ring
        bandwidth, a slow battery) or a good one, into both clusters."""
        if checks is None:
            checks = {"ring_allreduce": not bad}
        if metrics is None:
            metrics = BAD_METRICS if bad else GOOD_METRICS
        for side in self.sides():
            side.publish(node, checks, metrics, links=links)
        self.sync()

    def delete_report(self, node: str) -> None:
        for side in self.sides():
            side.delete_report(node)
        self.sync()

    def update_node(self, name: str, fn) -> None:
        for side in self.sides():
            side.update_node(name, fn)
        self.compare(f"after updating {name}")

    def act(self, fn, machine: str = "port"):
        """``fn(side, machine)`` on A with the JAX machine and on B with
        ``machine``; equal clusters after."""
        out_a, out_b = fn(self.a, "jax"), fn(self.b, machine)
        assert out_a == out_b, (out_a, out_b)
        self.compare(f"after {getattr(fn, '__name__', fn)}")
        return out_b

    def one_pass(self, policy: dict, machine: str = "port") -> dict:
        self.sync()
        p = len(self.passes)
        out_a = self.a.one_pass("jax", policy)
        out_b = self.b.one_pass(machine, policy)
        assert out_a == out_b, f"pass {p}"
        self.passes.append(out_b)
        self.compare(f"pass {p}")
        return out_b

    def reconcile(self, policy: dict, passes: int = 1, machine: str = "port") -> None:
        for _ in range(passes):
            self.one_pass(policy, machine)

    def rollout(self, template_hash: str = "rev-2") -> None:
        for side in self.sides():
            side.sim.set_template_hash(template_hash)
            side.sim.step()
        self.compare("rollout")

    # -- what the JAX tests read, on B --------------------------------------------
    def state_of(self, name: str) -> str:
        return self.b.state_of(name)

    def node(self, name: str) -> Node:
        return self.b.node("port", name)

    def totals(self) -> dict:
        return self.b.totals()

    def messages(self) -> list[str]:
        return self.b.observe()["events"]


@pytest.fixture
def twin_of(clock):
    with contextlib.ExitStack() as stack:
        yield lambda nodes=4, telemetry=True: Twin(nodes, clock, stack, telemetry)


# ----------------------------------------------------------------------
# TestAdmission
# ----------------------------------------------------------------------


def test_degraded_idle_node_is_cordoned_into_quarantine(twin_of):
    h = twin_of()
    policy = quarantine_policy()
    h.reconcile(policy)  # everyone classified done
    h.publish("node-1", bad=True)
    h.reconcile(policy)
    node = h.node("node-1")
    assert node.labels[KEYS.state_label] == QUARANTINED
    assert node.unschedulable
    assert KEYS.quarantine_start_annotation in node.annotations
    assert KEYS.quarantine_recheck_annotation in node.annotations
    assert any("quarantined" in m for m in h.messages())
    totals = h.totals()
    assert totals["entered"] == 1
    assert totals["in_quarantine"] == 1


def test_admission_is_budget_bounded(twin_of):
    """Six degraded reports, a 25% budget on 8 nodes: 2 slots, so exactly 2
    quarantined (the worst first) and the rest counted denied."""
    h = twin_of(nodes=8)
    policy = quarantine_policy(max_unavailable="25%")
    h.reconcile(policy)
    for i in range(6):
        h.publish(f"node-{i}", bad=True)
    h.reconcile(policy, passes=2)
    quarantined = [f"node-{i}" for i in range(8) if h.state_of(f"node-{i}") == QUARANTINED]
    assert len(quarantined) == 2
    assert sum(1 for i in range(8) if h.node(f"node-{i}").unschedulable) == 2
    totals = h.totals()
    assert totals["entered"] == 2
    assert totals["budget_denied"] >= 4


def test_skip_labeled_and_cordoned_nodes_are_not_admitted(twin_of):
    h = twin_of()
    policy = quarantine_policy()
    h.reconcile(policy)
    h.update_node("node-1", lambda n: n.labels.__setitem__(KEYS.skip_label, "true"))

    def cordon(n):
        n.unschedulable = True

    h.update_node("node-2", cordon)
    h.publish("node-1", bad=True)
    h.publish("node-2", bad=True)
    h.reconcile(policy, passes=2)
    assert h.state_of("node-1") != QUARANTINED
    assert h.state_of("node-2") != QUARANTINED
    assert h.totals()["entered"] == 0


def test_mid_roll_nodes_are_not_admitted(twin_of):
    """Outside any roll: only idle (unknown or done) nodes are candidates."""
    h = twin_of()
    policy = quarantine_policy()
    h.reconcile(policy)
    h.publish("node-1", bad=True)

    def mid_roll(side, machine):
        state = (JaxState if machine == "jax" else UpgradeState).WAIT_FOR_JOBS_REQUIRED
        side.machines[machine].provider.change_node_upgrade_state(
            side.node(machine, "node-1"), state
        )

    h.act(mid_roll)
    h.reconcile(policy)
    assert h.state_of("node-1") != QUARANTINED


def test_no_quarantine_without_telemetry_or_spec(twin_of):
    # The spec on, no health source: nothing is admitted.
    bare = twin_of(nodes=2, telemetry=False)
    bare.reconcile(quarantine_policy())
    assert bare.passes[-1]["health"] is None
    assert bare.totals()["entered"] == 0
    # A health source, no spec: nothing either.
    h = twin_of()
    h.publish("node-1", bad=True)
    h.reconcile(NO_QUARANTINE, passes=2)
    assert h.state_of("node-1") in ("", "upgrade-done")
    assert h.passes[-1]["health"]["node-1"][0] < 50.0


# ----------------------------------------------------------------------
# TestLifecycle
# ----------------------------------------------------------------------


def test_recovery_releases_and_reclassifies(twin_of, clock):
    h = twin_of()
    policy = quarantine_policy(reprobe_backoff_seconds=1)
    h.reconcile(policy)
    h.publish("node-1", bad=True)
    h.reconcile(policy)
    assert h.state_of("node-1") == QUARANTINED
    h.publish("node-1", bad=False)
    clock.now += PAST_BACKOFF_S
    h.reconcile(policy)  # release
    h.reconcile(policy)  # unknown -> done
    node = h.node("node-1")
    assert node.labels[KEYS.state_label] == "upgrade-done"
    assert not node.unschedulable
    assert KEYS.quarantine_start_annotation not in node.annotations
    totals = h.totals()
    assert totals["released"] == 1
    assert totals["in_quarantine"] == 0


def test_hysteresis_keeps_borderline_node_quarantined(twin_of, clock):
    """A score between the entry and the recovery thresholds stays in."""
    h = twin_of()
    policy = quarantine_policy(unhealthy_score=50.0, recovery_score=90.0,
                               reprobe_backoff_seconds=1)
    h.reconcile(policy)
    h.publish("node-1", bad=True)
    h.reconcile(policy)
    h.publish("node-1", checks={"ring_allreduce": True, "mxu": False}, metrics=GOOD_METRICS)
    clock.now += PAST_BACKOFF_S
    h.reconcile(policy, passes=2)
    assert 50.0 < h.passes[-1]["health"]["node-1"][0] < 90.0
    assert h.state_of("node-1") == QUARANTINED


def test_backoff_doubles_and_caps(twin_of, clock):
    clock.now = 1000.0
    h = twin_of()
    policy = quarantine_policy(reprobe_backoff_seconds=10, max_backoff_seconds=25)
    h.reconcile(policy)
    h.publish("node-1", bad=True)
    h.reconcile(policy)  # enter: backoff 10, recheck at 1010
    node = h.node("node-1")
    assert node.annotations[KEYS.quarantine_backoff_annotation] == "10"
    assert node.annotations[KEYS.quarantine_recheck_annotation] == "1010"
    clock.now = 1005.0
    h.reconcile(policy)  # not due: nothing moves
    assert h.node("node-1").annotations[KEYS.quarantine_backoff_annotation] == "10"
    clock.now = 1011.0
    h.reconcile(policy)  # due, still bad: backoff 20
    node = h.node("node-1")
    assert node.annotations[KEYS.quarantine_backoff_annotation] == "20"
    assert node.annotations[KEYS.quarantine_recheck_annotation] == "1031"
    clock.now = 1032.0
    h.reconcile(policy)  # due again: capped at 25
    assert h.node("node-1").annotations[KEYS.quarantine_backoff_annotation] == "25"


def test_missing_report_is_not_recovery(twin_of, clock):
    """No report does not release a quarantined node: a crashed publisher
    on a sick node is the likeliest case."""
    h = twin_of()
    policy = quarantine_policy(reprobe_backoff_seconds=1)
    h.reconcile(policy)
    h.publish("node-1", bad=True)
    h.reconcile(policy)
    h.delete_report("node-1")
    clock.now += PAST_BACKOFF_S
    h.reconcile(policy, passes=2)
    assert "node-1" not in h.passes[-1]["health"]
    assert h.state_of("node-1") == QUARANTINED


def test_handoff_to_upgrade_pipeline_after_deadline(twin_of, clock):
    clock.now = 1000.0
    h = twin_of()
    policy = quarantine_policy(reprobe_backoff_seconds=10, handoff_after_seconds=100)
    h.reconcile(policy)
    h.publish("node-1", bad=True)
    h.reconcile(policy)
    clock.now = 1101.0
    h.reconcile(policy)
    node = h.node("node-1")
    # Handed to the roll: upgrade-required, still cordoned, clocks cleared.
    assert node.labels[KEYS.state_label] == str(UpgradeState.UPGRADE_REQUIRED)
    assert node.unschedulable
    assert KEYS.quarantine_start_annotation not in node.annotations
    totals = h.totals()
    assert totals["handed_off"] == 1
    assert totals["in_quarantine"] == 0
    assert any("handed" in m for m in h.messages())


def test_withdrawn_policy_releases_parked_nodes(twin_of):
    h = twin_of()
    policy = quarantine_policy()
    h.reconcile(policy)
    h.publish("node-1", bad=True)
    h.reconcile(policy)
    assert h.state_of("node-1") == QUARANTINED
    h.reconcile(NO_QUARANTINE, passes=2)
    node = h.node("node-1")
    assert not node.unschedulable
    assert node.labels[KEYS.state_label] == "upgrade-done"
    assert KEYS.quarantine_recheck_annotation not in node.annotations


# ----------------------------------------------------------------------
# TestBudgetCoupling
# ----------------------------------------------------------------------


def test_quarantined_nodes_consume_upgrade_budget(twin_of):
    """A quarantined (cordoned) node counts unavailable, so quarantine and
    the roll together stay within maxUnavailable."""
    h = twin_of(nodes=4)
    policy = quarantine_policy(max_unavailable="25%")
    h.reconcile(policy)
    h.publish("node-0", bad=True)
    h.reconcile(policy)
    assert h.state_of("node-0") == QUARANTINED
    # A rollout lands; the one slot of 4 is the quarantined node's.
    h.rollout()
    h.reconcile(policy, passes=2)
    started = [
        f"node-{i}" for i in range(4)
        if h.state_of(f"node-{i}") not in ("", "upgrade-done", "upgrade-required", QUARANTINED)
    ]
    assert started == []

    def counts(side, machine):
        mgr = side.machines[machine]
        state = mgr.build_state(NS, LABELS)
        return (mgr.get_upgrades_in_progress(state),
                mgr.common.get_current_unavailable_nodes(state))

    # Through the unavailability count, not the in-progress one.
    in_progress, unavailable = h.act(counts)
    assert in_progress == 0
    assert unavailable >= 1


def test_quarantine_does_not_eat_parallel_slots(twin_of):
    """With room in the unavailability budget a rollout starts while a node
    sits in quarantine: the quarantine takes no parallel-upgrade slot."""
    h = twin_of(nodes=4)
    policy = quarantine_policy(max_unavailable="100%", max_parallel=1)
    h.reconcile(policy)
    h.publish("node-0", bad=True)
    h.reconcile(policy)
    assert h.state_of("node-0") == QUARANTINED
    h.rollout()
    h.reconcile(policy, passes=2)
    started = [
        f"node-{i}" for i in range(1, 4)
        if h.state_of(f"node-{i}") not in ("", "upgrade-done", "upgrade-required")
    ]
    assert len(started) == 1


def test_managed_and_partition_accounting():
    """QUARANTINED is managed (it counts in the budget) and idle (cordoned
    capacity, not an upgrade in flight), as in the JAX package."""
    assert UpgradeState.QUARANTINED in consts.MANAGED_STATES
    assert UpgradeState.QUARANTINED not in consts.MAINTENANCE_STATES
    assert UpgradeState.QUARANTINED in consts.IDLE_STATES
    for name in ("MANAGED_STATES", "MAINTENANCE_STATES", "IDLE_STATES"):
        assert {str(s) for s in getattr(consts, name)} == {
            str(s) for s in getattr(jax_consts, name)
        }, name


# ----------------------------------------------------------------------
# TestQuarantineLinkAware (tests/test_link_health.py)
# ----------------------------------------------------------------------

LINK_POLICY = quarantine_policy(max_unavailable="100%")


def test_both_endpoints_quarantine_and_release_on_link_recovery(twin_of, clock):
    h = twin_of(nodes=4)
    for _ in range(3):
        for side in h.sides():
            side.sim.step()
        h.one_pass(LINK_POLICY)
    # One sick link, reported by node-0 only; node-2's report is healthy and
    # node-1 never reports.
    h.publish("node-0", bad=False, links={"node-1": dict(SICK)})
    h.publish("node-2", bad=False, links={"node-3": dict(HEALTHY)})
    h.one_pass(LINK_POLICY)
    states = {f"node-{i}": h.state_of(f"node-{i}") for i in range(4)}
    assert states == {"node-0": QUARANTINED, "node-1": QUARANTINED,
                      "node-2": "upgrade-done", "node-3": "upgrade-done"}
    # Only the link can release them: node-0's own score was always 100.
    h.publish("node-0", bad=False, links={"node-1": dict(HEALTHY)})
    for _ in range(5):
        clock.now += PAST_BACKOFF_S
        h.one_pass(LINK_POLICY)
        if h.totals()["in_quarantine"] == 0:
            break
    assert h.totals() == {"entered": 2, "released": 2, "handed_off": 0, "budget_denied": 0,
                          "in_quarantine": 0}
    assert not any(h.node(f"node-{i}").unschedulable for i in range(4))


# ----------------------------------------------------------------------
# One machine finishes the other's arc
# ----------------------------------------------------------------------


@pytest.mark.parametrize("first, then", [("jax", "port"), ("port", "jax")])
def test_one_machine_finishes_the_others_arc(twin_of, clock, first, then):
    """On B one machine quarantines the node, the other releases it and
    classifies it done; A's JAX machine does the whole arc. The keys and
    the clocks on the node are all either machine needs."""
    h = twin_of()
    policy = quarantine_policy(reprobe_backoff_seconds=1)
    h.reconcile(policy, machine=first)
    h.publish("node-1", bad=True)
    h.reconcile(policy, machine=first)
    assert h.state_of("node-1") == QUARANTINED
    h.publish("node-1", bad=False)
    clock.now += PAST_BACKOFF_S
    h.reconcile(policy, machine=then)
    assert h.state_of("node-1") == ""
    h.reconcile(policy, machine=then)
    assert h.state_of("node-1") == "upgrade-done"
    assert not h.node("node-1").unschedulable
    assert h.totals() == {"entered": 1, "released": 1, "handed_off": 0, "budget_denied": 0,
                          "in_quarantine": 0}


# ----------------------------------------------------------------------
# chip_smoke.py's quarantine phase, rehearsed on the CPU
# ----------------------------------------------------------------------


def test_chip_smoke_quarantine_phase_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The quarantine phase whole (``quarantine_phase`` over ``DictClient``:
    the pool, the machine with health telemetry and validation, the
    kubelet, the arc and its checks), with node labels that need no card,
    two reports like the monitor's (the failing one with its ``mxu`` check
    failed) and each probe pod's payload replaced by a stub: the node is
    quarantined twice, released once, handed off once and rolled to
    ``upgrade-done`` by one probe pod."""
    import json

    from k8s_operator_libs_tpu_torch.api.telemetry_v1alpha1 import (
        make_node_health_report,
        report_history,
    )
    from k8s_operator_libs_tpu_torch.parallel import topology
    from test_torch_cuda import chip_smoke_module

    smoke = chip_smoke_module()
    monkeypatch.setattr(topology, "local_gpu_labels", lambda: {
        "nvidia.com/gpu.present": "true", "nvidia.com/gpu.count": "1",
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
    })
    monkeypatch.setattr(smoke, "ROLL_PASS_INTERVAL_S", 0.0)
    launches = {"matmul": 1165, "flash_attention": 4}
    pods = []

    def probe_pod(container, host_paths, workdir, label):
        pods.append((label, sorted(set(host_paths.values()))))
        return {"seconds_to_ready": 0.0, "launches": dict(launches),
                "build_s": {"matmul": 0.0, "flash_attention": 0.0}}

    monkeypatch.setattr(smoke, "run_probe_pod", probe_pod)
    node = smoke.QUARANTINE_NODES[0]
    metrics = {"probe_latency_s": 12.5, "mxu_tflops": 240.0}
    healthy = make_node_health_report(node, {"all_reduce": True, "mxu": True}, metrics)
    degraded = make_node_health_report(node, {"all_reduce": True, "mxu": False},
                                       {"probe_latency_s": 12.5},
                                       history=report_history(healthy))
    result = smoke.quarantine_phase("cpu", launches, str(tmp_path),
                                    {"healthy": healthy, "degraded": degraded})
    assert result["counters"] == {"entered": 2, "released": 1, "handed_off": 1}
    assert result["totals"] == {"entered": 2, "released": 1, "handed_off": 1,
                                "budget_denied": 0, "in_quarantine": 0}
    # The failing report: one check of two failed, the rest alike.
    assert result["scores"] == {"healthy": 100.0, "degraded": 70.0}
    assert result["thresholds"] == {"unhealthy": 85.0, "recovery": 100.0}
    assert len(pods) == 1 and node in pods[0][0]
    assert pods[0][1] == [str(tmp_path / smoke.ROLL_NODES[0])]
    assert result["pod_launches"] == launches
    labels = [p["label"] for p in result["passes"]]
    assert labels[:8] == ["settle"] * 3 + ["degraded", "recheck", "recovered", "reclassified",
                                          "degraded-again"]
    assert labels[8] == "handoff" and set(labels[9:]) == {"roll"}
    line = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert line[-1]["quarantine"]["healthy_card_score"] == 100.0
