"""The port's rolling-upgrade state machine, held pass by pass against the
JAX machine.

Two in-memory clusters of the JAX package are built alike from one seeded
node list. Cluster A is rolled by the JAX ``ClusterUpgradeStateManager``,
its client the cluster itself. Cluster B is rolled by the port's manager,
its client the port's ``RestClient`` over a ``LocalApiServer`` serving B.
Both use inline task runners and one virtual clock installed in both
packages' ``utils.faultpoints``. Before each pass the JAX
``DaemonSetSimulator`` (and, where validation is on, the
``ValidationPodSimulator``) drives each cluster. After each pass these
must be equal on A and B: every node's state label, cordon bit and
upgrade annotations (their timestamps from the shared clock), the pods
(name, revision, phase), and the snapshot's counters (in progress, done,
failed, pending, total, and the upgrades available).

The handoff tests run one machine for the first passes of a roll on B and
the other for the rest, against a JAX-only roll on A. The refusal tests
pin each arc the port's machine does not run to its ROADMAP item; the
requestor mode runs, held to the JAX machine's in
``tests/test_torch_requestor.py``, and so does the checkpoint arc, in
``tests/test_torch_checkpoint.py``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import pytest

from builders import make_node, make_pod
from k8s_operator_libs_tpu.api import DriverUpgradePolicySpec as JaxPolicy
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator, ValidationPodSimulator
from k8s_operator_libs_tpu.upgrade import ClusterUpgradeStateManager as JaxManager
from k8s_operator_libs_tpu.upgrade import DeviceClass as JaxDeviceClass
from k8s_operator_libs_tpu.upgrade import TaskRunner as JaxRunner
from k8s_operator_libs_tpu.utils import faultpoints as jax_faultpoints
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.parallel.topology import (
    GPU_COUNT_LABEL,
    GPU_PRESENT_LABEL,
    GPU_PRODUCT_LABEL,
)
from k8s_operator_libs_tpu_torch.tpu.validation_pod import ValidationPodManager, ValidationPodSpec
from k8s_operator_libs_tpu_torch.upgrade import (
    ClusterUpgradeStateManager,
    DeviceClass,
    StateOptions,
    TaskRunner,
    UpgradeKeys,
)
from k8s_operator_libs_tpu_torch.utils import faultpoints

NS = "gpu-operator"
LABELS = {"app": "nvidia-driver-daemonset"}
KEYS = UpgradeKeys(DeviceClass.nvidia("gpu"))
KEY_PREFIX = f"{KEYS.device.domain}/{KEYS.device.driver}-driver-"
OLD, NEW = "550.54.15", "560.35.03"
PRODUCTS = ("NVIDIA-H100-80GB-HBM3", "NVIDIA-A100-SXM4-80GB")
PROBE = ValidationPodSpec(namespace=NS)
CRASHING = {
    "phase": "Running",
    "conditions": [{"type": "Ready", "status": "False"}],
    "containerStatuses": [{"name": "driver", "ready": False, "restartCount": 11}],
}
RUNNING = {
    "phase": "Running",
    "conditions": [{"type": "Ready", "status": "True"}],
    "containerStatuses": [{"name": "driver", "ready": True, "restartCount": 11}],
}


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
    return f"gpu-{i:02d}"


@dataclass
class Scenario:
    """One roll, set up alike on both clusters."""

    policy: dict
    nodes: int = 4
    seed: int = 0
    #: Chance that a seeded node runs a workload pod.
    workload_share: float = 0.0
    cordoned: tuple = ()
    skip: tuple = ()
    safe_load: bool = False
    #: Validation timeout seconds; None: validation off.
    validation_timeout: Optional[int] = None
    pod_deletion: Optional[Callable] = None
    #: ``setup(cluster, sim)`` after the pool settled, before the bump.
    setup: Optional[Callable] = None
    #: ``hook(pass_index, side, health)`` before each pass.
    hook: Optional[Callable] = None
    bump: bool = True
    tick_s: float = 10.0
    max_passes: int = 80


def seeded_nodes(sc: Scenario):
    """The pool: GPU facts and workload pods drawn from ``sc.seed``."""
    rng = np.random.default_rng(sc.seed)
    nodes, workloads = [], []
    for i in range(sc.nodes):
        name = node_name(i)
        labels = {
            GPU_PRESENT_LABEL: "true",
            GPU_PRODUCT_LABEL: PRODUCTS[int(rng.integers(len(PRODUCTS)))],
            GPU_COUNT_LABEL: str(int(rng.choice([4, 8]))),
        }
        if name in sc.skip:
            labels[KEYS.skip_label] = "true"
        nodes.append(make_node(name, labels=labels, unschedulable=name in sc.cordoned))
        if rng.random() < sc.workload_share:
            app = ("train", "serve")[int(rng.integers(2))]
            workloads.append(
                make_pod(
                    f"{app}-{name}", namespace="default", node_name=name,
                    labels={"app": app, "evict": "yes" if app == "train" else "no"},
                    controlled=True,
                )
            )
    return nodes, workloads


class Side:
    """One cluster with its simulators, its API server and both machines."""

    def __init__(self, sc: Scenario, health: dict, stack: contextlib.ExitStack) -> None:
        self.sc = sc
        self.cluster = FakeCluster()
        nodes, workloads = seeded_nodes(sc)
        for node in nodes:
            self.cluster.create(node)
        self.sim = DaemonSetSimulator(
            self.cluster, name=LABELS["app"], namespace=NS, match_labels=LABELS,
            initial_hash=OLD,
        )
        self.sim.settle()
        for pod in workloads:
            self.cluster.create(pod)
        if sc.setup is not None:
            sc.setup(self.cluster, self.sim)
        if sc.safe_load:
            self.sim.safe_load_annotation = KEYS.safe_driver_load_annotation
        server = stack.enter_context(LocalApiServer(cluster=self.cluster))
        self.rest = RestClient(RestConfig(server=server.url))
        self.machines = {
            "jax": self._configure(
                JaxManager(self.cluster, JaxDeviceClass.nvidia("gpu"), runner=JaxRunner(inline=True)),
                self.cluster,
            ),
            "port": self._configure(
                ClusterUpgradeStateManager(
                    self.rest, DeviceClass.nvidia("gpu"), runner=TaskRunner(inline=True)
                ),
                self.rest,
            ),
        }
        self.policies = {
            "jax": JaxPolicy.from_dict(sc.policy),
            "port": DriverUpgradePolicySpec.from_dict(sc.policy),
        }
        self.vsim = None
        if sc.validation_timeout is not None:
            self.vsim = ValidationPodSimulator(
                self.cluster, namespace=PROBE.namespace, label_selector=PROBE.pod_selector,
                decide=lambda pod: health.get(pod.node_name, True),
            )
        if sc.bump:
            self.sim.set_template_hash(NEW)

    def _configure(self, mgr, client):
        if self.sc.pod_deletion is not None:
            mgr.with_pod_deletion_enabled(self.sc.pod_deletion)
        if self.sc.validation_timeout is not None:
            mgr.with_validation_enabled(
                pod_provisioner=ValidationPodManager(client, PROBE),
                timeout_seconds=self.sc.validation_timeout,
            )
        return mgr

    def one_pass(self, machine: str) -> dict:
        """A kubelet tick, one pass of ``machine``, a kubelet tick; the
        counters of the pass's snapshot."""
        self.sim.step()
        if self.vsim is not None:
            self.vsim.step()
        mgr, policy = self.machines[machine], self.policies[machine]
        state = mgr.build_state(NS, LABELS)
        total = mgr.get_total_managed_nodes(state)
        counters = {
            "total": total,
            "in_progress": mgr.get_upgrades_in_progress(state),
            "done": mgr.get_upgrades_done(state),
            "failed": mgr.get_upgrades_failed(state),
            "pending": mgr.get_upgrades_pending(state),
            "available": mgr.common.get_upgrades_available(
                state, policy.max_parallel_upgrades, policy.resolved_max_unavailable(total)
            ),
        }
        mgr.apply_state(state, policy)
        self.sim.step()
        return counters

    def observe(self) -> dict:
        nodes = {}
        for n in self.cluster.list("Node"):
            meta = n.raw["metadata"]
            nodes[n.name] = (
                (meta.get("labels") or {}).get(KEYS.state_label, ""),
                bool((n.raw.get("spec") or {}).get("unschedulable", False)),
                {k: v for k, v in (meta.get("annotations") or {}).items() if k.startswith(KEY_PREFIX)},
            )
        pods = sorted(
            (p.namespace, p.name, p.labels.get("controller-revision-hash", ""), p.phase)
            for p in self.cluster.list("Pod")
        )
        return {"nodes": nodes, "pods": pods}

    def states(self) -> dict[str, str]:
        return {name: obs[0] for name, obs in self.observe()["nodes"].items()}

    def settled(self) -> bool:
        states = self.states()
        if any(s != "upgrade-done" for name, s in states.items() if name not in self.sc.skip):
            return False
        return bool(self.sc.skip) or self.sim.all_pods_ready_and_current()


def run_twin(sc: Scenario, clock: Clock, schedule: Callable[[int], str] = lambda p: "port"):
    """Roll A with the JAX machine and B with ``schedule(pass)``'s machine,
    comparing after every pass; the per-pass node states, and both sides."""
    health: dict = {}
    with contextlib.ExitStack() as stack:
        a, b = Side(sc, health, stack), Side(sc, health, stack)
        trajectory = []
        for p in range(sc.max_passes):
            clock.now += sc.tick_s
            if sc.hook is not None:
                for side in (a, b):
                    sc.hook(p, side, health)
            counters_a = a.one_pass("jax")
            counters_b = b.one_pass(schedule(p))
            assert counters_a == counters_b, f"pass {p}"
            obs_a, obs_b = a.observe(), b.observe()
            assert obs_a == obs_b, f"pass {p}"
            trajectory.append(a.states())
            if a.settled() and b.settled():
                return trajectory, a, b
        raise AssertionError(f"no convergence in {sc.max_passes} passes: {a.states()}")


def policy(max_parallel=1, max_unavailable="25%", **extra) -> dict:
    return {
        "autoUpgrade": True,
        "maxParallelUpgrades": max_parallel,
        "maxUnavailable": max_unavailable,
        **extra,
    }


DRAIN = {"drain": {"enable": True, "force": True, "timeoutSeconds": 60}}


def _jobs(setup_nodes):
    def setup(cluster, sim):
        for name in setup_nodes:
            cluster.create(
                make_pod(f"job-{name}", namespace="default", node_name=name,
                         labels={"job": "batch"}, controlled=True)
            )
    return setup


def _finish_jobs_at(k):
    def hook(p, side, health):
        if p == k:
            for pod in side.cluster.list("Pod", namespace="default", label_selector="job=batch"):
                side.cluster.patch("Pod", pod.name, "default", patch={"status": {"phase": "Succeeded"}})
    return hook


def _heal_at(names, k):
    def hook(p, side, health):
        for name in names:
            health[name] = p >= k
    return hook


def _crash_loop(name, until):
    def hook(p, side, health):
        pod = side.cluster.get_or_none("Pod", side.sim.pod_name(name), NS)
        if pod is None or pod.labels.get("controller-revision-hash") != NEW:
            return
        side.cluster.patch(
            "Pod", pod.name, NS, patch={"status": CRASHING if p < until else RUNNING}
        )
    return hook


def _orphan(cluster, sim):
    orphan = make_pod("orphan-driver", namespace=NS, node_name=node_name(1), labels=LABELS)
    orphan.labels["controller-revision-hash"] = OLD
    cluster.create(orphan)


SCENARIOS = {
    **{
        f"budget-parallel{mp}-unavailable{mu}": Scenario(
            policy(mp, mu), nodes=6, seed=mp
        )
        for mp in (1, 2, 0)
        for mu in ("25%", 1, "100%")
    },
    "drain-pod-selector": Scenario(
        policy(2, "50%", drain={"enable": True, "podSelector": "app=train", "force": True}),
        nodes=6, seed=3, workload_share=0.8,
    ),
    "drain-skip-label": Scenario(
        policy(1, 1, **DRAIN), nodes=3, seed=4, workload_share=1.0,
        setup=lambda cluster, sim: cluster.create(
            make_pod("keeper", namespace="default", node_name=node_name(0),
                     labels={KEYS.skip_drain_pod_label: "true"}, controlled=True)
        ),
    ),
    "wait-for-completion": Scenario(
        policy(0, "100%", waitForCompletion={"podSelector": "job=batch"}),
        nodes=3, setup=_jobs([node_name(0), node_name(2)]), hook=_finish_jobs_at(6),
    ),
    "wait-for-completion-timeout": Scenario(
        policy(0, "100%", waitForCompletion={"podSelector": "job=batch", "timeoutSeconds": 30}),
        nodes=2, setup=_jobs([node_name(1)]),
    ),
    "pod-deletion-filter": Scenario(
        policy(2, "100%", podDeletion={"force": True}), nodes=4, seed=5, workload_share=1.0,
        pod_deletion=lambda pod: pod.labels.get("evict") == "yes",
    ),
    "pod-deletion-then-drain": Scenario(
        policy(1, "100%", podDeletion={}, **DRAIN), nodes=3, seed=6, workload_share=1.0,
        pod_deletion=lambda pod: pod.labels.get("app") == "serve",
    ),
    "validation-passes": Scenario(
        policy(2, "50%", **DRAIN), nodes=4, seed=7, workload_share=0.5, validation_timeout=600,
    ),
    "validation-times-out-then-recovers": Scenario(
        policy(0, "100%"), nodes=3, validation_timeout=40,
        hook=_heal_at([node_name(1)], 14),
    ),
    "skip-label": Scenario(policy(0, "100%"), nodes=3, skip=(node_name(1),)),
    "crash-looping-driver-pod": Scenario(
        policy(0, "100%"), nodes=2, hook=_crash_loop(node_name(0), 9),
    ),
    "orphaned-driver-pod": Scenario(policy(1, "100%"), nodes=2, setup=_orphan),
    "safe-load-handshake": Scenario(policy(1, "100%", **DRAIN), nodes=3, safe_load=True),
    "cordoned-before-roll": Scenario(policy(1, 2), nodes=3, cordoned=(node_name(1),)),
    "pool-of-32-gpu-nodes": Scenario(
        policy(8, "25%", **DRAIN), nodes=32, seed=32, workload_share=0.6,
        validation_timeout=600, max_passes=120,
    ),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_machine_equals_jax_machine_after_every_pass(name, clock):
    sc = SCENARIOS[name]
    trajectory, a, b = run_twin(sc, clock)
    final = trajectory[-1]
    assert all(final[n] == "upgrade-done" for n in final if n not in sc.skip)
    for n in sc.skip:
        assert final[n] == "upgrade-required"
    # Nodes that began cordoned end cordoned; every other node is back.
    nodes = b.observe()["nodes"]
    for n, (_, unschedulable, annotations) in nodes.items():
        assert unschedulable == (n in sc.cordoned)
        assert KEYS.initial_state_annotation not in annotations


def test_cases_take_the_arcs_they_name(clock):
    """The scenarios reach the states they are about."""
    seen = {}
    for name in ("validation-times-out-then-recovers", "crash-looping-driver-pod",
                 "wait-for-completion", "pod-deletion-filter", "safe-load-handshake"):
        trajectory, _, _ = run_twin(SCENARIOS[name], clock)
        seen[name] = {s for states in trajectory for s in states.values()}
    assert "upgrade-failed" in seen["validation-times-out-then-recovers"]
    assert "validation-required" in seen["validation-times-out-then-recovers"]
    assert "upgrade-failed" in seen["crash-looping-driver-pod"]
    assert "wait-for-jobs-required" in seen["wait-for-completion"]
    assert "pod-deletion-required" in seen["pod-deletion-filter"]
    assert "pod-restart-required" in seen["safe-load-handshake"]


def test_a_settled_pool_makes_no_writes(clock):
    sc = Scenario(policy(1, "25%"), nodes=4, bump=False)
    with contextlib.ExitStack() as stack:
        health: dict = {}
        a, b = Side(sc, health, stack), Side(sc, health, stack)
        for side, machine in ((a, "jax"), (b, "port")):
            side.one_pass(machine)  # unknown -> done
        assert a.observe() == b.observe()
        versions = [{n.name: n.resource_version for n in s.cluster.list("Node")} for s in (a, b)]
        for _ in range(3):
            clock.now += sc.tick_s
            a.one_pass("jax")
            b.one_pass("port")
            assert a.machines["jax"].last_pass_stats.writes_issued == 0
            stats = b.machines["port"].last_pass_stats
            assert stats.writes_issued == 0 and stats.writes_skipped == 0
            assert stats.reads_issued == 3
        assert versions == [
            {n.name: n.resource_version for n in s.cluster.list("Node")} for s in (a, b)
        ]


@pytest.mark.parametrize("k", [3, 8, 15])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_one_machine_finishes_the_others_roll(first, k, clock):
    """B runs ``first``'s machine for ``k`` passes and the other's after;
    every pass equals the JAX-only roll on A."""
    second = "port" if first == "jax" else "jax"
    sc = Scenario(
        policy(1, "50%", **DRAIN), nodes=4, seed=11, workload_share=0.7,
        validation_timeout=600, safe_load=True,
    )
    trajectory, _, b = run_twin(sc, clock, schedule=lambda p: first if p < k else second)
    assert len(trajectory) > k
    assert set(trajectory[-1].values()) == {"upgrade-done"}


# ----------------------------------------------------------------------
# What the port's machine refuses
# ----------------------------------------------------------------------


@pytest.fixture
def pool():
    cluster = FakeCluster()
    for i in range(2):
        cluster.create(make_node(node_name(i)))
    sim = DaemonSetSimulator(cluster, name=LABELS["app"], namespace=NS, match_labels=LABELS)
    sim.settle()
    return cluster


def _manager(cluster, **kwargs):
    return ClusterUpgradeStateManager(
        cluster, DeviceClass.nvidia("gpu"), runner=TaskRunner(inline=True), **kwargs
    )


@pytest.mark.parametrize(
    "kwargs, item",
    [
        ({"options": StateOptions(batch_writes=True)}, "A14"),
    ],
    ids=["batch_writes"],
)
def test_unported_options_are_refused(pool, kwargs, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        _manager(pool, **kwargs)


@pytest.mark.parametrize(
    "method, item",
    [
        ("with_snapshot_from_informers", "A14"),
        ("enable_write_batching", "A14"),
    ],
)
def test_unported_wirings_are_refused(pool, method, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        getattr(_manager(pool), method)()


QUARANTINE = {"quarantine": {"enable": True}}


@pytest.mark.parametrize(
    "labels, extra, wanted, released",
    [
        ({KEYS.state_label: "quarantined"}, {}, "upgrade-done", 1),
        ({KEYS.state_label: "quarantined"}, QUARANTINE, "quarantined", 0),
        ({}, QUARANTINE, "upgrade-done", 0),
    ],
    ids=["quarantined-policy-withdrawn", "quarantined-held", "quarantine-policy"],
)
def test_the_quarantine_arc_runs_one_pass(pool, labels, extra, wanted, released):
    """Each way into the quarantine arc runs (the whole arc is held to the
    JAX machine in ``tests/test_torch_quarantine.py``): a quarantined node
    under a policy without the arc is released and classified done on the
    next pass; under the arc, without telemetry, it stays held (no report
    is no recovery); a policy with the arc and no telemetry admits no
    node."""
    pool.patch("Node", node_name(1), patch={"metadata": {"labels": labels}})
    mgr = _manager(pool)
    pol = DriverUpgradePolicySpec.from_dict(policy(**extra))
    for _ in range(2):
        mgr.apply_state(mgr.build_state(NS, LABELS), pol)
    states = {n.name: n.labels.get(KEYS.state_label) for n in pool.list("Node")}
    assert states == {node_name(0): "upgrade-done", node_name(1): wanted}
    totals = mgr.common.quarantine_manager.totals()
    assert totals["entered"] == 0
    assert totals["released"] == released
    assert totals["in_quarantine"] == (1 if wanted == "quarantined" else 0)


CHECKPOINT = {"checkpoint": {"enable": True, "podSelector": "app=trainer"}}


@pytest.mark.parametrize(
    "labels, annotations, extra, wanted, totals",
    [
        ({KEYS.state_label: "checkpoint-required"}, {}, CHECKPOINT, "drain-required",
         {"completions": 1, "advanced": 1}),
        ({KEYS.state_label: "pod-restart-required"},
         {KEYS.checkpoint_manifest_annotation: "{}"}, {}, "validation-required", {}),
        ({KEYS.state_label: "wait-for-jobs-required"}, {}, CHECKPOINT, "checkpoint-required",
         {}),
    ],
    ids=["checkpoint-required", "manifest-in-pod-restart", "checkpoint-policy"],
)
def test_the_checkpoint_arc_runs_one_pass(pool, labels, annotations, extra, wanted, totals):
    """Each way into the checkpoint arc runs: a node in its state, a node
    with a manifest, a policy enabling it. One pass moves node-1 one step
    along the arc (the whole arc is held to the JAX machine in
    ``tests/test_torch_checkpoint.py``)."""
    meta = {"labels": labels, "annotations": annotations}
    pool.patch("Node", node_name(1), patch={"metadata": meta})
    mgr = _manager(pool)
    mgr.apply_state(mgr.build_state(NS, LABELS), DriverUpgradePolicySpec.from_dict(policy(**extra)))
    states = {n.name: n.labels.get(KEYS.state_label) for n in pool.list("Node")}
    assert states == {node_name(0): "upgrade-done", node_name(1): wanted}
    counted = {k: v for k, v in mgr.common.checkpoint_manager.totals().items() if v}
    assert counted == totals


def test_disabled_arcs_in_a_policy_are_accepted(pool):
    mgr = _manager(pool)
    doc = policy(checkpoint={"enable": False}, quarantine={"enable": False})
    mgr.apply_state(mgr.build_state(NS, LABELS), DriverUpgradePolicySpec.from_dict(doc))
    assert {n.labels.get(KEYS.state_label) for n in pool.list("Node")} == {"upgrade-done"}
