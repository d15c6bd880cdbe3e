"""The port's slice-aware planner against the JAX package's, on the CPU.

The same roll runs through the JAX ``ClusterUpgradeStateManager`` on the
JAX in-memory cluster twice: on a TPU pool (slices are GKE node pools)
under the JAX planner, and on a GPU pool with the same slice structure
(slices are ``nvidia.com/gpu.clique`` NVLink domains of 2-4 nodes) under
the port's planner. The disruption windows must be the same. The twins of
``tests/test_multislice.py`` then hold the port's planner to the JAX
planner's guarantees on the GPU pool: the budget counts slices, a wounded
slice rolls first, a slice cordons together, a crash mid-slice resumes
without a second window, requestor CRs align to slices whichever mode is
enabled first, on the JAX machine and on the port's. A GPU pool without
cliques rolls node by node. The port's own ``ClusterUpgradeStateManager``
under the port's planner opens the same windows, pass by pass, as the JAX
machine under it.
"""

from __future__ import annotations

import numpy as np
import pytest

from k8s_operator_libs_tpu.api import DriverUpgradePolicySpec
from k8s_operator_libs_tpu.api import telemetry_v1alpha1 as jax_tel
from k8s_operator_libs_tpu.kube import FakeCluster, Node
from k8s_operator_libs_tpu.kube.client import ApiError
from k8s_operator_libs_tpu.kube.objects import set_condition
from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator, MaintenanceOperatorSimulator
from k8s_operator_libs_tpu.parallel.topology import (
    GKE_NODEPOOL_LABEL,
    GKE_TPU_ACCELERATOR_LABEL,
    GKE_TPU_TOPOLOGY_LABEL,
)
from k8s_operator_libs_tpu.tpu import planner as jax_planner
from k8s_operator_libs_tpu.tpu.detector import TpuNodeDetector as JaxDetector
from k8s_operator_libs_tpu.upgrade import (
    ClusterUpgradeStateManager,
    DeviceClass,
    RequestorOptions,
    TaskRunner,
    UpgradeKeys,
    enable_requestor_mode,
)
from k8s_operator_libs_tpu.utils import IntOrString
from k8s_operator_libs_tpu_torch.parallel.topology import (
    GPU_CLIQUE_LABEL,
    GPU_COUNT_LABEL,
    GPU_PRESENT_LABEL,
    GPU_PRODUCT_LABEL,
)
from k8s_operator_libs_tpu_torch.tpu import planner as port
from k8s_operator_libs_tpu_torch.tpu.detector import TpuNodeDetector
from k8s_operator_libs_tpu_torch.tpu.monitor import ICI_HEALTHY_CONDITION
from k8s_operator_libs_tpu_torch.upgrade import ClusterUpgradeStateManager as PortManager
from k8s_operator_libs_tpu_torch.upgrade import DeviceClass as PortDeviceClass
from k8s_operator_libs_tpu_torch.upgrade import TaskRunner as PortTaskRunner
from k8s_operator_libs_tpu_torch.upgrade import RequestorOptions as PortRequestorOptions
from k8s_operator_libs_tpu_torch.upgrade import enable_requestor_mode as port_enable_requestor_mode
from k8s_operator_libs_tpu_torch.kube.sim import MaintenanceOperatorSimulator as PortMaintenanceOperator
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import (
    DriverUpgradePolicySpec as PortPolicy,
)

NS = "kube-system"
DS_LABELS = {"app": "driver-installer"}
TPU = DeviceClass.tpu()
GPU = DeviceClass.nvidia("gpu")
#: Nodes in each slice: NVLink domains of 2, 3 and 4 nodes.
SLICE_SIZES = (2, 3, 4)

POLICY = DriverUpgradePolicySpec(
    auto_upgrade=True, max_parallel_upgrades=1, max_unavailable=IntOrString(1),
)


def slice_name(s: int) -> str:
    return f"domain-{s}"


def tpu_labels(s: int) -> dict:
    return {
        GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
        GKE_TPU_TOPOLOGY_LABEL: "4x4",
        GKE_NODEPOOL_LABEL: slice_name(s),
    }


def gpu_labels(s, clique: bool = True) -> dict:
    labels = {
        GPU_PRESENT_LABEL: "true",
        GPU_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3",
        GPU_COUNT_LABEL: "8",
    }
    if clique:
        labels[GPU_CLIQUE_LABEL] = slice_name(s)
    return labels


class Pool:
    """Nodes ``s<slice>-h<host>`` on the JAX in-memory cluster, a driver
    DaemonSet on them, and a state machine (the JAX package's, or with
    ``machine="port"`` the port's) with a slice planner."""

    def __init__(
        self, kind: str, sizes=SLICE_SIZES, clique: bool = True, machine: str = "jax"
    ) -> None:
        self.kind = kind
        self.device = TPU if kind == "tpu" else GPU
        self.keys = UpgradeKeys(self.device)
        self.cluster = FakeCluster()
        self.slice_of: dict[str, str] = {}
        for s, hosts in enumerate(sizes):
            for h in range(hosts):
                name = f"s{s}-h{h}"
                labels = tpu_labels(s) if kind == "tpu" else gpu_labels(s, clique)
                node = Node.new(name, labels=labels)
                node.set_ready(True)
                self.cluster.create(node)
                self.slice_of[name] = slice_name(s) if clique else name
        self.sim = DaemonSetSimulator(
            self.cluster, name="driver-installer", namespace=NS,
            match_labels=DS_LABELS, initial_hash="v1",
        )
        self.sim.settle()
        self.policy = POLICY
        if machine == "port":
            self.mgr = PortManager(
                self.cluster, PortDeviceClass.nvidia("gpu"), runner=PortTaskRunner(inline=True)
            )
            self.policy = PortPolicy.from_dict(POLICY.to_dict())
        else:
            self.mgr = ClusterUpgradeStateManager(
                self.cluster, self.device, runner=TaskRunner(inline=True)
            )

    def enable_planner(self) -> None:
        if self.kind == "tpu":
            jax_planner.enable_slice_aware_planning(self.mgr)
        else:
            port.enable_slice_aware_planning(self.mgr)

    def wound(self, node_name: str) -> None:
        """What the monitor writes on a failing node."""
        node = Node(self.cluster.get("Node", node_name).raw)
        set_condition(
            node.status, ICI_HEALTHY_CONDITION, "False",
            reason="ProbeFailed", message="ring bandwidth below floor",
        )
        self.cluster.update_status(node)

    def disrupted(self) -> set[str]:
        out = set()
        for obj in self.cluster.list("Node"):
            node = Node(obj.raw)
            if node.unschedulable or not node.is_ready():
                out.add(self.slice_of[node.name])
        return out

    def done(self) -> bool:
        return all(
            n.labels.get(self.keys.state_label) == "upgrade-done"
            for n in self.cluster.list("Node")
        ) and self.sim.all_pods_ready_and_current()

    def drive(self, per_pass=None, max_passes: int = 200, bump: bool = True) -> list[set]:
        """Bump the driver (unless already bumped), then passes to
        convergence; the disrupted slices after each."""
        if bump:
            self.sim.set_template_hash("v2")
        samples = []
        for _ in range(max_passes):
            if per_pass is not None:
                per_pass()
            self.sim.step()
            self.mgr.apply_state(self.mgr.build_state(NS, DS_LABELS), self.policy)
            self.sim.step()
            samples.append(self.disrupted())
            if self.done():
                return samples
        raise AssertionError(f"{self.kind} roll did not converge")


def _stats(samples):
    return port.disruption_stats(samples)


@pytest.mark.parametrize(
    "wounded", [None, "s2-h1", "s0-h0"], ids=["healthy", "wound-s2", "wound-s0"]
)
def test_same_roll_gives_the_same_windows_on_tpu_and_gpu_pools(wounded):
    stats = {}
    for kind in ("tpu", "gpu"):
        pool = Pool(kind)
        if wounded:
            pool.wound(wounded)
        pool.enable_planner()
        stats[kind] = (jax_planner if kind == "tpu" else port).disruption_stats(pool.drive())
    fields = ("windows", "first_order", "per_slice", "max_at_once")
    assert [getattr(stats["gpu"], f) for f in fields] == [getattr(stats["tpu"], f) for f in fields]
    assert stats["gpu"].windows == len(SLICE_SIZES)
    assert stats["gpu"].max_at_once == 1
    if wounded:
        assert stats["gpu"].first_order[0] == slice_name(int(wounded[1]))


@pytest.mark.parametrize(
    "wounded, clique",
    [(None, True), ("s2-h1", True), ("s0-h0", True), (None, False)],
    ids=["healthy", "wound-s2", "wound-s0", "no-cliques"],
)
def test_port_machine_opens_the_same_windows_as_the_jax_machine(wounded, clique):
    samples = {}
    for machine in ("jax", "port"):
        pool = Pool("gpu", clique=clique, machine=machine)
        if wounded:
            pool.wound(wounded)
        pool.enable_planner()
        assert isinstance(pool.mgr.inplace, port.SliceAwareInplaceManager)
        samples[machine] = pool.drive()
    assert samples["port"] == samples["jax"]
    stats = port.disruption_stats(samples["port"])
    assert stats.max_at_once == 1
    assert stats.windows == (len(SLICE_SIZES) if clique else sum(SLICE_SIZES))


def test_disruption_stats_equal_jax_on_seeded_series():
    rng = np.random.default_rng(5)
    names = [slice_name(s) for s in range(4)]
    for _ in range(20):
        samples = [
            {n for n in names if rng.random() < 0.3} for _ in range(int(rng.integers(0, 12)))
        ]
        ours, theirs = port.disruption_stats(samples), jax_planner.disruption_stats(samples)
        assert (ours.windows, ours.first_order, ours.per_slice, ours.max_at_once) == (
            theirs.windows, theirs.first_order, theirs.per_slice, theirs.max_at_once
        )


def _health(name, score, trend, links=None):
    raw = jax_tel.make_node_health_report(name, {"psum": score > 50}, {}, links=links)
    raw["status"]["score"], raw["status"]["trend"] = score, trend
    return jax_tel.parse_node_health(raw)


def test_assessment_and_order_equal_jax_with_telemetry():
    """The same node health (scores, trends, a sick link only one endpoint
    reported) on both pools: equal scores, link scores, worst links and
    candidate order."""
    health = {
        "s0-h1": _health("s0-h1", 90.0, "stable"),
        "s1-h0": _health("s1-h0", 90.0, "degrading"),
        "s2-h3": _health(
            "s2-h3", 100.0, "stable",
            links={"s0-h0": {"ok": True, "latency_s": 1e-4, "gbytes_per_s": 1.0}},
        ),
    }
    seen = {}
    for kind in ("tpu", "gpu"):
        pool = Pool(kind)
        pool.enable_planner()
        pool.sim.set_template_hash("v2")
        pool.sim.step()
        pool.mgr.apply_state(pool.mgr.build_state(NS, DS_LABELS), POLICY)
        state = pool.mgr.build_state(NS, DS_LABELS)
        state.node_health = health
        if kind == "tpu":
            a = jax_planner.assess_slices(JaxDetector(), state)
        else:
            a = port.assess_slices(TpuNodeDetector(), state)
        seen[kind] = (
            a.total_slices, a.disrupted, a.in_progress, a.wounded, a.scores,
            a.trends, a.link_scores, a.worst_links,
            [name for name, _ in a.ordered_candidates()],
            {s: sorted(ns.node.name for ns in m) for s, m in a.candidates.items()},
        )
    assert seen["gpu"] == seen["tpu"]
    assert seen["gpu"][6] == {slice_name(0): 40.0, slice_name(2): 40.0}


# ----------------------------------------------------------------------
# Twins of tests/test_multislice.py on the GPU pool
# ----------------------------------------------------------------------

def _gpu_pool(**kwargs) -> Pool:
    pool = Pool("gpu", **kwargs)
    pool.enable_planner()
    return pool


def test_budget_counts_slices_and_one_window_each():
    samples = _gpu_pool().drive()
    stats = _stats(samples)
    assert stats.max_at_once <= 1
    assert stats.windows == len(SLICE_SIZES)
    assert stats.per_slice == {slice_name(s): 1 for s in range(len(SLICE_SIZES))}


def test_wounded_slice_rolls_first():
    pool = Pool("gpu")
    pool.wound("s2-h0")
    pool.enable_planner()
    stats = _stats(pool.drive())
    assert stats.first_order[0] == slice_name(2)
    assert set(stats.first_order) == {slice_name(s) for s in range(len(SLICE_SIZES))}


def test_whole_slice_cordons_together():
    pool = _gpu_pool()
    cordon_pass: dict[str, int] = {}
    pass_no = [0]

    def record():
        pass_no[0] += 1
        for obj in pool.cluster.list("Node"):
            node = Node(obj.raw)
            if node.unschedulable and node.name not in cordon_pass:
                cordon_pass[node.name] = pass_no[0]

    pool.drive(per_pass=record)
    record()
    for s, hosts in enumerate(SLICE_SIZES):
        assert len({cordon_pass[f"s{s}-h{h}"] for h in range(hosts)}) == 1, s


def test_partial_slice_start_resumes_without_extra_budget():
    """A pass that dies after starting part of a slice heals on the next
    pass under the already-disrupted exemption: no second slot, no second
    window."""
    pool = _gpu_pool()
    keys = pool.keys
    armed = {"writes": 0, "on": True}

    def fail_second_state_write(verb, kind, payload):
        labels = ((payload.get("patch") or {}).get("metadata") or {}).get("labels") or {}
        if labels.get(keys.state_label) != "cordon-required":
            return
        armed["writes"] += 1
        if armed["on"] and armed["writes"] == 2:
            armed["on"] = False
            raise ApiError("injected: apiserver blip mid-batch")

    pool.cluster.add_reactor("patch", "Node", fail_second_state_write)
    pool.sim.set_template_hash("v2")
    for _ in range(5):
        pool.sim.step()
        try:
            pool.mgr.apply_state(pool.mgr.build_state(NS, DS_LABELS), POLICY)
        except ApiError:
            break
    else:
        raise AssertionError("the injected fault did not surface")
    started = [
        n.name for n in pool.cluster.list("Node")
        if n.labels.get(keys.state_label) == "cordon-required"
    ]
    assert len(started) == 1
    stats = _stats(pool.drive(bump=False))
    assert stats.max_at_once <= 1
    assert stats.windows == len(SLICE_SIZES)
    assert all(count == 1 for count in stats.per_slice.values()), stats.per_slice


def test_gpu_pool_without_cliques_rolls_node_by_node():
    """Without a clique an HGX node's NVLink ends at the node: each node is
    its own slice, so the budget of one admits one node at a time."""
    pool = _gpu_pool(clique=False)
    stats = _stats(pool.drive())
    assert stats.windows == sum(SLICE_SIZES)
    assert stats.max_at_once == 1
    assert all(count == 1 for count in stats.per_slice.values())


def _requestor_roll(slice_aware_first: bool, wound=None, machine: str = "jax"):
    """A requestor-mode roll under the port's planner, on the JAX machine
    (its requestor and simulator) or on the port's (the port's)."""
    pool = Pool("gpu", machine=machine)
    if wound:
        pool.wound(wound)
    if machine == "port":
        opts = PortRequestorOptions(
            use_maintenance_operator=True, requestor_id="gpu.operator.dev", namespace=NS,
        )
        enable = port_enable_requestor_mode
        operator = PortMaintenanceOperator(pool.cluster, namespace=NS)
    else:
        opts = RequestorOptions(
            use_maintenance_operator=True, requestor_id="gpu.operator.dev", namespace=NS,
        )
        enable = enable_requestor_mode
        operator = MaintenanceOperatorSimulator(pool.cluster, namespace=NS)
    if slice_aware_first:
        pool.enable_planner()
        enable(pool.mgr, opts)
    else:
        enable(pool.mgr, opts)
        pool.enable_planner()
    assert isinstance(pool.mgr.requestor, port.SliceAwareRequestorManager)
    cr_first_pass: dict[str, int] = {}
    live_slices = []
    pass_no = [0]

    def tick():
        operator.step()
        pass_no[0] += 1
        live = set()
        for obj in pool.cluster.list("NodeMaintenance", namespace=NS):
            node_name = obj.raw["spec"]["nodeName"]
            live.add(pool.slice_of[node_name])
            cr_first_pass.setdefault(node_name, pass_no[0])
        live_slices.append(live)

    samples = pool.drive(per_pass=tick)
    operator.step()
    return pool, cr_first_pass, live_slices, samples


@pytest.mark.parametrize("machine", ["jax", "port"])
@pytest.mark.parametrize(
    "slice_aware_first", [True, False], ids=["planner-first", "requestor-first"]
)
def test_requestor_crs_align_to_slices_whatever_the_enable_order(slice_aware_first, machine):
    pool, cr_first_pass, live_slices, samples = _requestor_roll(slice_aware_first, machine=machine)
    assert len(cr_first_pass) == sum(SLICE_SIZES)
    for s, hosts in enumerate(SLICE_SIZES):
        assert len({cr_first_pass[f"s{s}-h{h}"] for h in range(hosts)}) == 1, s
    assert max(len(s) for s in live_slices) <= 1
    assert max(len(s) for s in samples) <= 1
    assert pool.cluster.list("NodeMaintenance", namespace=NS) == []


@pytest.mark.parametrize("machine", ["jax", "port"])
def test_wounded_slice_requests_maintenance_first(machine):
    _, cr_first_pass, _, _ = _requestor_roll(False, wound="s1-h2", machine=machine)
    first = {
        s: min(cr_first_pass[f"s{s}-h{h}"] for h in range(hosts))
        for s, hosts in enumerate(SLICE_SIZES)
    }
    assert all(first[1] < first[s] for s in (0, 2)), first


def test_enabling_twice_keeps_one_wrapper():
    pool = _gpu_pool()
    inplace = pool.mgr.inplace
    port.enable_slice_aware_planning(pool.mgr)
    assert pool.mgr.inplace is inplace
    assert not isinstance(inplace.base, port.SliceAwareInplaceManager)
    assert type(pool.mgr).__name__ == "ClusterUpgradeStateManager"
