"""The port's slice gate and its gang world against the JAX package's, on
the CPU.

* The gang's pod and Service, diffed against the JAX builder's: they differ
  only where the device does.
* Twins of ``tests/test_slice_gate.py``'s gang shape and lifecycle, on GPU
  nodes of one ``nvidia.com/gpu.clique``.
* Real processes: two GPU-labelled nodes of one clique roll through the JAX
  state machine, each gang pod's payload a process on the CPU with one
  gloo rank, the coordinator's DNS name mapped to loopback. Both nodes end
  ``upgrade-done`` and both ready files read ``slice=2/2 over 2 hosts``;
  one broken rank holds both back.
* The gang world: 2 hosts x 2 gloo ranks give the exact collective results
  of a JAX host mesh of 4 and of the port's one-host world of 4; hops to the
  other host are named after its node; a host that never arrives fails the
  gate's report within the form timeout.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from k8s_operator_libs_tpu.api import DriverUpgradePolicySpec
from k8s_operator_libs_tpu.kube import FakeCluster, Node, Pod
from k8s_operator_libs_tpu.kube.sim import (
    DaemonSetSimulator,
    KubeletPayloadExecutor,
    ValidationPodSimulator,
)
from k8s_operator_libs_tpu.parallel.mesh import single_axis_mesh as jax_mesh
from k8s_operator_libs_tpu.parallel.topology import (
    GKE_NODEPOOL_LABEL,
    GKE_TPU_ACCELERATOR_LABEL,
    GKE_TPU_TOPOLOGY_LABEL,
)
from k8s_operator_libs_tpu.tpu import slice_gate as jax_gate
from k8s_operator_libs_tpu.upgrade import ClusterUpgradeStateManager, TaskRunner
from k8s_operator_libs_tpu.upgrade import DeviceClass as JaxDeviceClass
from k8s_operator_libs_tpu.utils import IntOrString
from k8s_operator_libs_tpu_torch.ops import collectives as port_coll
from k8s_operator_libs_tpu_torch.ops import probe_harness as port_harness
from k8s_operator_libs_tpu_torch.parallel import mesh as port_mesh
from k8s_operator_libs_tpu_torch.parallel.mesh import GANG_FORM_PHASES, World
from k8s_operator_libs_tpu_torch.parallel.topology import (
    GPU_CLIQUE_LABEL,
    GPU_COUNT_LABEL,
    GPU_PRESENT_LABEL,
    GPU_PRODUCT_LABEL,
)
from k8s_operator_libs_tpu_torch.tpu import slice_gate as port
from k8s_operator_libs_tpu_torch.tpu.health import HealthReport, IciHealthGate
from k8s_operator_libs_tpu_torch.tpu.planner import enable_slice_aware_planning
from k8s_operator_libs_tpu_torch.tpu.validation_pod import VALIDATION_APP
from k8s_operator_libs_tpu_torch.upgrade.consts import DeviceClass, UpgradeKeys
from test_torch_device_class import MISSING, json_diff

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

REPO = Path(__file__).resolve().parents[1]
NS = "kube-system"
KEYS = UpgradeKeys(DeviceClass.nvidia("gpu"))
DOMAIN = "pool-a"
SLUG = port.slice_slug(DOMAIN)


def gpu_node(cluster, name, clique=DOMAIN, cards="8"):
    labels = {GPU_PRESENT_LABEL: "true", GPU_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3",
              GPU_COUNT_LABEL: cards}
    if clique:
        labels[GPU_CLIQUE_LABEL] = clique
    node = Node.new(name, labels=labels)
    node.set_ready(True)
    cluster.create(node)
    return node


def tpu_node(cluster, name, pool=DOMAIN):
    node = Node.new(name, labels={
        GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
        GKE_TPU_TOPOLOGY_LABEL: "4x4",
        GKE_NODEPOOL_LABEL: pool,
    })
    node.set_ready(True)
    cluster.create(node)
    return node


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------------------
# The gang's pod and Service against the JAX builder's
# ----------------------------------------------------------------------

def test_gang_pod_and_service_differ_from_jax_only_where_the_device_does():
    same = dict(image="example.org/probe", tpu_chips=8, compile_cache_dir="")
    jax_cluster, port_cluster = FakeCluster(), FakeCluster()
    jax_nodes = [tpu_node(jax_cluster, f"host-{i}") for i in range(2)]
    port_nodes = [gpu_node(port_cluster, f"host-{i}") for i in range(2)]
    jax_mgr = jax_gate.SliceProbeGangManager(
        jax_cluster, jax_gate.SliceProbeSpec(device=JaxDeviceClass.nvidia("gpu"), **same)
    )
    port_mgr = port.SliceProbeGangManager(port_cluster, port.SliceProbeSpec(**same))
    jax_pod = jax_mgr.ensure(jax_nodes[1])
    port_pod = port_mgr.ensure(port_nodes[1])

    jax_cmd = jax_pod.spec["containers"][0].pop("command")
    port_cmd = port_pod.spec["containers"][0].pop("command")
    floors = ["--min-ring-gbps", "5.0", "--min-mxu-tflops", "31.0"]
    start = jax_cmd.index(floors[0])
    assert jax_cmd[start:start + 4] == floors  # TPU floors the port does not carry
    jax_cmd = jax_cmd[:start] + jax_cmd[start + 4:]
    expected = [
        part.replace("tpu-health-probe", "gpu-health-probe")
        .replace("k8s_operator_libs_tpu.", "k8s_operator_libs_tpu_torch.")
        for part in jax_cmd
    ]
    assert port_cmd == expected
    assert port_cmd[-8:] == [
        "--coordinator", f"gpu-health-probe-{SLUG}-g1-0.gpu-health-probe-{SLUG}:8476",
        "--num-processes", "2", "--process-id", "1", "--link-peers", "host-0,host-1",
    ]

    renamed = (f"tpu-health-probe-{SLUG}", f"gpu-health-probe-{SLUG}")
    c = "/spec/containers[0]"
    want = {
        "/metadata/labels/app": ("tpu-health-probe", "gpu-health-probe"),
        "/metadata/name": (f"{renamed[0]}-g1-1", f"{renamed[1]}-g1-1"),
        "/spec/hostname": (f"{renamed[0]}-g1-1", f"{renamed[1]}-g1-1"),
        "/spec/subdomain": renamed,
        "/spec/tolerations[0]/key": ("google.com/tpu", "nvidia.com/gpu"),
        "/metadata/uid": (jax_pod.uid, port_pod.uid),
        "/metadata/creationTimestamp": (
            jax_pod.metadata["creationTimestamp"], port_pod.metadata["creationTimestamp"]
        ),
    }
    for side in ("requests", "limits"):
        want[f"{c}/resources/{side}/google.com/tpu"] = ("8", MISSING)
        want[f"{c}/resources/{side}/nvidia.com/gpu"] = (MISSING, "8")
    diff = json_diff(jax_pod.raw, port_pod.raw)
    diff.pop("/metadata/resourceVersion", None)
    assert diff == want

    jax_svc = jax_cluster.get("Service", jax_mgr.service_name(DOMAIN), NS).raw
    port_svc = port_cluster.get("Service", port_mgr.service_name(DOMAIN), NS).raw
    diff = json_diff(jax_svc, port_svc)
    for key in ("/metadata/uid", "/metadata/creationTimestamp", "/metadata/resourceVersion"):
        diff.pop(key, None)
    assert diff == {
        "/metadata/labels/app": ("tpu-health-probe", "gpu-health-probe"),
        "/metadata/name": renamed,
    }


# ----------------------------------------------------------------------
# Twins of the JAX gang's shape and lifecycle
# ----------------------------------------------------------------------

def build(n=2, cards="8"):
    cluster = FakeCluster()
    nodes = [gpu_node(cluster, f"host-{i}", cards=cards) for i in range(n)]
    return cluster, nodes, port.SliceProbeGangManager(cluster, port.SliceProbeSpec())


def gang_pods(cluster):
    return [
        Pod(o.raw)
        for o in cluster.list("Pod", namespace=NS, label_selector=f"{port.GANG_SLICE_LABEL}={SLUG}")
    ]


def _ready(cluster, pod):
    cluster.patch("Pod", pod.name, NS, patch={"status": {
        "phase": "Running", "conditions": [{"type": "Ready", "status": "True"}],
    }})


def _state(cluster, name, state):
    cluster.patch("Node", name, "", patch={"metadata": {"labels": {KEYS.state_label: state}}})


class TestGangShape:
    def test_membership_follows_the_clique(self):
        cluster, nodes, mgr = build(3)
        gpu_node(cluster, "other", clique="pool-b")
        gpu_node(cluster, "hgx", clique="")
        assert mgr.slice_members(nodes[0]) == (DOMAIN, ["host-0", "host-1", "host-2"])
        assert mgr.slice_members(Node(cluster.get("Node", "hgx").raw)) == ("hgx", ["hgx"])

    def test_explicit_slice_label_carves_a_node_out_of_its_clique(self):
        cluster, nodes, mgr = build(3)
        cluster.patch("Node", "host-2", "", patch={
            "metadata": {"labels": {mgr.detector.slice_id_label: "carved"}}
        })
        assert mgr.slice_members(nodes[0]) == (DOMAIN, ["host-0", "host-1"])

    def test_gang_pod_carries_the_rendezvous_argv(self):
        cluster, nodes, mgr = build(2)
        pod = mgr.ensure(nodes[0])
        cmd = pod.spec["containers"][0]["command"]
        assert cmd[cmd.index("--num-processes") + 1] == "2"
        assert cmd[cmd.index("--process-id") + 1] == "0"
        coord = cmd[cmd.index("--coordinator") + 1]
        assert coord == f"{mgr.pod_name(DOMAIN, 1, 0)}.{mgr.service_name(DOMAIN)}:8476"
        assert pod.spec["subdomain"] == mgr.service_name(DOMAIN)
        svc = cluster.get("Service", mgr.service_name(DOMAIN), NS)
        assert svc.raw["spec"]["clusterIP"] == "None"

    def test_one_pod_per_host_with_ranks_and_each_members_cards(self):
        cluster, nodes, mgr = build(3, cards="4")
        mgr.ensure(nodes[1])
        pods = gang_pods(cluster)
        assert {p.node_name for p in pods} == {"host-0", "host-1", "host-2"}
        by_rank = {int(p.labels[port.GANG_RANK_LABEL]): p for p in pods}
        assert sorted(by_rank) == [0, 1, 2] and by_rank[0].node_name == "host-0"
        for p in pods:
            assert p.spec["containers"][0]["resources"]["limits"] == {"nvidia.com/gpu": "4"}

    def test_a_node_without_a_clique_takes_the_per_node_pod(self):
        cluster = FakeCluster()
        node = gpu_node(cluster, "hgx", clique="")
        pod = port.SliceProbeGangManager(cluster).ensure(node)
        assert "--num-processes" not in pod.spec["containers"][0]["command"]
        assert pod.name == f"{VALIDATION_APP}-hgx"

    def test_a_node_without_gpus_takes_the_per_node_pod(self):
        cluster = FakeCluster()
        node = Node.new("cpu-node")
        cluster.create(node)
        pod = port.SliceProbeGangManager(cluster).ensure(node)
        assert "--num-processes" not in pod.spec["containers"][0]["command"]


class TestGangLifecycle:
    def test_ensure_is_idempotent_for_a_live_gang(self):
        cluster, nodes, mgr = build(2)
        first, again = mgr.ensure(nodes[0]), mgr.ensure(nodes[1])
        assert {first.name, again.name} == {p.name for p in gang_pods(cluster)}

    def test_finished_member_replaces_the_whole_gang(self):
        cluster, nodes, mgr = build(2)
        mgr.ensure(nodes[0])
        victim = next(p for p in gang_pods(cluster) if p.node_name == "host-1")
        cluster.patch("Pod", victim.name, NS, patch={"status": {"phase": "Failed"}})
        mgr.ensure(nodes[0])
        pods = gang_pods(cluster)
        assert len(pods) == 2 and {p.labels[port.GANG_GENERATION_LABEL] for p in pods} == {"2"}
        assert victim.name not in {p.name for p in pods}

    def test_ready_pod_is_never_disturbed(self):
        cluster, nodes, mgr = build(2)
        mine = mgr.ensure(nodes[0])
        _ready(cluster, mine)
        peer = next(p for p in gang_pods(cluster) if p.node_name == "host-1")
        cluster.delete("Pod", peer.name, NS)
        assert mgr.ensure(nodes[0]).name == mine.name
        assert len(gang_pods(cluster)) == 1

    def test_cleanup_defers_while_a_peer_still_needs_the_gang(self):
        cluster, nodes, mgr = build(2)
        mgr.ensure(nodes[0])
        svc = mgr.service_name(DOMAIN)
        _state(cluster, "host-1", "validation-required")
        mgr.cleanup(Node(cluster.get("Node", "host-0").raw))
        assert len(gang_pods(cluster)) == 2
        assert cluster.get_or_none("Service", svc, NS) is not None
        _state(cluster, "host-1", "upgrade-done")
        mgr.cleanup(Node(cluster.get("Node", "host-1").raw))
        assert gang_pods(cluster) == []
        assert cluster.get_or_none("Service", svc, NS) is None

    def test_late_joiner_defers_while_peer_verdicts_are_unconsumed(self):
        cluster, nodes, mgr = build(2)
        mgr.ensure(nodes[0])
        for pod in gang_pods(cluster):
            _ready(cluster, pod)
        for name in ("host-0", "host-1"):
            _state(cluster, name, "validation-required")
        joiner = gpu_node(cluster, "host-2")
        with pytest.raises(RuntimeError, match="mid-consumption"):
            mgr.ensure(joiner)
        assert all(p.is_ready() for p in gang_pods(cluster))
        for name in ("host-0", "host-1"):
            _state(cluster, name, "upgrade-done")
        mine = mgr.ensure(joiner)
        pods = gang_pods(cluster)
        assert len(pods) == 3 and {p.labels[port.GANG_GENERATION_LABEL] for p in pods} == {"2"}
        assert mine.node_name == "host-2"

    def test_terminating_pods_do_not_churn_generations(self):
        cluster, nodes, mgr = build(2)
        mgr.ensure(nodes[0])
        victim = next(p for p in gang_pods(cluster) if p.node_name == "host-1")
        cluster.patch("Pod", victim.name, NS, patch={
            "metadata": {"finalizers": ["test/hold"]}, "status": {"phase": "Failed"},
        })
        for _ in range(2):
            mgr.ensure(nodes[0])
            live = [p for p in gang_pods(cluster) if p.deletion_timestamp is None]
            assert {p.labels[port.GANG_GENERATION_LABEL] for p in live} == {"2"}
        assert any(p.deletion_timestamp is not None for p in gang_pods(cluster))

    def test_membership_change_starts_a_new_generation(self):
        cluster, nodes, mgr = build(2)
        mgr.ensure(nodes[0])
        gpu_node(cluster, "host-2")
        mgr.ensure(nodes[0])
        pods = gang_pods(cluster)
        assert {p.node_name for p in pods} == {"host-0", "host-1", "host-2"}
        cmd = pods[0].spec["containers"][0]["command"]
        assert cmd[cmd.index("--num-processes") + 1] == "3"


# ----------------------------------------------------------------------
# The roll behind one real gang battery
# ----------------------------------------------------------------------

POLICY = DriverUpgradePolicySpec(
    auto_upgrade=True, max_parallel_upgrades=0, max_unavailable=IntOrString("100%"),
)
BUDGET_S = 240.0


class GangRoll:
    """Two GPU nodes of one clique, a driver roll, the gang provisioner and
    a kubelet running each gang pod's command on the CPU: its coordinator
    mapped to a free loopback port (the cluster DNS's part), its output
    kept in ``<out_dir>/<pod>.out|.err``."""

    def __init__(self, out_dir: Path, broken_node: str = "") -> None:
        self.out_dir = out_dir
        self.broken_node = broken_node
        self.cluster = FakeCluster()
        for i in range(2):
            gpu_node(self.cluster, f"host-{i}")
        self.sim = DaemonSetSimulator(
            self.cluster, name="driver-installer", namespace=NS,
            match_labels={"app": "driver-installer"}, initial_hash="v1",
        )
        self.sim.settle()
        spec = port.SliceProbeSpec(
            payload_mb=0.05, matmul_size=64, run_flash_attention=False,
            run_seq_parallel_probes=False, compile_cache_dir="",
        )
        self.ports: dict[str, int] = {}
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"
        self.executor = KubeletPayloadExecutor(
            env=env, extra_args=["--device", "cpu"], timeout_seconds=BUDGET_S,
            argv_transform=self._transform,
        )
        self.pods = ValidationPodSimulator(
            self.cluster, namespace=NS, label_selector=spec.pod_selector, executor=self.executor,
        )
        self.mgr = ClusterUpgradeStateManager(
            self.cluster, JaxDeviceClass.nvidia("gpu"), runner=TaskRunner(inline=True)
        )
        self.mgr.with_validation_enabled(
            pod_provisioner=port.make_validation_provisioner(self.cluster, spec),
            timeout_seconds=600,
        )
        enable_slice_aware_planning(self.mgr)
        self.sim.set_template_hash("v2")
        self.ready: dict[str, str] = {}

    def _transform(self, pod, argv):
        argv = list(argv)
        i = argv.index("--coordinator") + 1
        port_no = self.ports.setdefault(argv[i], free_port())
        argv[i] = f"127.0.0.1:{port_no}"
        if pod.node_name == self.broken_node:
            argv += ["--min-mxu-tflops", "1e9"]
        out = str(self.out_dir / pod.name)
        return ["/bin/sh", "-c", 'exec "$@" >"$0.out" 2>"$0.err"', out, *argv]

    def states(self):
        return {n.name: n.labels.get(KEYS.state_label) for n in self.cluster.list("Node")}

    def one_pass(self):
        self.sim.step()
        self.pods.step()
        for name in self.executor.tracked_pods():
            content = self.executor.ready_file_content(name)
            if content is not None:
                self.ready[name] = content
        self.mgr.apply_state(self.mgr.build_state(NS, {"app": "driver-installer"}), POLICY)
        self.sim.step()

    def drive(self, until, budget_s):
        deadline = time.monotonic() + budget_s
        while True:
            self.one_pass()
            if until(self):
                return True
            if time.monotonic() > deadline:
                return False
            time.sleep(0.5)

    def report(self, pod_name):
        path = self.out_dir / f"{pod_name}.out"
        lines = [ln for ln in path.read_text().splitlines() if ln.startswith("{")]
        return HealthReport.from_dict(json.loads(lines[-1]))


def test_clique_rolls_behind_one_real_gang_battery(tmp_path):
    roll = GangRoll(tmp_path)
    with roll.executor:
        done = roll.drive(
            lambda r: all(s == "upgrade-done" for s in r.states().values())
            and r.sim.all_pods_ready_and_current(),
            BUDGET_S,
        )
        history = dict(roll.executor.history)
    assert done, roll.states()
    assert len(history) == 2 and all(history.values()), history
    assert len(roll.ready) == 2
    for pod_name, content in roll.ready.items():
        assert "slice=2/2 over 2 hosts" in content, content
        report = roll.report(pod_name)
        assert report.ok and report.process_count == 2
        assert (report.slice_devices_passed, report.slice_devices_total) == (2, 2)
        rank = int(pod_name.rsplit("-", 1)[1])
        # Each member publishes its own outgoing hop, keyed by the other
        # member's node name.
        assert [(h.src, h.dst, h.peer, h.ok) for h in report.links] == [
            (rank, 1 - rank, f"host-{1 - rank}", True)
        ]
    for node in roll.cluster.list("Node"):
        assert not Node(node.raw).unschedulable
    assert roll.cluster.list("Pod", namespace=NS, label_selector=f"app={VALIDATION_APP}") == []


def test_one_broken_rank_holds_both_nodes_back(tmp_path):
    roll = GangRoll(tmp_path, broken_node="host-1")
    with roll.executor:
        finished = roll.drive(lambda r: len(r.executor.history) >= 2, BUDGET_S)
        assert finished, "the gang's payloads never finished"
        assert not any(roll.executor.history.values()), roll.executor.history
        assert roll.ready == {}
        reports = {p: roll.report(p) for p in roll.executor.history}
        for pod_name, report in reports.items():
            assert not report.ok
            assert (report.slice_devices_passed, report.slice_devices_total) == (1, 2)
            assert any("slice agreement" in f for f in report.failures)
        roll.mgr.common.validation_manager._timeout = 0
        failed = roll.drive(
            lambda r: all(s == "upgrade-failed" for s in r.states().values()), 60.0
        )
    assert failed, roll.states()
    for node in roll.cluster.list("Node"):
        assert Node(node.raw).unschedulable


# ----------------------------------------------------------------------
# The gang world
# ----------------------------------------------------------------------

def _on_both(hosts, fn):
    """``fn(world)`` on each host's world at once; the results by host."""
    out = [None] * len(hosts)

    def call(i):
        try:
            out[i] = fn(hosts[i])
        except Exception as e:  # noqa: BLE001 - re-raised below
            out[i] = e

    threads = [threading.Thread(target=call, args=(i,)) for i in range(1, len(hosts))]
    for t in threads:
        t.start()
    call(0)
    for t in threads:
        t.join()
    for r in out:
        if isinstance(r, Exception):
            raise r
    return out


@pytest.fixture(scope="module")
def gang():
    """Two hosts of two gloo ranks each, joined through a TCP store."""
    coordinator = f"127.0.0.1:{free_port()}"
    hosts = [
        World(["cpu"] * 2, coordinator=coordinator, num_hosts=2, host_index=i)
        for i in range(2)
    ]
    _on_both(hosts, World.start)
    yield hosts
    for w in hosts:
        w.close()


@pytest.fixture(scope="module")
def one_host_world():
    world = World(["cpu"] * 4)
    yield world
    world.close()


def _jax_collective(mesh, body, x):
    return np.asarray(shard_map(body, mesh=mesh, in_specs=P("x"), out_specs=P("x"))(x))


def test_gang_world_forms_with_the_tcp_join(gang):
    assert [w.size for w in gang] == [4, 4] and [w.local_size for w in gang] == [2, 2]
    for w in gang:
        assert list(w.form_times) == [*GANG_FORM_PHASES, "total"]
        assert w.form_times["tcp_join"] >= 0


@pytest.mark.parametrize(
    "rank_fn,body,make_input",
    [
        ("_psum_rank", lambda s: jax.lax.psum(s, "x"), lambda n: jnp.arange(n, dtype=jnp.float32)),
        ("_all_gather_rank", lambda s: jax.lax.all_gather(s, "x", tiled=True),
         lambda n: jnp.arange(n, dtype=jnp.float32)),
        ("_reduce_scatter_rank", lambda s: jax.lax.psum_scatter(s, "x", tiled=True),
         lambda n: jnp.ones((n * n,), jnp.float32)),
    ],
    ids=["psum", "all_gather", "reduce_scatter"],
)
def test_gang_collectives_equal_jax_and_one_host(gang, one_host_world, rank_fn, body, make_input):
    fn = getattr(port_coll, rank_fn)
    flat = lambda parts: np.asarray([v for part in parts for v in part], np.float32)  # noqa: E731
    per_host = _on_both(gang, lambda w: w.run(fn, "x"))
    gang_values = flat(per_host[0] + per_host[1])
    one_host = flat(one_host_world.run(fn, "x"))
    theirs = _jax_collective(jax_mesh("x", devices=jax.devices()[:4]), body, make_input(4))
    np.testing.assert_array_equal(gang_values, theirs)
    np.testing.assert_array_equal(one_host, theirs)


def test_gang_battery_and_agreement(gang):
    reports = _on_both(gang, lambda w: port_coll.run_ici_probes(w, payload_mb=0.05))
    for host in reports:
        assert [(r.op, r.ok) for r in host] == [
            ("psum", True), ("all_gather", True), ("reduce_scatter", True), ("ppermute_ring", True)
        ]
    assert _on_both(gang, lambda w: port_coll.slice_agreement(w, "x", True)) == [(4, 4)] * 2
    verdicts = _on_both(
        gang, lambda w: port_coll.slice_agreement(w, "x", local_ok=w.host_index == 0)
    )
    assert verdicts == [(2, 4)] * 2


def test_cross_host_peers_follow_member_names(gang):
    names = ["node-a", "node-b"]

    def hops(world):
        peer_of, owns_hop = port_coll.make_peer_resolver(names, world)
        return [
            (h.src, h.dst, h.peer, h.ok)
            for h in port_coll.ppermute_per_link(world, payload_mb=0.05, peer_of=peer_of)
            if owns_hop(h)
        ]

    assert _on_both(gang, hops) == [
        [(0, 1, "device-1", True), (1, 2, "node-b", True)],
        [(2, 3, "device-3", True), (3, 0, "node-a", True)],
    ]
    quick = _on_both(
        gang,
        lambda w: port_harness.slice_gang_quick_battery(
            w, member_names=names, payload_mb=0.05, matmul_size=32
        ),
    )
    assert [sorted(q.links) for q in quick] == [["device-1", "node-b"], ["device-3", "node-a"]]
    assert all(q.ok for q in quick)


def test_a_host_that_never_arrives_fails_the_report_in_time(monkeypatch):
    monkeypatch.setattr(port_mesh, "FORM_TIMEOUT_S", 5.0)
    gate = IciHealthGate(
        device="cpu", matmul_size=32, payload_mb=0.05, run_burnin=False,
        coordinator=f"127.0.0.1:{free_port()}", num_processes=2, process_id=0,
    )
    start = time.monotonic()
    try:
        report = gate.run()
    finally:
        gate.close()
    assert time.monotonic() - start < 60
    assert not report.ok
    assert report.process_count == 2 and report.slice_devices_total is None
    # The world's deadline or the store's own, whichever fires first.
    assert any("forming the world" in f for f in report.failures), report.failures
    assert any("slice agreement collective failed" in f for f in report.failures)


def test_gang_flags_parse_as_the_jax_payload_takes_them():
    from k8s_operator_libs_tpu_torch.tpu.health import build_parser, main

    cluster, nodes, mgr = build(2)
    cmd = mgr.ensure(nodes[1]).spec["containers"][0]["command"]
    args = build_parser().parse_args(cmd[3:])
    assert (args.num_processes, args.process_id, args.link_peers) == (2, 1, "host-0,host-1")
    assert args.coordinator.endswith(":8476")
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--num-processes", "2"])
