"""The roll cell: the port's state machine rolling a new NVIDIA driver over
a pool of one-card GPU nodes in a large cluster.

The cluster is the port's ``FakeCluster``, read through ``CachedClient``;
the manager is ``ClusterUpgradeStateManager`` with the snapshot source the
port's controller command uses by default (three LISTs a pass), the GPU
pods' deletion on, and each node validated in process by the shipped gate
(``with_validation_enabled(validation_hook=...)``) on the card.

The other parties are the benchmark's own simulators, stepped between
passes with no sleep and no clock: the driver DaemonSet's controller and
kubelets (``DriverDaemonSet``), and the GPU workload that gives each pool
node one pod requesting a card (``GpuWorkload``). Each writes only what
changed. Passes run back to back; the window opens with a driver version
bump, and if the pool finishes inside it, the version is bumped again.

The in-memory cluster stands for the API server, which in a deployment is
another process: its store is in no controller's heap. So ``before_torch``
builds it before torch, the gate or the state machine is imported and
freezes the heap then (``gc.freeze()``): the interpreter's start-up, the
port's ``kube`` modules and the cluster. Torch, the gate, the state
machine and everything the passes make stay in the collector's view, as in
a controller that validates in process.
"""

from __future__ import annotations

import gc
import math
import random
import time
from dataclasses import dataclass
from typing import Optional

from ..record import Run
from ..reference import inputs
from ..reference.guarantees import RollChecker

GPU_RESOURCE = "nvidia.com/gpu"


def node_object(name: str, labels: dict, resources: dict):
    """A Node as a kubelet reports it (about 2.6 KB of JSON)."""
    from k8s_operator_libs_tpu_torch.kube.objects import Node

    node = Node.new(name, labels={**labels, "kubernetes.io/hostname": name,
                                  "kubernetes.io/os": "linux", "kubernetes.io/arch": "amd64",
                                  "topology.kubernetes.io/zone": "us-central1-a"})
    stamp = "2026-01-01T00:00:00Z"
    node.raw["spec"] = {"podCIDR": "10.64.0.0/24",
                        "providerID": f"gce://fleet/us-central1-a/{name}"}
    node.raw["status"] = {
        "capacity": dict(resources),
        "allocatable": dict(resources),
        "conditions": [
            {"type": kind, "status": status, "reason": reason,
             "lastHeartbeatTime": stamp, "lastTransitionTime": stamp}
            for kind, status, reason in (
                ("MemoryPressure", "False", "KubeletHasSufficientMemory"),
                ("DiskPressure", "False", "KubeletHasNoDiskPressure"),
                ("PIDPressure", "False", "KubeletHasSufficientPID"),
                ("Ready", "True", "KubeletReady"),
            )
        ],
        "addresses": [{"type": "InternalIP", "address": "10.128.0.2"},
                      {"type": "Hostname", "address": name}],
        "daemonEndpoints": {"kubeletEndpoint": {"Port": 10250}},
        "nodeInfo": {
            "kernelVersion": "6.8.0-1015-gcp", "osImage": "Ubuntu 22.04.4 LTS",
            "containerRuntimeVersion": "containerd://1.7.19", "kubeletVersion": "v1.30.3",
            "kubeProxyVersion": "v1.30.3", "operatingSystem": "linux", "architecture": "amd64",
        },
        "images": [
            {"names": [f"nvcr.io/nvidia/{image}"], "sizeBytes": size}
            for image, size in (("driver:550.54.15-ubuntu22.04", 1450000000),
                                ("k8s-device-plugin:v0.16.2", 130000000),
                                ("gpu-feature-discovery:v0.16.2", 120000000),
                                ("dcgm-exporter:3.3.7-3.5.0-ubuntu22.04", 450000000))
        ],
    }
    return node


class DriverDaemonSet:
    """The driver DaemonSet's controller and the kubelets of its nodes: a
    ControllerRevision a version, and on every pool node a driver pod at
    the newest one, Ready, made again when the state machine deletes it."""

    def __init__(self, client, conf: dict, pool: list) -> None:
        from k8s_operator_libs_tpu_torch.kube.objects import DaemonSet

        self.client = client
        self.namespace = conf["namespace"]
        self.labels = dict(conf["labels"])
        self.pool = list(pool)
        self.revision = 0
        self.version = ""
        ds = DaemonSet.new(conf["name"], namespace=self.namespace)
        ds.match_labels = dict(self.labels)
        ds.labels.update(self.labels)
        ds.raw["status"] = {"desiredNumberScheduled": len(self.pool)}
        self.ds = DaemonSet(client.create(ds).raw)

    def publish(self, version: str) -> None:
        """A new driver version: a new ControllerRevision, whose name after
        the DaemonSet's is the hash its pods carry."""
        from k8s_operator_libs_tpu_torch.kube.objects import ControllerRevision

        self.revision += 1
        self.version = f"{version}-{self.revision}"
        cr = ControllerRevision.new(f"{self.ds.name}-{self.version}", namespace=self.namespace)
        cr.revision = self.revision
        cr.labels.update(self.labels)
        cr.labels["controller-revision-hash"] = self.version
        cr.add_owner_reference(self.ds)
        self.client.create(cr)

    def pod_name(self, node: str) -> str:
        return f"{self.ds.name}-{node}"

    def versions(self) -> dict:
        """Node -> the version of its driver pod (read without a copy)."""
        return {
            raw["spec"]["nodeName"]: raw["metadata"]["labels"].get("controller-revision-hash", "")
            for raw in self.client.list_peek("Pod", namespace=self.namespace,
                                             label_selector=dict(self.labels))
        }

    def step(self, versions: dict) -> None:
        """Every pool node without a driver pod gets one at the newest
        version, Ready (``versions``: ``self.versions()`` of this tick)."""
        from k8s_operator_libs_tpu_torch.kube.objects import Pod

        for node in self.pool:
            if node in versions:
                continue
            pod = Pod.new(self.pod_name(node), namespace=self.namespace, labels=self.labels)
            pod.labels["controller-revision-hash"] = self.version
            pod.node_name = node
            pod.add_owner_reference(self.ds)
            pod.raw["status"] = {
                "phase": "Running",
                "conditions": [{"type": "Ready", "status": "True"}],
                "containerStatuses": [{"name": "nvidia-driver-ctr", "ready": True,
                                       "restartCount": 0}],
            }
            self.client.create(pod)
            versions[node] = self.version


class GpuWorkload:
    """One pod requesting a card on every pool node, made again on a node
    once it is back in service (uncordoned and done)."""

    def __init__(self, client, conf: dict, pool: list) -> None:
        self.client = client
        self.namespace = conf["namespace"]
        self.labels = dict(conf["labels"])
        self.pool = list(pool)
        self.per_node = int(conf["pods_per_node"])

    def pods(self) -> set:
        return {raw["metadata"]["name"]
                for raw in self.client.list_peek("Pod", namespace=self.namespace,
                                                 label_selector=dict(self.labels))}

    def step(self, in_service: set) -> None:
        from k8s_operator_libs_tpu_torch.kube.objects import Pod

        present = self.pods()
        for node in self.pool:
            if node not in in_service:
                continue
            for i in range(self.per_node):
                name = f"gpu-job-{node}-{i}"
                if name in present:
                    continue
                pod = Pod.new(name, namespace=self.namespace, labels=self.labels)
                pod.node_name = node
                pod.metadata["ownerReferences"] = [
                    {"apiVersion": "apps/v1", "kind": "ReplicaSet", "name": "gpu-job",
                     "uid": "uid-gpu-job", "controller": True}]
                pod.raw["spec"]["containers"] = [{
                    "name": "train", "image": "nvcr.io/nvidia/pytorch:24.08-py3",
                    "resources": {"limits": {GPU_RESOURCE: "1"},
                                  "requests": {GPU_RESOURCE: "1"}}}]
                pod.raw["status"] = {"phase": "Running"}
                self.client.create(pod)


def uses_gpu(pod) -> bool:
    """The GPU Operator's deletion filter: a pod that requests a card."""
    for container in (pod.raw.get("spec") or {}).get("containers") or []:
        resources = container.get("resources") or {}
        for group in ("limits", "requests"):
            if GPU_RESOURCE in (resources.get(group) or {}):
                return True
    return False


@dataclass
class Cluster:
    """The in-memory cluster of one run and the simulators that write to
    it: the stand-ins for the API server, the driver DaemonSet and the
    GPU workload."""

    store: object
    pool: list
    driver: DriverDaemonSet
    workload: GpuWorkload


def build_cluster(config: dict, seed: int) -> Cluster:
    """Every node of the configuration's cluster, the driver DaemonSet at
    the first version and the GPU workload; the pool placed among the node
    names by ``seed`` (the work is the same for every seed)."""
    from k8s_operator_libs_tpu_torch.kube.fake import FakeCluster

    conf = config["cluster"]
    total = conf["other_nodes"] + conf["pool_nodes"]
    rng = random.Random(inputs.stream(seed, "roll.pool"))
    pool_index = set(rng.sample(range(total), conf["pool_nodes"]))
    names = [f"node-{i:04d}" for i in range(total)]
    store = FakeCluster()
    for i, name in enumerate(names):
        group = "pool" if i in pool_index else "other"
        store.create(node_object(name, conf[group]["labels"], conf[group]["resources"]))
    pool = [n for i, n in enumerate(names) if i in pool_index]
    driver = DriverDaemonSet(store, config["driver"], pool)
    driver.publish(config["driver"]["versions"][0])
    return Cluster(store, pool, driver, GpuWorkload(store, config["workload"], pool))


def before_torch(ctx) -> None:
    """Build the run's cluster and freeze the heap, before torch or any
    other module of the port than ``kube`` is imported (module doc); the
    count of frozen objects goes to the run's notes."""
    ctx.prepared = build_cluster(ctx.config, ctx.seed)
    gc.collect()
    gc.freeze()
    ctx.notes["gc_frozen_objects"] = gc.get_freeze_count()


class Roll:
    """The cluster, the simulators, the manager and the checker of one run."""

    def __init__(self, config: dict, seed: int, validation_hook, run: Run,
                 cluster: Optional[Cluster] = None) -> None:
        from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
        from k8s_operator_libs_tpu_torch.kube.cache import CachedClient
        from k8s_operator_libs_tpu_torch.upgrade import (
            ClusterUpgradeStateManager,
            DeviceClass,
            TaskRunner,
        )

        cluster = cluster or build_cluster(config, seed)
        self.run = run
        self.state_label = config["state_label"]
        self.versions_list = list(config["driver"]["versions"])
        self.cluster = cluster.store
        self.pool = cluster.pool
        self.driver = cluster.driver
        self.workload = cluster.workload
        self.pool_selector = dict(config["cluster"]["pool"]["selector"])
        reader_conf = config["reader"]
        self.reader = CachedClient(self.cluster, sync_mode=reader_conf["sync_mode"],
                                   lag_seconds=reader_conf["lag_seconds"])
        # The runner's inline mode, the port's for a simulated roll: a
        # node's pod deletion runs inside its pass, so a pass never races
        # a background thread and the passes a node takes do not vary.
        self.mgr = ClusterUpgradeStateManager(self.cluster, DeviceClass.nvidia("gpu"),
                                              reader=self.reader,
                                              runner=TaskRunner(inline=True))
        self.mgr.with_pod_deletion_enabled(uses_gpu)
        self.policy = DriverUpgradePolicySpec.from_dict(config["upgrade_policy"])
        self.max_unavailable = _count(config["upgrade_policy"]["maxUnavailable"], len(self.pool))
        self.checker = RollChecker(self.policy.max_parallel_upgrades, self.max_unavailable)
        self.hook = validation_hook
        self.mgr.with_validation_enabled(validation_hook=self._hook)
        self.passes = 0
        self.bumps = 0
        self._observation: Optional[dict] = None

    def _hook(self, node) -> bool:
        with self.run.span("gate"):
            ok = self.hook(node)
        self.checker.verdict(node.name, ok, time.perf_counter())
        return ok

    def observe(self) -> tuple[dict, dict]:
        """Each pool node's (state, cordoned), and its driver pod's version,
        read without a copy."""
        nodes = {
            raw["metadata"]["name"]: (raw["metadata"]["labels"].get(self.state_label, ""),
                                      bool(raw["spec"].get("unschedulable")))
            for raw in self.cluster.list_peek("Node", label_selector=self.pool_selector)
        }
        return nodes, self.driver.versions()

    def one_pass(self, count_stall: bool = True) -> None:
        """The simulators' tick, then one pass, then an observation."""
        from k8s_operator_libs_tpu_torch.upgrade import BuildStateError

        began = time.perf_counter()
        nodes, versions = self._observation or self.observe()
        with self.run.span("sim"):
            self.driver.step(versions)
            in_service = {n for n, (state, out) in nodes.items()
                          if not out and state in ("", "upgrade-done")}
            self.workload.step(in_service)
        self.passes += 1
        passing = time.perf_counter()
        try:
            with self.run.span("pass.snapshot"):
                state = self.mgr.build_state(self.driver.namespace, self.driver.labels)
            self.run.count("pass.snapshot_s", self.mgr.last_pass_stats.snapshot_s)
            with self.run.span("pass.apply"):
                self.mgr.apply_state(state, self.policy)
        except BuildStateError:
            self.run.count("pass.aborted", 1)
        observing = time.perf_counter()
        self.run.count("pass.wall_s", observing - passing)
        nodes, versions = self.observe()
        self.run.count("harness_s", passing - began + time.perf_counter() - observing)
        self._observation = (nodes, versions)
        self.checker.observe(time.perf_counter(), nodes, versions, self.driver.version,
                             count_stall=count_stall)

    def settled(self) -> bool:
        nodes, versions = self._observation or self.observe()
        return all(state == "upgrade-done" and not out for state, out in nodes.values()) and all(
            versions.get(n) == self.driver.version for n in self.pool)

    def bump(self) -> None:
        """The next driver version (the list's versions in turn)."""
        self.bumps += 1
        self.driver.publish(self.versions_list[self.bumps % len(self.versions_list)])

    def close(self) -> None:
        self.mgr.runner.shutdown()
        self.reader.close()
        self.cluster.close()


def _count(value, total: int) -> int:
    """An int or a percentage of ``total`` (rounded down, at least 1)."""
    if isinstance(value, str) and value.endswith("%"):
        return max(1, math.floor(total * float(value[:-1]) / 100))
    return int(value)


def run_cell(ctx):
    """One run of a roll cell (``ctx``: ``run.Context``): a
    ``drivers.gate.Outcome``."""
    from . import gate as gate_driver

    config, traffic = ctx.config, ctx.traffic
    conf = config["gate"]
    run = Run(trace=ctx.trace)
    run.notes.update(ctx.notes)
    run.work = gate_driver.probe_work(conf)
    gate = gate_driver.make_gate(conf, ctx.cards, ctx.device)
    probes = gate_driver.GateProbes(gate, conf, ctx.seed, run, traffic["sample_outputs"])
    roll = None

    def hook(node) -> bool:
        return probes.battery().ok

    try:
        gate_driver.warm(gate, probes, traffic["warmup_batteries"])
        roll = Roll(config, ctx.seed, hook, run, cluster=ctx.prepared)
        for _ in range(traffic["settle_passes_max"]):
            roll.one_pass(count_stall=False)
            if roll.settled():
                break
        else:
            raise RuntimeError("the pool did not settle at the first driver version")
        traced = ctx.start_trace(gate._world)
        setup_s = ctx.setup_seconds()
        first_pass = roll.passes
        with ctx.window(run):
            start = time.perf_counter()
            deadline = start + ctx.seconds
            roll.bump()
            while time.perf_counter() < deadline:
                roll.one_pass()
                if roll.settled():
                    roll.bump()
            window_end = time.perf_counter()
        ctx.stop_trace(traced, gate._world, run)
        window_passes = roll.passes - first_pass
        ended_in_window = list(roll.checker.ended)
        # The node-rolls under way finish, outside the window.
        for _ in range(traffic["grace_passes"]):
            if not roll.checker.open:
                break
            roll.one_pass(count_stall=False)
        peak = gate_driver.memory_peak(gate, ctx.cards) if ctx.device is None else 0
        probes.host_outputs()
    finally:
        probes.uninstall()
        if roll is not None:
            roll.close()
        gate.close()
    window_s = window_end - start
    for name in ("pass.snapshot_s", "pass.wall_s", "harness_s"):
        run.notes[name] = gate_driver.spread_note(run.counters[name][-window_passes:])
    run.notes["battery_s"] = gate_driver.spread_note([b.seconds for b in probes.batteries])
    gate_driver.span_notes(run)
    done = [r for r in ended_in_window if r.uncordoned_at <= window_end]
    run.count("window.passes", window_passes)
    run.count("window.node_rolls", len(done))
    checker = roll.checker
    end_to_end = {}
    if done:
        end_to_end["roll_s_per_node"] = window_s / len(done)
        end_to_end["node_out_s"] = sum(r.uncordoned_at - r.cordoned_at for r in done) / len(done)
    numbers = probes.numbers()
    failed = {r.node for r in checker.ended if not r.ok} | checker.failed_nodes
    numbers.update({
        "guarantee_violations": float(checker.violation_count()),
        "node_rolls_unfinished": float(checker.unfinished()),
        "node_rolls_failed": float(len(failed)),
        "longest_stall_passes": float(checker.longest_stall),
    })
    return gate_driver.Outcome(
        end_to_end=end_to_end,
        attempted=len(checker.ended) + checker.unfinished(),
        failed=len(failed) + checker.unfinished(),
        numbers=numbers,
        limits=config["limits"],
        run=run,
        memory_peak_bytes=peak,
        setup_s=setup_s,
    )
