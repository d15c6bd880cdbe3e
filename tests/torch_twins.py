"""Twin clusters for the parity tests of the port's snapshot sources and
write batcher (``tests/test_torch_{snapshot_source,write_batching,
incremental_state}.py``).

A :class:`Side` is one in-memory ``FakeCluster`` of the JAX package with
GPU nodes and a driver DaemonSet settled on them by the JAX
``DaemonSetSimulator``. On the ``jax`` side the JAX machine runs over the
cluster itself; on the ``port`` side the port's machine runs over the
port's ``RestClient`` against a ``LocalApiServer`` serving the cluster.
:data:`PKGS` names each package's classes, so that one scenario, written
once against ``side.pkg``, runs on both sides; the tests then compare what
each side's cluster holds (:func:`node_view`) and what each machine
counted.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace

from builders import make_node
from k8s_operator_libs_tpu import upgrade as jax_upgrade
from k8s_operator_libs_tpu.api import DriverUpgradePolicySpec as JaxPolicy
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube import Node as JaxNode
from k8s_operator_libs_tpu.kube import client as jax_client
from k8s_operator_libs_tpu.kube.informer import Informer as JaxInformer
from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator
from k8s_operator_libs_tpu.kube.watchhub import WatchHub as JaxWatchHub
from k8s_operator_libs_tpu.upgrade import state_provider as jax_state_provider
from k8s_operator_libs_tpu.upgrade import write_batch as jax_write_batch
from k8s_operator_libs_tpu.upgrade.consts import NULL_STRING as JAX_NULL
from k8s_operator_libs_tpu.utils import faultpoints as jax_faultpoints
from k8s_operator_libs_tpu_torch import upgrade as port_upgrade
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from k8s_operator_libs_tpu_torch.kube import client as port_client
from k8s_operator_libs_tpu_torch.kube.informer import Informer
from k8s_operator_libs_tpu_torch.kube.objects import Node
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.kube.watchhub import WatchHub
from k8s_operator_libs_tpu_torch.upgrade import state_provider as port_state_provider
from k8s_operator_libs_tpu_torch.upgrade import write_batch as port_write_batch
from k8s_operator_libs_tpu_torch.upgrade.consts import NULL_STRING
from k8s_operator_libs_tpu_torch.utils import faultpoints

NS = "driver-ns"
LABELS = {"app": "driver"}
#: The policy of the JAX files: every node at once.
POLICY = {"autoUpgrade": True, "maxParallelUpgrades": 0, "maxUnavailable": "100%"}


def _pkg(upgrade, policy_cls, node_cls, client_mod, provider_mod, batch_mod, fault_mod,
         informer_cls, null, hub_cls):
    device = upgrade.DeviceClass.nvidia("gpu")
    return SimpleNamespace(
        upgrade=upgrade,
        device=device,
        keys=upgrade.UpgradeKeys(device),
        policy=policy_cls.from_dict(POLICY),
        policy_cls=policy_cls,
        Node=node_cls,
        ConflictError=client_mod.ConflictError,
        Provider=provider_mod.NodeUpgradeStateProvider,
        WriteBatcher=batch_mod.WriteBatcher,
        WriteBatchError=batch_mod.WriteBatchError,
        faultpoints=fault_mod,
        Informer=informer_cls,
        NULL=null,
        WatchHub=hub_cls,
    )


PKGS = {
    "jax": _pkg(jax_upgrade, JaxPolicy, JaxNode, jax_client, jax_state_provider,
                jax_write_batch, jax_faultpoints, JaxInformer, JAX_NULL, JaxWatchHub),
    "port": _pkg(port_upgrade, DriverUpgradePolicySpec, Node, port_client,
                 port_state_provider, port_write_batch, faultpoints, Informer, NULL_STRING,
                 WatchHub),
}
#: The port's keys are the JAX package's, byte for byte.
KEYS = PKGS["port"].keys
assert KEYS.state_label == PKGS["jax"].keys.state_label


class Recorder:
    def __init__(self) -> None:
        self.events: list[tuple] = []

    def eventf(self, obj, event_type, reason, fmt, *args) -> None:
        self.events.append((obj.name, event_type, reason, fmt % args if args else fmt))


class Side:
    """One cluster (``nodes`` GPU nodes, the driver DaemonSet settled on
    them unless ``driver`` is False) and the client its machine runs
    over: the cluster itself (``jax``) or a ``RestClient`` at a server of
    it (``port``)."""

    def __init__(self, name: str, stack: contextlib.ExitStack, nodes: int = 3,
                 driver: bool = True) -> None:
        self.name = name
        self.pkg = PKGS[name]
        self.cluster = FakeCluster()
        for i in range(nodes):
            self.cluster.create(make_node(f"node-{i}"))
        self.sim = None
        if driver:
            self.sim = DaemonSetSimulator(self.cluster, name="driver", namespace=NS,
                                          match_labels=LABELS)
            self.sim.settle()
        if name == "port":
            server = stack.enter_context(LocalApiServer(cluster=self.cluster))
            self.client = RestClient(RestConfig(server=server.url))
        else:
            self.client = self.cluster
        self.recorder = Recorder()
        self.stack = stack

    def manager(self, runner=None, options=None, **kwargs):
        up = self.pkg.upgrade
        return up.ClusterUpgradeStateManager(
            self.client, self.pkg.device,
            runner=runner if runner is not None else up.TaskRunner(inline=True),
            options=options, recorder=self.recorder, **kwargs,
        )

    def node(self, name: str):
        """The node, as this side's package views it."""
        return self.pkg.Node(self.client.get("Node", name).raw)

    def state(self, name: str) -> str:
        return (self.cluster.get("Node", name).labels or {}).get(KEYS.state_label, "")


def node_view(cluster: FakeCluster) -> dict:
    """Each node's upgrade labels and annotations and its cordon bit."""
    prefix = f"{KEYS.device.domain}/"
    view = {}
    for obj in cluster.list("Node"):
        meta = obj.raw.get("metadata") or {}
        view[obj.name] = (
            {k: v for k, v in (meta.get("labels") or {}).items() if k.startswith(prefix)},
            {k: v for k, v in (meta.get("annotations") or {}).items() if k.startswith(prefix)},
            bool((obj.raw.get("spec") or {}).get("unschedulable")),
        )
    return view


def state_shape(state) -> dict:
    """A classification to compare across clusters: node -> sorted
    (bucket, pod name, owned by a DaemonSet)."""
    shape: dict = {}
    for bucket, entries in state.node_states.items():
        for ns in entries:
            shape.setdefault(ns.node.name, []).append(
                (str(bucket), ns.driver_pod.name, ns.driver_daemonset is not None)
            )
    return {name: sorted(rows) for name, rows in shape.items()}


def pass_stats(stats, *fields) -> dict:
    return {f: getattr(stats, f) for f in fields}


#: The PassStats fields a side's pass is compared by.
STAT_FIELDS = (
    "reads_issued", "writes_issued", "writes_skipped", "writes_coalesced", "writes_batched",
    "node_errors", "snapshot_cached", "snapshot_incremental", "full_rebuild",
    "snapshot_skipped", "dirty_node_count", "nodes_reclassified", "verify_divergences",
    "delta_hit_rate",
)


def wait_until(predicate, timeout: float = 10.0, interval: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def informer_truth(source, cluster, kind) -> dict:
    """(namespace, name) -> resourceVersion of what ``kind``'s informer
    is scoped to."""
    kwargs = {}
    if kind in ("Pod", "DaemonSet"):
        kwargs = dict(namespace=source.namespace, label_selector=dict(source.driver_labels))
    elif kind == "ControllerRevision":
        kwargs = dict(namespace=source.namespace)
    return {(o.namespace, o.name): str(o.resource_version) for o in cluster.list(kind, **kwargs)}


def _store(inf) -> dict:
    with inf._lock:
        return {
            key: str((raw.get("metadata") or {}).get("resourceVersion", ""))
            for key, raw in inf._store.items()
        }


KINDS = ("Node", "Pod", "DaemonSet", "ControllerRevision")


def deliveries_caught_up(source, cluster) -> bool:
    """Every informer's store equals the cluster and every stored revision
    has been handed to the handlers."""
    for kind in KINDS:
        inf = source.informer(kind)
        truth = informer_truth(source, cluster, kind)
        with inf._dispatch_lock:
            dispatched = dict(inf._dispatched_rv)
        if _store(inf) != truth or dispatched != truth:
            return False
    return True


def stores_caught_up(source, cluster) -> bool:
    """The stores equal the cluster (the barrier once write-throughs,
    which dispatch nothing, are in play)."""
    return all(_store(source.informer(k)) == informer_truth(source, cluster, k) for k in KINDS)
