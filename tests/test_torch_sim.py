"""The port's simulators (``kube/sim.py``) against the JAX package's, tick by
tick, on twin clusters.

Each case makes two ``FakeCluster``s alike; the JAX simulator runs over
one in process, the port's over the port's ``RestClient`` at a
``LocalApiServer`` serving the other. After every tick the two clusters
must hold the same objects (:func:`view`: each object's labels,
annotations, spec, status and owners, the server's own stamps left out)
and the simulators must say the same:

* ``DaemonSetSimulator``: settle, a template bump, the machine deleting
  driver pods; at once, after ``readiness_steps``, and through the
  safe-load gate until the annotation is removed;
* ``ValidationPodSimulator`` with a ``decide`` per node: a healthy and an
  unhealthy probe pod after ``readiness_steps``, a pod deleted mid-way;
* ``KubeletPayloadExecutor`` behind each package's
  ``ValidationPodSimulator``: the port's own probe pod
  (``ValidationPodManager``), whose command is ``python -m
  k8s_operator_libs_tpu_torch.tpu.health``, run with ``--device cpu``;
  the pod turns Ready from its ready file on both sides, with the same
  verdict history.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from pathlib import Path

import pytest

from builders import make_node
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube import Pod as JaxPod
from k8s_operator_libs_tpu.kube import sim as jax_sim
from k8s_operator_libs_tpu_torch.kube import sim as port_sim
from k8s_operator_libs_tpu_torch.kube.objects import Pod
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.tpu.validation_pod import (
    ValidationPodManager,
    ValidationPodSpec,
)

REPO = Path(__file__).resolve().parents[1]
NS = "driver-ns"
PROBE_NS = "kube-system"
SAFE_LOAD = "nvidia.com/gpu-driver-upgrade.driver-wait-for-safe-load"

#: Stamped by the server, so different on twin clusters.
SERVER_FIELDS = ("resourceVersion", "uid", "creationTimestamp", "generation",
                 "managedFields", "deletionTimestamp")


def view(cluster: FakeCluster) -> dict:
    """Every object of the kinds the simulators touch, without the
    server's stamps."""
    out = {}
    for kind in ("Node", "Pod", "DaemonSet", "ControllerRevision"):
        for obj in cluster.list(kind):
            meta = dict(obj.raw.get("metadata") or {})
            for key in SERVER_FIELDS:
                meta.pop(key, None)
            meta["ownerReferences"] = [
                {k: v for k, v in ref.items() if k != "uid"}
                for ref in meta.get("ownerReferences") or []
            ]
            out[(kind, obj.namespace, obj.name)] = (
                meta, obj.raw.get("spec") or {}, obj.raw.get("status") or {},
            )
    return out


class Twins:
    """Two clusters of ``nodes`` nodes; ``clients["jax"]`` is one of them,
    ``clients["port"]`` a ``RestClient`` at a server of the other."""

    def __init__(self, stack: contextlib.ExitStack, nodes: int = 3) -> None:
        self.clusters = {"jax": FakeCluster(), "port": FakeCluster()}
        for cluster in self.clusters.values():
            for i in range(nodes):
                cluster.create(make_node(f"node-{i}"))
        server = stack.enter_context(LocalApiServer(cluster=self.clusters["port"]))
        self.clients = {"jax": self.clusters["jax"],
                        "port": RestClient(RestConfig(server=server.url))}

    def check(self, label: str) -> None:
        views = {side: view(c) for side, c in self.clusters.items()}
        assert views["port"] == views["jax"], label


def _same(outcomes: dict, label: str):
    assert outcomes["port"] == outcomes["jax"], label
    return outcomes["port"]


@pytest.mark.parametrize("readiness_steps, safe_load", [(0, ""), (2, ""), (0, SAFE_LOAD)],
                         ids=["at-once", "readiness-2", "safe-load"])
def test_daemonset_simulator_matches_jax_tick_by_tick(readiness_steps, safe_load):
    with contextlib.ExitStack() as stack:
        twins = Twins(stack)
        mods = {"jax": jax_sim, "port": port_sim}
        sims = {
            side: mods[side].DaemonSetSimulator(
                twins.clients[side], name="driver", namespace=NS, match_labels={"app": "driver"},
                readiness_steps=readiness_steps, initial_hash="550",
            )
            for side in mods
        }
        twins.check("created")
        for sim in sims.values():
            sim.settle()
        twins.check("settled")
        assert _same({s: sim.all_pods_ready_and_current() for s, sim in sims.items()}, "settled")
        for sim in sims.values():
            sim.safe_load_annotation = safe_load
            sim.set_template_hash("560")
        twins.check("bumped")
        ready = []
        for tick in range(6):
            if tick in (0, 2):
                # The machine deletes a stale driver pod, one a time.
                for side, cluster in twins.clusters.items():
                    cluster.delete("Pod", sims[side].pod_name(f"node-{tick // 2}"), NS)
            if tick == 4 and safe_load:
                # The machine unblocks the loads: the annotation goes.
                for cluster in twins.clusters.values():
                    for name in ("node-0", "node-1"):
                        cluster.patch("Node", name, patch={
                            "metadata": {"annotations": {safe_load: None}}})
            for sim in sims.values():
                sim.step()
            twins.check(f"tick {tick}")
            ready.append(_same({s: sim.all_pods_ready_and_current() for s, sim in sims.items()},
                               f"tick {tick}"))
        pods = {p.name: Pod(p.raw) for p in twins.clusters["port"].list("Pod", namespace=NS)}
        renewed = [pods[f"driver-node-{i}"].labels["controller-revision-hash"] for i in range(3)]
        assert renewed == ["560", "560", "550"] and not any(ready)
        if safe_load:
            node = twins.clusters["port"].get("Node", "node-2")
            assert safe_load not in node.annotations  # node-2 was never recreated
            assert all(pods[f"driver-node-{i}"].is_ready() for i in range(2))


def test_validation_pod_simulator_matches_jax_tick_by_tick():
    with contextlib.ExitStack() as stack:
        twins = Twins(stack)
        for cluster in twins.clusters.values():
            for i in range(3):
                pod = Pod.new(f"probe-node-{i}", namespace=PROBE_NS,
                              labels={"app": "gpu-health-probe"})
                pod.node_name = f"node-{i}"
                pod.raw["status"] = {"phase": "Pending"}
                cluster.create(JaxPod(copy.deepcopy(pod.raw)))
        mods = {"jax": jax_sim, "port": port_sim}
        sims = {
            side: mods[side].ValidationPodSimulator(
                twins.clients[side], namespace=PROBE_NS, label_selector="app=gpu-health-probe",
                readiness_steps=2, decide=lambda pod: pod.raw["spec"]["nodeName"] != "node-1",
            )
            for side in mods
        }
        phases = []
        for tick in range(4):
            if tick == 1:
                for cluster in twins.clusters.values():
                    cluster.delete("Pod", "probe-node-2", PROBE_NS)
            for sim in sims.values():
                sim.step()
            twins.check(f"tick {tick}")
            phases.append({p.name: Pod(p.raw).phase
                           for p in twins.clusters["port"].list("Pod", namespace=PROBE_NS)})
        assert phases[0] == {f"probe-node-{i}": "Pending" for i in range(3)}
        assert phases[-1] == {"probe-node-0": "Running", "probe-node-1": "Failed"}
        assert _same({s: dict(sim._pending) for s, sim in sims.items()}, "counters") == {}


def test_kubelet_payload_executor_runs_the_ports_payload_on_the_cpu(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    spec = ValidationPodSpec(payload_mb=0.05, matmul_size=64, run_flash_attention=False,
                             run_seq_parallel_probes=False, compile_cache_dir="")

    def keep_output(side):
        def transform(pod, argv):
            out = str(tmp_path / f"{side}-{pod.name}")
            return ["/bin/sh", "-c", 'exec "$@" >"$0.out" 2>"$0.err"', out, *argv]
        return transform

    with contextlib.ExitStack() as stack:
        twins = Twins(stack, nodes=1)
        mods = {"jax": jax_sim, "port": port_sim}
        executors = {
            side: stack.enter_context(mods[side].KubeletPayloadExecutor(
                env=env, extra_args=["--device", "cpu"], timeout_seconds=240,
                argv_transform=keep_output(side)))
            for side in mods
        }
        sims = {
            side: mods[side].ValidationPodSimulator(
                twins.clients[side], namespace=spec.namespace, label_selector=spec.pod_selector,
                executor=executors[side])
            for side in mods
        }
        for side, client in twins.clients.items():
            ValidationPodManager(client, spec).ensure(client.get("Node", "node-0"))
        pod_name = ValidationPodManager(twins.clients["port"], spec).pod_name("node-0")
        command = twins.clusters["port"].get("Pod", pod_name, spec.namespace).spec[
            "containers"][0]["command"]
        assert "k8s_operator_libs_tpu_torch.tpu.health" in command
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            for sim in sims.values():
                sim.step()
            if all(e.history.get(pod_name) is not None for e in executors.values()):
                break
            time.sleep(0.2)
        for sim in sims.values():
            sim.step()  # the pod turns Ready from the recorded verdict
        twins.check("after the payloads")
        history = _same({s: dict(e.history) for s, e in executors.items()}, "verdicts")
        assert history == {pod_name: True}
        pod = Pod(twins.clusters["port"].get("Pod", pod_name, spec.namespace).raw)
        assert pod.is_ready() and pod.phase == "Running"
        content = _same({s: "ok=True" in (e.ready_file_content(pod_name) or "")
                         for s, e in executors.items()}, "ready files")
        assert content
        kernels = (tmp_path / f"port-{pod_name}.err").read_text()
        assert '"kernels"' in kernels
        # The pod deleted: the kubelet kills its parked payload.
        for cluster in twins.clusters.values():
            cluster.delete("Pod", pod_name, spec.namespace)
        for sim in sims.values():
            sim.step()
        assert _same({s: e.tracked_pods() for s, e in executors.items()}, "released") == set()
