"""The port's health monitor against the JAX package's, on the CPU.

Scripted gate reports, made from a seed, drive a JAX monitor and the port's
monitor, each on a JAX in-memory cluster of its own: the Node condition,
the Events, the NodeHealthReport documents (debounce, heartbeat, the link
map carried forward), the metrics, the restart seeding, the skip label and
the busy-card skip must be the same. The JAX monitor is given the GPU
device class, so both read and write the same keys; the busy-card skip
differs only in the resource each looks for.

Then the twin of ``tests/test_monitor_e2e.py``: ``python -m
k8s_operator_libs_tpu_torch.tpu.monitor --once --gate-preset portable
--device cpu`` runs as a process against the JAX package's local API
server, its subprocess gate running the port's payload on the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube.events import EventRecorder as JaxRecorder
from k8s_operator_libs_tpu.kube.objects import Node, Pod, condition_status, set_condition
from k8s_operator_libs_tpu.tpu import health as jax_health
from k8s_operator_libs_tpu.tpu import monitor as jax_monitor
from k8s_operator_libs_tpu.upgrade import DeviceClass as JaxDeviceClass
from k8s_operator_libs_tpu_torch.kube.events import EventRecorder
from k8s_operator_libs_tpu_torch.tpu import health as port_health
from k8s_operator_libs_tpu_torch.tpu import monitor as port_monitor
from k8s_operator_libs_tpu_torch.upgrade.consts import DeviceClass, UpgradeKeys

REPO = Path(__file__).resolve().parents[1]
NODE = "gpu-node"
KEYS = UpgradeKeys(DeviceClass.nvidia("gpu"))


def scripted_reports(seed: int, cycles: int) -> list[dict]:
    """Gate reports as the payload prints them: verdicts, rates and link
    maps that wander, sometimes sick."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(cycles):
        ok = bool(rng.random() > 0.4)
        ring = float(rng.choice([45.0, 44.0, 12.0, 0.0]))
        links = []
        if rng.random() > 0.3:
            for src, peer in ((0, "device-1"), (1, "gpu-node-b")):
                links.append({
                    "src": src, "dst": src + 1, "peer": peer,
                    "ok": bool(rng.random() > 0.2),
                    "latency_s": float(rng.choice([1e-4, 3.0])),
                    "gbytes_per_s": float(rng.choice([40.0, 5.0])),
                    "error": "",
                })
        out.append({
            "ok": ok,
            "collectives": [
                {"op": "psum", "ok": ok, "elapsed_s": 0.0, "gbytes_per_s": 0.0, "error": ""},
                {"op": "ppermute_ring", "ok": True, "elapsed_s": 0.001,
                 "gbytes_per_s": ring, "error": ""},
            ],
            "mxu": {"ok": True, "tflops": float(rng.uniform(200, 250)),
                    "max_abs_err": 0.0, "error": ""},
            "burnin_ok": True,
            "elapsed_s": float(rng.uniform(0.3, 60.0)),
            "failures": [] if ok else ["psum: expected 1.0, got [0.0]"],
            "links": links,
        })
    return out


class ScriptedGate:
    def __init__(self, report_cls, script):
        self.reports = [report_cls.from_dict(json.loads(json.dumps(d))) for d in script]
        self.runs = 0

    def run(self):
        self.runs += 1
        return self.reports[self.runs - 1]


class Clock:
    def __init__(self):
        self.t = 1_000_000.0

    def __call__(self):
        return self.t


def _node(labels=None, condition=None):
    node = Node.new(NODE, labels=labels or {})
    node.set_ready(True)
    if condition is not None:
        set_condition(node.status, port_monitor.ICI_HEALTHY_CONDITION, condition,
                      reason="ProbeFailed", message="earlier")
    return node


def _busy_pod(resource):
    pod = Pod.new("trainer", namespace="default")
    pod.node_name = NODE
    pod.spec["containers"] = [{"name": "t", "resources": {"limits": {resource: "8"}}}]
    pod.phase = "Running"
    return pod


class Side:
    """One package's monitor on a cluster of its own."""

    def __init__(self, which, script, threshold, success, labels=None, condition=None,
                 busy=False, publish=True):
        self.which = which
        self.cluster = FakeCluster()
        self.cluster.create(_node(labels, condition))
        if busy:
            resource = "nvidia.com/gpu" if which == "port" else "google.com/tpu"
            self.cluster.create(_busy_pod(resource))
        self.clock = Clock()
        mod = port_monitor if which == "port" else jax_monitor
        report_cls = port_health.HealthReport if which == "port" else jax_health.HealthReport
        recorder = EventRecorder(self.cluster) if which == "port" else JaxRecorder(self.cluster)
        self.gate = ScriptedGate(report_cls, script)
        self.metrics = mod.MonitorMetrics(NODE)
        kwargs = {} if which == "port" else {"device": JaxDeviceClass.nvidia("gpu")}
        self.monitor = mod.TpuHealthMonitor(
            self.cluster, NODE, gate=self.gate,
            failure_threshold=threshold, success_threshold=success,
            recorder=recorder, metrics=self.metrics,
            report_publisher=(
                mod.ReportPublisher(self.cluster, NODE, now=self.clock, heartbeat_seconds=300.0)
                if publish else None
            ),
            **kwargs,
        )

    def cycle(self):
        report = self.monitor.check_once()
        self.clock.t += 60.0
        node = Node(self.cluster.get("Node", NODE).raw)
        cond = next(
            (
                {k: c.get(k) for k in ("type", "status", "reason", "message")}
                for c in node.status.get("conditions") or []
                if c["type"] == port_monitor.ICI_HEALTHY_CONDITION
            ),
            None,
        )
        events = sorted(
            (e.raw["type"], e.raw["reason"], e.raw["message"], e.raw["count"],
             e.raw["involvedObject"]["name"])
            for e in self.cluster.list("Event")
        )
        reports = [
            {k: r.raw[k] for k in ("apiVersion", "kind", "spec", "status")}
            for r in self.cluster.list("NodeHealthReport")
        ]
        return {
            "ran": report is not None,
            "ok": report.ok if report is not None else None,
            "condition": cond,
            "events": events,
            "reports": reports,
            # Names, types and values; the help texts are prose.
            "metrics": [ln for ln in self.metrics.render().splitlines()
                        if not ln.startswith("# HELP")],
        }


def _run_both(script, cycles, **kwargs):
    port = Side("port", script, **kwargs)
    jax = Side("jax", script, **kwargs)
    for i in range(cycles):
        assert port.cycle() == jax.cycle(), f"cycle {i}"
    return port, jax


@pytest.mark.parametrize(
    "threshold,success", [(1, 1), (3, 2), (2, 1)], ids=["t1s1", "t3s2", "t2s1"]
)
@pytest.mark.parametrize("seed", range(2))
def test_scripted_cycles_publish_what_jax_publishes(seed, threshold, success):
    script = scripted_reports(seed, 24)
    port, _ = _run_both(script, 24, threshold=threshold, success=success)
    assert port.gate.runs == 24
    reports = port.cluster.list("NodeHealthReport")
    assert len(reports) == 1 and reports[0].raw["status"]["history"]


def test_restarted_monitor_starts_from_the_published_condition():
    """The node was left False; one pass must not clear it when two are
    needed."""
    script = scripted_reports(3, 4)
    for d in script:
        d.update(ok=True, failures=[])
    port, _ = _run_both(script, 4, threshold=1, success=2, condition="False")
    cond = condition_status(Node(port.cluster.get("Node", NODE).raw).status,
                            port_monitor.ICI_HEALTHY_CONDITION)
    assert cond == "True"


def test_c17_a_floor_failure_publishes_a_degraded_report():
    """C17: a battery failed only by a floor (its ``mxu`` rate below
    ``min_mxu_tflops``) flips the condition on both monitors; the JAX
    report's checks still pass, so its publisher sees the passing cycle's
    score again and writes nothing, while the port's report fails the
    ``mxu`` check and publishes the lower score the quarantine arc reads."""
    (passing,) = scripted_reports(6, 1)
    passing.update(ok=True, failures=[], links=[])
    passing["collectives"][0]["ok"] = True
    floored = json.loads(json.dumps(passing))
    floored.update(ok=False, failures=["mxu 240.00 TFLOP/s below floor 1000000000.00"])
    sides = {w: Side(w, [passing, floored], threshold=1, success=1) for w in ("port", "jax")}
    first = {w: side.cycle() for w, side in sides.items()}
    assert first["port"] == first["jax"]
    second = {w: side.cycle() for w, side in sides.items()}
    assert second["port"]["condition"] == second["jax"]["condition"]
    assert second["port"]["condition"]["status"] == "False"
    assert second["jax"]["reports"] == first["jax"]["reports"]  # debounced
    (status,) = [r["status"] for r in second["port"]["reports"]]
    before = first["port"]["reports"][0]["status"]
    assert status["checks"] == {**before["checks"], "mxu": False}
    assert status["score"] == round(before["score"] - 60.0 / len(before["checks"]), 2)
    assert status["metrics"] == before["metrics"]  # the rate was measured


def test_skip_label_probes_nothing_as_jax():
    script = scripted_reports(4, 2)
    port, jax = _run_both(script, 2, threshold=1, success=1,
                          labels={KEYS.skip_label: "true"})
    assert port.gate.runs == jax.gate.runs == 0


def test_busy_cards_skip_the_cycle_as_jax():
    script = scripted_reports(5, 2)
    port, jax = _run_both(script, 2, threshold=1, success=1, busy=True)
    assert port.gate.runs == jax.gate.runs == 0
    assert "tpu_monitor_probes_skipped_total" in port.metrics.render()


def test_drain_skip_pods_do_not_hold_the_cards():
    cluster = FakeCluster()
    cluster.create(_node())
    pod = _busy_pod("nvidia.com/gpu")
    pod.labels[KEYS.skip_drain_pod_label] = "true"
    cluster.create(pod)
    assert not port_monitor.tpu_chips_busy(cluster, NODE, KEYS)
    guard = port_monitor.make_quick_probe_guard(cluster, NODE)
    assert guard() is None
    cluster.create(_other_busy_pod())
    assert guard() == "GPUs in use by workloads"


def _other_busy_pod():
    pod = _busy_pod("nvidia.com/gpu")
    pod.metadata["name"] = "trainer-2"
    return pod


def test_publisher_carries_the_link_map_forward_as_jax():
    """A battery with no link tier keeps the map the last one wrote."""
    results = {}
    for which, mod in (("port", port_monitor), ("jax", jax_monitor)):
        cluster, clock = FakeCluster(), Clock()
        pub = mod.ReportPublisher(cluster, NODE, now=clock)
        links = {"gpu-node-b": {"ok": False, "latency_s": 0.1, "gbytes_per_s": 1.0}}
        wrote = [pub.publish({"psum": True}, {"mxu_tflops": 200.0}, links=links)]
        for _ in range(3):
            clock.t += 60.0
            wrote.append(pub.publish({"psum": True}, {"mxu_tflops": 200.0}, links=None))
        clock.t += 60.0
        wrote.append(pub.publish({"psum": True}, {"mxu_tflops": 200.0}, links={}))
        raw = cluster.get("NodeHealthReport", NODE).raw
        results[which] = (wrote, raw["spec"], raw["status"])
    assert results["port"] == results["jax"]
    assert results["port"][0] == [True, False, False, False, True]


def test_quick_probe_loop_publishes_a_report_per_cycle():
    cluster, clock = FakeCluster(), Clock()
    cluster.create(_node())
    publisher = port_monitor.ReportPublisher(cluster, NODE, now=clock, source="quick-probe")
    rc = port_monitor.run_quick_probe_loop(
        publisher, once=True, device="cpu",
        skip_cycle=port_monitor.make_quick_probe_guard(cluster, NODE),
    )
    assert rc == 0
    raw = cluster.get("NodeHealthReport", NODE).raw
    assert raw["spec"]["source"] == "quick-probe"
    assert raw["status"]["checks"] == {"ring_allreduce": True, "mxu": True}


# ----------------------------------------------------------------------
# The monitor as a process against a local API server
# ----------------------------------------------------------------------

def _run_monitor_process(server, tmp_path, *extra, timeout=240):
    kubeconfig = tmp_path / "kubeconfig"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "local",
        "clusters": [{"name": "local", "cluster": {"server": server.url}}],
        "users": [{"name": "u", "user": {}}],
        "contexts": [{"name": "local", "context": {"cluster": "local", "user": "u"}}],
    }))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["KUBECONFIG"] = str(kubeconfig)
    env["NODE_NAME"] = NODE
    env["OMP_NUM_THREADS"] = "1"
    env.pop("KUBERNETES_SERVICE_HOST", None)
    return subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.tpu.monitor", "--once",
         "--gate-preset", "portable", "--device", "cpu", *extra],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.parametrize(
    "extra,rc,condition",
    [((), 0, "True"), (("--min-mxu-tflops", "1e9"), 1, "False")],
    ids=["pass", "impossible-floor"],
)
def test_monitor_process_writes_the_condition(tmp_path, extra, rc, condition):
    with LocalApiServer() as server:
        server.cluster.create(_node())
        proc = _run_monitor_process(server, tmp_path, "--publish-reports", *extra)
        assert proc.returncode == rc, proc.stderr[-3000:]
        node = Node(server.cluster.get("Node", NODE).raw)
        assert condition_status(node.status, port_monitor.ICI_HEALTHY_CONDITION) == condition
        events = [e.raw for e in server.cluster.list("Event")]
        assert [(e["type"], e["reason"]) for e in events] == [
            ("Normal" if rc == 0 else "Warning", "GPUDriverUpgrade")
        ]
        report = server.cluster.get("NodeHealthReport", NODE).raw
        assert report["spec"] == {"nodeName": NODE, "source": "monitor"}
        # The impossible floor fails the mxu check (C17); the rate stays.
        assert report["status"]["checks"]["mxu"] is (rc == 0)
        assert report["status"]["metrics"]["mxu_tflops"] > 0


# ----------------------------------------------------------------------
# The payload's --publish-report
# ----------------------------------------------------------------------

def _payload_args(ready):
    return ["--device", "cpu", "--matmul-size", "64", "--no-burnin", "--no-flash-attention",
            "--ready-file", str(ready), "--publish-report"]


def test_payload_publishes_its_report_as_the_gate(tmp_path, monkeypatch, capsys):
    with LocalApiServer() as server:
        server.cluster.create(_node())
        kubeconfig = tmp_path / "kubeconfig"
        kubeconfig.write_text(json.dumps({
            "current-context": "c",
            "clusters": [{"name": "c", "cluster": {"server": server.url}}],
            "users": [{"name": "u", "user": {}}],
            "contexts": [{"name": "c", "context": {"cluster": "c", "user": "u"}}],
        }))
        monkeypatch.setenv("KUBECONFIG", str(kubeconfig))
        monkeypatch.setenv("NODE_NAME", NODE)
        monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
        assert port_health.main(_payload_args(tmp_path / "ready")) == 0
        report = server.cluster.get("NodeHealthReport", NODE).raw
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    checks, metrics = port_health.HealthReport.from_dict(printed).observation()
    assert report["spec"] == {"nodeName": NODE, "source": "gate"}
    assert report["status"]["checks"] == checks
    assert report["status"]["metrics"]["mxu_tflops"] == metrics["mxu_tflops"]


def test_payload_publish_failure_never_changes_the_verdict(tmp_path, monkeypatch, caplog):
    kubeconfig = tmp_path / "kubeconfig"
    kubeconfig.write_text(json.dumps({
        "current-context": "c",
        "clusters": [{"name": "c", "cluster": {"server": "http://127.0.0.1:9"}}],
        "users": [{"name": "u", "user": {}}],
        "contexts": [{"name": "c", "context": {"cluster": "c", "user": "u"}}],
    }))
    monkeypatch.setenv("KUBECONFIG", str(kubeconfig))
    monkeypatch.setenv("NODE_NAME", NODE)
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    ready = tmp_path / "ready"
    assert port_health.main(_payload_args(ready)) == 0
    assert ready.read_text().startswith("ok=True")
    assert "NodeHealthReport publish failed" in caplog.text


def test_publish_report_needs_the_node_name(monkeypatch):
    monkeypatch.delenv("NODE_NAME", raising=False)
    with pytest.raises(SystemExit):
        port_health.main(["--device", "cpu", "--publish-report"])
