"""The port's GPU monitor manifests, shipped as package data.

The JAX package's manifest tests (``tests/test_metrics.py``
``TestMonitorManifest``, ``tests/test_manifests.py`` ``TestMonitorDaemonSet``
and ``TestQuickProbeDaemonSet``) case by case, against the port's
constants: the GPU Feature Discovery label, the ``nvidia.com/gpu``
resource, the kernel cache and the port's probe image. Then what only the
port's manifests must show: every argument of both commands parses in the
port's monitor, the cards are visible without a card request, the quick
tier carries no kernel cache and its battery launches no kernel, and every
API call the monitor makes through a pass, two identical failing
transitions, a busy skip and a quick cycle is allowed by the shipped
ClusterRole, the Event patch of a repeated Warning included.
"""

from __future__ import annotations

import importlib.resources
import importlib.util
import json
from pathlib import Path

import pytest
import yaml

from k8s_operator_libs_tpu.kube import FakeCluster
from k8s_operator_libs_tpu.kube.objects import Node, Pod
from k8s_operator_libs_tpu_torch.kube.events import EventRecorder
from k8s_operator_libs_tpu_torch.kube.resources import resource_for_kind
from k8s_operator_libs_tpu_torch.ops import flash_attention as flash_mod
from k8s_operator_libs_tpu_torch.ops import matmul as matmul_mod
from k8s_operator_libs_tpu_torch.ops._build import KERNEL_DIR_ENV
from k8s_operator_libs_tpu_torch.ops.probe_harness import QuickBatteryReport
from k8s_operator_libs_tpu_torch.parallel.topology import GPU_PRESENT_LABEL
from k8s_operator_libs_tpu_torch.tpu import monitor as port_monitor
from k8s_operator_libs_tpu_torch.tpu.health import KERNEL_CACHE_DIR, HealthReport, MxuReport
from k8s_operator_libs_tpu_torch.tpu.libtpu import TPU_RESOURCE
from k8s_operator_libs_tpu_torch.tpu.validation_pod import ValidationPodSpec

REPO = Path(__file__).resolve().parents[1]
FULL = "monitor-daemonset.yaml"
QUICK = "monitor-quickprobe-daemonset.yaml"
MODULE = "k8s_operator_libs_tpu_torch.tpu.monitor"
NODE = "gpu-node-0"


def shipped(name: str) -> Path:
    """A manifest as the installed package holds it."""
    return Path(str(importlib.resources.files("k8s_operator_libs_tpu_torch")
                    / "manifests" / name))


def docs_of(name: str) -> dict:
    with open(shipped(name)) as fh:
        return {d["kind"]: d for d in yaml.safe_load_all(fh) if d}


def container_of(name: str) -> dict:
    (container,) = docs_of(name)["DaemonSet"]["spec"]["template"]["spec"]["containers"]
    return container


def pod_spec_of(name: str) -> dict:
    return docs_of(name)["DaemonSet"]["spec"]["template"]["spec"]


def parsed_command(name: str):
    cmd = container_of(name)["command"]
    assert cmd[:3] == ["python", "-m", MODULE]
    return port_monitor.build_parser().parse_args(cmd[3:])


def rules_allow(rules: list, group: str, resource: str, verb: str) -> bool:
    return any(
        group in r.get("apiGroups", ())
        and resource in r.get("resources", ())
        and verb in r.get("verbs", ())
        for r in rules
    )


def allows(name: str, resource: str, verb: str, group: str = "") -> bool:
    return rules_allow(docs_of(name)["ClusterRole"]["rules"], group, resource, verb)


@pytest.mark.parametrize("name", [FULL, QUICK])
def test_every_manifest_parses_with_kind_and_name(name):
    with open(shipped(name)) as fh:
        docs = [d for d in yaml.safe_load_all(fh) if d]
    assert [d["kind"] for d in docs] == [
        "DaemonSet", "ServiceAccount", "ClusterRole", "ClusterRoleBinding"
    ]
    for doc in docs:
        assert doc.get("apiVersion")
        assert (doc.get("metadata") or {}).get("name")


class TestMonitorManifest:
    """``tests/test_metrics.py::TestMonitorManifest``."""

    def test_monitor_daemonset_manifest_shape(self):
        container = container_of(FULL)
        env = {e["name"]: e for e in container["env"]}
        assert env["NODE_NAME"]["valueFrom"]["fieldRef"]["fieldPath"] == "spec.nodeName"
        # Deliberately does NOT request cards (it skips busy nodes).
        resources = container.get("resources", {})
        assert TPU_RESOURCE not in (resources.get("requests") or {})
        assert any(t.get("key") == TPU_RESOURCE for t in pod_spec_of(FULL)["tolerations"])
        assert allows(FULL, "nodes", "get")
        assert allows(FULL, "nodes/status", "update")
        assert allows(FULL, "pods", "list")
        assert allows(FULL, "events", "create")


class TestMonitorDaemonSet:
    """``tests/test_manifests.py::TestMonitorDaemonSet``."""

    def test_selector_matches_template_labels(self):
        ds = docs_of(FULL)["DaemonSet"]
        match = ds["spec"]["selector"]["matchLabels"]
        labels = ds["spec"]["template"]["metadata"]["labels"]
        assert match.items() <= labels.items()

    def test_image_matches_validation_pod_spec(self):
        # The JAX test also holds the image to the Makefile's IMAGE; that
        # Makefile builds the JAX package's image, so the port's half ends
        # at the probe pod's image, which the monitor shares.
        assert container_of(FULL)["image"] == ValidationPodSpec().full_image

    def test_command_is_the_monitor_module(self):
        cmd = container_of(FULL)["command"]
        assert cmd[:3] == ["python", "-m", MODULE]
        assert importlib.util.find_spec(cmd[2]) is not None

    def test_metrics_port_consistent_with_command(self):
        container = container_of(FULL)
        declared = {p["containerPort"]: p["name"] for p in container["ports"]}
        assert declared.get(parsed_command(FULL).metrics_port) == "metrics"

    def test_node_name_from_downward_api(self):
        env = {e["name"]: e for e in container_of(FULL)["env"]}
        assert env["NODE_NAME"]["valueFrom"]["fieldRef"]["fieldPath"] == "spec.nodeName"

    def test_kernel_cache_env_matches_mount_and_constant(self):
        pod = pod_spec_of(FULL)
        container = container_of(FULL)
        env = {e["name"]: e.get("value") for e in container["env"]}
        assert env[KERNEL_DIR_ENV] == KERNEL_CACHE_DIR
        assert "JAX_COMPILATION_CACHE_DIR" not in env
        mounts = {m["name"]: m["mountPath"] for m in container["volumeMounts"]}
        volumes = {v["name"]: v for v in pod["volumes"]}
        assert mounts["kernel-cache"] == KERNEL_CACHE_DIR
        assert volumes["kernel-cache"]["hostPath"] == {
            "path": KERNEL_CACHE_DIR, "type": "DirectoryOrCreate",
        }
        # The probe pods of the node build into the same directory.
        assert ValidationPodSpec().compile_cache_dir == KERNEL_CACHE_DIR

    def test_targets_gpu_nodes_and_tolerates_taints(self):
        pod = pod_spec_of(FULL)
        terms = pod["affinity"]["nodeAffinity"][
            "requiredDuringSchedulingIgnoredDuringExecution"
        ]["nodeSelectorTerms"]
        exprs = [e for t in terms for e in t["matchExpressions"]]
        assert {"key": GPU_PRESENT_LABEL, "operator": "In", "values": ["true"]} in exprs
        tolerations = {(t.get("key"), t.get("effect")) for t in pod["tolerations"]}
        assert (TPU_RESOURCE, "NoSchedule") in tolerations
        assert (None, "NoExecute") in tolerations

    def test_rbac_covers_every_monitor_api_call(self):
        assert allows(FULL, "nodes", "get")
        assert allows(FULL, "nodes/status", "update")
        assert allows(FULL, "nodes/status", "patch")
        assert allows(FULL, "pods", "list")
        assert allows(FULL, "events", "create")
        assert allows(FULL, "events", "patch")
        check_binding(docs_of(FULL))


def check_binding(docs: dict) -> None:
    binding = docs["ClusterRoleBinding"]
    assert binding["roleRef"]["name"] == docs["ClusterRole"]["metadata"]["name"]
    (subject,) = binding["subjects"]
    sa = docs["ServiceAccount"]
    assert subject["kind"] == "ServiceAccount"
    assert subject["name"] == sa["metadata"]["name"]
    assert subject["namespace"] == sa["metadata"]["namespace"]
    assert docs["DaemonSet"]["spec"]["template"]["spec"]["serviceAccountName"] == (
        sa["metadata"]["name"]
    )


class TestQuickProbeDaemonSet:
    """``tests/test_manifests.py::TestQuickProbeDaemonSet``."""

    def test_selector_matches_template_labels(self):
        ds = docs_of(QUICK)["DaemonSet"]
        match = ds["spec"]["selector"]["matchLabels"]
        labels = ds["spec"]["template"]["metadata"]["labels"]
        assert match.items() <= labels.items()

    def test_command_is_quick_only_monitor(self):
        cmd = container_of(QUICK)["command"]
        assert cmd[:3] == ["python", "-m", MODULE]
        assert importlib.util.find_spec(cmd[2]) is not None
        args = parsed_command(QUICK)
        assert args.quick_only
        # The tier's whole point is a cadence well below the full gate's.
        assert 0 < args.quick_interval_seconds < parsed_command(FULL).interval_seconds
        # The monitor refuses a metrics port under --quick-only.
        assert args.metrics_port == 0
        assert "ports" not in container_of(QUICK)

    def test_image_matches_full_monitor_and_carries_no_kernel_cache(self):
        qc, fc = container_of(QUICK), container_of(FULL)
        assert qc["image"] == fc["image"]  # one probe payload image
        qenv = {e["name"]: e for e in qc["env"]}
        assert qenv["NODE_NAME"]["valueFrom"]["fieldRef"]["fieldPath"] == "spec.nodeName"
        # The quick battery builds nothing (its matmul is the plain
        # product), so unlike the TPU tier it mounts no cache.
        assert KERNEL_DIR_ENV not in qenv
        assert "JAX_COMPILATION_CACHE_DIR" not in qenv
        assert not qc.get("volumeMounts")
        assert not pod_spec_of(QUICK).get("volumes")

    def test_rbac_is_exactly_the_report_surface(self):
        group = "telemetry.tpu-operator.dev"
        for verb in ("get", "create", "update", "patch"):
            assert allows(QUICK, "nodehealthreports", verb, group)
        assert allows(QUICK, "nodehealthreports/status", "update", group)
        assert allows(QUICK, "nodes", "get")
        assert allows(QUICK, "pods", "list")
        for resource, verb in (("nodes/status", "update"), ("nodes/status", "patch"),
                               ("nodes", "update"), ("nodes", "patch"),
                               ("events", "create"), ("events", "patch")):
            assert not allows(QUICK, resource, verb)
        check_binding(docs_of(QUICK))

    def test_targets_gpu_nodes(self):
        pod = pod_spec_of(QUICK)
        terms = pod["affinity"]["nodeAffinity"][
            "requiredDuringSchedulingIgnoredDuringExecution"
        ]["nodeSelectorTerms"]
        keys = {e["key"] for t in terms for e in t["matchExpressions"]}
        assert GPU_PRESENT_LABEL in keys
        assert pod["tolerations"] == pod_spec_of(FULL)["tolerations"]
        assert pod["affinity"] == pod_spec_of(FULL)["affinity"]


# ----------------------------------------------------------------------
# What only the port's manifests must show.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", [FULL, QUICK])
def test_every_argument_parses_in_the_port_monitor(name):
    parser = port_monitor.build_parser()
    known = {option for action in parser._actions for option in action.option_strings}
    flags = [a for a in container_of(name)["command"][3:] if a.startswith("--")]
    assert flags and set(flags) <= known
    args = parsed_command(name)  # argparse exits on anything it cannot take
    assert args.device == "cuda"
    assert not args.in_process  # a child per cycle: no card held between cycles


@pytest.mark.parametrize("name", [FULL, QUICK])
def test_cards_visible_without_a_card_request(name):
    pod, container = pod_spec_of(name), container_of(name)
    resources = container.get("resources") or {}
    for part in ("requests", "limits"):
        assert TPU_RESOURCE not in (resources.get(part) or {})
    env = {e["name"]: e.get("value") for e in container["env"]}
    assert env["NVIDIA_VISIBLE_DEVICES"] == "all"
    assert set(env["NVIDIA_DRIVER_CAPABILITIES"].split(",")) == {"compute", "utility"}
    assert container["securityContext"] == {"privileged": True}
    assert pod["runtimeClassName"] == "nvidia"


def test_quick_battery_launches_no_kernel_on_the_cpu(monkeypatch):
    called = []

    def refuse(name):
        def wrapper(*args, **kwargs):
            called.append(name)
            raise AssertionError(f"the quick battery called {name}")
        return wrapper

    monkeypatch.setattr(matmul_mod, "matmul", refuse("matmul"))
    monkeypatch.setattr(flash_mod, "flash_attention", refuse("flash_attention"))
    publisher = RecordingPublisher()
    rc = port_monitor.run_quick_probe_loop(publisher, once=True, device="cpu")
    assert rc == 0
    assert called == []
    (checks,) = publisher.checks
    assert checks == {"ring_allreduce": True, "mxu": True}


class RecordingPublisher:
    def __init__(self):
        self.checks = []

    def publish(self, checks, metrics, links=None):
        self.checks.append(dict(checks))
        return True


# ----------------------------------------------------------------------
# RBAC from the calls the monitor makes.
# ----------------------------------------------------------------------

class RecordingClient:
    """A client that records each call's method and arguments, then makes
    it on the cluster behind it."""

    def __init__(self, inner):
        self._inner = inner
        self.calls: list[tuple[str, tuple]] = []

    def __getattr__(self, method):
        attr = getattr(self._inner, method)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            self.calls.append((method, args))
            return attr(*args, **kwargs)

        return call


#: Client method -> (API verb, subresource).
VERBS = {
    "get": ("get", ""),
    "list": ("list", ""),
    "watch": ("watch", ""),
    "create": ("create", ""),
    "update": ("update", ""),
    "update_status": ("update", "/status"),
    "patch": ("patch", ""),
    "delete": ("delete", ""),
}


def api_requests(calls) -> list[tuple[str, str, str]]:
    """Each recorded call as (API group, resource, verb); a call with no
    verb here fails the test rather than pass unchecked."""
    out = []
    for method, args in calls:
        assert method in VERBS, f"unmapped client call {method}"
        verb, sub = VERBS[method]
        kind = args[0] if isinstance(args[0], str) else args[0].raw["kind"]
        info = resource_for_kind(kind)
        out.append((info.group, info.plural + sub, verb))
    return out


def mxu(tflops=240.0):
    return MxuReport(ok=True, tflops=tflops)


PASS = HealthReport(ok=True, mxu=mxu(), elapsed_s=9.5)
FAIL = HealthReport(ok=False, mxu=mxu(), elapsed_s=9.5,
                    failures=["mxu 240.00 TFLOP/s below floor 1000000000.00"])


class ScriptedGate:
    def __init__(self, script):
        self.script = list(script)

    def run(self):
        return self.script.pop(0)


def gpu_cluster() -> FakeCluster:
    cluster = FakeCluster()
    node = Node.new(NODE, labels={GPU_PRESENT_LABEL: "true"})
    node.set_ready(True)
    cluster.create(node)
    return cluster


def full_tier_monitor(client, script):
    """The full tier as its shipped command builds it (``main()``), with
    a scripted gate in place of the per-cycle child."""
    args = parsed_command(FULL)
    publisher = (
        port_monitor.ReportPublisher(client, NODE) if args.publish_reports else None
    )
    return port_monitor.TpuHealthMonitor(
        client, NODE, gate=ScriptedGate(script),
        interval_seconds=args.interval_seconds,
        failure_threshold=args.failure_threshold,
        recorder=EventRecorder(client),
        metrics=port_monitor.MonitorMetrics(NODE),
        report_publisher=publisher,
    )


@pytest.fixture(scope="module")
def recorded():
    """The full tier through a pass, two identical failing transitions
    (the node recovers between them) and a busy skip; then one quick
    cycle."""
    cluster = gpu_cluster()
    full = RecordingClient(cluster)
    threshold = parsed_command(FULL).failure_threshold
    script = [PASS] + [FAIL] * threshold + [PASS] * 2 + [FAIL] * threshold
    monitor = full_tier_monitor(full, script)
    for _ in script:
        assert monitor.check_once() is not None
    busy = Pod.new("trainer", namespace="default")
    busy.node_name = NODE
    busy.spec["containers"] = [{"name": "t", "resources": {"limits": {TPU_RESOURCE: "8"}}}]
    busy.phase = "Running"
    cluster.create(busy)
    assert monitor.check_once() is None
    cluster.delete("Pod", "trainer", "default")

    quick = RecordingClient(cluster)
    args = parsed_command(QUICK)
    rc = port_monitor.run_quick_probe_loop(
        port_monitor.ReportPublisher(quick, NODE, source="quick-probe"),
        interval_seconds=args.quick_interval_seconds, once=True,
        battery=lambda: QuickBatteryReport(
            ok=True, checks={"ring_allreduce": True, "mxu": True},
            metrics={"mxu_tflops": 1.0, "probe_latency_s": 0.1},
        ),
        skip_cycle=port_monitor.make_quick_probe_guard(quick, NODE),
    )
    assert rc == 0
    return {"cluster": cluster, "full": api_requests(full.calls),
            "quick": api_requests(quick.calls)}


def test_the_recorded_cycles_repeat_each_event(recorded):
    events = [e.raw for e in recorded["cluster"].list("Event")]
    assert sorted((e["type"], e["count"]) for e in events) == [("Normal", 2), ("Warning", 2)]


@pytest.mark.parametrize("tier", ["full", "quick"])
def test_shipped_cluster_role_allows_every_recorded_call(recorded, tier):
    rules = docs_of(FULL if tier == "full" else QUICK)["ClusterRole"]["rules"]
    denied = sorted({r for r in recorded[tier] if not rules_allow(rules, *r)})
    assert not denied, f"{tier} tier: the ClusterRole denies {denied}"


def test_full_tier_calls_include_the_event_patch(recorded):
    assert ("", "events", "patch") in recorded["full"]
    assert ("", "events", "create") in recorded["full"]
    assert ("", "nodes/status", "update") in recorded["full"]


def test_quick_tier_writes_no_node_status_and_no_event(recorded):
    assert not [r for r in recorded["quick"] if r[1].startswith("nodes/") or r[1] == "events"]
    assert ("telemetry.tpu-operator.dev", "nodehealthreports/status", "update") in (
        recorded["quick"]
    )


def test_the_tpu_cluster_role_lacks_the_event_patch(recorded):
    """The JAX manifest grants only ``create`` on events: a monitor that
    repeats a Warning would be refused its patch (logged, never a crash,
    ``run_forever``). The port's role grants it; the JAX file is not
    edited."""
    with open(REPO / "manifests" / "monitor-daemonset.yaml") as fh:
        tpu = {d["kind"]: d for d in yaml.safe_load_all(fh) if d}
    rules = tpu["ClusterRole"]["rules"]
    denied = {r for r in recorded["full"] if not rules_allow(rules, *r)}
    assert denied == {("", "events", "patch")}



def test_chip_smoke_monitor_manifest_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s monitor_manifest phase on the CPU: each shipped
    DaemonSet's command run as its kubelet would over ``ApiStub``, with
    ``--device cpu`` (and the full tier's portable preset, which builds no
    kernel). Every check of the phase passes but the last, the kernel
    cache's, which only a card can meet."""
    from k8s_operator_libs_tpu_torch.parallel import topology
    from test_torch_cuda import chip_smoke_module

    smoke = chip_smoke_module()
    monkeypatch.setattr(topology, "local_gpu_labels", lambda: {
        GPU_PRESENT_LABEL: "true", "nvidia.com/gpu.count": "1",
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
    })

    class CpuPod(smoke.DaemonSetPod):
        def __init__(self, docs, label, workdir, kubeconfig, host_paths, flags=None):
            flags = {**(flags or {}), "--device": "cpu"}
            if label != "quick":
                flags["--gate-preset"] = "portable"
            super().__init__(docs, label, workdir, kubeconfig, host_paths, flags)

    monkeypatch.setattr(smoke, "DaemonSetPod", CpuPod)
    with pytest.raises(AssertionError, match="pod 1 did not build"):
        smoke.monitor_manifest_phase("cpu", {"matmul": 0, "flash_attention": 0})
    (info,) = [json.loads(line)["monitor_manifest"] for line in capsys.readouterr().out.splitlines()
               if line.startswith('{"monitor_manifest"')]
    assert info["denied"] == {}
    seen = info["requests"]
    assert {"update nodes/status", "create events"} <= set(seen["full_1"])
    assert set(seen["full_2"]) <= {"get nodes", "list pods"}
    assert "patch events" in seen["full_flap"]
    assert max(info["full_flap"]["warning_counts"]) >= 2
    assert "update telemetry.tpu-operator.dev/nodehealthreports/status" in seen["quick"]
    assert not [r for r in seen["quick"] if "nodes/status" in r or "events" in r]
    assert info["quick"]["node_rv_unchanged"]
    assert info["full_1"]["launches"] == {"matmul": 0, "flash_attention": 0}
