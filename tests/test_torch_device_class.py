"""The port's GPU device class against the JAX package's TPU one, on the CPU.

Keys, object views, API-error helpers, node facts, the node detector, the
driver DaemonSet and ``SliceScopedGate``: each is held against its JAX
counterpart, against the JAX package's in-memory cluster and its real
exception classes, or against the GPU facts it must read. Also the two
packaging repairs: the kernel sources ship in the wheel, and the kernels'
build directory follows ``K8S_OPERATOR_LIBS_TORCH_KERNEL_DIR``.
"""

import os
import shutil
import subprocess
import sys
import time
import zipfile
from pathlib import Path

import pytest

from builders import make_node
from k8s_operator_libs_tpu.kube import FakeCluster
from k8s_operator_libs_tpu.kube import client as jax_client
from k8s_operator_libs_tpu.kube.objects import DaemonSet as JaxDaemonSet
from k8s_operator_libs_tpu.kube.objects import Pod as JaxPod
from k8s_operator_libs_tpu.parallel.topology import (
    GKE_NODEPOOL_LABEL,
    GKE_TPU_ACCELERATOR_LABEL,
    GKE_TPU_TOPOLOGY_LABEL,
)
from k8s_operator_libs_tpu.parallel.topology import SliceTopology as JaxSliceTopology
from k8s_operator_libs_tpu.tpu import health as jax_health
from k8s_operator_libs_tpu.tpu import libtpu as jax_libtpu
from k8s_operator_libs_tpu.upgrade import consts as jax_consts
from k8s_operator_libs_tpu_torch.kube import client as port_client
from k8s_operator_libs_tpu_torch.kube import objects as port_objects
from k8s_operator_libs_tpu_torch.ops import _build
from k8s_operator_libs_tpu_torch.parallel import topology as port_topology
from k8s_operator_libs_tpu_torch.parallel.topology import (
    GPU_CLIQUE_LABEL,
    GPU_COUNT_LABEL,
    GPU_MEMORY_LABEL,
    GPU_PRESENT_LABEL,
    GPU_PRODUCT_LABEL,
    SliceTopology,
)
from k8s_operator_libs_tpu_torch.tpu import health as port_health
from k8s_operator_libs_tpu_torch.tpu import libtpu as port_libtpu
from k8s_operator_libs_tpu_torch.tpu.detector import TPU_SLICE_ID_LABEL, TpuNodeDetector
from k8s_operator_libs_tpu_torch.upgrade import consts as port_consts

REPO = Path(__file__).resolve().parents[1]
NS = "kube-system"

#: GFD labels of one HGX H100 node (8 cards of 80 GB).
H100_LABELS = {
    GPU_PRESENT_LABEL: "true",
    GPU_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3",
    GPU_COUNT_LABEL: "8",
    GPU_MEMORY_LABEL: "81559",
}


def gpu_node(name, **extra):
    return make_node(name, labels={**H100_LABELS, **extra})


# ----------------------------------------------------------------------
# upgrade/consts.py
# ----------------------------------------------------------------------

def _properties(cls):
    return [name for name, v in vars(cls).items() if isinstance(v, property)]


@pytest.mark.parametrize(
    "name,driver,domain",
    [
        ("gpu", "gpu", "nvidia.com"),
        ("gpu", "nvidia", "nvidia.com"),
        ("tpu", "libtpu", "tpu-operator.dev"),
        ("nic", "ofed", "example.org"),
    ],
)
def test_every_key_equals_jax(name, driver, domain):
    port_keys = port_consts.UpgradeKeys(port_consts.DeviceClass(name, driver, domain))
    jax_keys = jax_consts.UpgradeKeys(jax_consts.DeviceClass(name, driver, domain))
    props = _properties(port_consts.UpgradeKeys)
    assert props  # the subset is not empty
    for prop in props:
        assert getattr(port_keys, prop) == getattr(jax_keys, prop), prop


def test_nvidia_device_class_gives_the_upstream_key_shape():
    device = port_consts.DeviceClass.nvidia("gpu")
    jax_device = jax_consts.DeviceClass.nvidia("gpu")
    assert (device.name, device.driver, device.domain) == (
        jax_device.name, jax_device.driver, jax_device.domain,
    )
    keys = port_consts.UpgradeKeys(device)
    assert keys.state_label == "nvidia.com/gpu-driver-upgrade-state"
    assert keys.safe_driver_load_annotation == (
        "nvidia.com/gpu-driver-upgrade.driver-wait-for-safe-load"
    )


@pytest.mark.parametrize("bad", ["", "a/b"])
def test_device_class_rejects_what_jax_rejects(bad):
    for cls in (port_consts.DeviceClass, jax_consts.DeviceClass):
        with pytest.raises(ValueError):
            cls(name=bad, driver="gpu")
        with pytest.raises(ValueError):
            cls(name="gpu", driver=bad)


# ----------------------------------------------------------------------
# kube/objects.py and kube/client.py, against the JAX in-memory cluster
# ----------------------------------------------------------------------

def test_port_objects_round_trip_through_the_jax_cluster():
    cluster = FakeCluster()
    pod = port_objects.Pod.new("p", namespace=NS, labels={"app": "x"})
    pod.node_name = "node-a"
    created = port_objects.Pod(cluster.create(pod).raw)
    assert created.name == "p" and created.namespace == NS
    assert created.labels == {"app": "x"} and created.node_name == "node-a"
    assert created.resource_version
    assert not created.is_finished()
    cluster.patch("Pod", "p", NS, patch={"status": {"phase": "Failed"}})
    got = port_objects.Pod(cluster.get("Pod", "p", NS).raw)
    assert got.is_finished() and got.phase == "Failed"
    assert JaxPod(got.raw).is_finished()

    ds = port_objects.DaemonSet.new("d", namespace=NS)
    ds.match_labels = {"app": "d"}
    read = JaxDaemonSet(cluster.create(ds).raw)
    assert read.match_labels == {"app": "d"}
    assert port_objects.DaemonSet(read.raw).match_labels == {"app": "d"}

    node = port_objects.Node.new("n", labels=H100_LABELS)
    assert cluster.create(node).labels == H100_LABELS


def test_deep_copy_is_independent():
    pod = port_objects.Pod.new("p", labels={"a": "1"})
    copy = pod.deep_copy()
    copy.labels["a"] = "2"
    assert type(copy) is port_objects.Pod and pod.labels["a"] == "1"


def _real_errors():
    """One exception of each kind, raised by the JAX in-memory cluster."""
    cluster = FakeCluster()
    found = {}
    try:
        cluster.get("Pod", "missing", NS)
    except jax_client.NotFoundError as e:
        found["NotFound"] = e
    cluster.create(JaxPod.new("p", namespace=NS))
    try:
        cluster.create(JaxPod.new("p", namespace=NS))
    except jax_client.AlreadyExistsError as e:
        found["AlreadyExists"] = e
    stale = JaxPod(cluster.get("Pod", "p", NS).raw)
    cluster.update(JaxPod(cluster.get("Pod", "p", NS).raw))
    try:
        cluster.update(stale)
    except jax_client.ConflictError as e:
        found["Conflict"] = e
    assert set(found) == {"NotFound", "AlreadyExists", "Conflict"}
    return found


PORT_ERRORS = {
    "NotFound": port_client.NotFoundError,
    "AlreadyExists": port_client.AlreadyExistsError,
    "Conflict": port_client.ConflictError,
}


@pytest.mark.parametrize("reason", sorted(PORT_ERRORS))
def test_has_reason_tells_the_clusters_errors_apart(reason):
    errors = _real_errors()
    for other, exc in errors.items():
        assert port_client.has_reason(exc, PORT_ERRORS[reason]) == (other == reason)
    # AlreadyExists and Conflict share the HTTP status; only the reason differs.
    assert errors["AlreadyExists"].status == errors["Conflict"].status
    assert not port_client.has_reason(ValueError("x"), PORT_ERRORS[reason])


def test_get_or_none_against_the_jax_cluster():
    cluster = FakeCluster()
    assert port_client.get_or_none(cluster, "Pod", "p", NS) is None
    cluster.create(JaxPod.new("p", namespace=NS))
    assert port_client.get_or_none(cluster, "Pod", "p", NS).name == "p"

    class Broken:
        def get(self, *args):
            raise _real_errors()["Conflict"]

    with pytest.raises(jax_client.ConflictError):
        port_client.get_or_none(Broken(), "Pod", "p", NS)


def test_delete_if_exists_against_the_jax_cluster():
    cluster = FakeCluster()
    cluster.create(JaxPod.new("p", namespace=NS))
    assert port_client.delete_if_exists(cluster, "Pod", "p", NS) is True
    assert port_client.delete_if_exists(cluster, "Pod", "p", NS) is False

    class Busy:
        def delete(self, *args):
            raise _real_errors()["Conflict"]

    with pytest.raises(jax_client.ConflictError):
        port_client.delete_if_exists(Busy(), "Pod", "p", NS)


def test_retry_on_conflict_against_the_jax_clusters_errors():
    errors = _real_errors()
    calls = []

    def conflicts_twice():
        calls.append(1)
        if len(calls) < 3:
            raise errors["Conflict"]
        return "done"

    assert port_client.retry_on_conflict(conflicts_twice) == "done"
    assert len(calls) == 3

    calls.clear()

    def always_conflicts():
        calls.append(1)
        raise errors["Conflict"]

    with pytest.raises(jax_client.ConflictError):
        port_client.retry_on_conflict(always_conflicts, attempts=4)
    assert len(calls) == 4

    calls.clear()

    def exists():
        calls.append(1)
        raise errors["AlreadyExists"]

    with pytest.raises(jax_client.AlreadyExistsError):
        port_client.retry_on_conflict(exists)
    assert len(calls) == 1


# ----------------------------------------------------------------------
# parallel/topology.py and tpu/detector.py
# ----------------------------------------------------------------------

def test_topology_of_an_hgx_node():
    topo = SliceTopology.from_labels(H100_LABELS)
    assert topo.accelerator == "NVIDIA-H100-80GB-HBM3"
    assert topo.topology == (8,) and topo.chips_per_host == 8
    assert topo.total_chips == 8 and topo.num_hosts == 1
    assert topo.memory_mib == 81559


@pytest.mark.parametrize(
    "labels",
    [
        {},
        {"foo": "bar"},
        {**H100_LABELS, GPU_PRESENT_LABEL: "false"},
        {GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice", GKE_TPU_TOPOLOGY_LABEL: "4x4"},
    ],
    ids=["no-labels", "other-labels", "present-false", "tpu-node"],
)
def test_not_a_gpu_node(labels):
    assert SliceTopology.from_labels(labels) is None


def test_gpu_labels_are_not_a_tpu_node_to_jax():
    assert JaxSliceTopology.from_labels(H100_LABELS) is None


def test_unknown_product_is_kept_verbatim():
    labels = {GPU_PRESENT_LABEL: "true", GPU_PRODUCT_LABEL: "NVIDIA-X999", GPU_COUNT_LABEL: "4"}
    topo = SliceTopology.from_labels(labels)
    assert topo.accelerator == "NVIDIA-X999" and topo.chips_per_host == 4
    assert topo.memory_mib == 0
    # Before GFD has labelled the node: one card, no product.
    bare = SliceTopology.from_labels({GPU_PRESENT_LABEL: "true"})
    assert bare.accelerator == "" and bare.topology == (1,)


@pytest.mark.parametrize("count", ["0", "-1", "eight"])
def test_invalid_count_raises(count):
    with pytest.raises(ValueError):
        SliceTopology.from_labels({**H100_LABELS, GPU_COUNT_LABEL: count})


def test_local_gpu_labels_need_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_topology.local_gpu_labels()


def test_detects_a_gpu_node():
    det = TpuNodeDetector()
    node = gpu_node("n1")
    assert det.is_tpu_node(node)
    info = det.detect(node)
    assert info.node_name == "n1" and info.chips == 8
    assert info.slice_id == "n1"
    plain = make_node("plain", labels={"foo": "bar"})
    assert not det.is_tpu_node(plain) and det.detect(plain) is None


def test_two_nodes_of_one_pool_without_a_clique_are_two_slices():
    det = TpuNodeDetector()
    nodes = [gpu_node(n, **{GKE_NODEPOOL_LABEL: "pool-a"}) for n in ("a0", "a1")]
    groups = det.group_by_slice(nodes)
    assert {k: [n.name for n in v] for k, v in groups.items()} == {
        "a0": ["a0"], "a1": ["a1"],
    }


def test_one_clique_is_one_slice():
    det = TpuNodeDetector()
    nodes = [
        gpu_node("a0", **{GPU_CLIQUE_LABEL: "uuid.1"}),
        gpu_node("a1", **{GPU_CLIQUE_LABEL: "uuid.1"}),
        gpu_node("b0", **{GPU_CLIQUE_LABEL: "uuid.2"}),
    ]
    groups = det.group_by_slice(nodes)
    assert {k: len(v) for k, v in groups.items()} == {"uuid.1": 2, "uuid.2": 1}


def test_explicit_slice_label_wins_over_the_clique():
    node = gpu_node("n1", **{GPU_CLIQUE_LABEL: "uuid.1", TPU_SLICE_ID_LABEL: "slice-7"})
    assert TpuNodeDetector().detect(node).slice_id == "slice-7"
    custom = TpuNodeDetector(slice_id_label="example.org/slice")
    assert custom.slice_id_label == "example.org/slice"
    assert custom.detect(node).slice_id == "uuid.1"


def test_non_gpu_nodes_are_singletons():
    det = TpuNodeDetector()
    nodes = [
        gpu_node("a0", **{GPU_CLIQUE_LABEL: "c"}),
        gpu_node("a1", **{GPU_CLIQUE_LABEL: "c"}),
        make_node("plain"),
        make_node("cpu-2", labels={GKE_NODEPOOL_LABEL: "pool-a"}),
    ]
    groups = det.group_by_slice(nodes)
    assert {k: len(v) for k, v in groups.items()} == {"c": 2, "plain": 1, "cpu-2": 1}


# ----------------------------------------------------------------------
# tpu/libtpu.py: the driver DaemonSet against the JAX builder
# ----------------------------------------------------------------------

#: json_diff's leaf for a path one document lacks.
MISSING = "<missing>"


def flatten(obj, prefix=""):
    """A JSON document as {path: leaf}."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(flatten(v, f"{prefix}/{k}"))
        return out
    if isinstance(obj, list):
        out = {}
        for i, v in enumerate(obj):
            out.update(flatten(v, f"{prefix}[{i}]"))
        return out
    return {prefix: obj}


def json_diff(jax_doc, port_doc):
    """{path: (JAX's leaf, the port's leaf)} where they differ."""
    a, b = flatten(jax_doc), flatten(port_doc)
    return {
        k: (a.get(k, MISSING), b.get(k, MISSING))
        for k in a.keys() | b.keys()
        if a.get(k, MISSING) != b.get(k, MISSING)
    }


def _daemonsets(version, safe_load):
    # The identity fields are given alike (JAX's default device is the
    # TPU's), so the diff shows what the builders themselves do apart.
    image = "example.org/driver-installer"
    jax_ds = jax_libtpu.LibtpuDaemonSetManager(
        FakeCluster(),
        jax_libtpu.LibtpuSpec(
            version=version, image=image, enable_safe_load=safe_load,
            device=jax_consts.DeviceClass.nvidia("gpu"),
        ),
    ).build_daemonset()
    port_ds = port_libtpu.LibtpuDaemonSetManager(
        FakeCluster(),
        port_libtpu.LibtpuSpec(version=version, image=image, enable_safe_load=safe_load),
    ).build_daemonset()
    return jax_ds, port_ds


@pytest.mark.parametrize("safe_load", [True, False])
def test_daemonset_differs_from_jax_only_where_the_device_does(safe_load):
    jax_ds, port_ds = _daemonsets("550.54.15", safe_load)
    pod = "/spec/template/spec"
    affinity = (
        f"{pod}/affinity/nodeAffinity/requiredDuringSchedulingIgnoredDuringExecution"
        "/nodeSelectorTerms[0]/matchExpressions[0]/key"
    )
    assert json_diff(jax_ds.raw, port_ds.raw) == {
        # the resource name
        f"{pod}/tolerations[0]/key": ("google.com/tpu", "nvidia.com/gpu"),
        # the affinity key
        affinity: (GKE_TPU_ACCELERATOR_LABEL, "nvidia.com/gpu.present"),
        # the installer command and host path
        f"{pod}/containers[0]/command[2]": (
            "install-libtpu --dest /home/kubernetes/bin && sleep infinity",
            "install-nvidia-driver --dest /run/nvidia/driver && sleep infinity",
        ),
        f"{pod}/containers[0]/volumeMounts[0]/mountPath": (
            "/home/kubernetes/bin", "/run/nvidia/driver",
        ),
        f"{pod}/volumes[0]/hostPath/path": ("/home/kubernetes/bin", "/run/nvidia/driver"),
    }
    if safe_load:
        gate = port_ds.spec["template"]["spec"]["initContainers"][0]
        assert gate["command"][-1].endswith(
            "nvidia.com/gpu-driver-upgrade.driver-wait-for-safe-load"
        )


def test_daemonset_defaults():
    spec = port_libtpu.LibtpuSpec(version="550.54.15")
    assert spec.device == port_consts.DeviceClass.nvidia("gpu")
    mgr = port_libtpu.LibtpuDaemonSetManager(None, spec)
    assert mgr.name == "gpu-installer" and mgr.match_labels == {"app": "gpu-installer"}
    assert port_libtpu.TPU_RESOURCE == "nvidia.com/gpu"


class _ConflictOnce:
    """The JAX cluster, whose first update raises its real ConflictError."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.updates = 0

    def __getattr__(self, name):
        return getattr(self.cluster, name)

    def update(self, obj, **kwargs):
        self.updates += 1
        if self.updates == 1:
            raise jax_client.ConflictError("stale")
        return self.cluster.update(obj, **kwargs)


def test_apply_and_delete_against_the_jax_cluster():
    cluster = FakeCluster()
    client = _ConflictOnce(cluster)
    mgr = port_libtpu.LibtpuDaemonSetManager(client, port_libtpu.LibtpuSpec(version="550"))
    created = mgr.apply()
    assert created.name == "gpu-installer" and created.namespace == NS
    mgr.spec.version = "560"
    updated = mgr.apply()  # the first update conflicts and is retried
    assert client.updates == 2
    template = updated.spec["template"]
    assert template["metadata"]["labels"]["version"] == "560"
    assert template["spec"]["containers"][0]["image"].endswith(":560")
    assert cluster.get("DaemonSet", "gpu-installer", NS).raw["spec"] == updated.raw["spec"]
    assert mgr.delete() is True
    assert mgr.delete() is False


def test_apply_updates_the_daemonset_jax_created():
    """Both managers name the same DaemonSet for the same device class, so
    the port can take over a rollout the JAX manager started."""
    cluster = FakeCluster()
    jax_libtpu.LibtpuDaemonSetManager(
        cluster,
        jax_libtpu.LibtpuSpec(version="550", device=jax_consts.DeviceClass.nvidia("gpu")),
    ).apply()
    port_libtpu.LibtpuDaemonSetManager(cluster, port_libtpu.LibtpuSpec(version="560")).apply()
    (ds,) = cluster.list("DaemonSet", namespace=NS)
    assert ds.raw["spec"]["template"]["metadata"]["labels"]["version"] == "560"


# ----------------------------------------------------------------------
# SliceScopedGate: the same sequence through the JAX and the port gate
# ----------------------------------------------------------------------

class _Report:
    def __init__(self, ok):
        self.ok = ok
        self.failures = [] if ok else ["scripted failure"]


class _ScriptedGate:
    """A gate whose runs return the scripted verdicts in turn."""

    def __init__(self, verdicts):
        self.verdicts = list(verdicts)
        self.runs = 0

    def run(self):
        self.runs += 1
        return _Report(self.verdicts.pop(0))


def _slice_nodes():
    """Nodes both detectors see alike: TPU and GPU labels, grouped by the
    explicit slice label, or singletons by name."""
    both = {
        **H100_LABELS,
        GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
        GKE_TPU_TOPOLOGY_LABEL: "2x2",
    }
    nodes = {
        name: make_node(name, labels={**both, TPU_SLICE_ID_LABEL: slice_id})
        for name, slice_id in (("a0", "A"), ("a1", "A"), ("a2", "A"), ("b0", "B"), ("b1", "B"))
    }
    nodes["solo"] = make_node("solo", labels=both)
    nodes["plain"] = make_node("plain")
    return nodes


#: (action, argument): visit a node, advance the clock, or reset.
SEQUENCE = [
    ("visit", "a0"),    # runs, passes: A cached
    ("visit", "a1"),    # cached pass
    ("visit", "b0"),    # runs, fails: not cached
    ("visit", "b1"),    # runs again, passes
    ("visit", "b0"),    # cached now
    ("visit", "solo"),  # its own slice: runs, fails
    ("visit", "solo"),  # runs again, passes
    ("visit", "plain"), # not a device node: its own slice, runs
    ("advance", 1000.0),
    ("visit", "a2"),    # A's pass is 1000 s old: still cached
    ("advance", 900.0),
    ("visit", "a2"),    # 1900 s old: expired, runs
    ("visit", "a0"),    # cached again
    ("reset", None),
    ("visit", "b1"),    # reset forgot B: runs
    ("visit", "a1"),    # and A: runs
]
VERDICTS = [True, False, True, False, True, True, True, True, True]


def _drive_slice_gate(module, nodes, clock):
    gate = _ScriptedGate(VERDICTS)
    scoped = module.SliceScopedGate(gate, max_age_seconds=1800.0)
    hook = scoped.validation_hook()
    trace = []
    for action, arg in SEQUENCE:
        if action == "visit":
            trace.append((arg, hook(nodes[arg]), gate.runs))
        elif action == "advance":
            clock[0] += arg
        else:
            scoped.reset()
    return trace, gate.runs


def test_slice_scoped_gate_matches_jax(monkeypatch):
    nodes = _slice_nodes()
    jax_det = jax_health.SliceScopedGate(None).detector
    port_det = port_health.SliceScopedGate(None).detector
    for node in nodes.values():
        jax_info, port_info = jax_det.detect(node), port_det.detect(node)
        assert (jax_info and jax_info.slice_id) == (port_info and port_info.slice_id)

    clock = [5000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    port_trace, port_runs = _drive_slice_gate(port_health, nodes, clock)
    clock[0] = 5000.0
    jax_trace, jax_runs = _drive_slice_gate(jax_health, nodes, clock)
    assert port_trace == jax_trace
    assert port_runs == jax_runs == len(VERDICTS)
    assert [ok for _, ok, _ in port_trace] == [
        True, True, False, True, True, False, True, True,
        True, True, True, True, True,
    ]


# ----------------------------------------------------------------------
# Packaging (the kernel sources ship) and the kernels' build directory
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def wheel_names(tmp_path_factory) -> set:
    """The file names in a wheel of the package. Built from a copy: an
    in-tree build would write build/ and egg-info into the checkout."""
    tmp_path = tmp_path_factory.mktemp("wheel")
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src / name)
    shutil.copytree(
        REPO / "k8s_operator_libs_tpu_torch", src / "k8s_operator_libs_tpu_torch",
        ignore=shutil.ignore_patterns("__pycache__"),
    )
    out = tmp_path / "wheel"
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "--no-cache-dir", "-q", "-w", str(out), str(src)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    (wheel,) = out.glob("*.whl")
    return set(zipfile.ZipFile(wheel).namelist())


def test_wheel_carries_the_kernel_sources(wheel_names):
    csrc = REPO / "k8s_operator_libs_tpu_torch" / "ops" / "csrc"
    sources = sorted(p.relative_to(REPO).as_posix() for p in csrc.iterdir() if p.is_file())
    assert "k8s_operator_libs_tpu_torch/ops/csrc/matmul.cu" in sources
    assert "k8s_operator_libs_tpu_torch/ops/csrc/flash_attention.cu" in sources
    assert not [s for s in sources if s not in wheel_names]


def test_wheel_carries_the_monitor_manifests(wheel_names):
    manifests = REPO / "k8s_operator_libs_tpu_torch" / "manifests"
    shipped = sorted(p.relative_to(REPO).as_posix() for p in manifests.glob("*.yaml"))
    assert shipped == [
        "k8s_operator_libs_tpu_torch/manifests/monitor-daemonset.yaml",
        "k8s_operator_libs_tpu_torch/manifests/monitor-quickprobe-daemonset.yaml",
    ]
    assert not [m for m in shipped if m not in wheel_names]


def test_build_directory_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.delenv(_build.KERNEL_DIR_ENV, raising=False)
    assert _build.library_path("matmul").parent == _build.BUILD_DIR
    assert _build.BUILD_DIR == REPO / "build" / "torch_kernels"
    # Read at each call, not at import.
    monkeypatch.setenv(_build.KERNEL_DIR_ENV, str(tmp_path / "kernels"))
    for lib in _build.SIGNATURES:
        path = _build.library_path(lib)
        assert path.parent == tmp_path / "kernels"
        assert path.name.startswith(f"{lib}-") and path.suffix == ".so"
    (tmp_path / "kernels").mkdir()
    _build.library_path("matmul").with_suffix(".ptxas.txt").write_text("report")
    assert _build.ptxas_report("matmul") == "report"


# ----------------------------------------------------------------------
# The new modules import with jax and the JAX package blocked
# ----------------------------------------------------------------------

def test_device_class_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['k8s_operator_libs_tpu'] = None\n"
        "from k8s_operator_libs_tpu_torch.tpu import (\n"
        "    LibtpuDaemonSetManager, LibtpuSpec, SliceScopedGate, TpuNodeDetector,\n"
        "    ValidationPodManager, ValidationPodSpec)\n"
        "pod = ValidationPodManager(None, ValidationPodSpec()).build_pod('n')\n"
        "ds = LibtpuDaemonSetManager(None, LibtpuSpec(version='1')).build_daemonset()\n"
        "assert pod.name and ds.name\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
