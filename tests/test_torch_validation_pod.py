"""The port's validation pod against the JAX package's, on the CPU.

The pod the port builds differs from the JAX pod only where the device
does; every argument its command carries parses in the port's payload; and
``ensure``/``cleanup`` are as idempotent against the JAX package's
in-memory cluster as the JAX manager's. The roll these pods gate is in
``tests/test_torch_roll.py``.
"""

import itertools

import pytest

from k8s_operator_libs_tpu.kube import FakeCluster
from k8s_operator_libs_tpu.kube import client as jax_client
from k8s_operator_libs_tpu.tpu import validation_pod as jax_vp
from k8s_operator_libs_tpu.upgrade import DeviceClass as JaxDeviceClass
from k8s_operator_libs_tpu_torch.kube.objects import Node as PortNode
from k8s_operator_libs_tpu_torch.ops._build import KERNEL_DIR_ENV
from k8s_operator_libs_tpu_torch.tpu import validation_pod as port_vp
from k8s_operator_libs_tpu_torch.tpu.health import KERNEL_CACHE_DIR, build_parser
from test_torch_device_class import MISSING, json_diff

NS = "kube-system"
JAX_MODULE = "k8s_operator_libs_tpu.tpu.health"
PORT_MODULE = "k8s_operator_libs_tpu_torch.tpu.health"


# ----------------------------------------------------------------------
# The pod against the JAX builder
# ----------------------------------------------------------------------

def _pods(**fields):
    # The identity fields are given alike (JAX's default device is the
    # TPU's, its default chip count a v5e host's), so the diff shows what
    # the builders themselves do apart.
    same = dict(image="example.org/probe", tpu_chips=8, **fields)
    jax_pod = jax_vp.ValidationPodManager(
        FakeCluster(),
        jax_vp.ValidationPodSpec(device=JaxDeviceClass.nvidia("gpu"), **same),
    ).build_pod("n")
    port_pod = port_vp.ValidationPodManager(
        FakeCluster(), port_vp.ValidationPodSpec(**same)
    ).build_pod("n")
    return jax_pod, port_pod


@pytest.mark.parametrize("cache", [True, False], ids=["kernel-cache", "no-cache"])
def test_pod_differs_from_jax_only_where_the_device_does(cache):
    jax_pod, port_pod = _pods(**({} if cache else {"compile_cache_dir": ""}))
    jax_cmd = jax_pod.spec["containers"][0].pop("command")
    port_cmd = port_pod.spec["containers"][0].pop("command")

    # The command: the module, and the TPU floors the port does not carry.
    floors = ["--min-ring-gbps", "5.0", "--min-mxu-tflops", "31.0"]
    start = jax_cmd.index(floors[0])
    assert jax_cmd[start:start + 4] == floors
    expected = jax_cmd[:start] + jax_cmd[start + 4:]
    expected[expected.index(JAX_MODULE)] = PORT_MODULE
    assert port_cmd == expected

    c = "/spec/containers[0]"
    want = {
        # the app label value (and the pod name made from it)
        "/metadata/labels/app": ("tpu-health-probe", "gpu-health-probe"),
        "/metadata/name": ("tpu-health-probe-n", "gpu-health-probe-n"),
        # the resource name
        "/spec/tolerations[0]/key": ("google.com/tpu", "nvidia.com/gpu"),
    }
    for side in ("requests", "limits"):
        want[f"{c}/resources/{side}/google.com/tpu"] = ("8", MISSING)
        want[f"{c}/resources/{side}/nvidia.com/gpu"] = (MISSING, "8")
    if cache:
        # the cache volume and env
        want.update({
            "/spec/volumes[0]/name": ("jax-cache", "kernel-cache"),
            "/spec/volumes[0]/hostPath/path": ("/var/cache/tpu-health-jax", KERNEL_CACHE_DIR),
            f"{c}/volumeMounts[0]/name": ("jax-cache", "kernel-cache"),
            f"{c}/volumeMounts[0]/mountPath": ("/var/cache/tpu-health-jax", KERNEL_CACHE_DIR),
            f"{c}/env[0]/name": ("JAX_COMPILATION_CACHE_DIR", KERNEL_DIR_ENV),
            f"{c}/env[0]/value": ("/var/cache/tpu-health-jax", KERNEL_CACHE_DIR),
        })
    assert json_diff(jax_pod.raw, port_pod.raw) == want


def test_pod_defaults_are_the_cards():
    spec = port_vp.ValidationPodSpec()
    assert spec.tpu_chips == 8
    assert spec.min_mxu_tflops == 0.0 and spec.min_ring_gbytes_per_s == 0.0
    assert spec.use_pallas_matmul and spec.run_flash_attention
    assert spec.run_seq_parallel_probes and spec.run_burnin
    assert spec.compile_cache_dir == KERNEL_CACHE_DIR
    assert KERNEL_CACHE_DIR.startswith("/var/cache/")
    assert spec.pod_selector == "app=gpu-health-probe"
    pod = port_vp.ValidationPodManager(None, spec).build_pod("node-a")
    assert pod.node_name == "node-a" and pod.labels["device-class"] == "gpu"
    (container,) = pod.spec["containers"]
    assert "--device" not in container["command"]  # the payload's default: the card
    assert container["readinessProbe"]["exec"]["command"] == ["cat", port_vp.READY_FILE]


def test_publish_reports_waits_for_the_monitor():
    """With the monitor's publisher ported, ``publish_reports`` adds what the
    JAX pod adds: ``--publish-report`` and ``NODE_NAME`` from the downward
    API; the flag parses in the payload."""
    jax_pod, port_pod = _pods(publish_reports=True, compile_cache_dir="")
    (jax_c,), (port_c,) = jax_pod.spec["containers"], port_pod.spec["containers"]
    assert port_c["command"][-1] == jax_c["command"][-1] == "--publish-report"
    assert port_c["env"] == jax_c["env"] == [
        {"name": "NODE_NAME", "valueFrom": {"fieldRef": {"fieldPath": "spec.nodeName"}}}
    ]
    assert build_parser().parse_args(port_c["command"][3:]).publish_report


SWITCHES = ("use_pallas_matmul", "run_flash_attention", "run_seq_parallel_probes", "run_burnin")


@pytest.mark.parametrize(
    "switches", list(itertools.product([True, False], repeat=len(SWITCHES))),
    ids=lambda s: "".join("1" if on else "0" for on in s),
)
def test_every_argument_of_the_pod_parses_in_the_payload(switches):
    knobs = dict(zip(SWITCHES, switches))
    spec = port_vp.ValidationPodSpec(
        min_ring_gbytes_per_s=2.5, min_mxu_tflops=40.0, payload_mb=0.5,
        matmul_size=512, **knobs,
    )
    command = spec.probe_command()
    assert command[:3] == ["python", "-m", PORT_MODULE]
    args = build_parser().parse_args(command[3:])
    assert args.ready_file == port_vp.READY_FILE and args.park
    assert (args.min_ring_gbps, args.min_mxu_tflops) == (2.5, 40.0)
    assert (args.payload_mb, args.matmul_size) == (0.5, 512)
    assert args.device == "cuda"
    for on, off, knob in (
        (args.pallas_matmul, args.no_pallas_matmul, "use_pallas_matmul"),
        (args.flash_attention, args.no_flash_attention, "run_flash_attention"),
        (args.seq_parallel, args.no_seq_parallel, "run_seq_parallel_probes"),
    ):
        assert (on, off) == (knobs[knob], not knobs[knob])
    assert args.no_burnin == (not knobs["run_burnin"])


# ----------------------------------------------------------------------
# ensure / cleanup against the JAX in-memory cluster
# ----------------------------------------------------------------------

def _manager(cluster):
    return port_vp.ValidationPodManager(cluster, port_vp.ValidationPodSpec())


def test_ensure_creates_once_and_replaces_a_finished_pod():
    cluster = FakeCluster()
    node = PortNode.new("node-a")
    mgr = _manager(cluster)
    first = mgr.ensure(node)
    assert mgr.ensure(node).raw["metadata"]["uid"] == first.raw["metadata"]["uid"]
    assert len(cluster.list("Pod", namespace=NS)) == 1
    cluster.patch("Pod", first.name, NS, patch={"status": {"phase": "Failed"}})
    fresh = mgr.ensure(node)
    assert fresh.phase != "Failed"
    assert fresh.raw["metadata"]["uid"] != first.raw["metadata"]["uid"]


def test_cleanup_is_idempotent():
    cluster = FakeCluster()
    node = PortNode.new("node-a")
    mgr = _manager(cluster)
    mgr.ensure(node)
    mgr.cleanup(node)
    mgr.cleanup(node)  # the second delete's NotFound does not escape
    assert cluster.list("Pod", namespace=NS) == []


class _StaleReads:
    """The JAX cluster behind a read that has not seen the pod yet."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.stale = True

    def __getattr__(self, name):
        return getattr(self.cluster, name)

    def get(self, *args):
        if self.stale:
            self.stale = False
            raise jax_client.NotFoundError("not in the cache yet")
        return self.cluster.get(*args)


def test_ensure_tolerates_already_exists():
    cluster = FakeCluster()
    node = PortNode.new("node-a")
    existing = _manager(cluster).ensure(node)
    got = _manager(_StaleReads(cluster)).ensure(node)
    assert got.raw["metadata"]["uid"] == existing.raw["metadata"]["uid"]


def test_cleanup_raises_what_is_not_not_found():
    class Refusing:
        def delete(self, *args):
            raise jax_client.ConflictError("busy")

    with pytest.raises(jax_client.ConflictError):
        _manager(Refusing()).cleanup(PortNode.new("node-a"))
