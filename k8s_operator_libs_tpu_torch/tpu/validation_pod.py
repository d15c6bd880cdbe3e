"""The health gate's validation pod, on a GPU node.

The state machine lets a node back into service once a pod matching its
pod selector is Ready on that node. The controller does not run on the
GPU node, so the probes must: this module builds and provisions the probe
pod, whose payload is ``python -m k8s_operator_libs_tpu_torch.tpu.health``.
It runs the battery on the node's cards, writes a ready file on a pass
and parks, so **pod Ready == cards healthy**.

Scheduling: the pod pins ``spec.nodeName`` (the node under validation is
still cordoned, and the kubelet admits pinned pods anyway), tolerates the
``nvidia.com/gpu`` taint and requests the node's ``nvidia.com/gpu`` cards,
free because the node was drained and released by the cleanup after a
pass. The kernels' build directory is a host path, so the probe pods of
one node run ``nvcc`` once.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..kube.client import AlreadyExistsError, delete_if_exists, get_or_none, has_reason
from ..kube.objects import Pod
from ..ops._build import KERNEL_DIR_ENV
from ..upgrade.consts import DeviceClass
from ..utils.log import get_logger
from .health import KERNEL_CACHE_DIR, IciHealthGate
from .libtpu import TPU_RESOURCE

log = get_logger("tpu.validation_pod")

#: Label identifying probe pods; the value feeds the pod_selector gate.
VALIDATION_APP_LABEL = "app"
VALIDATION_APP = "gpu-health-probe"

#: Marker file the probe payload writes on pass; the pod's readinessProbe
#: watches it, turning probe success into pod readiness. (The JAX
#: package's path: a path inside the pod's own filesystem.)
READY_FILE = "/tmp/tpu-health-ready"


@dataclass
class ValidationPodSpec:
    """Probe-pod shape and gate thresholds serialized into the pod command."""

    image: str = "tpu-operator.dev/gpu-health-probe"
    tag: str = "latest"
    namespace: str = "kube-system"
    device: DeviceClass = field(default_factory=lambda: DeviceClass.nvidia("gpu"))
    #: ``nvidia.com/gpu`` cards to request: the whole node (8 on an HGX
    #: node), so the probe exercises every card and every NVLink.
    tpu_chips: int = 8
    payload_mb: float = 4.0
    matmul_size: int = 1024
    #: Perf floors: 0 until floors measured on the card exist (the JAX
    #: package's floors were set on a TPU).
    min_ring_gbytes_per_s: float = 0.0
    min_mxu_tflops: float = 0.0
    #: Both CUDA kernels and the flash probe on, as on the card they are.
    use_pallas_matmul: bool = True
    run_flash_attention: bool = True
    #: The ring and Ulysses probes over every card of the node (skipped,
    #: with a logged reason, on a node of one card).
    run_seq_parallel_probes: bool = True
    #: One sharded train step as part of the battery.
    run_burnin: bool = True
    #: Seconds between readinessProbe executions / before first check.
    probe_period_seconds: int = 10
    #: Host path for the kernels' build directory (empty = no mount: each
    #: pod builds anew inside its own filesystem). Keep it under a
    #: root-owned parent: see ``health.KERNEL_CACHE_DIR``.
    compile_cache_dir: str = KERNEL_CACHE_DIR
    #: Publish each battery as the node's NodeHealthReport from the pod
    #: (``--publish-report``, the node named by ``NODE_NAME`` from the
    #: downward API): a slice gang's pods then publish the links between
    #: their nodes, keyed by node name.
    publish_reports: bool = False

    @property
    def full_image(self) -> str:
        return f"{self.image}:{self.tag}"

    @property
    def pod_selector(self) -> str:
        """Selector string for ``with_validation_enabled(pod_selector=...)``."""
        return f"{VALIDATION_APP_LABEL}={VALIDATION_APP}"

    def probe_command(self) -> list[str]:
        """The payload: the health CLI, parked after a passing battery. The
        knobs serialize through ``IciHealthGate.to_cli_args``, with explicit
        force-on/force-off kernel flags, so the pod runs exactly the
        configured battery."""
        gate = IciHealthGate(
            min_ring_gbytes_per_s=self.min_ring_gbytes_per_s,
            min_mxu_tflops=self.min_mxu_tflops,
            payload_mb=self.payload_mb,
            matmul_size=self.matmul_size,
            use_pallas_matmul=self.use_pallas_matmul,
            run_flash_attention=self.run_flash_attention,
            run_seq_parallel_probes=self.run_seq_parallel_probes,
            run_burnin=self.run_burnin,
        )
        command = [
            "python", "-m", "k8s_operator_libs_tpu_torch.tpu.health",
            "--ready-file", READY_FILE,
            "--park",
            *gate.to_cli_args(),
        ]
        if self.publish_reports:
            command.append("--publish-report")
        return command


class ValidationPodManager:
    """Provisions one probe pod per node under validation.

    Plugs into the state machine's ``with_validation_enabled`` as its
    ``pod_provisioner``: ``ensure`` runs before the pod-readiness check (so
    the gate always has a pod to watch), ``cleanup`` after validation
    passes (releasing the node's cards before uncordon). The client is the
    operator's.
    """

    def __init__(self, client, spec: ValidationPodSpec) -> None:
        self.client = client
        self.spec = spec

    def pod_name(self, node_name: str) -> str:
        return f"{VALIDATION_APP}-{node_name}"

    def build_pod(self, node_name: str) -> Pod:
        spec = self.spec
        pod = Pod.new(self.pod_name(node_name), namespace=spec.namespace)
        pod.labels[VALIDATION_APP_LABEL] = VALIDATION_APP
        pod.labels["device-class"] = spec.device.name
        pod.node_name = node_name
        pod.spec["restartPolicy"] = "Never"
        pod.spec["tolerations"] = [
            {"key": TPU_RESOURCE, "operator": "Exists", "effect": "NoSchedule"},
            {"operator": "Exists", "effect": "NoExecute"},
        ]
        env = []
        if spec.publish_reports:
            env.append(
                {
                    "name": "NODE_NAME",
                    "valueFrom": {"fieldRef": {"fieldPath": "spec.nodeName"}},
                }
            )
        volume_mounts = []
        if spec.compile_cache_dir:
            # The build lives on the host: a later probe pod on this node
            # loads the libraries the first one built.
            pod.spec["volumes"] = [
                {
                    "name": "kernel-cache",
                    "hostPath": {
                        "path": spec.compile_cache_dir,
                        "type": "DirectoryOrCreate",
                    },
                }
            ]
            env.append({"name": KERNEL_DIR_ENV, "value": spec.compile_cache_dir})
            volume_mounts.append(
                {"name": "kernel-cache", "mountPath": spec.compile_cache_dir}
            )
        pod.spec["containers"] = [
            {
                "name": "probe",
                "image": spec.full_image,
                "command": spec.probe_command(),
                "env": env,
                "volumeMounts": volume_mounts,
                "resources": {
                    "requests": {TPU_RESOURCE: str(spec.tpu_chips)},
                    "limits": {TPU_RESOURCE: str(spec.tpu_chips)},
                },
                "readinessProbe": {
                    "exec": {"command": ["cat", READY_FILE]},
                    "initialDelaySeconds": spec.probe_period_seconds,
                    "periodSeconds": spec.probe_period_seconds,
                },
            }
        ]
        return pod

    def ensure(self, node) -> Pod:
        """Create the probe pod if absent; replace a finished (crashed or
        completed) one so every validation attempt gets a live probe."""
        name = self.pod_name(node.name)
        existing = get_or_none(self.client, "Pod", name, self.spec.namespace)
        if existing is not None:
            pod = Pod(existing.raw)
            if not pod.is_finished():
                return pod
            log.info(
                "validation pod %s finished in phase %s; recreating",
                name, pod.phase,
            )
            delete_if_exists(self.client, "Pod", name, self.spec.namespace)
        desired = self.build_pod(node.name)
        log.info("creating validation pod %s on node %s", name, node.name)
        try:
            return Pod(self.client.create(desired).raw)
        except Exception as e:  # noqa: BLE001 - the client's own classes
            if not has_reason(e, AlreadyExistsError):
                raise
        return Pod(self.client.get("Pod", name, self.spec.namespace).raw)

    def cleanup(self, node) -> None:
        """Delete the node's probe pod (validation passed — release cards)."""
        delete_if_exists(self.client, "Pod", self.pod_name(node.name), self.spec.namespace)
