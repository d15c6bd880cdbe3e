"""NVIDIA driver DaemonSet manager.

The counterpart of the JAX package's libtpu DaemonSet manager, at its path
and with its names: a node-resident installer DaemonSet that places a
versioned NVIDIA driver on every GPU node, wired for the safe-load
handshake the state machine drives:

* an init container ("safe-load gate") annotates the node with the
  safe-driver-load key and blocks until the upgrade state machine has
  drained the node and removed the annotation;
* the main container installs the driver under ``/run/nvidia/driver`` on
  the host and then sleeps as the liveness anchor: its Ready status is
  what the state machine reads as "driver healthy", and its
  controller-revision-hash label is the rollout's sync signal.

It runs on the nodes labelled ``nvidia.com/gpu.present`` and tolerates the
``nvidia.com/gpu`` taint.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..kube.client import delete_if_exists, get_or_none, retry_on_conflict
from ..kube.objects import DaemonSet
from ..parallel.topology import GPU_PRESENT_LABEL
from ..upgrade.consts import DeviceClass, UpgradeKeys
from ..utils.log import get_logger

log = get_logger("tpu.libtpu")

#: The extended resource and taint of NVIDIA nodes (the device plugin's).
TPU_RESOURCE = "nvidia.com/gpu"


@dataclass
class LibtpuSpec:
    """The driver installer's version, image and placement."""

    version: str
    image: str = "tpu-operator.dev/nvidia-driver-installer"
    namespace: str = "kube-system"
    device: DeviceClass = field(default_factory=lambda: DeviceClass.nvidia("gpu"))
    #: Where the driver lands on the host (the GPU operator's driver root).
    host_lib_path: str = "/run/nvidia/driver"
    enable_safe_load: bool = True

    @property
    def full_image(self) -> str:
        return f"{self.image}:{self.version}"


class LibtpuDaemonSetManager:
    """Creates, updates and deletes the driver installer DaemonSet through
    the operator's client. A version bump through :meth:`apply` is what
    starts a rolling upgrade."""

    def __init__(self, client, spec: LibtpuSpec) -> None:
        self.client = client
        self.spec = spec
        self.keys = UpgradeKeys(spec.device)

    @property
    def name(self) -> str:
        return f"{self.spec.device.driver}-installer"

    @property
    def match_labels(self) -> dict[str, str]:
        return {"app": self.name}

    def build_daemonset(self) -> DaemonSet:
        spec = self.spec
        ds = DaemonSet.new(self.name, namespace=spec.namespace)
        ds.match_labels = self.match_labels
        ds.labels.update(self.match_labels)
        pod_labels = dict(self.match_labels)
        pod_labels["version"] = spec.version
        containers = [
            {
                "name": "installer",
                "image": spec.full_image,
                # Install then park: the running container is the health
                # anchor the state machine watches.
                "command": ["/bin/sh", "-c",
                            "install-nvidia-driver --dest " + spec.host_lib_path
                            + " && sleep infinity"],
                "volumeMounts": [{"name": "host-lib", "mountPath": spec.host_lib_path}],
                "resources": {"requests": {"cpu": "50m", "memory": "64Mi"}},
            }
        ]
        init_containers = []
        if spec.enable_safe_load:
            init_containers.append(
                {
                    "name": "safe-load-gate",
                    "image": spec.full_image,
                    # Sets the safe-load annotation then blocks until the
                    # state machine removes it (drain done).
                    "command": [
                        "/bin/sh", "-c",
                        f"safe-load-gate --annotation "
                        f"{self.keys.safe_driver_load_annotation}",
                    ],
                    "env": [
                        {"name": "NODE_NAME",
                         "valueFrom": {"fieldRef": {"fieldPath": "spec.nodeName"}}},
                    ],
                }
            )
        ds.spec["template"] = {
            "metadata": {"labels": pod_labels},
            "spec": {
                "nodeSelector": {},
                # Run only on GPU nodes; tolerate the GPU taint and stay
                # resident through cordons (DaemonSet pods always do).
                "affinity": {
                    "nodeAffinity": {
                        "requiredDuringSchedulingIgnoredDuringExecution": {
                            "nodeSelectorTerms": [
                                {"matchExpressions": [
                                    {"key": GPU_PRESENT_LABEL,
                                     "operator": "Exists"}
                                ]}
                            ]
                        }
                    }
                },
                "tolerations": [
                    {"key": TPU_RESOURCE, "operator": "Exists",
                     "effect": "NoSchedule"},
                    {"operator": "Exists", "effect": "NoExecute"},
                ],
                "priorityClassName": "system-node-critical",
                "hostPID": True,
                "initContainers": init_containers,
                "containers": containers,
                "volumes": [
                    {"name": "host-lib",
                     "hostPath": {"path": spec.host_lib_path,
                                  "type": "DirectoryOrCreate"}},
                ],
            },
        }
        return ds

    def apply(self) -> DaemonSet:
        """Create or update the installer DaemonSet."""
        desired = self.build_daemonset()
        existing = get_or_none(self.client, "DaemonSet", desired.name, desired.namespace)
        if existing is None:
            log.info("creating %s DaemonSet (driver %s)", self.name, self.spec.version)
            return DaemonSet(self.client.create(desired).raw)

        def attempt():
            fresh = self.client.get("DaemonSet", desired.name, desired.namespace)
            update = desired.deep_copy()
            update.metadata["resourceVersion"] = fresh.resource_version
            return self.client.update(update)

        log.info("updating %s DaemonSet to driver %s", self.name, self.spec.version)
        return DaemonSet(retry_on_conflict(attempt).raw)

    def delete(self) -> bool:
        """Delete the DaemonSet; ``False`` when it was not there."""
        return delete_if_exists(self.client, "DaemonSet", self.name, self.spec.namespace)
