"""A GPU node roll, end to end, through a state machine (the JAX
package's, or the port's own), gated by the port's probe pods, each run by
a real payload process.

The pieces are the JAX package's jax-free control plane (the in-memory
cluster, the DaemonSet and kubelet simulators), a
``ClusterUpgradeStateManager`` (the JAX package's, or with
``machine="port"`` the port's) and the port's device class (the driver
DaemonSet's name and safe-load key, ``ValidationPodManager`` as the pod
provisioner). ``KubeletPayloadExecutor``
runs each probe pod's container command as a child process, so a node is
let back in only when ``python -m k8s_operator_libs_tpu_torch.tpu.health``
wrote its ready file. Each child's stdout and stderr go to
``<out_dir>/<pod>.out`` and ``.err``, where the report and the kernel line
are read back.

The tests here roll two GPU-labelled nodes on the CPU (``--device cpu``),
with a passing and with a failing payload, through each machine.
``GpuRoll`` also drives the card's roll (``tests/test_torch_cuda.py``);
this module imports no JAX.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Callable, Optional

from k8s_operator_libs_tpu.api import DriverUpgradePolicySpec
from k8s_operator_libs_tpu.kube import FakeCluster, Node
from k8s_operator_libs_tpu.kube.sim import (
    DaemonSetSimulator,
    KubeletPayloadExecutor,
    ValidationPodSimulator,
)
from k8s_operator_libs_tpu.upgrade import ClusterUpgradeStateManager, TaskRunner
from k8s_operator_libs_tpu.upgrade import DeviceClass as JaxDeviceClass
from k8s_operator_libs_tpu.utils import IntOrString
from k8s_operator_libs_tpu_torch.parallel.topology import (
    GPU_COUNT_LABEL,
    GPU_MEMORY_LABEL,
    GPU_PRESENT_LABEL,
    GPU_PRODUCT_LABEL,
)
from k8s_operator_libs_tpu_torch.tpu.health import HealthReport
from k8s_operator_libs_tpu_torch.tpu.libtpu import LibtpuDaemonSetManager, LibtpuSpec
from k8s_operator_libs_tpu_torch.tpu.validation_pod import (
    ValidationPodManager,
    ValidationPodSpec,
)
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import (
    DriverUpgradePolicySpec as PortPolicy,
)
from k8s_operator_libs_tpu_torch.upgrade import ClusterUpgradeStateManager as PortManager
from k8s_operator_libs_tpu_torch.upgrade import TaskRunner as PortTaskRunner
from k8s_operator_libs_tpu_torch.upgrade.consts import DeviceClass, UpgradeKeys

REPO = Path(__file__).resolve().parents[1]
NS = "kube-system"
KEYS = UpgradeKeys(DeviceClass.nvidia("gpu"))
POLICY = DriverUpgradePolicySpec(
    auto_upgrade=True,
    max_parallel_upgrades=0,
    max_unavailable=IntOrString("100%"),
)
PORT_POLICY = PortPolicy.from_dict(POLICY.to_dict())


def _last_json(path: Path, key: Optional[str] = None) -> Optional[dict]:
    """The last JSON object line of ``path`` (holding ``key``, if given)."""
    if not path.exists():
        return None
    for line in reversed(path.read_text().splitlines()):
        if line.startswith("{"):
            parsed = json.loads(line)
            if key is None or key in parsed:
                return parsed
    return None


class GpuRoll:
    """GPU nodes on the in-memory cluster, a driver roll from 550 to 560,
    and a state machine validating each node through the port's pod:
    ``machine`` is ``"jax"`` for the JAX package's, ``"port"`` for the
    port's."""

    def __init__(
        self,
        spec: ValidationPodSpec,
        node_labels: dict[str, dict[str, str]],
        out_dir: Path,
        env: dict,
        extra_args: list[str],
        payload_timeout_s: float,
        machine: str = "jax",
    ) -> None:
        self.spec = spec
        self.out_dir = out_dir
        self.cluster = FakeCluster()
        for name, labels in node_labels.items():
            node = Node.new(name, labels=labels)
            node.set_ready(True)
            self.cluster.create(node)
        self.installer = LibtpuDaemonSetManager(self.cluster, LibtpuSpec(version="550.54.15"))
        self.sim = DaemonSetSimulator(
            self.cluster,
            name=self.installer.name,
            namespace=NS,
            match_labels=self.installer.match_labels,
            initial_hash="550.54.15",
        )
        self.sim.settle()
        # The new driver's pods block on the port's safe-load key until the
        # state machine has drained their node.
        self.sim.safe_load_annotation = self.installer.keys.safe_driver_load_annotation
        self.provisioner = ValidationPodManager(self.cluster, spec)
        self.executor = KubeletPayloadExecutor(
            env=env,
            extra_args=extra_args,
            timeout_seconds=payload_timeout_s,
            argv_transform=self._capture_output,
        )
        self.pods = ValidationPodSimulator(
            self.cluster,
            namespace=spec.namespace,
            label_selector=spec.pod_selector,
            executor=self.executor,
        )
        if machine == "port":
            self.mgr = PortManager(
                self.cluster, DeviceClass.nvidia("gpu"), runner=PortTaskRunner(inline=True)
            )
            self.policy = PORT_POLICY
        else:
            self.mgr = ClusterUpgradeStateManager(
                self.cluster, JaxDeviceClass.nvidia("gpu"), runner=TaskRunner(inline=True)
            )
            self.policy = POLICY
        self.mgr.with_validation_enabled(pod_provisioner=self.provisioner, timeout_seconds=600)
        #: Ready-file contents seen, by pod (the executor drops a pod's file
        #: when the pod is cleaned up after its pass).
        self.ready: dict[str, str] = {}
        self.sim.set_template_hash("560.35.03")

    def _capture_output(self, pod, argv: list[str]) -> list[str]:
        out = str(self.out_dir / pod.name)
        return ["/bin/sh", "-c", 'exec "$@" >"$0.out" 2>"$0.err"', out, *argv]

    def states(self) -> dict[str, Optional[str]]:
        return {n.name: n.labels.get(KEYS.state_label) for n in self.cluster.list("Node")}

    def node(self, name: str) -> Node:
        return Node(self.cluster.get("Node", name).raw)

    def one_pass(self) -> None:
        self.sim.step()
        self.pods.step()
        for pod_name in self.executor.tracked_pods():
            content = self.executor.ready_file_content(pod_name)
            if content is not None:
                self.ready[pod_name] = content
        state = self.mgr.build_state(NS, self.installer.match_labels)
        self.mgr.apply_state(state, self.policy)
        self.sim.step()

    def drive(self, until: Callable[["GpuRoll"], bool], budget_s: float) -> bool:
        """Passes until ``until(self)`` or the deadline; whether it held.
        A deadline, not a count of passes: the payloads' wall time depends
        on the machine's load."""
        deadline = time.monotonic() + budget_s
        while True:
            self.one_pass()
            if until(self):
                return True
            if time.monotonic() > deadline:
                return False
            time.sleep(0.5)

    def all_done(self) -> bool:
        return all(s == "upgrade-done" for s in self.states().values()) and (
            self.sim.all_pods_ready_and_current()
        )

    def pod_name(self, node_name: str) -> str:
        return self.provisioner.pod_name(node_name)

    def report(self, node_name: str) -> Optional[dict]:
        """The report line the node's payload printed."""
        return _last_json(self.out_dir / f"{self.pod_name(node_name)}.out")

    def kernel_line(self, node_name: str) -> Optional[dict]:
        """The payload's stderr line of kernel build seconds and launches."""
        line = _last_json(self.out_dir / f"{self.pod_name(node_name)}.err", "kernels")
        return line and line["kernels"]

    def close(self) -> None:
        self.executor.close()

    def __enter__(self) -> "GpuRoll":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ----------------------------------------------------------------------
# The roll on the CPU: two nodes, a real payload process per pod
# ----------------------------------------------------------------------

GPU_LABELS = {
    GPU_PRESENT_LABEL: "true",
    GPU_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3",
    GPU_COUNT_LABEL: "8",
    GPU_MEMORY_LABEL: "81559",
}
NODES = ("gpu-0", "gpu-1")
BUDGET_S = 240.0


def _cheap_spec(**overrides):
    fields = dict(
        payload_mb=0.05,
        matmul_size=64,
        run_flash_attention=False,
        run_seq_parallel_probes=False,
        compile_cache_dir="",
    )
    fields.update(overrides)
    return ValidationPodSpec(**fields)


def _cpu_roll(spec, out_dir, machine="jax"):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return GpuRoll(
        spec,
        {name: dict(GPU_LABELS) for name in NODES},
        out_dir,
        env=env,
        extra_args=["--device", "cpu"],
        payload_timeout_s=BUDGET_S,
        machine=machine,
    )


def test_gpu_roll_gated_by_real_payload_processes(tmp_path):
    _roll_passes(tmp_path, "jax")


def test_gpu_roll_gated_by_real_payload_processes_through_the_port_machine(tmp_path):
    _roll_passes(tmp_path, "port")


def test_gpu_roll_held_back_by_a_failing_payload(tmp_path):
    _roll_held_back(tmp_path, "jax")


def test_gpu_roll_held_back_by_a_failing_payload_through_the_port_machine(tmp_path):
    _roll_held_back(tmp_path, "port")


def _roll_passes(tmp_path, machine):
    with _cpu_roll(_cheap_spec(), tmp_path, machine) as roll:
        done = roll.drive(GpuRoll.all_done, BUDGET_S)
        states = roll.states()
        history = dict(roll.executor.history)
    assert done, states
    assert states == {name: "upgrade-done" for name in NODES}
    pods = {roll.pod_name(name) for name in NODES}
    # Every verdict came from a payload process that passed.
    assert set(history) == pods and all(history.values())
    for name in NODES:
        assert "ok=True" in roll.ready[roll.pod_name(name)]
        report = HealthReport.from_dict(roll.report(name))
        assert report.ok and report.mxu.ok and report.burnin_ok
        assert [c.op for c in report.collectives] == [
            "psum", "all_gather", "reduce_scatter", "ppermute_ring",
        ]
        node = roll.node(name)
        assert not node.unschedulable
        assert KEYS.safe_driver_load_annotation not in node.annotations
    # Each probe pod was cleaned up after its pass.
    assert not [p for p in roll.cluster.list("Pod", namespace=NS) if p.name in pods]


def _roll_held_back(tmp_path, machine):
    # A floor the CPU cannot meet: the battery runs, the payload exits 1
    # without a ready file, the pod goes Failed and the node stays out.
    with _cpu_roll(_cheap_spec(min_mxu_tflops=1e9), tmp_path, machine) as roll:
        pods = [roll.pod_name(name) for name in NODES]
        verdicts = roll.drive(
            lambda r: all(r.executor.history.get(p) is not None for p in pods), BUDGET_S,
        )
        assert verdicts, "the payloads never finished"
        roll.one_pass()
        assert all(roll.executor.history[p] is False for p in pods)
        assert roll.ready == {}
        for name in NODES:
            report = HealthReport.from_dict(roll.report(name))
            assert not report.ok and any("below floor" in f for f in report.failures)
            node = roll.node(name)
            assert node.labels.get(KEYS.state_label) == "validation-required"
            assert node.unschedulable
        # Once the validation timeout lapses, the nodes fail the upgrade.
        roll.mgr.common.validation_manager._timeout = 0
        failed = roll.drive(
            lambda r: all(s == "upgrade-failed" for s in r.states().values()), 30.0,
        )
        assert failed, roll.states()
        assert all(roll.node(name).unschedulable for name in NODES)
        assert "upgrade-done" not in roll.states().values()
