"""DrainManager: each node drained on a task of its own (the JAX package's
``upgrade/drain_manager.py``).

A node already being drained is not scheduled again. The outcome is the
node's next state: ``pod-restart-required`` after a drain,
``upgrade-failed`` when it fails or times out. The event that schedules a
drain names its kind: coordinated by the checkpoint arc, escalated past
the checkpoint deadline, or plain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..api.upgrade_v1alpha1 import DrainSpec
from ..kube.client import Client
from ..kube.drain import DrainConfig, DrainError, DrainHelper
from ..kube.objects import Node
from ..utils.log import get_logger
from .consts import TRUE_STRING, UpgradeKeys, UpgradeState
from .state_provider import NodeUpgradeStateProvider
from .task_runner import TaskRunner

log = get_logger("upgrade.drain")


@dataclass
class DrainConfiguration:
    spec: Optional[DrainSpec]
    nodes: Sequence[Node]


class DrainManager:
    def __init__(
        self,
        client: Client,
        state_provider: NodeUpgradeStateProvider,
        keys: UpgradeKeys,
        runner: Optional[TaskRunner] = None,
        recorder=None,
    ) -> None:
        self._client = client
        self._provider = state_provider
        self._keys = keys
        self._runner = runner if runner is not None else TaskRunner()
        self._recorder = recorder

    def _drain_config(self, spec: DrainSpec) -> DrainConfig:
        # Pods labelled <domain>/<driver>-driver-upgrade-drain.skip=true stay.
        skip_label = self._keys.skip_drain_pod_label

        def not_skipped(pod) -> bool:
            return pod.labels.get(skip_label) != TRUE_STRING

        return DrainConfig(
            force=spec.force,
            delete_empty_dir=spec.delete_empty_dir,
            timeout_seconds=spec.timeout_seconds,
            pod_selector=spec.pod_selector,
            extra_filters=(not_skipped,),
        )

    def schedule_nodes_drain(self, config: DrainConfiguration) -> None:
        """Start a drain task for each node."""
        if not config.nodes:
            log.info("no nodes scheduled to drain")
            return
        if config.spec is None:
            raise ValueError("drain spec should not be empty")
        if not config.spec.enable:
            log.info("drain is disabled")
            return
        drain_cfg = self._drain_config(config.spec)
        helper = DrainHelper(self._client)
        for node in config.nodes:
            self._schedule_one(helper, drain_cfg, node)

    def _schedule_one(self, helper: DrainHelper, drain_cfg: DrainConfig, node: Node) -> None:
        def task() -> None:
            try:
                helper.drain(node.name, drain_cfg)
            except DrainError as e:
                log.error("drain of node %s failed: %s", node.name, e)
                self._provider.change_node_upgrade_state(node, UpgradeState.FAILED)
                self._event(node, "Warning", f"Failed to drain the node, {e}")
                return
            log.info("drained node %s", node.name)
            self._event(node, "Normal", "Successfully drained the node")
            self._provider.change_node_upgrade_state(node, UpgradeState.POD_RESTART_REQUIRED)

        if self._runner.submit(node.name, task):
            self._event(node, "Normal", self._drain_flavor(node))
        else:
            log.info("node %s is already being drained, skipping", node.name)

    def _drain_flavor(self, node: Node) -> str:
        """A checkpoint-coordinated drain evicts workloads whose state is
        saved; an escalated one gave up on a wedged workload at the
        deadline; a plain one never entered the checkpoint arc."""
        annotations = node.annotations
        if annotations.get(self._keys.checkpoint_escalated_annotation) == TRUE_STRING:
            return "Scheduling drain of the node (checkpoint deadline escalated - plain drain)"
        if self._keys.checkpoint_manifest_annotation in annotations:
            return "Scheduling checkpoint-coordinated drain of the node"
        return "Scheduling drain of the node"

    def _event(self, node: Node, event_type: str, message: str) -> None:
        if self._recorder is not None:
            self._recorder.eventf(node, event_type, self._keys.event_reason(), message)
