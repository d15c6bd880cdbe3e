"""ValidationManager: the gate a node passes before it is uncordoned.

The JAX package's ``upgrade/validation_manager.py`` without its tracing
spans. First the checkpoint arc's ``restore_gate``, where one is set: it
runs even with validation otherwise off, outside the validation clock,
since it keeps its own deadline. After the driver pod restarts at
the new revision, every pod matching ``pod_selector`` on the node must be
Running with all containers ready, and the ``validation_hook``, where one
is given, must pass. A ``pod_provisioner`` (the port's
``tpu.validation_pod.ValidationPodManager``) makes the probe pod on the
node first and deletes it once the node passed. A durable start-time
annotation bounds the wait: at the timeout the node goes to
``upgrade-failed``, marked so that its recovery validates again. When no
validation pod is on the node the clock runs too, so a node whose probe
was never scheduled fails instead of waiting forever.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..kube.client import Client
from ..kube.objects import Node, Pod
from ..utils.faultpoints import wall_now
from ..utils.log import get_logger
from .consts import NULL_STRING, TRUE_STRING, UpgradeKeys, UpgradeState
from .state_provider import NodeUpgradeStateProvider

log = get_logger("upgrade.validation")

VALIDATION_TIMEOUT_SECONDS = 600

#: A gate run in the controller beside the pod check; True passes the node.
ValidationHook = Callable[[Node], bool]


def advance_durable_clock(provider, node: Node, key: str, timeout_seconds: float) -> bool:
    """The durable timeout on annotation ``key``: stamp the start on first
    sight, reset an unparseable stamp, and at expiry clear the stamp and
    return True (the caller applies the consequence). The time is
    :func:`~..utils.faultpoints.wall_now`."""
    now = int(wall_now())
    start_raw = node.annotations.get(key)
    if start_raw is None:
        provider.change_node_upgrade_annotation(node, key, str(now))
        return False
    try:
        start = int(start_raw)
    except ValueError:
        log.error("node %s has invalid start-time %r for %s; resetting", node.name, start_raw, key)
        provider.change_node_upgrade_annotation(node, key, str(now))
        return False
    if now > start + timeout_seconds:
        provider.change_node_upgrade_annotation(node, key, NULL_STRING)
        return True
    return False


class ValidationManager:
    def __init__(
        self,
        client: Client,
        state_provider: NodeUpgradeStateProvider,
        keys: UpgradeKeys,
        pod_selector: str = "",
        validation_hook: Optional[ValidationHook] = None,
        timeout_seconds: int = VALIDATION_TIMEOUT_SECONDS,
        recorder=None,
        pod_provisioner=None,
    ) -> None:
        self._client = client
        self._provider = state_provider
        self._keys = keys
        self._pod_selector = pod_selector
        self._hook = validation_hook
        self._timeout = timeout_seconds
        self._recorder = recorder
        self._provisioner = pod_provisioner
        #: The restore-verified uncordon (``CheckpointManager.restore_gate``),
        #: set by the state machine and carried across a manager swap. It
        #: runs before the other gates, so that a deferral does not run the
        #: probe every pass, and outside the validation clock, so that a
        #: deferral does not spend the validation budget into a failure.
        self.restore_gate: Optional[Callable[[Node], bool]] = None

    @property
    def enabled(self) -> bool:
        return bool(self._pod_selector) or self._hook is not None

    def _restore_ok(self, node: Node) -> bool:
        if self.restore_gate is None:
            return True
        return bool(self.restore_gate(node))

    def validate(self, node: Node) -> bool:
        """True when the node passes validation. The restore gate comes
        first, with validation on or off: a node with a checkpoint
        manifest goes through the validation bucket for it alone."""
        if not self._restore_ok(node):
            # Deferred, not failed. The gates below are not running, so
            # their clock is retired: left to age through a long deferral,
            # a later flap of the probe pod would read it as expired.
            self._provider.change_node_upgrade_annotation(
                node, self._keys.validation_start_annotation, NULL_STRING
            )
            return False
        if not self.enabled:
            return True
        if self._provisioner is not None:
            try:
                self._provisioner.ensure(node)
            except Exception as e:  # noqa: BLE001 - a failure, not a crash
                # The timeout clock still runs: a node whose probe pod can
                # never be made fails instead of waiting.
                log.error("validation pod provisioning failed on node %s: %s", node.name, e)
                self._handle_timeout(node)
                return False
        if self._pod_selector:
            pods = [
                Pod(o.raw)
                for o in self._client.list(
                    "Pod",
                    label_selector=self._pod_selector,
                    field_selector=f"spec.nodeName={node.name}",
                )
            ]
            if not pods:
                log.warning(
                    "no validation pods found on node %s (selector %r)",
                    node.name, self._pod_selector,
                )
                self._handle_timeout(node)
                return False
            if not all(self._is_pod_ready(pod) for pod in pods):
                self._handle_timeout(node)
                return False
        if self._hook is not None:
            try:
                ok = self._hook(node)
            except Exception as e:  # noqa: BLE001 - a failed hook fails the node
                log.error("validation hook failed on node %s: %s", node.name, e)
                ok = False
            if not ok:
                self._event(node, "Warning", "Validation hook failed for the node")
                self._handle_timeout(node)
                return False
        # Passed: release the probe pod's cards before the uncordon and
        # clear the clock.
        if self._provisioner is not None:
            try:
                self._provisioner.cleanup(node)
            except Exception as e:  # noqa: BLE001 - the probe passed all the same
                log.warning("validation pod cleanup failed on node %s: %s", node.name, e)
        self._provider.change_node_upgrade_annotation(
            node, self._keys.validation_start_annotation, NULL_STRING
        )
        if self._keys.validation_failed_annotation in node.annotations:
            self._provider.change_node_upgrade_annotation(
                node, self._keys.validation_failed_annotation, NULL_STRING
            )
        return True

    @staticmethod
    def _is_pod_ready(pod: Pod) -> bool:
        """Running with every container ready."""
        statuses = pod.container_statuses
        return pod.phase == "Running" and bool(statuses) and all(
            s.get("ready", False) for s in statuses
        )

    def _handle_timeout(self, node: Node) -> None:
        if not advance_durable_clock(
            self._provider, node, self._keys.validation_start_annotation, self._timeout
        ):
            return
        # Say why the node failed: its recovery goes back through the gate.
        self._provider.change_node_upgrade_annotation(
            node, self._keys.validation_failed_annotation, TRUE_STRING
        )
        self._provider.change_node_upgrade_state(node, UpgradeState.FAILED)
        log.info("validation timeout exceeded on node %s", node.name)
        self._event(node, "Warning", "Validation timed out for the driver upgrade")

    def _event(self, node: Node, event_type: str, message: str) -> None:
        if self._recorder is not None:
            self._recorder.eventf(node, event_type, self._keys.event_reason(), message)
