"""SafeDriverLoadManager: the safe-load handshake (the JAX package's
``upgrade/safe_driver_load.py``).

The new driver pod's init container sets the safe-load annotation on its
node and blocks. The state machine takes such a node as upgrade-required,
cordons and drains it as the policy says, and at ``pod-restart-required``
removes the annotation instead of restarting the pod; the init container
then lets the NVIDIA driver load onto a node with no workload on its
cards.
"""

from __future__ import annotations

from ..kube.objects import Node
from ..utils.log import get_logger
from .consts import NULL_STRING, UpgradeKeys
from .state_provider import NodeUpgradeStateProvider

log = get_logger("upgrade.safe_load")


class SafeDriverLoadManager:
    def __init__(self, state_provider: NodeUpgradeStateProvider, keys: UpgradeKeys) -> None:
        self._provider = state_provider
        self._keys = keys

    def is_waiting_for_safe_driver_load(self, node: Node) -> bool:
        return bool(node.annotations.get(self._keys.safe_driver_load_annotation, ""))

    def unblock_loading(self, node: Node) -> None:
        """Remove the annotation, releasing the blocked init container."""
        if not self.is_waiting_for_safe_driver_load(node):
            return
        log.info("unblocking safe driver load on node %s", node.name)
        self._provider.change_node_upgrade_annotation(
            node, self._keys.safe_driver_load_annotation, NULL_STRING
        )
