"""CordonManager: cordon and uncordon a node (the JAX package's
``upgrade/cordon_manager.py``)."""

from __future__ import annotations

from ..kube.client import Client
from ..kube.drain import DrainHelper
from ..kube.objects import Node
from ..utils.log import get_logger
from .consts import UpgradeKeys

log = get_logger("upgrade.cordon")


class CordonManager:
    def __init__(self, client: Client, keys: UpgradeKeys, recorder=None) -> None:
        self._helper = DrainHelper(client)
        self._keys = keys
        self._recorder = recorder

    def cordon(self, node: Node) -> None:
        log.info("cordoning node %s", node.name)
        self._helper.cordon(node.name)
        node.unschedulable = True
        self._event(node, "Cordoned the node")

    def uncordon(self, node: Node) -> None:
        log.info("uncordoning node %s", node.name)
        self._helper.uncordon(node.name)
        node.unschedulable = False
        self._event(node, "Uncordoned the node")

    def _event(self, node: Node, message: str) -> None:
        if self._recorder is not None:
            self._recorder.eventf(node, "Normal", self._keys.event_reason(), message)
