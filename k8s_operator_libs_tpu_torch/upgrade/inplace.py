"""The in-place strategy: the library itself cordons, drains and
uncordons (the JAX package's ``upgrade/inplace.py``).

Upgrades start within the ``maxParallelUpgrades`` and ``maxUnavailable``
budget, through the policy plugins of the policy's ``policy`` list; a node
already cordoned by hand may start when the budget is spent, since
upgrading it takes nothing more out of service.
"""

from __future__ import annotations

from typing import Protocol

from ..api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from ..policy import CandidateView, for_spec, tier_of
from ..utils.log import get_logger
from .common_manager import ClusterUpgradeState, CommonUpgradeManager
from .consts import NULL_STRING, UpgradeState

log = get_logger("upgrade.inplace")


class ProcessNodeStateManager(Protocol):
    """A mode strategy: the steps that differ between the in-place mode
    and the requestor mode (``requestor.py``)."""

    def process_upgrade_required_nodes(
        self, state: ClusterUpgradeState, policy: DriverUpgradePolicySpec
    ) -> None: ...

    def process_node_maintenance_required_nodes(self, state: ClusterUpgradeState) -> None: ...

    def process_post_maintenance_required_nodes(self, state: ClusterUpgradeState) -> None: ...

    def process_uncordon_required_nodes(self, state: ClusterUpgradeState) -> None: ...


class InplaceNodeStateManager:
    def __init__(self, common: CommonUpgradeManager) -> None:
        self.common = common

    def process_upgrade_required_nodes(
        self, state: ClusterUpgradeState, policy: DriverUpgradePolicySpec
    ) -> None:
        """Move upgrade-required nodes to cordon-required within the budget."""
        common = self.common
        candidates = state.nodes_in(UpgradeState.UPGRADE_REQUIRED)
        if not candidates:
            return
        plugin = for_spec(policy.policy)
        total = common.get_total_managed_nodes(state)
        max_unavailable = policy.resolved_max_unavailable(total)
        view = common.budget_view(state, policy.max_parallel_upgrades, max_unavailable)
        available = plugin.budget(view).available
        log.info(
            "upgrade slots: in_progress=%d max_parallel=%d available=%d "
            "unavailable=%d total=%d max_unavailable=%d",
            view.in_progress, policy.max_parallel_upgrades, available,
            common.get_current_unavailable_nodes(state), total, max_unavailable,
        )
        for ns in candidates:
            node = ns.node
            if common.is_upgrade_requested(node):
                # The request is one-shot.
                common.provider.change_node_upgrade_annotation(
                    node, common.keys.upgrade_requested_annotation, NULL_STRING
                )
            if common.skip_node_upgrade(node):
                log.info("node %s is marked to skip upgrades", node.name)
                continue
            decision = plugin.admit(
                CandidateView(
                    name=node.name,
                    disrupted=bool(node.unschedulable),
                    tier=tier_of(node.name),
                ),
                view,
            )
            if not decision.allowed:
                log.info(
                    "node %s refused by policy %s: %s",
                    node.name, plugin.name, decision.reason,
                )
                continue
            if available <= 0:
                # Spent: only a node already cordoned may start.
                if not node.unschedulable:
                    continue
                log.info("node %s already cordoned, proceeding despite budget", node.name)
            common.provider.change_node_upgrade_state(node, UpgradeState.CORDON_REQUIRED)
            available -= 1

    def process_node_maintenance_required_nodes(self, state: ClusterUpgradeState) -> None:
        """Nothing: the in-place mode asks no maintenance operator."""

    def process_post_maintenance_required_nodes(self, state: ClusterUpgradeState) -> None:
        """Nothing, as the step before."""

    def process_uncordon_required_nodes(self, state: ClusterUpgradeState) -> None:
        """Uncordon, and the node's upgrade is done. A node in the
        requestor mode is skipped: the requestor releases its
        NodeMaintenance first, and the maintenance operator uncordons."""
        common = self.common

        def release(ns) -> None:
            if common.is_node_in_requestor_mode(ns.node):
                return
            common.cordon_manager.uncordon(ns.node)
            common.provider.change_node_upgrade_state(ns.node, UpgradeState.DONE)

        common._for_each(
            "uncordon",
            state.nodes_in(UpgradeState.UNCORDON_REQUIRED),
            lambda ns: ns.node.name,
            release,
        )
