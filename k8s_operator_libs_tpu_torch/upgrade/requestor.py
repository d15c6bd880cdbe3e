"""The requestor mode: node maintenance delegated to an external operator.

The JAX package's ``upgrade/requestor.py``. Instead of cordoning and
draining a node itself, the state machine creates a ``NodeMaintenance``
object for it; an external maintenance operator (NVIDIA's) cordons, waits
for the selected pods, drains, and reports ``Ready`` in the object's
status. Several operators (the GPU driver's, the NIC firmware's) share one
object per node: the first to create it owns it (``requestorID``), later
ones append themselves to ``additionalRequestors`` under an optimistic
lock. At the end the owner deletes the object, whose finalizer lets the
maintenance operator uncordon the node; a non-owner only removes itself.

With ``use_post_maintenance`` a node whose maintenance is Ready passes
through ``post-maintenance-required`` before its driver pod restarts: the
node is still cordoned and drained, its cards free, and the hook runs
there (``tpu.health.cache_warmup_hook``: one gate run that builds the
kernels and forms the world), under a durable deadline like the
validation gate's.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from ..kube.client import AlreadyExistsError, Client, get_or_none, has_reason, retry_on_conflict
from ..kube.objects import NodeMaintenance
from ..policy import for_spec
from ..utils.log import get_logger
from .common_manager import ClusterUpgradeState, CommonUpgradeManager, NodeUpgradeState
from .consts import NULL_STRING, TRUE_STRING, UpgradeState
from .state_manager import StateOptions
from .validation_manager import advance_durable_clock

log = get_logger("upgrade.requestor")

#: The name prefix operators share: objects of this prefix are joined,
#: not duplicated.
DEFAULT_NODE_MAINTENANCE_NAME_PREFIX = "tpu-operator"


@dataclass
class RequestorOptions:
    """How the requestor asks for maintenance."""

    use_maintenance_operator: bool = False
    requestor_id: str = "tpu.operator.dev"
    namespace: str = "default"
    node_maintenance_name_prefix: str = DEFAULT_NODE_MAINTENANCE_NAME_PREFIX
    #: Pod eviction filters handed to the maintenance operator when the
    #: policy enables pod deletion (``spec.drainSpec.podEvictionFilters``).
    pod_eviction_filters: list[dict] = field(default_factory=list)
    #: Pass maintenance-Ready nodes through post-maintenance-required, and
    #: count both maintenance states in the budget.
    use_post_maintenance: bool = False
    #: node -> True when the post-maintenance work is done, False to try
    #: again next pass; None passes straight through. A crash counts as
    #: not done.
    post_maintenance_hook: Optional[Callable] = None
    #: Durable deadline of the post-maintenance step.
    post_maintenance_timeout_seconds: int = 600

    @staticmethod
    def from_env() -> "RequestorOptions":
        """From the ``MAINTENANCE_OPERATOR_*`` environment; a variable set
        but empty takes the default (an empty requestor ID would make
        every operator the owner of every object, an empty prefix an
        invalid name)."""
        return RequestorOptions(
            use_maintenance_operator=os.environ.get("MAINTENANCE_OPERATOR_ENABLED") == TRUE_STRING,
            use_post_maintenance=(
                os.environ.get("MAINTENANCE_OPERATOR_POST_MAINTENANCE") == TRUE_STRING
            ),
            requestor_id=(
                os.environ.get("MAINTENANCE_OPERATOR_REQUESTOR_ID") or RequestorOptions.requestor_id
            ),
            namespace=os.environ.get("MAINTENANCE_OPERATOR_REQUESTOR_NAMESPACE") or "default",
            node_maintenance_name_prefix=(
                os.environ.get("MAINTENANCE_OPERATOR_NODE_MAINTENANCE_PREFIX")
                or DEFAULT_NODE_MAINTENANCE_NAME_PREFIX
            ),
        )

    def to_state_options(self) -> StateOptions:
        return StateOptions(use_maintenance_operator=self.use_maintenance_operator)


def condition_changed_predicate(old: Optional[dict], new: Optional[dict]) -> bool:
    """Watch predicate for a controller of NodeMaintenance objects: the
    status conditions changed (in any order), or the deletion began."""
    if old is None or new is None:
        return False

    def conds(obj: dict) -> list[tuple]:
        return sorted(
            (c.get("type", ""), c.get("status", ""), c.get("reason", ""), c.get("message", ""))
            for c in (obj.get("status") or {}).get("conditions") or []
        )

    old_meta = old.get("metadata") or {}
    new_meta = new.get("metadata") or {}
    deleting = (
        bool(old_meta.get("finalizers"))
        and not new_meta.get("finalizers")
        and new_meta.get("deletionTimestamp") is not None
    )
    return conds(old) != conds(new) or deleting


def requestor_id_predicate(obj: dict, requestor_id: str) -> bool:
    """The object is owned by or shared with ``requestor_id``."""
    spec = obj.get("spec") or {}
    return requestor_id == spec.get("requestorID") or requestor_id in (
        spec.get("additionalRequestors") or []
    )


def enable_requestor_mode(manager, opts: RequestorOptions):
    """Run ``manager``'s upgrades in the requestor mode; the in-place
    flow still finishes the nodes it began. ``opts`` is checked before
    the manager changes. The manager's other options stay. Returns the
    manager.

    The requestor is assigned to ``manager.requestor``, which the slice
    planner (``tpu/planner.py``) wraps whichever was enabled first."""
    requestor = RequestorNodeStateManager(manager.client, manager.common, opts)
    manager.options = dataclasses.replace(
        manager.options, use_maintenance_operator=opts.use_maintenance_operator
    )
    manager.requestor = requestor
    manager.common.count_maintenance_states = opts.use_post_maintenance
    return manager


class RequestorNodeStateManager:
    """The requestor mode's strategy: its upgrade-required, maintenance,
    post-maintenance and uncordon steps."""

    def __init__(
        self, client: Client, common: CommonUpgradeManager, opts: RequestorOptions
    ) -> None:
        if not opts.use_maintenance_operator:
            raise ValueError("node maintenance upgrade mode is disabled")
        self.client = client
        self.common = common
        self.opts = opts

    # -- the NodeMaintenance object -------------------------------------------
    def node_maintenance_name(self, node_name: str) -> str:
        return f"{self.opts.node_maintenance_name_prefix}-{node_name}"

    def new_node_maintenance(
        self,
        node_name: str,
        policy: Optional[DriverUpgradePolicySpec],
        health=None,
        sick_links=None,
    ) -> NodeMaintenance:
        """The object for ``node_name``, its drain and wait specs from the
        policy. ``health`` (the node's telemetry) and ``sick_links`` go to
        ``spec.nodeHealth``; without either the field is left off, so the
        operator can tell "unmeasured" from "healthy"."""
        nm = NodeMaintenance.new(
            self.node_maintenance_name(node_name), namespace=self.opts.namespace
        )
        nm.requestor_id = self.opts.requestor_id
        nm.node_name = node_name
        if health is not None or sick_links:
            payload = {}
            if health is not None:
                payload = {"score": health.score, "trend": health.trend}
            if sick_links:
                payload["worstLinks"] = [dict(link) for link in sick_links]
            nm.node_health = payload
        if policy is not None:
            drain: dict = {}
            if policy.drain is not None:
                drain = {
                    "force": policy.drain.force,
                    "podSelector": policy.drain.pod_selector,
                    "timeoutSeconds": policy.drain.timeout_seconds,
                    "deleteEmptyDir": policy.drain.delete_empty_dir,
                }
            if policy.pod_deletion is not None and self.opts.pod_eviction_filters:
                drain["podEvictionFilters"] = list(self.opts.pod_eviction_filters)
            if drain:
                nm.spec["drainSpec"] = drain
            if policy.wait_for_completion is not None:
                nm.spec["waitForPodCompletion"] = {
                    "podSelector": policy.wait_for_completion.pod_selector,
                    "timeoutSeconds": policy.wait_for_completion.timeout_seconds,
                }
        return nm

    def get_node_maintenance_obj(self, node_name: str) -> Optional[NodeMaintenance]:
        name = self.node_maintenance_name(node_name)
        obj = get_or_none(self.client, "NodeMaintenance", name, self.opts.namespace)
        return NodeMaintenance(obj.raw) if obj is not None else None

    def _create_node_maintenance(
        self, node_state: NodeUpgradeState, policy, health=None, sick_links=None
    ) -> None:
        nm = self.new_node_maintenance(node_state.node.name, policy, health, sick_links=sick_links)
        node_state.node_maintenance = nm
        try:
            self.client.create(nm)
        except Exception as e:  # noqa: BLE001 - the client's own classes
            if not has_reason(e, AlreadyExistsError):
                raise
            log.warning("nodeMaintenance %s already exists", nm.name)

    def _delete_node_maintenance(self, node_state: NodeUpgradeState) -> None:
        """Ask for the deletion; the maintenance operator finalizes it."""
        if node_state.node_maintenance is None:
            raise ValueError(f"missing nodeMaintenance for node {node_state.node.name}")
        name = self.node_maintenance_name(node_state.node.name)
        current = get_or_none(self.client, "NodeMaintenance", name, self.opts.namespace)
        if current is not None and current.deletion_timestamp is None:
            self.client.delete("NodeMaintenance", name, self.opts.namespace)

    def create_or_update_node_maintenance(
        self, node_state: NodeUpgradeState, policy, health=None, sick_links=None
    ) -> None:
        """Create the node's object, or, where another operator owns one of
        the shared prefix, append this requestor to its
        ``additionalRequestors`` (read, change, update with the read
        resourceVersion, again on a conflict)."""
        existing = node_state.node_maintenance
        prefix = self.opts.node_maintenance_name_prefix
        shared_naming = prefix == DEFAULT_NODE_MAINTENANCE_NAME_PREFIX
        if existing is None or not shared_naming:
            self._create_node_maintenance(node_state, policy, health, sick_links=sick_links)
            return
        nm = NodeMaintenance(existing.raw)
        if nm.requestor_id == self.opts.requestor_id:
            log.info("nodeMaintenance %s already exists, skip creation", nm.name)
            return
        if self.opts.requestor_id in nm.additional_requestors:
            log.info("requestor %s already in additionalRequestors", self.opts.requestor_id)
            return

        def append() -> None:
            fresh = NodeMaintenance(self.client.get("NodeMaintenance", nm.name, nm.namespace).raw)
            if self.opts.requestor_id in fresh.additional_requestors:
                return
            fresh.additional_requestors = fresh.additional_requestors + [self.opts.requestor_id]
            self.client.update(fresh)

        retry_on_conflict(append)

    def delete_or_update_node_maintenance(self, node_state: NodeUpgradeState) -> None:
        """The owner deletes the object; a non-owner removes itself from
        ``additionalRequestors`` (again on a conflict)."""
        if node_state.node_maintenance is None:
            return
        nm = NodeMaintenance(node_state.node_maintenance.raw)
        if nm.requestor_id == self.opts.requestor_id:
            self._delete_node_maintenance(node_state)
            return
        if self.opts.requestor_id not in nm.additional_requestors:
            return

        def remove() -> None:
            obj = get_or_none(self.client, "NodeMaintenance", nm.name, nm.namespace)
            if obj is None:
                return
            fresh = NodeMaintenance(obj.raw)
            if self.opts.requestor_id not in fresh.additional_requestors:
                return
            fresh.additional_requestors = [
                r for r in fresh.additional_requestors if r != self.opts.requestor_id
            ]
            self.client.update(fresh)

        retry_on_conflict(remove)

    # -- the steps ----------------------------------------------------------------
    def process_upgrade_required_nodes(
        self, state: ClusterUpgradeState, policy: DriverUpgradePolicySpec
    ) -> None:
        """Ask for each upgrade-required node's maintenance, mark the node
        as in the requestor mode and move it to node-maintenance-required.

        The base mode asks for every node at once and leaves the pace to
        the maintenance operator (the maintenance states take no budget).
        With ``use_post_maintenance`` they do, and this step keeps to the
        in-place mode's ``maxParallelUpgrades`` and ``maxUnavailable``; a
        node already cordoned may start when the budget is spent."""
        common = self.common
        available: Optional[int] = None
        if self.opts.use_post_maintenance:
            total = common.get_total_managed_nodes(state)
            max_unavailable = policy.resolved_max_unavailable(total)
            available = common.get_upgrades_available(
                state, policy.max_parallel_upgrades, max_unavailable, plugin=for_spec(policy.policy)
            )
            log.info(
                "requestor upgrade slots: in_progress=%d max_parallel=%d available=%d "
                "total=%d max_unavailable=%d",
                common.get_upgrades_in_progress(state), policy.max_parallel_upgrades,
                available, total, max_unavailable,
            )
        for ns in state.nodes_in(UpgradeState.UPGRADE_REQUIRED):
            node = ns.node
            if common.is_upgrade_requested(node):
                common.provider.change_node_upgrade_annotation(
                    node, common.keys.upgrade_requested_annotation, NULL_STRING
                )
            if common.skip_node_upgrade(node):
                log.info("node %s is marked to skip upgrades", node.name)
                continue
            if available is not None and available <= 0:
                if not node.unschedulable:
                    continue
                log.info("node %s already cordoned, proceeding despite budget", node.name)
            self.create_or_update_node_maintenance(
                ns, policy, health=state.health_of(node.name),
                sick_links=state.sick_links_of(node.name),
            )
            common.provider.change_node_upgrade_annotation(
                node, common.keys.requestor_mode_annotation, TRUE_STRING
            )
            common.provider.change_node_upgrade_state(node, UpgradeState.NODE_MAINTENANCE_REQUIRED)
            if available is not None:
                available -= 1

    def process_node_maintenance_required_nodes(self, state: ClusterUpgradeState) -> None:
        """Maintenance Ready: on to post-maintenance (or pod restart). A
        node whose object is gone goes back to upgrade-required."""
        common = self.common
        for ns in state.nodes_in(UpgradeState.NODE_MAINTENANCE_REQUIRED):
            if ns.node_maintenance is None:
                if not common.is_node_in_requestor_mode(ns.node):
                    log.warning("node %s missing requestor-mode annotation", ns.node.name)
                common.provider.change_node_upgrade_state(ns.node, UpgradeState.UPGRADE_REQUIRED)
                continue
            nm = NodeMaintenance(ns.node_maintenance.raw)
            if nm.ready_reason() == NodeMaintenance.CONDITION_REASON_READY:
                log.info("node maintenance completed for node %s", nm.node_name)
                next_state = (
                    UpgradeState.POST_MAINTENANCE_REQUIRED
                    if self.opts.use_post_maintenance
                    else UpgradeState.POD_RESTART_REQUIRED
                )
                common.provider.change_node_upgrade_state(ns.node, next_state)

    def process_post_maintenance_required_nodes(self, state: ClusterUpgradeState) -> None:
        """Run the hook on each node, still cordoned and drained; done:
        on to pod restart. Not done (or crashed): again next pass, within
        the durable deadline, whose expiry fails the node with the
        validation-failed marker, so its recovery goes through the gate."""
        if not self.opts.use_post_maintenance:
            return
        common = self.common
        key = common.keys.post_maintenance_start_annotation
        for ns in state.nodes_in(UpgradeState.POST_MAINTENANCE_REQUIRED):
            node = ns.node
            done = True
            if self.opts.post_maintenance_hook is not None:
                try:
                    done = bool(self.opts.post_maintenance_hook(node))
                except Exception as e:  # noqa: BLE001 - a crash is not done
                    log.error("post-maintenance hook failed on node %s: %s", node.name, e)
                    done = False
            if done:
                if key in node.annotations:
                    common.provider.change_node_upgrade_annotation(node, key, NULL_STRING)
                common.provider.change_node_upgrade_state(node, UpgradeState.POD_RESTART_REQUIRED)
                continue
            if advance_durable_clock(
                common.provider, node, key, self.opts.post_maintenance_timeout_seconds
            ):
                log.warning("post-maintenance timed out on node %s", node.name)
                common.provider.change_node_upgrade_annotation(
                    node, common.keys.validation_failed_annotation, TRUE_STRING
                )
                common.provider.change_node_upgrade_state(node, UpgradeState.FAILED)

    def process_uncordon_required_nodes(self, state: ClusterUpgradeState) -> None:
        """Release the node's object, drop the mode's annotation, then mark
        the node done: a release that fails leaves the node here, to be
        tried again next pass, never done with its object orphaned."""
        common = self.common
        for ns in state.nodes_in(UpgradeState.UNCORDON_REQUIRED):
            if not common.is_node_in_requestor_mode(ns.node):
                continue
            self.delete_or_update_node_maintenance(ns)
            common.provider.change_node_upgrade_annotation(
                ns.node, common.keys.requestor_mode_annotation, NULL_STRING
            )
            common.provider.change_node_upgrade_state(ns.node, UpgradeState.DONE)
