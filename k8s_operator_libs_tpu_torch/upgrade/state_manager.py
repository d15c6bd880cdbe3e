"""ClusterUpgradeStateManager: the rolling-upgrade state machine.

The JAX package's ``upgrade/state_manager.py`` for the in-place path,
the requestor mode, the checkpoint arc and the quarantine arc.
``build_state`` takes a snapshot of the driver DaemonSets, their pods and
the nodes (and, in the requestor mode, each node's NodeMaintenance
object); ``apply_state`` runs one stateless pass that moves each node at
most one step, from ``upgrade-required`` through cordon, the wait for
jobs, pod deletion, drain, the driver pod's restart and validation to
``upgrade-done`` (or ``upgrade-failed``, from which a node recovers once
its driver pod is back in sync). In the requestor mode
(``requestor.enable_requestor_mode``) an external maintenance operator
cordons and drains instead: the node goes from ``upgrade-required``
through ``node-maintenance-required`` (and, with
``use_post_maintenance``, ``post-maintenance-required``) to the driver
pod's restart, and the requestor releases the object before the node is
done. Nodes the in-place flow began finish in place. With a policy's
``checkpoint`` enabled, a node passes through ``checkpoint-required``
before its eviction, where its training pods checkpoint, and its
uncordon waits until those checkpoints are verified restorable
(``checkpoint_manager.py``). With ``with_health_telemetry`` every
snapshot carries the nodes' NodeHealthReports (``health_source.py``), and
a policy's ``quarantine`` cordons an idle node whose score degrades into
``quarantined``, within the disruption budget, until it recovers or is
handed to the roll (``quarantine_manager.py``). All state is on the nodes
and the objects, as the JAX machine writes it, so either machine can carry
on a roll or an arc the other began. An error aborts the pass; the next
pass resumes from the node labels.

What the JAX machine does beyond that is refused with
``NotImplementedError`` naming its ROADMAP item, never skipped: the
informer and incremental snapshot sources and write batching (A14):
``with_snapshot_from_informers``, ``enable_write_batching`` and
``StateOptions.batch_writes``.

The JAX machine's tracing spans (A15) have no counterpart; the API calls
of the last pass are counted in :class:`PassStats`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

from ..api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from ..kube.client import Client
from ..kube.objects import DaemonSet, Node, Pod
from ..utils.log import get_logger
from .common_manager import ClusterUpgradeState, CommonUpgradeManager, NodeUpgradeState
from .consts import DeviceClass, UpgradeKeys, UpgradeState
from .cordon_manager import CordonManager
from .drain_manager import DrainManager
from .inplace import InplaceNodeStateManager, ProcessNodeStateManager
from .pod_manager import PodDeletionFilter, PodManager
from .safe_driver_load import SafeDriverLoadManager
from .snapshot import ClientSnapshotSource, SnapshotSource
from .state_provider import NodeUpgradeStateProvider
from .task_runner import TaskRunner
from .validation_manager import ValidationHook, ValidationManager

log = get_logger("upgrade.state_manager")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: not ported to k8s_operator_libs_tpu_torch yet (ROADMAP {item})"
    )


class BuildStateError(Exception):
    pass


@dataclass
class StateOptions:
    """The JAX machine's options. The port's machine refuses
    ``batch_writes`` (ROADMAP A14). The requestor's own settings are on
    ``requestor.RequestorOptions``."""

    #: Run the requestor strategy (where the manager has one).
    use_maintenance_operator: bool = False
    #: Nodes of a bucket worked on at once (1: one at a time; an inline
    #: runner is serial whatever this says).
    apply_width: int = 8
    batch_writes: bool = False


@dataclass
class PassStats:
    """The API calls of one pass: ``build_state`` opens the record,
    ``apply_state`` completes it."""

    #: Client reads of the snapshot, each node's NodeMaintenance GET in
    #: the requestor mode included.
    reads_issued: int = 0
    #: State PATCHes sent, and those left out because the node already
    #: held the value.
    writes_issued: int = 0
    writes_skipped: int = 0
    # The checkpoint arc, counted once a pass has seen it.
    #: Nodes still held in checkpoint-required after this pass.
    checkpoint_nodes_waiting: int = 0
    #: Checkpoint requests written on workload pods this pass.
    checkpoint_requests_issued: int = 0
    #: Nodes whose checkpoint gate completed this pass.
    checkpoint_completions: int = 0
    #: Escalations to a plain drain at the deadline this pass.
    checkpoint_escalations: int = 0
    #: The ``CheckpointManager``'s lifetime counters: an escalation means
    #: a workload started over.
    checkpoint_escalations_total: int = 0
    checkpoints_completed_total: int = 0
    checkpoint_restores_verified_total: int = 0
    checkpoint_restore_escalations_total: int = 0


class ClusterUpgradeStateManager:
    """The state machine's entry point (see the module doc)."""

    def __init__(
        self,
        client: Client,
        device: DeviceClass,
        recorder=None,
        options: Optional[StateOptions] = None,
        runner: Optional[TaskRunner] = None,
        requestor: Optional[ProcessNodeStateManager] = None,
    ) -> None:
        self.options = options or StateOptions()
        if self.options.batch_writes:
            raise not_ported("write batching", "A14")
        self.keys = UpgradeKeys(device)
        runner = runner or TaskRunner()
        provider = NodeUpgradeStateProvider(client, self.keys, recorder=recorder)
        self.provider = provider
        width = self.options.apply_width
        self.common = CommonUpgradeManager(
            client=client,
            state_provider=provider,
            keys=self.keys,
            cordon_manager=CordonManager(client, self.keys, recorder=recorder),
            drain_manager=DrainManager(
                client, provider, self.keys, runner=runner, recorder=recorder
            ),
            pod_manager=PodManager(
                client, provider, self.keys, runner=runner, recorder=recorder, apply_width=width
            ),
            validation_manager=ValidationManager(client, provider, self.keys, recorder=recorder),
            safe_load_manager=SafeDriverLoadManager(provider, self.keys),
            recorder=recorder,
            runner=runner,
            apply_width=width,
        )
        self.client = client
        self.recorder = recorder
        self.runner = runner
        self.snapshot_source: SnapshotSource = ClientSnapshotSource(client)
        self.last_pass_stats = PassStats()
        self.inplace: ProcessNodeStateManager = InplaceNodeStateManager(self.common)
        #: The requestor strategy (``requestor.enable_requestor_mode``); it
        #: runs while ``options.use_maintenance_operator`` is on.
        self.requestor: Optional[ProcessNodeStateManager] = requestor
        #: The NodeHealthReports' source, once ``with_health_telemetry``
        #: wired one: every snapshot then carries its map. None: no
        #: telemetry, and the quarantine arc admits no node.
        self.health_source = None
        #: Set once a pass saw the checkpoint arc (a policy enabling it or
        #: a node in its bucket); from then on every pass counts the arc
        #: in its PassStats.
        self._checkpoint_seen = False

    # -- what the port's machine refuses -------------------------------------
    def enable_write_batching(self, max_batch: int = 64):
        raise not_ported("write batching", "A14")

    def with_snapshot_from_informers(self, *args, **kwargs):
        raise not_ported("the informer and incremental snapshot sources", "A14")

    # -- the health telemetry -------------------------------------------------
    def with_health_telemetry(self, health_source=None, sync_timeout: float = 30.0):
        """Read the NodeHealthReports through an informer
        (``health_source.HealthSource``, built over this manager's client
        when none is given) and attach its map to every snapshot
        (``ClusterUpgradeState.node_health``), which the planner's
        degraded-first order and the quarantine arc read. Starts the
        source and returns it; the caller stops it."""
        from .health_source import HealthSource

        if health_source is None:
            health_source = HealthSource(self.client)
        if not health_source.started:
            health_source.start(sync_timeout=sync_timeout)
        self.health_source = health_source
        return health_source

    # -- optional states -----------------------------------------------------
    def with_pod_deletion_enabled(
        self, pod_deletion_filter: PodDeletionFilter
    ) -> "ClusterUpgradeStateManager":
        if pod_deletion_filter is None:
            log.warning("cannot enable pod deletion: filter is None")
            return self
        self.common.pod_manager = PodManager(
            self.client,
            self.provider,
            self.keys,
            pod_deletion_filter=pod_deletion_filter,
            runner=self.runner,
            recorder=self.recorder,
            apply_width=self.options.apply_width,
        )
        self.common.pod_deletion_enabled = True
        return self

    def with_validation_enabled(
        self,
        pod_selector: str = "",
        validation_hook: Optional[ValidationHook] = None,
        timeout_seconds: Optional[int] = None,
        pod_provisioner=None,
    ) -> "ClusterUpgradeStateManager":
        """Validate each node by a pod selector, an in-process hook, or
        both. ``pod_provisioner`` (the port's
        ``tpu.validation_pod.ValidationPodManager``) makes the probe pod on
        each node under validation; where no selector is given, its
        ``spec.pod_selector`` is taken."""
        if pod_provisioner is not None and not pod_selector:
            spec = getattr(pod_provisioner, "spec", None)
            pod_selector = getattr(spec, "pod_selector", "") if spec else ""
        if not pod_selector and validation_hook is None:
            log.warning("cannot enable validation: no selector and no hook")
            return self
        kwargs = {} if timeout_seconds is None else {"timeout_seconds": timeout_seconds}
        self.common.validation_manager = ValidationManager(
            self.client,
            self.provider,
            self.keys,
            pod_selector=pod_selector,
            validation_hook=validation_hook,
            recorder=self.recorder,
            pod_provisioner=pod_provisioner,
            **kwargs,
        )
        # The new manager carries the restore-verified uncordon.
        self.common.validation_manager.restore_gate = self.common.checkpoint_manager.restore_gate
        self.common.validation_enabled = True
        return self

    # -- counters ------------------------------------------------------------
    def get_total_managed_nodes(self, state: ClusterUpgradeState) -> int:
        return self.common.get_total_managed_nodes(state)

    def get_upgrades_in_progress(self, state: ClusterUpgradeState) -> int:
        return self.common.get_upgrades_in_progress(state)

    def get_upgrades_done(self, state: ClusterUpgradeState) -> int:
        return self.common.get_upgrades_done(state)

    def get_upgrades_failed(self, state: ClusterUpgradeState) -> int:
        return self.common.get_upgrades_failed(state)

    def get_upgrades_pending(self, state: ClusterUpgradeState) -> int:
        return self.common.get_upgrades_pending(state)

    def is_pod_deletion_enabled(self) -> bool:
        return self.common.pod_deletion_enabled

    def is_validation_enabled(self) -> bool:
        return self.common.validation_enabled

    # -- the snapshot --------------------------------------------------------
    def build_state(self, namespace: str, driver_labels: Mapping[str, str]) -> ClusterUpgradeState:
        source = self.snapshot_source
        source.consume_reads()  # drop reads made outside a pass
        stats = PassStats()
        self.last_pass_stats = stats
        # One revision memo a snapshot: a rollout between two passes must
        # not be served from the last pass's memo.
        reset = getattr(self.common.pod_manager, "reset_pass_caches", None)
        if callable(reset):
            reset()
        state = self._build_state_full(namespace, driver_labels, source)
        stats.reads_issued = source.consume_reads()
        if self._requestor_active():  # one NodeMaintenance GET a node
            stats.reads_issued += sum(len(b) for b in state.node_states.values())
        return state

    def _build_state_full(
        self, namespace: str, driver_labels: Mapping[str, str], source: SnapshotSource
    ) -> ClusterUpgradeState:
        state = ClusterUpgradeState()
        daemonsets = {ds.uid: ds for ds in source.daemonsets(namespace, dict(driver_labels))}
        pods = source.pods(namespace, dict(driver_labels))
        selected: list[Pod] = []
        for ds in daemonsets.values():
            ds_pods = self.common.get_pods_owned_by_ds(ds, pods)
            if ds.desired_number_scheduled != len(ds_pods):
                # A missing driver pod would let its node escape the roll.
                raise BuildStateError(
                    f"driver DaemonSet {ds.name} should not have unscheduled "
                    f"pods (desired {ds.desired_number_scheduled}, found {len(ds_pods)})"
                )
            selected.extend(ds_pods)
        selected.extend(self.common.get_orphaned_pods(pods))
        nodes = source.nodes()
        for pod in selected:
            if not pod.node_name and pod.phase == "Pending":
                log.info("driver pod %s has no node yet, skipping", pod.name)
                continue
            owner = None
            if not self.common.is_orphaned_pod(pod):
                refs = pod.owner_references
                owner = daemonsets.get(refs[0].get("uid")) if refs else None
            ns = self._build_node_upgrade_state(pod, owner, node=nodes.get(pod.node_name))
            bucket = self.provider.get_upgrade_state(ns.node)
            state.node_states[bucket].append(ns)
        if self.health_source is not None:
            # Memoized: a settled pool attaches the same mapping again.
            state.node_health = self.health_source.snapshot()
        return state

    def _build_node_upgrade_state(
        self, pod: Pod, ds: Optional[DaemonSet], node: Optional[Node] = None
    ) -> NodeUpgradeState:
        """``node`` comes from the snapshot's node LIST; a node it missed
        (made since) is read by name. In the requestor mode the node's
        NodeMaintenance object is read by name too."""
        if node is None:
            node = self.provider.get_node(pod.node_name)
        maintenance = None
        if self._requestor_active():
            maintenance = self.requestor.get_node_maintenance_obj(node.name)
        return NodeUpgradeState(
            node=node, driver_pod=pod, driver_daemonset=ds, node_maintenance=maintenance
        )

    def _requestor_active(self) -> bool:
        return self.options.use_maintenance_operator and self.requestor is not None

    # -- the pass ------------------------------------------------------------
    def apply_state(
        self, state: ClusterUpgradeState, policy: Optional[DriverUpgradePolicySpec]
    ) -> None:
        if state is None:
            raise ValueError("currentState should not be empty")
        if policy is None or not policy.auto_upgrade:
            log.info("driver auto upgrade is disabled, skipping")
            return
        log.info(
            "node states: %s",
            {str(k) or "unknown": len(v) for k, v in state.node_states.items() if v},
        )
        common = self.common
        stats = self.last_pass_stats
        writes_before = self.provider.write_stats()
        checkpoint_enabled = policy.checkpoint is not None and policy.checkpoint.enable
        checkpoint_bucket = len(state.nodes_in(UpgradeState.CHECKPOINT_REQUIRED))
        if checkpoint_enabled or checkpoint_bucket:
            self._checkpoint_seen = True
        checkpoint_before = common.checkpoint_manager.totals() if self._checkpoint_seen else None
        if policy.checkpoint is not None:
            # The restore check follows the policy in force now, not the
            # one the node checkpointed under.
            common.checkpoint_manager.set_verify_restore(policy.checkpoint.verify_restore)
        try:
            common.process_done_or_unknown_nodes(state, UpgradeState.UNKNOWN)
            common.process_done_or_unknown_nodes(state, UpgradeState.DONE)
            # After the classification (a node made upgrade-required this
            # pass is the roll's) and before the start of upgrades (a node
            # handed off is already cordoned when the planner counts).
            common.process_quarantined_nodes(state, policy)
            self._process_upgrade_required_nodes(state, policy)
            common.process_cordon_required_nodes(state)
            common.process_wait_for_jobs_required_nodes(
                state, policy.wait_for_completion, checkpoint_enabled
            )
            common.process_checkpoint_required_nodes(state, policy.checkpoint)
            drain_enabled = policy.drain is not None and policy.drain.enable
            common.process_pod_deletion_required_nodes(state, policy.pod_deletion, drain_enabled)
            common.process_drain_nodes(state, policy.drain)
            self._process_node_maintenance_required_nodes(state)
            self._process_post_maintenance_required_nodes(state)
            common.process_pod_restart_nodes(state)
            common.process_upgrade_failed_nodes(state)
            common.process_validation_required_nodes(state)
            self._process_uncordon_required_nodes(state)
        finally:
            writes_after = self.provider.write_stats()
            stats.writes_issued = writes_after["issued"] - writes_before["issued"]
            stats.writes_skipped = writes_after["skipped"] - writes_before["skipped"]
            if checkpoint_before is not None:
                self._count_checkpoints(
                    stats, checkpoint_before, checkpoint_bucket if checkpoint_enabled else None
                )
        log.info("state manager finished processing")

    def _count_checkpoints(self, stats: PassStats, before: dict, bucket: Optional[int]) -> None:
        """The pass's checkpoint counts: the difference of the manager's
        totals, and the nodes of the bucket (``None`` with the arc off)
        that did not advance."""
        after = self.common.checkpoint_manager.totals()
        stats.checkpoint_requests_issued = after["requests"] - before["requests"]
        stats.checkpoint_completions = after["completions"] - before["completions"]
        stats.checkpoint_escalations = after["escalations"] - before["escalations"]
        advanced = after["advanced"] - before["advanced"]
        stats.checkpoint_nodes_waiting = 0 if bucket is None else max(0, bucket - advanced)
        stats.checkpoint_escalations_total = after["escalations"]
        stats.checkpoints_completed_total = after["completions"]
        stats.checkpoint_restores_verified_total = after["restores_verified"]
        stats.checkpoint_restore_escalations_total = after["restore_escalations"]

    # -- the mode's steps ----------------------------------------------------
    def _process_upgrade_required_nodes(
        self, state: ClusterUpgradeState, policy: DriverUpgradePolicySpec
    ) -> None:
        mode = self.requestor if self._requestor_active() else self.inplace
        mode.process_upgrade_required_nodes(state, policy)

    def _process_node_maintenance_required_nodes(self, state: ClusterUpgradeState) -> None:
        if self._requestor_active():
            self.requestor.process_node_maintenance_required_nodes(state)

    def _process_post_maintenance_required_nodes(self, state: ClusterUpgradeState) -> None:
        if self._requestor_active():
            self.requestor.process_post_maintenance_required_nodes(state)

    def _process_uncordon_required_nodes(self, state: ClusterUpgradeState) -> None:
        """Both flows: the in-place one finishes the nodes it began after
        the requestor mode is enabled."""
        self.inplace.process_uncordon_required_nodes(state)
        if self._requestor_active():
            self.requestor.process_uncordon_required_nodes(state)
