"""CommonUpgradeManager: the per-state processors of a pass, and the
budget's counters.

The JAX package's ``upgrade/common_manager.py`` for the in-place path, the
requestor mode, the checkpoint arc and the quarantine arc. It holds the
node managers (cordon, drain, pod, validation, safe load, checkpoint,
quarantine) and moves the nodes of each state's bucket one step. A bucket
runs through the task runner with each node's error isolated; once the
bucket is done its first error aborts the pass, and the next pass resumes
from the node labels. Each non-empty bucket is timed into
``bucket_seconds`` and, with a tracer installed, is a ``bucket.<what>``
span under the pass span (its category from :data:`_BUCKET_CATEGORIES`);
an empty bucket records nothing, so a settled pass allocates nothing.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Sequence, TypeVar

from ..api.telemetry_v1alpha1 import (
    NodeHealth,
    effective_scores,
    fold_link_topology,
    sick_links_from_topology,
)
from ..api.upgrade_v1alpha1 import (
    CheckpointSpec,
    DrainSpec,
    PodDeletionSpec,
    QuarantineSpec,
    WaitForCompletionSpec,
)
from ..kube.client import Client
from ..kube.objects import DaemonSet, Node, NodeMaintenance, Pod
from ..policy import BudgetView, UpgradePolicy, for_spec
from ..utils import tracing
from ..utils.faultpoints import wall_now
from ..utils.log import get_logger
from .consts import (
    IDLE_STATES,
    MAINTENANCE_STATES,
    MANAGED_STATES,
    NULL_STRING,
    TRUE_STRING,
    UpgradeKeys,
    UpgradeState,
)
from .checkpoint_manager import CheckpointManager
from .cordon_manager import CordonManager
from .drain_manager import DrainConfiguration, DrainManager
from .pod_manager import PodManager, PodManagerConfig
from .quarantine_manager import QuarantineManager
from .safe_driver_load import SafeDriverLoadManager
from .state_provider import NodeUpgradeStateProvider
from .task_runner import TaskRunner
from .validation_manager import ValidationManager

log = get_logger("upgrade.common")

T = TypeVar("T")

#: A driver pod container not ready after more restarts than this fails
#: the node.
FAILING_RESTART_COUNT = 10

#: Bucket-label prefix -> the bucket span's attribution category; anything
#: unlisted is ``reconcile`` (``classify[unknown]`` maps by its prefix).
_BUCKET_CATEGORIES = {
    "checkpoint": "checkpoint",
    "validation": "probe",
    "drain-sched": "drain",
    "pod-deletion": "drain",
    "wait-for-jobs-poll": "drain",
}


@dataclass
class NodeUpgradeState:
    """A node, the driver pod on it, the DaemonSet that owns the pod (None
    for an orphaned pod) and, in the requestor mode, the node's
    NodeMaintenance object (None where there is none)."""

    node: Node
    driver_pod: Pod
    driver_daemonset: Optional[DaemonSet]
    node_maintenance: Optional[NodeMaintenance] = None

    def is_orphaned_pod(self) -> bool:
        return self.driver_daemonset is None


@dataclass
class ClusterUpgradeState:
    """A snapshot of the driver's nodes, bucketed by their state label."""

    node_states: dict[UpgradeState, list[NodeUpgradeState]] = field(
        default_factory=lambda: defaultdict(list)
    )
    #: From an incremental snapshot source: the nodes whose world changed
    #: since the last pass. None (a full rebuild, a LIST or plain informer
    #: source): every bucket walks all its nodes. A set, even empty: the
    #: buckets that only react to watched state walk just those nodes
    #: (:meth:`reactive_nodes_in`), and a settled pass walks none.
    dirty_nodes: Optional[frozenset[str]] = None
    #: node name -> :class:`NodeHealth` from the NodeHealthReports, attached
    #: by the state machine when a ``HealthSource`` is wired
    #: (``with_health_telemetry``). None without one: the planner orders by
    #: name and the quarantine arc admits no node.
    node_health: Optional[Mapping[str, NodeHealth]] = None
    #: The link topology folded from ``node_health`` and the map it was
    #: folded from (by identity: the health source attaches the same
    #: mapping until a report changes), so :meth:`sick_links_of` folds once
    #: a snapshot, not once a node. A cache, not state.
    _link_fold: Optional[dict] = field(default=None, repr=False, compare=False)
    _link_fold_src: Optional[Mapping[str, NodeHealth]] = field(
        default=None, repr=False, compare=False
    )

    def nodes_in(self, state: UpgradeState) -> list[NodeUpgradeState]:
        return self.node_states.get(state, [])

    def reactive_nodes_in(self, state: UpgradeState) -> list[NodeUpgradeState]:
        """The bucket's dirty nodes, for the steps that only react to
        watched state (classify, the spec-less advance, the pod-restart
        check, recovery, uncordon). A step whose progress hangs on objects
        the snapshot source does not watch (workload pods, checkpoint
        acks, evictions, validation) must walk :meth:`nodes_in`, or it
        would never be woken."""
        nodes = self.node_states.get(state, [])
        if self.dirty_nodes is None:
            return nodes
        if not self.dirty_nodes or not nodes:
            return []
        return [ns for ns in nodes if ns.node.name in self.dirty_nodes]

    def health_of(self, node_name: str) -> Optional[NodeHealth]:
        """The node's parsed telemetry, where a health source is wired."""
        if self.node_health is None:
            return None
        return self.node_health.get(node_name)

    def sick_links_of(self, node_name: str) -> list:
        """The node's sick incident links over the folded topology, for its
        NodeMaintenance request's ``nodeHealth.worstLinks``; empty without
        telemetry or with every link ok."""
        if self.node_health is None:
            return []
        if self._link_fold is None or self._link_fold_src is not self.node_health:
            self._link_fold = fold_link_topology(self.node_health)
            self._link_fold_src = self.node_health
        return sick_links_from_topology(node_name, self._link_fold)


class CommonUpgradeManager:
    def __init__(
        self,
        client: Client,
        state_provider: NodeUpgradeStateProvider,
        keys: UpgradeKeys,
        cordon_manager: CordonManager,
        drain_manager: DrainManager,
        pod_manager: PodManager,
        validation_manager: ValidationManager,
        safe_load_manager: SafeDriverLoadManager,
        recorder=None,
        runner: Optional[TaskRunner] = None,
        apply_width: Optional[int] = None,
    ) -> None:
        self.provider = state_provider
        self.keys = keys
        self.cordon_manager = cordon_manager
        self.drain_manager = drain_manager
        self.pod_manager = pod_manager
        self.validation_manager = validation_manager
        self.safe_load_manager = safe_load_manager
        self.checkpoint_manager = CheckpointManager(client, state_provider, keys, recorder=recorder)
        # The validation bucket runs the checkpoint arc's restore-verified
        # uncordon.
        self.validation_manager.restore_gate = self.checkpoint_manager.restore_gate
        # The quarantine arc admits no node until a policy enables it and a
        # health source attaches node_health to the snapshots.
        self.quarantine_manager = QuarantineManager(
            cordon_manager, state_provider, keys, recorder=recorder
        )
        self.runner = runner if runner is not None else TaskRunner(inline=True)
        self.apply_width = apply_width
        self.pod_deletion_enabled = False
        self.validation_enabled = False
        #: The current pass's seconds in each non-empty bucket (bucket label
        #: -> s): reset by the state machine as ``apply_state`` begins and
        #: copied into ``PassStats.bucket_seconds`` as it ends. Reconcile
        #: thread only (a bucket joins before the next starts).
        self.bucket_seconds: dict[str, float] = {}
        #: The lazy pass-span trigger: set by the state machine when a
        #: tracer is installed and the snapshot opened no pass span; the
        #: first non-empty bucket calls it (it clears itself), so a pass
        #: whose only work is a polling bucket still gets its span.
        self.on_first_bucket = None
        #: Whether the budget counts the two maintenance states (managed
        #: and in progress). Off, as in the JAX machine's default: the base
        #: requestor mode reserves no budget for a node under external
        #: maintenance. ``enable_requestor_mode`` turns it on with
        #: ``use_post_maintenance``.
        self.count_maintenance_states = False

    # -- counters and the budget -------------------------------------------
    def _managed_states(self) -> tuple[UpgradeState, ...]:
        if self.count_maintenance_states:
            return MANAGED_STATES + MAINTENANCE_STATES
        return MANAGED_STATES

    def get_total_managed_nodes(self, state: ClusterUpgradeState) -> int:
        return sum(len(state.nodes_in(s)) for s in self._managed_states())

    def get_upgrades_in_progress(self, state: ClusterUpgradeState) -> int:
        idle = sum(len(state.nodes_in(s)) for s in IDLE_STATES)
        return self.get_total_managed_nodes(state) - idle

    def get_upgrades_done(self, state: ClusterUpgradeState) -> int:
        return len(state.nodes_in(UpgradeState.DONE))

    def get_upgrades_failed(self, state: ClusterUpgradeState) -> int:
        return len(state.nodes_in(UpgradeState.FAILED))

    def get_upgrades_pending(self, state: ClusterUpgradeState) -> int:
        return len(state.nodes_in(UpgradeState.UPGRADE_REQUIRED))

    def get_current_unavailable_nodes(self, state: ClusterUpgradeState) -> int:
        """Cordoned or NotReady nodes across the snapshot."""
        return sum(
            1
            for states in state.node_states.values()
            for ns in states
            if ns.node.unschedulable or not ns.node.is_ready()
        )

    def budget_view(
        self, state: ClusterUpgradeState, max_parallel_upgrades: int, max_unavailable: int
    ) -> BudgetView:
        """The budget's inputs for the policy plugin; nodes about to be
        cordoned count as unavailable, and the wall clock is stamped here
        so the policy stays a pure function."""
        return BudgetView(
            total=self.get_total_managed_nodes(state),
            in_progress=self.get_upgrades_in_progress(state),
            unavailable=self.get_current_unavailable_nodes(state)
            + len(state.nodes_in(UpgradeState.CORDON_REQUIRED)),
            candidates=len(state.nodes_in(UpgradeState.UPGRADE_REQUIRED)),
            max_parallel=max_parallel_upgrades,
            max_unavailable=max_unavailable,
            now=wall_now(),
        )

    def get_upgrades_available(
        self,
        state: ClusterUpgradeState,
        max_parallel_upgrades: int,
        max_unavailable: int,
        plugin: Optional[UpgradePolicy] = None,
    ) -> int:
        """Upgrades this pass may start: the parallel-slot limit, clamped by
        the unavailability budget (the default policy's budget, or
        ``plugin``'s)."""
        if plugin is None:
            plugin = for_spec(())
        view = self.budget_view(state, max_parallel_upgrades, max_unavailable)
        return plugin.budget(view).available

    # -- node predicates -----------------------------------------------------
    def is_upgrade_requested(self, node: Node) -> bool:
        return node.annotations.get(self.keys.upgrade_requested_annotation) == TRUE_STRING

    def skip_node_upgrade(self, node: Node) -> bool:
        return node.labels.get(self.keys.skip_label) == TRUE_STRING

    def is_node_in_requestor_mode(self, node: Node) -> bool:
        """The requestor-mode annotation is present, whatever its value."""
        return self.keys.requestor_mode_annotation in node.annotations

    def pod_in_sync_with_ds(self, node_state: NodeUpgradeState) -> tuple[bool, bool]:
        """``(synced, orphaned)``: the driver pod's revision against its
        DaemonSet's latest."""
        if node_state.is_orphaned_pod():
            return False, True
        pod_hash = self.pod_manager.get_pod_controller_revision_hash(node_state.driver_pod)
        ds_hash = self.pod_manager.get_daemonset_controller_revision_hash(
            node_state.driver_daemonset
        )
        return pod_hash == ds_hash, False

    def is_driver_pod_in_sync(self, node_state: NodeUpgradeState) -> bool:
        """At the latest revision, Running, and every container ready."""
        synced, orphaned = self.pod_in_sync_with_ds(node_state)
        if orphaned or not synced:
            return False
        pod = node_state.driver_pod
        statuses = pod.container_statuses
        return pod.phase == "Running" and bool(statuses) and all(
            s.get("ready", False) for s in statuses
        )

    @staticmethod
    def is_driver_pod_failing(pod: Pod) -> bool:
        """A container (init or main) not ready after too many restarts."""
        return any(
            not s.get("ready", False) and s.get("restartCount", 0) > FAILING_RESTART_COUNT
            for s in list(pod.init_container_statuses) + list(pod.container_statuses)
        )

    # -- buckets -------------------------------------------------------------
    class _BucketScope:
        """Times one non-empty bucket into ``bucket_seconds`` and, with a
        tracer installed, opens its ``bucket.<what>`` span under the pass
        span. Made only for non-empty buckets."""

        __slots__ = ("_common", "_what", "_span_scope", "_t0")

        def __init__(self, common: "CommonUpgradeManager", what: str, count: int) -> None:
            self._common = common
            self._what = what
            self._span_scope = tracing.span(
                f"bucket.{what}",
                category=_BUCKET_CATEGORIES.get(what.split("[", 1)[0], "reconcile"),
                bucket=what,
                nodes=count,
            )
            self._t0 = 0.0

        def __enter__(self) -> "CommonUpgradeManager._BucketScope":
            trigger = self._common.on_first_bucket
            if trigger is not None:
                # The pass's first work: open its span so this bucket's
                # span has a parent.
                trigger()
            self._span_scope.__enter__()
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc) -> None:
            elapsed = time.perf_counter() - self._t0
            seconds = self._common.bucket_seconds
            seconds[self._what] = seconds.get(self._what, 0.0) + elapsed
            self._span_scope.__exit__(*exc)

    def _bucket_scope(self, what: str, count: int) -> "CommonUpgradeManager._BucketScope":
        return self._BucketScope(self, what, count)

    def _for_each(
        self, what: str, items: Sequence[T], key: Callable[[T], str], fn: Callable[[T], None]
    ) -> None:
        """Run ``fn`` on every item through the runner, join, then raise
        the first failure: one node's error never keeps the bucket's other
        nodes from their step, and still aborts the pass."""
        tasks = [(key(item), (lambda item=item: fn(item))) for item in items]
        if not tasks:
            return
        with self._bucket_scope(what, len(tasks)):
            errors = self.runner.run_bucket(tasks, width=self.apply_width)
        failures = [(tasks[i][0], e) for i, e in enumerate(errors) if e is not None]
        if not failures:
            return
        log.error(
            "%s: %d/%d nodes failed (%s); aborting pass after bucket",
            what, len(failures), len(tasks), ", ".join(k for k, _ in failures),
        )
        raise failures[0][1]

    def _advance_all(self, what: str, nodes: Sequence[Node], next_state: UpgradeState) -> None:
        """Move every node of a stage the policy skips on to ``next_state``."""
        self._for_each(
            f"advance[{what}]",
            nodes,
            lambda node: node.name,
            lambda node: self.provider.change_node_upgrade_state(node, next_state),
        )

    # -- the processors, in the order of a pass ------------------------------
    def process_done_or_unknown_nodes(
        self, state: ClusterUpgradeState, bucket: UpgradeState
    ) -> None:
        """An out-of-sync driver pod, a safe-load wait or an upgrade request
        makes the node upgrade-required (marking a node that starts
        cordoned); an in-sync unknown node is done."""

        def classify(ns: NodeUpgradeState) -> None:
            synced, orphaned = self.pod_in_sync_with_ds(ns)
            if (
                (not synced and not orphaned)
                or self.safe_load_manager.is_waiting_for_safe_driver_load(ns.node)
                or self.is_upgrade_requested(ns.node)
            ):
                self.provider.change_node_state_and_annotations(
                    ns.node,
                    UpgradeState.UPGRADE_REQUIRED,
                    {self.keys.initial_state_annotation: TRUE_STRING}
                    if ns.node.unschedulable
                    else {},
                )
                log.info("node %s requires upgrade", ns.node.name)
                return
            if bucket == UpgradeState.UNKNOWN:
                self.provider.change_node_upgrade_state(ns.node, UpgradeState.DONE)
                log.info("node %s moved unknown -> done", ns.node.name)

        self._for_each(
            f"classify[{bucket or 'unknown'}]",
            state.reactive_nodes_in(bucket),
            lambda ns: ns.node.name,
            classify,
        )

    def process_cordon_required_nodes(self, state: ClusterUpgradeState) -> None:
        def cordon(ns: NodeUpgradeState) -> None:
            self.cordon_manager.cordon(ns.node)
            self.provider.change_node_upgrade_state(ns.node, UpgradeState.WAIT_FOR_JOBS_REQUIRED)

        self._for_each(
            "cordon", state.nodes_in(UpgradeState.CORDON_REQUIRED), lambda ns: ns.node.name, cordon
        )

    def _post_checkpoint_state(self) -> UpgradeState:
        """Where a node goes after the checkpoint arc (complete, escalated
        or withdrawn), or after the wait for jobs without it: the eviction
        path."""
        return (
            UpgradeState.POD_DELETION_REQUIRED
            if self.pod_deletion_enabled
            else UpgradeState.DRAIN_REQUIRED
        )

    def process_wait_for_jobs_required_nodes(
        self,
        state: ClusterUpgradeState,
        wait_spec: Optional[WaitForCompletionSpec],
        checkpoint_enabled: bool = False,
    ) -> None:
        """Without a pod selector the nodes go straight on to pod deletion
        (or, with it off, the drain); with one, each node waits for its
        selected pods to finish, within the spec's timeout, and then goes
        on to pod deletion. With the checkpoint arc enabled, both paths
        lead to ``checkpoint-required`` instead."""
        if wait_spec is None or not wait_spec.pod_selector:
            # A node enters this bucket by a state write, which marks it
            # dirty, so the advance runs on the next pass.
            nodes = [
                ns.node for ns in state.reactive_nodes_in(UpgradeState.WAIT_FOR_JOBS_REQUIRED)
            ]
            next_state = (
                UpgradeState.CHECKPOINT_REQUIRED
                if checkpoint_enabled
                else self._post_checkpoint_state()
            )
            self._advance_all("wait-for-jobs", nodes, next_state)
            return
        # The selector's pods are not watched: this bucket polls.
        nodes = [ns.node for ns in state.nodes_in(UpgradeState.WAIT_FOR_JOBS_REQUIRED)]
        if not nodes:
            return
        with self._bucket_scope("wait-for-jobs-poll", len(nodes)):
            self.pod_manager.schedule_check_on_pod_completion(
                PodManagerConfig(
                    nodes=nodes,
                    wait_for_completion_spec=wait_spec,
                    completion_next_state=(
                        UpgradeState.CHECKPOINT_REQUIRED
                        if checkpoint_enabled
                        else UpgradeState.POD_DELETION_REQUIRED
                    ),
                )
            )

    def process_checkpoint_required_nodes(
        self, state: ClusterUpgradeState, checkpoint_spec: Optional[CheckpointSpec]
    ) -> None:
        """Ask the selected workload pods to checkpoint, hold the drain
        until they ack, escalate to a plain drain at each node's deadline
        (``checkpoint_manager.py``). With the spec absent or disabled (a
        policy changed in the middle of a roll) the nodes held here go on
        to the eviction path, their clocks cleared."""
        node_states = state.nodes_in(UpgradeState.CHECKPOINT_REQUIRED)
        next_state = self._post_checkpoint_state()
        if checkpoint_spec is None or not checkpoint_spec.enable:
            self._for_each(
                "advance[checkpoint]",
                node_states,
                lambda ns: ns.node.name,
                lambda ns: self.checkpoint_manager.abandon(ns.node, next_state),
            )
            return
        self._for_each(
            "checkpoint",
            node_states,
            lambda ns: ns.node.name,
            lambda ns: self.checkpoint_manager.coordinate(ns.node, checkpoint_spec, next_state),
        )

    def process_quarantined_nodes(self, state: ClusterUpgradeState, policy) -> None:
        """The quarantine arc: the ``quarantined`` bucket (hand-off
        deadlines, re-evaluation on the backoff clock, releases), then the
        admission of newly degraded idle nodes within the disruption budget.

        Both halves poll: the clocks run on time, not on events, and a slot
        freed by another node's release must admit a candidate refused
        passes ago. With the spec absent or disabled, the nodes held are
        released, so a withdrawn policy strands no cordoned capacity."""
        spec: Optional[QuarantineSpec] = getattr(policy, "quarantine", None)
        qm = self.quarantine_manager
        node_states = state.nodes_in(UpgradeState.QUARANTINED)
        if spec is None or not spec.enable:
            if node_states:
                qm.adopt(ns.node.name for ns in node_states)
                self._for_each(
                    "advance[quarantine]",
                    node_states,
                    lambda ns: ns.node.name,
                    lambda ns: qm.release(ns.node, "quarantine disabled by policy"),
                )
            return
        # The link fold once a pass, for the bucket's rechecks and the
        # admission alike.
        eff_scores = effective_scores(state.node_health) if state.node_health else {}
        if node_states:
            # Membership first: a restarted controller's gauge counts the
            # nodes an earlier one quarantined.
            qm.adopt(ns.node.name for ns in node_states)
            self._for_each(
                "quarantine",
                node_states,
                lambda ns: ns.node.name,
                lambda ns: qm.evaluate(ns.node, spec, state.node_health, scores=eff_scores),
            )
        if not state.node_health:
            return
        # Admission: idle (unknown or done) schedulable nodes whose effective
        # score (their own, or their worst incident link's: both endpoints
        # of a sick link are candidates, also one that never reported) is
        # below the threshold, worst first, within the roll's own
        # unavailability budget. The health map is scanned first, so a
        # healthy pool walks no bucket.
        degraded = {
            name: score for name, score in eff_scores.items() if score < spec.unhealthy_score
        }
        if not degraded:
            return
        candidates: list[tuple[float, NodeUpgradeState]] = []
        for bucket in (UpgradeState.UNKNOWN, UpgradeState.DONE):
            for ns in state.nodes_in(bucket):
                node = ns.node
                score = degraded.get(node.name)
                if score is None:
                    continue
                if node.unschedulable or not node.is_ready():
                    continue  # out of service already: nothing to protect
                if self.skip_node_upgrade(node):
                    continue
                if self.provider.get_upgrade_state(node) not in (
                    UpgradeState.UNKNOWN,
                    UpgradeState.DONE,
                ):
                    continue  # classified upgrade-required earlier this pass
                candidates.append((score, ns))
        if not candidates:
            return
        candidates.sort(key=lambda item: (item[0], item[1].node.name))
        total = self.get_total_managed_nodes(state)
        max_unavailable = policy.resolved_max_unavailable(total)
        unavailable = self.get_current_unavailable_nodes(state) + len(
            state.nodes_in(UpgradeState.CORDON_REQUIRED)
        )
        slots = max(0, max_unavailable - unavailable)
        for score, ns in candidates:
            if slots <= 0:
                qm.deny_budget(ns.node, score)
                continue
            qm.enter(ns.node, spec, score)
            slots -= 1

    def process_pod_deletion_required_nodes(
        self,
        state: ClusterUpgradeState,
        deletion_spec: Optional[PodDeletionSpec],
        drain_enabled: bool,
    ) -> None:
        nodes = [ns.node for ns in state.nodes_in(UpgradeState.POD_DELETION_REQUIRED)]
        if not self.pod_deletion_enabled:
            self._advance_all("pod-deletion", nodes, UpgradeState.DRAIN_REQUIRED)
            return
        if not nodes:
            return
        with self._bucket_scope("pod-deletion", len(nodes)):
            self.pod_manager.schedule_pod_eviction(
                PodManagerConfig(
                    nodes=nodes,
                    deletion_spec=deletion_spec or PodDeletionSpec(),
                    drain_enabled=drain_enabled,
                )
            )

    def process_drain_nodes(
        self, state: ClusterUpgradeState, drain_spec: Optional[DrainSpec]
    ) -> None:
        nodes = [ns.node for ns in state.nodes_in(UpgradeState.DRAIN_REQUIRED)]
        if drain_spec is None or not drain_spec.enable:
            self._advance_all("drain", nodes, UpgradeState.POD_RESTART_REQUIRED)
            return
        if not nodes:
            return
        with self._bucket_scope("drain-sched", len(nodes)):
            self.drain_manager.schedule_nodes_drain(
                DrainConfiguration(spec=drain_spec, nodes=nodes)
            )

    def process_pod_restart_nodes(self, state: ClusterUpgradeState) -> None:
        """Restart out-of-sync driver pods; unblock the safe load; move an
        in-sync Ready node on to validation (or uncordon); fail a node
        whose driver pod keeps crashing."""
        pods_to_restart: list[Pod] = []

        def advance(ns: NodeUpgradeState) -> None:
            synced, orphaned = self.pod_in_sync_with_ds(ns)
            if not synced or orphaned:
                if ns.driver_pod.deletion_timestamp is None:
                    pods_to_restart.append(ns.driver_pod)  # drained after the join
                return
            self.safe_load_manager.unblock_loading(ns.node)
            if self.is_driver_pod_in_sync(ns):
                # A checkpoint manifest goes through the validation bucket
                # even with validation off: the restore-verified uncordon
                # runs there.
                if not (
                    self.validation_enabled or self.checkpoint_manager.has_manifest(ns.node)
                ):
                    self.update_node_to_uncordon_or_done_state(ns)
                    return
                self.provider.change_node_upgrade_state(ns.node, UpgradeState.VALIDATION_REQUIRED)
            elif self.is_driver_pod_failing(ns.driver_pod):
                log.info("driver pod failing with repeated restarts on node %s", ns.node.name)
                self.provider.change_node_upgrade_state(ns.node, UpgradeState.FAILED)

        self._for_each(
            "pod-restart",
            state.reactive_nodes_in(UpgradeState.POD_RESTART_REQUIRED),
            lambda ns: ns.node.name,
            advance,
        )
        self.pod_manager.schedule_pods_restart(pods_to_restart)

    def process_upgrade_failed_nodes(self, state: ClusterUpgradeState) -> None:
        """A failed node whose driver pod is back in sync recovers: to
        uncordon (or done, if it started cordoned); back through validation
        if validation failed it, since a Ready driver pod is no proof that
        the cards are healthy, or if it carries a checkpoint manifest,
        whose restore-verified uncordon runs there (and retires the
        manifest, so that it cannot follow the node into the next roll)."""

        def recover(ns: NodeUpgradeState) -> None:
            if not self.is_driver_pod_in_sync(ns):
                return
            failed_validation = self.keys.validation_failed_annotation in ns.node.annotations
            if (
                self.validation_enabled and failed_validation
            ) or self.checkpoint_manager.has_manifest(ns.node):
                log.info(
                    "node %s failed validation or carries checkpoints to verify; "
                    "recovery goes through the gate again",
                    ns.node.name,
                )
                self.provider.change_node_upgrade_state(ns.node, UpgradeState.VALIDATION_REQUIRED)
                return
            if self.keys.initial_state_annotation in ns.node.annotations:
                self.provider.change_node_state_and_annotations(
                    ns.node, UpgradeState.DONE, {self.keys.initial_state_annotation: NULL_STRING}
                )
            else:
                self.provider.change_node_upgrade_state(ns.node, UpgradeState.UNCORDON_REQUIRED)

        self._for_each(
            "failed-recovery",
            state.reactive_nodes_in(UpgradeState.FAILED),
            lambda ns: ns.node.name,
            recover,
        )

    def process_validation_required_nodes(self, state: ClusterUpgradeState) -> None:
        """Serial on purpose: a hook may hold the node's cards."""
        node_states = state.nodes_in(UpgradeState.VALIDATION_REQUIRED)
        if not node_states:
            return
        with self._bucket_scope("validation", len(node_states)):
            for ns in node_states:
                # The driver may have restarted since and wait on its safe
                # load again.
                self.safe_load_manager.unblock_loading(ns.node)
                if not self.validation_manager.validate(ns.node):
                    log.info("validation not complete on node %s", ns.node.name)
                    continue
                self.update_node_to_uncordon_or_done_state(ns)

    def update_node_to_uncordon_or_done_state(self, node_state: NodeUpgradeState) -> None:
        """Uncordon next, or done for a node that began its upgrade
        cordoned; one PATCH retires the markers the upgrade leaves. A node
        in the requestor mode always goes to uncordon, where the requestor
        releases its NodeMaintenance, and drops the initial-state marker
        (the maintenance operator's uncordon is the requestor's to ask)."""
        node = node_state.node
        annotations = {self.keys.checkpoint_escalated_annotation: NULL_STRING}
        new_state = UpgradeState.UNCORDON_REQUIRED
        in_requestor_mode = self.is_node_in_requestor_mode(node)
        if self.keys.initial_state_annotation in node.annotations and not in_requestor_mode:
            log.info("node %s was unschedulable at upgrade start, skipping uncordon", node.name)
            new_state = UpgradeState.DONE
        if new_state == UpgradeState.DONE or in_requestor_mode:
            annotations[self.keys.initial_state_annotation] = NULL_STRING
        self.provider.change_node_state_and_annotations(node, new_state, annotations)

    # -- snapshot helpers ----------------------------------------------------
    @staticmethod
    def is_orphaned_pod(pod: Pod) -> bool:
        return not pod.owner_references

    def get_pods_owned_by_ds(self, ds: DaemonSet, pods: Sequence[Pod]) -> list[Pod]:
        return [
            p for p in pods if p.owner_references and p.owner_references[0].get("uid") == ds.uid
        ]

    def get_orphaned_pods(self, pods: Sequence[Pod]) -> list[Pod]:
        return [p for p in pods if self.is_orphaned_pod(p)]
