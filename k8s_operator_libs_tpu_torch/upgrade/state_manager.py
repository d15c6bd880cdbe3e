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

``build_state`` reads through a ``SnapshotSource`` (``snapshot.py``): three
LISTs a pass by default (the nodes through ``reader``, a cached reader the
provider also reads nodes and checks its writes with, where one is given),
or with ``with_snapshot_from_informers`` the
stores of informers, whose ``incremental`` form keeps the classified state
and reclassifies only the nodes a delta touched (a settled pool's pass
reads and writes nothing; every ``verify_every_n``-th pass audits the kept
state against a full rebuild). ``enable_write_batching`` (or
``StateOptions.batch_writes``) stages the provider's PATCHes through a
``WriteBatcher`` (``write_batch.py``).

The last pass is accounted in :class:`PassStats`: its snapshot and apply
seconds, each bucket's seconds, its API calls, the incremental source's
work, and the completeness aborts in all (``upgrade/metrics.py``'s
``UpgradeMetrics`` exports them). With a tracer installed
(``utils/tracing.py``) a pass with work is a ``reconcile.pass`` span,
opened by ``build_state`` for a snapshot that is not settled, or by the
first non-empty bucket, and closed as ``apply_state`` ends; it links to
the traces of the writes whose deliveries woke it. A settled pass opens
no span. A shared watch hub for the informers waits for A18 and is
refused.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Mapping, Optional

from ..api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from ..kube.client import Client
from ..kube.objects import DaemonSet, Node, Pod
from ..utils import tracing
from ..utils.faultpoints import wall_now
from ..utils.log import get_logger
from .common_manager import ClusterUpgradeState, CommonUpgradeManager, NodeUpgradeState
from .consts import DeviceClass, UpgradeKeys, UpgradeState
from .cordon_manager import CordonManager
from .drain_manager import DrainManager
from .inplace import InplaceNodeStateManager, ProcessNodeStateManager
from .pod_manager import PodDeletionFilter, PodManager
from .safe_driver_load import SafeDriverLoadManager
from .snapshot import (
    ClientSnapshotSource,
    IncrementalSnapshotSource,
    InformerSnapshotSource,
    SnapshotDelta,
    SnapshotSource,
)
from .state_provider import NodeUpgradeStateProvider
from .task_runner import TaskRunner
from .validation_manager import ValidationHook, ValidationManager
from .write_batch import WriteBatcher

log = get_logger("upgrade.state_manager")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: not ported to k8s_operator_libs_tpu_torch yet (ROADMAP {item})"
    )


class BuildStateError(Exception):
    pass


def _assignment_shape(assignment: Mapping) -> dict[str, list[tuple]]:
    """A classification to compare: node name -> sorted (bucket, pod
    namespace, pod name, owning DaemonSet's uid); which pass built the
    entries does not matter."""
    return {
        name: sorted(
            (
                str(bucket),
                ns.driver_pod.namespace,
                ns.driver_pod.name,
                ns.driver_daemonset.uid if ns.driver_daemonset else "",
            )
            for bucket, ns in entries
        )
        for name, entries in assignment.items()
    }


@dataclass
class StateOptions:
    """The JAX machine's options. The requestor's own settings are on
    ``requestor.RequestorOptions``."""

    #: Run the requestor strategy (where the manager has one).
    use_maintenance_operator: bool = False
    #: Nodes of a bucket worked on at once (1: one at a time; an inline
    #: runner is serial whatever this says).
    apply_width: int = 8
    #: Stage the provider's PATCHes through a ``WriteBatcher``: a bucket's
    #: nodes then share flushes (where the runner fans out; a serial
    #: caller makes batches of one).
    batch_writes: bool = False
    #: The largest flush with ``batch_writes``.
    write_batch_max: int = 64


@dataclass
class PassStats:
    """Where one pass spent its time and its API calls: ``build_state``
    opens the record, ``apply_state`` completes it. ``UpgradeMetrics``
    exports it."""

    #: Wall seconds of the snapshot (``build_state``) and of ``apply_state``.
    snapshot_s: float = 0.0
    apply_s: float = 0.0
    #: Client reads of the snapshot, each node's NodeMaintenance GET in
    #: the requestor mode included.
    reads_issued: int = 0
    #: True when the snapshot came from informer stores.
    snapshot_cached: bool = False
    #: State PATCHes sent, and those left out because the node already
    #: held the value (fire-and-forget drain tasks land theirs in the pass
    #: open when they finish).
    writes_issued: int = 0
    writes_skipped: int = 0
    #: Keys that rode another key's PATCH, and PATCHes staged through the
    #: write batcher.
    writes_coalesced: int = 0
    writes_batched: int = 0
    #: Node errors the buckets isolated this pass.
    node_errors: int = 0
    # The incremental source's pass, where there is one.
    #: True when the snapshot came from an ``IncrementalSnapshotSource``.
    snapshot_incremental: bool = False
    #: Every node reclassified (the first build, a DaemonSet or
    #: ControllerRevision delta, an invalidation, or an audit).
    full_rebuild: bool = False
    #: The kept state served untouched: no read, no node reclassified.
    snapshot_skipped: bool = False
    #: The dirty nodes this snapshot consumed.
    dirty_node_count: int = 0
    #: The nodes this snapshot reclassified.
    nodes_reclassified: int = 0
    #: Differences between the kept state and the audit's rebuild, found
    #: and repaired this pass.
    verify_divergences: int = 0
    #: The share of the incremental source's builds served from deltas
    #: without a full rebuild, in all.
    delta_hit_rate: float = 0.0
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
    #: Passes aborted by the snapshot's completeness check
    #: (``BuildStateError``), in all: the race between the check and a
    #: driver pod not yet delivered. The next pass's full rebuild resumes;
    #: a wedged pool shows as every pass aborting.
    aborted_completeness_races: int = 0
    #: Apply wall seconds of each non-empty bucket this pass (bucket label
    #: -> s), the gauge-side twin of the pass span's bucket children;
    #: empty on a settled pass.
    bucket_seconds: dict = field(default_factory=dict)


class ClusterUpgradeStateManager:
    """The state machine's entry point (see the module doc)."""

    def __init__(
        self,
        client: Client,
        device: DeviceClass,
        reader: Optional[Client] = None,
        recorder=None,
        options: Optional[StateOptions] = None,
        runner: Optional[TaskRunner] = None,
        requestor: Optional[ProcessNodeStateManager] = None,
        snapshot_source: Optional[SnapshotSource] = None,
    ) -> None:
        self.options = options or StateOptions()
        self.keys = UpgradeKeys(device)
        runner = runner or TaskRunner()
        provider = NodeUpgradeStateProvider(client, self.keys, reader=reader, recorder=recorder)
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
        self._batcher: Optional[WriteBatcher] = None
        if self.options.batch_writes:
            self.enable_write_batching(self.options.write_batch_max)
        self.snapshot_source: SnapshotSource = (
            snapshot_source
            if snapshot_source is not None
            else ClientSnapshotSource(client, node_reader=reader)
        )
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
        # The incremental source's builds and those served from deltas.
        self._incremental_builds = 0
        self._incremental_hits = 0
        #: NodeMaintenance GETs of the requestor mode since build_state
        #: began.
        self._maintenance_reads = 0
        #: Passes aborted by the completeness check, in all (see
        #: ``PassStats.aborted_completeness_races``). Reconcile thread only.
        self.completeness_aborts_total = 0
        # The pass span, opened lazily: by build_state for a snapshot that
        # is not settled, or by the first non-empty bucket. A settled pass
        # opens none and allocates nothing but one tracer() read.
        self._pass_span = None
        self._pass_activation = None
        self._pass_seq = 0
        #: Attributes stamped on every pass span: a fleet shard worker sets
        #: ``{"worker": identity}``, so the pass spans of workers in one
        #: process stay apart in a trace.
        self.trace_attrs: dict = {}
        # One bound method for common.on_first_bucket, never a closure a
        # pass.
        self._lazy_open = self._lazy_open_pass_span

    # -- the read and write paths ----------------------------------------------
    def enable_write_batching(self, max_batch: int = 64) -> WriteBatcher:
        """Stage the provider's PATCHes through a ``WriteBatcher``, outside
        the per-node mutex, so a bucket's nodes share flushes. Once only;
        the batcher (its ``stats()``) is returned each time."""
        batcher = self._batcher
        if batcher is None:
            batcher = WriteBatcher(self.client, max_batch=max_batch)
            self._batcher = batcher
            self.provider.set_batcher(batcher)
        return batcher

    def with_snapshot_from_informers(
        self,
        namespace: str,
        driver_labels: Mapping[str, str],
        resync_period_s: Optional[float] = None,
        sync_timeout: float = 30.0,
        incremental: bool = False,
        verify_every_n: int = 0,
        watch_hub=None,
    ) -> InformerSnapshotSource:
        """Read each snapshot from informer stores and give the provider's
        writes to them (read-your-writes); with ``incremental`` keep the
        classified state too, so ``build_state`` costs what changed, and
        with ``verify_every_n`` audit it every n-th build. Starts the
        informers and waits until they have listed; returns the source,
        which the caller stops. A ``watch_hub`` is refused (ROADMAP A18)."""
        if watch_hub is not None:
            raise not_ported("a snapshot source on a shared watch hub", "A18")
        kwargs = {}
        if resync_period_s is not None:
            kwargs["resync_period_s"] = resync_period_s
        if incremental:
            source: InformerSnapshotSource = IncrementalSnapshotSource(
                self.client, namespace, driver_labels, verify_every_n=verify_every_n, **kwargs
            )
        else:
            source = InformerSnapshotSource(self.client, namespace, driver_labels, **kwargs)
        source.start(sync_timeout=sync_timeout)
        self.snapshot_source = source
        self.provider.set_write_through(source.record_write)
        self.common.pod_manager.revision_source = source
        # A health source wired first still feeds the dirty set.
        if self.health_source is not None and incremental:
            self.health_source.attach(source)
        return source

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
        if getattr(self.snapshot_source, "incremental", False):
            health_source.attach(self.snapshot_source)
        return health_source

    # -- optional states -----------------------------------------------------
    def with_pod_deletion_enabled(
        self, pod_deletion_filter: PodDeletionFilter
    ) -> "ClusterUpgradeStateManager":
        if pod_deletion_filter is None:
            log.warning("cannot enable pod deletion: filter is None")
            return self
        revision_source = self.common.pod_manager.revision_source
        self.common.pod_manager = PodManager(
            self.client,
            self.provider,
            self.keys,
            pod_deletion_filter=pod_deletion_filter,
            runner=self.runner,
            recorder=self.recorder,
            apply_width=self.options.apply_width,
        )
        self.common.pod_manager.revision_source = revision_source
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

    # -- the pass span --------------------------------------------------------
    def _open_pass_span(self, t: tracing.Tracer, start_wall: float) -> None:
        if self._pass_span is not None:
            self._close_pass_span(None)
        attrs: dict = {"pass": self._pass_seq}
        attrs.update(self.trace_attrs)
        self._pass_span = t.start_span(
            "reconcile.pass", category="reconcile", start=start_wall, attrs=attrs,
        )
        self._pass_activation = tracing.activate(self._pass_span)

    def _lazy_open_pass_span(self) -> None:
        """``common.on_first_bucket``: the snapshot was settled, but a
        polling bucket is about to work, so its span needs the pass's."""
        self.common.on_first_bucket = None
        t = tracing.tracer()
        if t is not None and self._pass_span is None:
            self._open_pass_span(t, wall_now())

    def _close_pass_span(self, stats: Optional[PassStats]) -> None:
        span = self._pass_span
        if span is None:
            return
        self._pass_span = None
        activation, self._pass_activation = self._pass_activation, None
        if activation is not None:
            activation.close()
        if stats is not None:
            span.attrs.update(
                full_rebuild=stats.full_rebuild,
                dirty=stats.dirty_node_count,
                reclassified=stats.nodes_reclassified,
                writes=stats.writes_issued,
            )
        t = tracing.tracer()
        if t is not None:
            t.end_span(span)

    # -- the snapshot --------------------------------------------------------
    def build_state(self, namespace: str, driver_labels: Mapping[str, str]) -> ClusterUpgradeState:
        start = time.perf_counter()
        tracer = tracing.tracer()
        if tracer is not None and self._pass_span is not None:
            # A pass whose apply never ran must not leak its span into this.
            self._close_pass_span(None)
        trace_start = wall_now() if tracer is not None else 0.0
        self._pass_seq += 1
        source = self.snapshot_source
        source.consume_reads()  # drop reads made outside a pass
        incremental = bool(getattr(source, "incremental", False))
        stats = PassStats(snapshot_cached=source.cached, snapshot_incremental=incremental)
        self.last_pass_stats = stats
        stats.aborted_completeness_races = self.completeness_aborts_total
        self._maintenance_reads = 0
        try:
            if incremental:
                state = self._build_state_incremental(namespace, driver_labels, source, stats)
            else:
                self._reset_pass_caches()
                state = self._build_state_full(namespace, driver_labels, source)
                state.dirty_nodes = None
        except BuildStateError:
            # The completeness race, counted before it propagates: the
            # caller's loop tolerates the abort, the counter shows it stays
            # bounded.
            self.completeness_aborts_total += 1
            stats.aborted_completeness_races = self.completeness_aborts_total
            stats.snapshot_s = time.perf_counter() - start
            raise
        if self.health_source is not None:
            # Memoized: a settled pool attaches the same mapping again.
            state.node_health = self.health_source.snapshot()
        # One NodeMaintenance GET a node built in the requestor mode.
        stats.reads_issued = source.consume_reads() + self._maintenance_reads
        stats.snapshot_s = time.perf_counter() - start
        if tracer is not None and not stats.snapshot_skipped:
            # A snapshot with news: the pass span covers both phases and
            # links to the traces of the writes whose deliveries woke it.
            self._open_pass_span(tracer, trace_start)
            consume_wakes = getattr(source, "consume_wake_traces", None)
            if callable(consume_wakes):
                for trace_id in consume_wakes():
                    tracer.add_link(self._pass_span, trace_id)
        return state

    def _reset_pass_caches(self) -> None:
        """One revision memo a full snapshot: a rollout between two passes
        must not be served from the last one's. Delta passes keep it (a
        rollout makes the next pass a full rebuild)."""
        reset = getattr(self.common.pod_manager, "reset_pass_caches", None)
        if callable(reset):
            reset()

    def _build_state_full(
        self,
        namespace: str,
        driver_labels: Mapping[str, str],
        source: SnapshotSource,
        assignment: Optional[dict] = None,
    ) -> ClusterUpgradeState:
        """Classify every driver pod's node. With ``assignment`` (priming
        the incremental source) each entry is also recorded there as node
        name -> [(bucket, entry)]."""
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
            if assignment is not None:
                assignment.setdefault(ns.node.name, []).append((bucket, ns))
        return state

    def _build_state_incremental(
        self,
        namespace: str,
        driver_labels: Mapping[str, str],
        source: IncrementalSnapshotSource,
        stats: PassStats,
    ) -> ClusterUpgradeState:
        """The snapshot from the source's deltas, cheapest shape first:

        * settled (no delta): the kept state, ``dirty_nodes`` empty; no
          read and no node classified;
        * delta: the dirty nodes reclassified from the stores, the
          completeness check on the pod counts the deltas keep;
        * full (the first build, a DaemonSet or ControllerRevision delta,
          an invalidation, or the ``verify_every_n`` audit): every node,
          kept as the new state. The audit first consumes the pending
          delta, then counts each node the rebuild classifies otherwise
          (``PassStats.verify_divergences``) and repairs it.

        ``dirty_nodes`` scopes the pass's reactive buckets: None after a
        full rebuild, the consumed nodes otherwise."""
        delta = source.dirty()
        self._incremental_builds += 1
        audit = (
            source.verify_every_n > 0
            and self._incremental_builds % source.verify_every_n == 0
        )
        cached = source.cached_state()
        if cached is None or delta.full or audit:
            expected = None
            if audit and cached is not None and not delta.full:
                # Pending deltas first, so the diff measures tracking
                # faults, not events not yet consumed.
                self._apply_delta(namespace, driver_labels, source, delta)
                expected = _assignment_shape(source.assignment())
            self._reset_pass_caches()
            assignment: dict = {}
            state = self._build_state_full(namespace, driver_labels, source, assignment=assignment)
            if expected is not None:
                # A node that took an event while the rebuild read is the
                # event's difference, not a fault; unattributable events in
                # flight, or an invalidation meanwhile, skip the count.
                racing = source.racing_nodes()
                if racing is None or source.dirty().full:
                    log.info(
                        "audit: in-flight deliveries or a mid-audit "
                        "invalidation; divergence count skipped this audit"
                    )
                else:
                    stats.verify_divergences = source.count_divergences(
                        expected, _assignment_shape(assignment), racing=racing
                    )
            source.prime(state, assignment)
            source.clean(delta)
            state.dirty_nodes = None
            stats.full_rebuild = True
            stats.dirty_node_count = len(delta.nodes)
            stats.nodes_reclassified = len(assignment)
        elif not delta.nodes:
            self._incremental_hits += 1
            stats.snapshot_skipped = True
            state = cached
            state.dirty_nodes = frozenset()
        else:
            self._incremental_hits += 1
            stats.nodes_reclassified = self._apply_delta(namespace, driver_labels, source, delta)
            stats.dirty_node_count = len(delta.nodes)
            state = cached
            state.dirty_nodes = frozenset(n for n in delta.nodes if n)
        stats.delta_hit_rate = round(self._incremental_hits / self._incremental_builds, 6)
        return state

    def audit_incremental(self, namespace: str, driver_labels: Mapping[str, str]) -> int:
        """The nodes the kept state classifies otherwise than a full walk
        of the stores now: a pure read for settled moments, which neither
        consumes deltas nor repairs. 0 for another source, before the
        first build, or while a delta is pending (the kept state is never
        served before that delta is consumed)."""
        source = self.snapshot_source
        if not isinstance(source, IncrementalSnapshotSource) or source.cached_state() is None:
            return 0
        pending = source.dirty()
        if pending.full or pending.nodes:
            return 0
        expected = _assignment_shape(source.assignment())
        assignment: dict = {}
        self._build_state_full(namespace, dict(driver_labels), source, assignment=assignment)
        actual = _assignment_shape(assignment)
        return sum(
            1 for name in set(expected) | set(actual) if expected.get(name) != actual.get(name)
        )

    def _apply_delta(
        self,
        namespace: str,
        driver_labels: Mapping[str, str],
        source: IncrementalSnapshotSource,
        delta: SnapshotDelta,
    ) -> int:
        """Reclassify the delta's nodes into the kept state; how many. A
        DaemonSet whose kept pod count is not its desired count raises
        ``BuildStateError`` with the delta left pending, and invalidates,
        so the retry is a full rebuild: a real gap fails there too, and a
        drifted count is recounted by ``prime``."""
        daemonsets = {ds.uid: ds for ds in source.daemonsets(namespace, dict(driver_labels))}
        for ds in daemonsets.values():
            found = source.ds_pod_count(ds.uid)
            if ds.desired_number_scheduled != found:
                source.invalidate()
                raise BuildStateError(
                    f"driver DaemonSet {ds.name} should not have unscheduled "
                    f"pods (desired {ds.desired_number_scheduled}, found {found})"
                )
        reclassified = 0
        for name in delta.nodes:
            if not name:
                continue  # a driver pod with no node yet
            self._reclassify_node(source, name, daemonsets)
            reclassified += 1
        source.clean(delta)
        return reclassified

    def _reclassify_node(
        self,
        source: IncrementalSnapshotSource,
        name: str,
        daemonsets: Mapping[str, DaemonSet],
    ) -> None:
        """The full path for one node: each driver pod on it classified,
        the result swapped into the kept state."""
        node = source.node(name)
        entries: list = []
        for pod in source.pods_on_node(name):
            owner = None
            if not self.common.is_orphaned_pod(pod):
                refs = pod.owner_references
                owner = daemonsets.get(refs[0].get("uid")) if refs else None
                if owner is None:
                    # The full path selects DaemonSet-owned and orphaned
                    # pods only; a pod of another owner is none of ours.
                    continue
            # A node gone before its pods is read by name, as the full
            # path reads a node its LIST missed.
            ns = self._build_node_upgrade_state(pod, owner, node=node)
            bucket = self.provider.get_upgrade_state(ns.node)
            entries.append((bucket, ns))
        source.update_node(name, entries)

    def _build_node_upgrade_state(
        self, pod: Pod, ds: Optional[DaemonSet], node: Optional[Node] = None
    ) -> NodeUpgradeState:
        """``node`` comes from the snapshot; a node it missed (made since)
        is read by name. In the requestor mode the node's NodeMaintenance
        object is read by name too."""
        if node is None:
            node = self.provider.get_node(pod.node_name)
        maintenance = None
        if self._requestor_active():
            self._maintenance_reads += 1
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
            self._close_pass_span(self.last_pass_stats)
            return
        log.info(
            "node states: %s",
            {str(k) or "unknown": len(v) for k, v in state.node_states.items() if v},
        )
        common = self.common
        stats = self.last_pass_stats
        start = time.perf_counter()
        # A settled snapshot opened no span; the first non-empty bucket
        # opens it. A settled pass runs no bucket and opens nothing.
        common.on_first_bucket = (
            self._lazy_open
            if tracing.tracer() is not None and self._pass_span is None
            else None
        )
        if common.bucket_seconds:
            common.bucket_seconds = {}
        writes_before = self.provider.write_stats()
        errors_before = self.runner.bucket_failures
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
        except BaseException:
            # An aborted pass may have left nodes half moved that no delta
            # will touch: the next pass reclassifies everything.
            if getattr(self.snapshot_source, "incremental", False):
                self.snapshot_source.invalidate()
            raise
        finally:
            writes_after = self.provider.write_stats()
            for key in ("issued", "skipped", "coalesced", "batched"):
                setattr(stats, f"writes_{key}", writes_after[key] - writes_before[key])
            stats.node_errors = self.runner.bucket_failures - errors_before
            stats.apply_s = time.perf_counter() - start
            stats.bucket_seconds = dict(common.bucket_seconds)
            common.on_first_bucket = None
            self._close_pass_span(stats)
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
