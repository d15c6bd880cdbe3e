"""Where ``build_state`` reads its view of the cluster.

The JAX package's ``upgrade/snapshot.py``. Three sources:

* :class:`ClientSnapshotSource` reads three LISTs a pass, the driver
  DaemonSets, their pods and every node, whatever the pool's size (and a
  fourth, the ControllerRevisions, where the pod manager asks it);
* :class:`InformerSnapshotSource` keeps Node, Pod, DaemonSet and
  ControllerRevision informers (``kube/informer.py``: one list, then the
  watch, with a resync as the safety net) and serves every snapshot from
  their stores, with no read on the pass. The provider's write-through
  lands each state write in the Node store at once, so the next pass
  reads its own writes before the watch brings them;
* :class:`IncrementalSnapshotSource` also keeps the classified state
  itself, from the informers' deltas: a pass reclassifies only the nodes
  whose world changed (:class:`SnapshotDelta`), and a settled pool's pass
  reads nothing and classifies nothing.

An informer snapshot is as stale as a controller-runtime cached client: at
most one watch delivery behind. ``build_state``'s completeness check (the
DaemonSet's desired count against its pods) is the guard: a stale view
aborts the pass and the next one retries. With a ``watch_hub`` (a
``kube/watchhub.py`` ``WatchHub``, or a ``kube/relay.py``
``RelayWatchSource``) every informer's watch rides the shared stream of
its scope, and co-hosted sources cost one upstream stream a kind; the
lists stay on the client. The incremental
source keeps a **wake book**: a node dirtied inside an informer's delivery
span (which joined the trace of the write it delivers) records that trace,
and the next pass span links to it (``consume_wake_traces``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Mapping, Optional, Protocol, Sequence

from ..kube.client import Client
from ..kube.informer import Informer
from ..kube.objects import ControllerRevision, DaemonSet, KubeObject, Node, Pod
from ..utils import tracing
from ..utils.lifecycle import lifecycle_resource
from ..utils.log import get_logger

if TYPE_CHECKING:  # a snapshot <-> common_manager import cycle otherwise
    from .common_manager import ClusterUpgradeState, NodeUpgradeState
    from .consts import UpgradeState

log = get_logger("upgrade.snapshot")

#: The informers' default resync period.
DEFAULT_RESYNC_PERIOD_S = 300.0


class SnapshotSource(Protocol):
    """What ``build_state`` reads; ``cached`` says whether it reads local
    stores."""

    cached: bool

    def daemonsets(self, namespace: str, labels: Mapping[str, str]) -> list[DaemonSet]: ...

    def pods(self, namespace: str, labels: Mapping[str, str]) -> list[Pod]: ...

    def nodes(self) -> dict[str, Node]: ...

    def controller_revisions(
        self, namespace: str, labels: Mapping[str, str]
    ) -> list[ControllerRevision]:
        """The ControllerRevisions the pod manager reads a DaemonSet's
        rollout hash from."""
        ...

    def consume_reads(self) -> int:
        """Client reads since the last call."""
        ...


class ClientSnapshotSource:
    """Three LISTs a snapshot: pods, DaemonSets and ControllerRevisions
    through the writing client, nodes through ``node_reader``, the
    (possibly cached) reader the provider reads nodes with (the writing
    client without one)."""

    cached = False

    def __init__(self, client: Client, node_reader: Optional[Client] = None) -> None:
        self._client = client
        self._node_reader = node_reader if node_reader is not None else client
        self._reads_lock = threading.Lock()
        self._reads = 0

    def _count(self) -> None:
        with self._reads_lock:
            self._reads += 1

    def consume_reads(self) -> int:
        with self._reads_lock:
            reads, self._reads = self._reads, 0
            return reads

    def daemonsets(self, namespace: str, labels: Mapping[str, str]) -> list[DaemonSet]:
        self._count()
        return [
            DaemonSet(o.raw)
            for o in self._client.list(
                "DaemonSet", namespace=namespace, label_selector=dict(labels)
            )
        ]

    def pods(self, namespace: str, labels: Mapping[str, str]) -> list[Pod]:
        self._count()
        return [
            Pod(o.raw)
            for o in self._client.list("Pod", namespace=namespace, label_selector=dict(labels))
        ]

    def nodes(self) -> dict[str, Node]:
        self._count()
        return {o.name: Node(o.raw) for o in self._node_reader.list("Node")}

    def controller_revisions(
        self, namespace: str, labels: Mapping[str, str]
    ) -> list[ControllerRevision]:
        self._count()
        return [
            ControllerRevision(o.raw)
            for o in self._client.list(
                "ControllerRevision", namespace=namespace, label_selector=dict(labels)
            )
        ]


@lifecycle_resource(acquire="start", release="stop")
class InformerSnapshotSource:
    """Snapshots from informer stores: Node cluster-wide, Pod and
    DaemonSet in the driver's namespace and labels, ControllerRevision in
    the namespace. :meth:`record_write` is the provider's write-through
    (``with_snapshot_from_informers`` wires both)."""

    cached = True

    def __init__(
        self,
        client: Client,
        namespace: str,
        driver_labels: Mapping[str, str],
        resync_period_s: float = DEFAULT_RESYNC_PERIOD_S,
        watch_hub=None,
    ) -> None:
        self._client = client
        self.namespace = namespace
        self.driver_labels = dict(driver_labels)
        self._informers: dict[str, Informer] = {
            "Node": Informer(client, "Node", resync_period_s=resync_period_s,
                             stream_source=watch_hub),
            "Pod": Informer(
                client, "Pod", namespace=namespace, label_selector=self.driver_labels,
                resync_period_s=resync_period_s, stream_source=watch_hub,
            ),
            "DaemonSet": Informer(
                client, "DaemonSet", namespace=namespace, label_selector=self.driver_labels,
                resync_period_s=resync_period_s, stream_source=watch_hub,
            ),
            # Read every pass (the rollout hash). Unselected within the
            # namespace: a revision carries the DaemonSet's match labels,
            # which may differ from the driver labels, and
            # controller_revisions() selects at read time.
            "ControllerRevision": Informer(
                client, "ControllerRevision", namespace=namespace,
                resync_period_s=resync_period_s, stream_source=watch_hub,
            ),
        }
        self._started = False
        self._primed = False

    # -- lifecycle ---------------------------------------------------------
    def start(self, sync_timeout: float = 30.0) -> "InformerSnapshotSource":
        """Start the informers and wait until each has listed: a snapshot
        before that would be empty, not stale. Where the client has
        ``prime_list_cache`` (``RestClient``), the informers' first lists
        are pipelined first as one batch on one connection, and each
        informer's list takes its primed result; a failed prime leaves
        the lists to ask, and meet the error, themselves. Only the first
        start primes: a restarted informer asks for the changes since its
        revision (``list_delta``), and a primed list it never took would
        wait, stale, for the next whole list."""
        prime = getattr(self._client, "prime_list_cache", None)
        if prime is not None and not self._primed:
            self._primed = True
            try:
                prime([
                    (inf.kind, inf.namespace, inf.label_selector, inf.field_selector)
                    for inf in self._informers.values()
                    if not inf.started
                ])
            except Exception:  # noqa: BLE001 - the seed is a saving only
                log.debug("pipelined informer seed failed; the lists will ask",
                          exc_info=True)
        for informer in self._informers.values():
            if not informer.started:
                informer.start()
        for kind, informer in self._informers.items():
            if not informer.wait_for_sync(timeout=sync_timeout):
                self.stop()
                raise TimeoutError(f"{kind} informer did not sync within {sync_timeout}s")
        self._started = True
        return self

    def stop(self) -> None:
        for informer in self._informers.values():
            if informer.started:
                informer.stop()
        self._started = False

    def __enter__(self) -> "InformerSnapshotSource":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def started(self) -> bool:
        return self._started

    def informer(self, kind: str) -> Informer:
        """The informer of ``kind`` ("Node", "Pod", "DaemonSet",
        "ControllerRevision"), for handlers that would otherwise open a
        watch of their own."""
        return self._informers[kind]

    # -- the provider's write-through ----------------------------------------
    def record_write(self, obj: KubeObject) -> None:
        """Land a write's result in its kind's store (read-your-writes);
        kinds without an informer are passed over."""
        raw = getattr(obj, "raw", obj)
        informer = self._informers.get(raw.get("kind", ""))
        if informer is not None:
            informer.record_write(raw)

    # -- SnapshotSource ----------------------------------------------------
    def consume_reads(self) -> int:
        return 0  # store reads; the informers' own lists are not a pass's

    def daemonsets(self, namespace: str, labels: Mapping[str, str]) -> list[DaemonSet]:
        # copy=False for the kinds the managers never change; nodes are
        # copied, since the provider and cordon write to them.
        self._check_scope(namespace, labels)
        return [DaemonSet(o.raw) for o in self._informers["DaemonSet"].list(copy=False)]

    def pods(self, namespace: str, labels: Mapping[str, str]) -> list[Pod]:
        self._check_scope(namespace, labels)
        return [Pod(o.raw) for o in self._informers["Pod"].list(copy=False)]

    def nodes(self) -> dict[str, Node]:
        return {o.name: Node(o.raw) for o in self._informers["Node"].list()}

    def controller_revisions(
        self, namespace: str, labels: Mapping[str, str]
    ) -> list[ControllerRevision]:
        if namespace != self.namespace:
            raise ValueError(
                f"snapshot source is scoped to namespace={self.namespace!r}; "
                f"got namespace={namespace!r}"
            )
        return [
            ControllerRevision(o.raw)
            for o in self._informers["ControllerRevision"].list(
                label_selector=dict(labels), copy=False
            )
        ]

    def _check_scope(self, namespace: str, labels: Mapping[str, str]) -> None:
        """The informers were scoped when made; another scope would read
        the wrong objects."""
        if namespace != self.namespace or dict(labels) != self.driver_labels:
            raise ValueError(
                "snapshot source is scoped to "
                f"namespace={self.namespace!r} labels={self.driver_labels!r}; "
                f"got namespace={namespace!r} labels={dict(labels)!r}"
            )


@dataclass(frozen=True)
class SnapshotDelta:
    """What changed since the last snapshot a pass consumed, read at the
    top of a pass (:meth:`IncrementalSnapshotSource.dirty`) and retired
    only after the pass used it (:meth:`~IncrementalSnapshotSource.clean`);
    what arrives meanwhile stays for the next pass."""

    #: No per-node view can vouch for the cached state: the first build, a
    #: DaemonSet or ControllerRevision delta, or ``invalidate()``.
    full: bool
    #: The invalidation epoch when read; ``clean`` retires no later one.
    epoch: int
    #: The nodes whose world changed: their object, a driver pod on them,
    #: or a write of the provider.
    nodes: frozenset[str]
    #: Each node's mark generation when read. ``clean`` retires a node only
    #: while its generation is unchanged: an event for an already dirty
    #: node mid-pass moves it on, and the pass may have read the store
    #: before that event.
    marks: Mapping[str, int] = field(default_factory=dict)


class IncrementalSnapshotSource(InformerSnapshotSource):
    """An informer source that also keeps the classified state.

    It handles its own informers' deltas into a **dirty set**: a Node
    event dirties that node, a Pod event the node it runs on (old and new
    ``spec.nodeName``), and the provider's write-through every node the
    pass wrote. A DaemonSet or ControllerRevision delta, which changes the
    revision every node's sync check compares with, bumps the **full
    epoch** instead, and the next pass reclassifies everything.
    ``build_state`` reads :meth:`dirty` and :meth:`clean`: a settled pool
    is served the cached ``ClusterUpgradeState`` with no read and no
    per-node work, and one node's event reclassifies one node. Buckets
    that poll objects this source does not watch (workload pods, the
    checkpoint arc's acks) iterate unfiltered; every move into or out of
    them is a provider write, which lands in the dirty set. The cached
    state lives here (:meth:`prime`, :meth:`update_node`); classifying it
    stays with the manager. With ``verify_every_n`` every n-th pass is a
    full rebuild diffed against the kept state, each difference counted
    and repaired.

    The dirty set, the per-DaemonSet pod counts and the epochs are shared
    with the informers' threads under ``_delta_lock``, under which nothing
    blocks; the cached state is the reconcile thread's alone (one manager,
    one pass at a time).
    """

    incremental = True

    #: The Pod informer's index of pods by their node.
    POD_NODE_INDEX = "spec.nodeName"

    def __init__(
        self,
        client: Client,
        namespace: str,
        driver_labels: Mapping[str, str],
        resync_period_s: float = DEFAULT_RESYNC_PERIOD_S,
        verify_every_n: int = 0,
        watch_hub=None,
    ) -> None:
        super().__init__(
            client, namespace, driver_labels,
            resync_period_s=resync_period_s, watch_hub=watch_hub,
        )
        #: Every n-th build is an audited full rebuild (0: none).
        self.verify_every_n = int(verify_every_n)
        self._delta_lock = threading.Lock()
        #: node name -> its mark's generation, from one counter that never
        #: resets: a node marked again after a clean gets a generation no
        #: consumed delta holds, so a second clean of that delta (the
        #: audit cleans twice) cannot absorb it.
        self._dirty: dict[str, int] = {}
        self._mark_seq = 0
        self._full_epoch = 1  # above the clean epoch: the first build is full
        self._clean_epoch = 0
        self._delta_events = 0
        self._full_invalidations = 0
        self._verify_divergences = 0
        #: The first ownerReference's uid -> its pods, kept from the pod
        #: deltas: the completeness check of a delta pass in O(DaemonSets).
        self._ds_pod_counts: dict[str, int] = {}
        #: The traces of the writes whose deltas dirtied this book since the
        #: last pass consumed it: at most 64, and empty with no tracer.
        self._wake_traces: list[str] = []
        # The cached classification (the reconcile thread's).
        self._state: Optional["ClusterUpgradeState"] = None
        self._assignment: dict[str, list[tuple["UpgradeState", "NodeUpgradeState"]]] = {}
        pod_informer = self._informers["Pod"]
        pod_informer.add_indexer(
            self.POD_NODE_INDEX,
            lambda o: [(o.raw.get("spec") or {}).get("nodeName", "") or ""],
        )
        # Registered before start(), so the first list's ADDEDs count.
        self._informers["Node"].add_event_handler(self._on_node_event)
        pod_informer.add_event_handler(self._on_pod_event)
        self._informers["DaemonSet"].add_event_handler(self._on_revision_event)
        self._informers["ControllerRevision"].add_event_handler(self._on_revision_event)

    # -- deltas in (the informers' threads) ----------------------------------
    def _mark_node(self, name: str) -> None:
        with self._delta_lock:
            self._mark_node_locked(name)
            self._delta_events += 1

    def _mark_node_locked(self, name: str) -> None:
        self._mark_seq += 1
        self._dirty[name] = self._mark_seq
        self._note_wake_locked(tracing.current_trace_id())

    def _note_wake_locked(self, trace_id: Optional[str]) -> None:
        if trace_id is not None and len(self._wake_traces) < 64 and (
            trace_id not in self._wake_traces
        ):
            self._wake_traces.append(trace_id)

    def note_wake_trace(self, trace_id: Optional[str]) -> None:
        """Record a wake from outside this source for the next pass: a
        fleet worker's tick loop hands in the trace of the delivery that
        woke it (``fleet/wakeup.py``), so the pass links to the grant even
        where the delivery dirtied nothing this source watches."""
        with self._delta_lock:
            self._note_wake_locked(trace_id)

    def consume_wake_traces(self) -> list[str]:
        """The traces that woke the next pass, taken out of the book."""
        with self._delta_lock:
            if not self._wake_traces:
                return []
            out, self._wake_traces = self._wake_traces, []
            return out

    def invalidate(self) -> None:
        """Make the next pass reclassify everything: for a DaemonSet or
        ControllerRevision delta, and after an aborted pass, which may
        have left nodes half moved that no delta will touch. A rollout's
        delta wakes the rebuild, whose pass links to it."""
        with self._delta_lock:
            self._full_epoch += 1
            self._full_invalidations += 1
            self._note_wake_locked(tracing.current_trace_id())

    def _on_node_event(self, event_type: str, obj, old) -> None:
        self._mark_node(obj.name)

    @staticmethod
    def _first_owner_uid(pod) -> Optional[str]:
        refs = pod.owner_references
        return refs[0].get("uid") if refs else None

    def _on_pod_event(self, event_type: str, obj, old) -> None:
        uid = self._first_owner_uid(obj)
        node = obj.node_name or ""
        old_uid = old_node = None
        if old is not None:
            old_uid = self._first_owner_uid(old)
            old_node = old.node_name or ""
        with self._delta_lock:
            self._delta_events += 1
            self._mark_node_locked(node)
            if old_node is not None and old_node != node:
                self._mark_node_locked(old_node)
            if event_type == "ADDED":
                if uid:
                    self._bump_ds_pod_count_locked(uid, node, +1)
            elif event_type == "DELETED":
                if uid:
                    self._bump_ds_pod_count_locked(uid, node, -1)
            elif uid != old_uid:  # MODIFIED with another owner
                if old_uid:
                    self._bump_ds_pod_count_locked(
                        old_uid, old_node if old_node is not None else node, -1
                    )
                if uid:
                    self._bump_ds_pod_count_locked(uid, node, +1)
            elif uid and old_node is not None and old_node != node:
                # The same owner, the pod on another node: no change to
                # the owner's count, but a count by place would see it.
                self._bump_ds_pod_count_locked(uid, old_node, -1)
                self._bump_ds_pod_count_locked(uid, node, +1)

    def _bump_ds_pod_count_locked(self, uid: str, node_name: str, delta: int) -> None:
        """One owner's pod count moved (``_delta_lock`` held); ``node_name``
        is where the pod is, for a subclass that counts by place."""
        self._ds_pod_counts[uid] = self._ds_pod_counts.get(uid, 0) + delta

    def _on_revision_event(self, event_type: str, obj, old) -> None:
        # A MODIFIED that changes nothing a classification reads (the
        # kubelet's numberReady, a resync's (obj, obj)) is passed over;
        # anything else reclassifies everything.
        if (
            event_type == "MODIFIED"
            and old is not None
            and self._revision_shape(obj.raw) == self._revision_shape(old.raw)
        ):
            return
        self.invalidate()

    @staticmethod
    def _revision_shape(raw: dict) -> tuple:
        """What of a DaemonSet or ControllerRevision a classification
        reads: its labels, spec, revision and data, and the desired count
        the completeness check compares with."""
        meta = raw.get("metadata") or {}
        return (
            meta.get("labels"),
            raw.get("spec"),
            raw.get("revision"),
            raw.get("data"),
            (raw.get("status") or {}).get("desiredNumberScheduled"),
        )

    def mark_dirty_on(
        self,
        informer: Informer,
        node_names: Callable[[KubeObject], Sequence[str]],
        include_old: bool = False,
    ) -> None:
        """Feed another informer's deltas into the dirty set: each event
        marks the nodes ``node_names(obj)`` returns, and with
        ``include_old`` those of the old object too (a report's dropped
        link peer). An empty or failed mapping invalidates instead: an
        outside delta is never dropped."""

        def handler(event_type, obj, old) -> None:
            names: list = []
            failed = False
            for target in (obj, old if include_old else None):
                if target is None:
                    continue
                try:
                    names += [n for n in (node_names(target) or []) if n]
                except Exception:  # noqa: BLE001 - the mapping owns its errors
                    log.exception("mark_dirty_on mapping failed for %s", obj.name)
                    failed = True
            if names and not failed:
                for name in dict.fromkeys(names):
                    self._mark_node(name)
            else:
                self.invalidate()

        informer.add_event_handler(handler)

    # -- the provider's write-through ----------------------------------------
    def record_write(self, obj: KubeObject) -> None:
        """The store repair, and a mark: the pass's own writes are what the
        next pass must reclassify, and a store repair dispatches no
        event."""
        super().record_write(obj)
        raw = getattr(obj, "raw", obj)
        if raw.get("kind") == "Node":
            name = (raw.get("metadata") or {}).get("name", "")
            if name:
                self._mark_node(name)

    # -- deltas out (the reconcile thread) -----------------------------------
    def dirty(self) -> SnapshotDelta:
        with self._delta_lock:
            return SnapshotDelta(
                full=self._full_epoch > self._clean_epoch,
                epoch=self._full_epoch,
                nodes=frozenset(self._dirty),
                marks=dict(self._dirty),
            )

    def clean(self, delta: SnapshotDelta) -> None:
        """Retire exactly ``delta``: a node marked after :meth:`dirty`
        (again, too) and an invalidation after its epoch stay."""
        with self._delta_lock:
            for name in delta.nodes:
                if self._dirty.get(name) == delta.marks.get(name):
                    self._dirty.pop(name, None)
            if delta.epoch > self._clean_epoch:
                self._clean_epoch = delta.epoch

    @property
    def delta_events(self) -> int:
        with self._delta_lock:
            return self._delta_events

    @property
    def full_invalidations(self) -> int:
        with self._delta_lock:
            return self._full_invalidations

    @property
    def verify_divergences_total(self) -> int:
        """The differences audits found between the kept and the rebuilt
        state, in all; above 0 means a delta was missed (and repaired)."""
        with self._delta_lock:
            return self._verify_divergences

    def racing_nodes(self) -> Optional[frozenset]:
        """After an audit's rebuild, the nodes an event in flight may
        concern: the dirty set and the nodes whose Node or Pod store entry
        is ahead of its dispatch (the store is written before the handler
        marks). None when what is in flight names no node (a DELETED whose
        object is gone, a DaemonSet or ControllerRevision delta): the
        audit then counts nothing. In-flight deliveries are read before
        the dirty set, so one that completes between the reads is seen."""
        node_pending, node_gone = self._informers["Node"].pending_dispatch()
        pod_pending, pod_gone = self._informers["Pod"].pending_dispatch()
        if node_gone or pod_gone:
            return None
        for kind in ("DaemonSet", "ControllerRevision"):
            pending, gone = self._informers[kind].pending_dispatch()
            if pending or gone:
                return None
        with self._delta_lock:
            racing = set(self._dirty)
        for raw in node_pending:
            racing.add((raw.get("metadata") or {}).get("name", ""))
        for raw in pod_pending:
            racing.add((raw.get("spec") or {}).get("nodeName", "") or "")
        return frozenset(n for n in racing if n)

    def count_divergences(
        self,
        incremental_shape: Mapping[str, Sequence],
        rebuilt_shape: Mapping[str, Sequence],
        racing: Optional[frozenset] = None,
    ) -> int:
        """Count, log and add to the total the nodes classified otherwise
        than the rebuild; a node in ``racing`` took an event mid-audit and
        is logged, not counted. The caller repairs by priming the
        rebuild."""
        diverged = 0
        for name in set(incremental_shape) | set(rebuilt_shape):
            ours = incremental_shape.get(name)
            truth = rebuilt_shape.get(name)
            if ours == truth:
                continue
            if racing is not None and name in racing:
                log.info(
                    "audit difference for node %s raced a mid-audit delta; "
                    "not counted (repaired + still dirty)", name,
                )
                continue
            diverged += 1
            log.warning(
                "incremental state diverged for node %s: incremental=%s rebuilt=%s (repaired)",
                name, ours, truth,
            )
        if diverged:
            with self._delta_lock:
                self._verify_divergences += diverged
        return diverged

    def ds_pod_count(self, uid: str) -> int:
        with self._delta_lock:
            return self._ds_pod_counts.get(uid, 0)

    # -- one node's reads ----------------------------------------------------
    def node(self, name: str) -> Optional[Node]:
        obj = self._informers["Node"].get(name)
        return Node(obj.raw) if obj is not None else None

    def pods_on_node(self, name: str) -> list[Pod]:
        return [Pod(o.raw) for o in self._informers["Pod"].by_index(self.POD_NODE_INDEX, name)]

    # -- the cached state (the reconcile thread) -------------------------------
    def cached_state(self) -> Optional["ClusterUpgradeState"]:
        return self._state

    def assignment(self) -> dict[str, list[tuple["UpgradeState", "NodeUpgradeState"]]]:
        """node name -> [(bucket, entry)]: the kept classification."""
        return self._assignment

    def prime(
        self,
        state: "ClusterUpgradeState",
        assignment: dict[str, list[tuple["UpgradeState", "NodeUpgradeState"]]],
    ) -> None:
        """Take a full rebuild as the kept state, and count the pods a
        DaemonSet anew from the Pod store while no delivery is in flight
        (else the counts stay as they are): a count that drifted, as after
        a handler died mid-delivery, would otherwise fail every delta
        pass's completeness check."""
        self._state = state
        self._assignment = dict(assignment)
        self._informers["Pod"].with_settled_store(self._rebase_pod_counts)

    def _rebase_pod_counts(self, raws: list) -> None:
        counts: dict[str, int] = {}
        for raw in raws:
            refs = (raw.get("metadata") or {}).get("ownerReferences") or []
            uid = refs[0].get("uid") if refs else None
            if uid:
                counts[uid] = counts.get(uid, 0) + 1
        with self._delta_lock:
            self._ds_pod_counts = counts

    def update_node(
        self,
        name: str,
        entries: Sequence[tuple["UpgradeState", "NodeUpgradeState"]],
    ) -> None:
        """Swap one node's classification into the kept state: its old
        entries leave their buckets (by identity), the new ones join
        theirs."""
        state = self._state
        assert state is not None, "update_node before prime"
        old = self._assignment.pop(name, None)
        if old:
            for bucket, entry in old:
                entries_in_bucket = state.node_states.get(bucket)
                if entries_in_bucket:
                    entries_in_bucket[:] = [e for e in entries_in_bucket if e is not entry]
        if entries:
            self._assignment[name] = list(entries)
            for bucket, entry in entries:
                state.node_states[bucket].append(entry)
