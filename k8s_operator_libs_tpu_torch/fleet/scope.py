"""Shard-scoped snapshots: one worker's window onto the fleet.

The JAX package's ``fleet/scope.py``. A shard worker (``fleet/worker.py``)
reconciles only the pools whose keys hash to its shards, but its informers
watch the whole fleet: the shards a worker owns change on failover, and a
watch's selector cannot follow a Lease. So the read side is scoped:
:class:`ShardScopedSnapshotSource` extends the incremental source
(``upgrade/snapshot.py``) so that ``build_state`` sees exactly the owned
shards' world:

* ``nodes()``, ``pods()`` and ``pods_on_node()`` keep what lies on a node
  of an owned shard (``shard_of_node``, a pure mapping of the node's name
  through the pool ring);
* the **completeness check** is scoped: the DaemonSet's
  ``desiredNumberScheduled`` is rewritten to the in-scope node count (kept
  per shard from the deltas, counted anew by ``prime()`` as the per-DaemonSet
  pod count is), and ``ds_pod_count`` serves the owned shards' part of a
  per-(uid, shard) twin of that count: a missing driver pod on an owned
  node still aborts the pass, while another shard's drain never wedges this
  worker;
* **a change of ownership invalidates**: the kept classification was made
  for another scope.

The rewrite of the desired count assumes the driver DaemonSet targets
every node of the fleet, the driver's deployment shape on dedicated
accelerator pools and the only shape the upgrade machine models.

With a ``watch_hub`` the informers' watches ride its shared streams:
workers in one process share a ``kube/watchhub.py`` ``WatchHub``, worker
processes of one host a ``kube/relay.py`` relay through their
``RelayWatchSource``.
"""

from __future__ import annotations

from typing import Callable, Mapping

from ..kube.client import Client
from ..kube.objects import DaemonSet, Node, Pod
from ..upgrade.snapshot import DEFAULT_RESYNC_PERIOD_S, IncrementalSnapshotSource
from ..utils.log import get_logger

log = get_logger("fleet.scope")

#: The shard of a key the mapping cannot place (an empty node name, a
#: mapper that raises). No worker owns it: such a node escapes every scope,
#: logged, rather than every worker adopting it at once.
UNMAPPED_SHARD = ""


class ShardScopedSnapshotSource(IncrementalSnapshotSource):
    """An incremental snapshot source filtered to a changing set of shards."""

    def __init__(
        self,
        client: Client,
        namespace: str,
        driver_labels: Mapping[str, str],
        shard_of_node: Callable[[str], str],
        resync_period_s: float = DEFAULT_RESYNC_PERIOD_S,
        verify_every_n: int = 0,
        watch_hub=None,
    ) -> None:
        # The scope's state first: the base registers the event handlers
        # this class overrides, and they read these fields.
        self._shard_of_node = shard_of_node
        #: node name -> shard. The mapping is pure and the ring fixed for
        #: the source's life, so a lookup (pod events' critical sections
        #: included) is a dict hit, not a ring lock and a bisect.
        self._shard_memo: dict[str, str] = {}
        self._owned_shards: frozenset[str] = frozenset()
        #: shard -> its live nodes (from the deltas; prime counts anew).
        self._node_count_by_shard: dict[str, int] = {}
        #: (owner uid, shard) -> its live pods: the base's per-DaemonSet pod
        #: count, by place.
        self._ds_pod_counts_by_shard: dict[tuple[str, str], int] = {}
        super().__init__(
            client, namespace, driver_labels,
            resync_period_s=resync_period_s, verify_every_n=verify_every_n,
            watch_hub=watch_hub,
        )

    # -- the shard mapping -------------------------------------------------------
    def shard_of(self, node_name: str) -> str:
        if not node_name:
            return UNMAPPED_SHARD
        shard = self._shard_memo.get(node_name)
        if shard is not None:
            return shard
        try:
            shard = self._shard_of_node(node_name) or UNMAPPED_SHARD
        except Exception:  # noqa: BLE001 - the mapper's own errors
            log.exception("shard mapping failed for node %s", node_name)
            return UNMAPPED_SHARD  # not kept: a transient error heals
        self._shard_memo[node_name] = shard
        return shard

    def in_scope(self, node_name: str) -> bool:
        return self.shard_of(node_name) in self._owned_shards

    def owned_shards(self) -> frozenset[str]:
        return self._owned_shards

    def set_owned_shards(self, shards: frozenset[str]) -> bool:
        """Adopt a new set of claims; True, and the kept state invalidated,
        where it changed. The reconcile thread's, as the kept state is."""
        shards = frozenset(shards)
        if shards == self._owned_shards:
            return False
        self._owned_shards = shards
        self.invalidate()
        return True

    # -- the counts kept from the deltas -----------------------------------------
    def _on_node_event(self, event_type: str, obj, old) -> None:
        super()._on_node_event(event_type, obj, old)
        if event_type not in ("ADDED", "DELETED"):
            return
        delta = 1 if event_type == "ADDED" else -1
        shard = self.shard_of(obj.name)
        with self._delta_lock:
            self._node_count_by_shard[shard] = self._node_count_by_shard.get(shard, 0) + delta

    def _bump_ds_pod_count_locked(self, uid: str, node_name: str, delta: int) -> None:
        super()._bump_ds_pod_count_locked(uid, node_name, delta)
        key = (uid, self.shard_of(node_name))
        self._ds_pod_counts_by_shard[key] = self._ds_pod_counts_by_shard.get(key, 0) + delta

    def _rebase_pod_counts(self, raws: list) -> None:
        """prime()'s recount, extended to the twin: both counts from one
        settled store, so they cannot disagree."""
        counts: dict[str, int] = {}
        by_shard: dict[tuple[str, str], int] = {}
        for raw in raws:
            refs = (raw.get("metadata") or {}).get("ownerReferences") or []
            uid = refs[0].get("uid") if refs else None
            if not uid:
                continue
            counts[uid] = counts.get(uid, 0) + 1
            node = (raw.get("spec") or {}).get("nodeName") or ""
            key = (uid, self.shard_of(node))
            by_shard[key] = by_shard.get(key, 0) + 1
        with self._delta_lock:
            self._ds_pod_counts = counts
            self._ds_pod_counts_by_shard = by_shard

    def _rebase_node_counts(self, raws: list) -> None:
        counts: dict[str, int] = {}
        for raw in raws:
            shard = self.shard_of((raw.get("metadata") or {}).get("name", ""))
            counts[shard] = counts.get(shard, 0) + 1
        with self._delta_lock:
            self._node_count_by_shard = counts

    def prime(self, state, assignment) -> None:
        super().prime(state, assignment)
        self._informers["Node"].with_settled_store(self._rebase_node_counts)

    # -- the scoped reads ----------------------------------------------------------
    def scoped_node_count(self) -> int:
        with self._delta_lock:
            return sum(self._node_count_by_shard.get(s, 0) for s in self._owned_shards)

    def nodes(self) -> dict[str, Node]:
        return {name: node for name, node in super().nodes().items() if self.in_scope(name)}

    def pods(self, namespace: str, labels: Mapping[str, str]) -> list[Pod]:
        # A pod on no node yet belongs to no shard: the scoped check counts
        # nodes, and the placement's event marks the node when it lands.
        return [p for p in super().pods(namespace, labels)
                if p.node_name and self.in_scope(p.node_name)]

    def daemonsets(self, namespace: str, labels: Mapping[str, str]) -> list[DaemonSet]:
        """The DaemonSets with ``desiredNumberScheduled`` rewritten to the
        in-scope node count, on a fresh top level and status: the store's
        objects are never touched."""
        scoped_desired = self.scoped_node_count()
        out: list[DaemonSet] = []
        for ds in super().daemonsets(namespace, labels):
            raw = dict(ds.raw)
            raw["status"] = dict(raw.get("status") or {})
            raw["status"]["desiredNumberScheduled"] = scoped_desired
            out.append(DaemonSet(raw))
        return out

    def ds_pod_count(self, uid: str) -> int:
        with self._delta_lock:
            return sum(self._ds_pod_counts_by_shard.get((uid, s), 0) for s in self._owned_shards)

    def pods_on_node(self, name: str) -> list[Pod]:
        # An out-of-scope dirty node (the informers mark every node)
        # classifies to no entry, which leaves the kept state as it is.
        if not self.in_scope(name):
            return []
        return super().pods_on_node(name)
