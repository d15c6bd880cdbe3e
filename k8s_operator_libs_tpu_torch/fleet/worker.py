"""Shard workers: N cooperating processes rolling one fleet.

The JAX package's ``fleet/worker.py``. The fleet is cut into a fixed set
of **shards**; pool keys hash onto shards through the consistent ring
(``fleet/hashring.py``), and each shard is owned by one worker at a time
through a ``coordination.k8s.io`` Lease of its own (``kube/leader.py``, the
controller's elector, one a shard). A worker that dies stops renewing: its
shards go stale, the survivors' failover probes claim them, and the new
owner resumes from the node labels and the FleetRollout ledger.

A tick does four things, each idempotent:

1. **campaign**: renew the held shard Leases (every ``retry_period_s``),
   acquire the preferred shards at once, probe the others at the slower
   ``failover_probe_s`` (so a healthy fleet settles on the ring's preferred
   balance instead of a rush of claims);
2. **scope**: adopt the claims into the shard-scoped snapshot source
   (``fleet/scope.py``); a change invalidates the kept state and refolds
   the scoped HealthSource;
3. **reconcile**: one ``build_state``/``apply_state`` pass over the owned
   scope with the unchanged machine, its planner swapped for
   :class:`GrantGatedInplaceManager` where a ledger is configured: the pool
   is the unit of disruption and the grant is the budget;
4. **report**: granted pools whose every in-scope node is upgrade-done,
   schedulable and running a current driver pod are marked ``done`` in the
   ledger (a write at the read's revision), which frees global budget.

The worker's own default machine is for NVIDIA GPU nodes
(``DeviceClass.nvidia("gpu")``). :meth:`ShardWorker.stop` releases the
shard Leases only when asked: a caller whose manager's background tasks (a
drain, an eviction wait) may still write passes ``release=False`` and lets
the Leases expire (``upgrade_controller.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence

from ..api.fleet_v1alpha1 import (
    FLEET_ROLLOUT_KIND,
    POOL_DONE,
    POOL_GRANTED,
    pool_phase,
    pools_in_phase,
    set_pool_phase,
)
from ..kube.client import Client, get_or_none, is_api_error, retry_on_conflict
from ..kube.leader import LeaderElectionConfig, LeaderElector
from ..kube.objects import ControllerRevision
from ..upgrade.consts import NULL_STRING, DeviceClass, UpgradeState
from ..upgrade.inplace import InplaceNodeStateManager
from ..upgrade.snapshot import DEFAULT_RESYNC_PERIOD_S
from ..upgrade.state_manager import ClusterUpgradeStateManager, StateOptions
from ..upgrade.task_runner import TaskRunner
from ..utils import tracing
from ..utils.faultpoints import fault_point, wall_now
from ..utils.lifecycle import lifecycle_resource
from ..utils.log import get_logger
from .hashring import HashRing
from .scope import ShardScopedSnapshotSource

log = get_logger("fleet.worker")


def shard_id(index: int) -> str:
    """A shard's name: stable, sortable, hashable on the ring."""
    return f"shard-{index:02d}"


@dataclass
class FleetWorkerConfig:
    """One shard worker's identity and wiring.

    ``pool_of`` maps a node's NAME to its pool: a pure function of the
    string, never a lookup, so every worker, the orchestrator's aggregator
    and the scoped source compute the same partition without coordination.
    The default (the node's name is its pool) shards by node.
    """

    identity: str
    #: The fleet's fixed shard count: every worker must agree (it defines
    #: the ring). More shards than workers is a finer grain of failover.
    shards: int
    namespace: str
    driver_labels: Mapping[str, str] = field(default_factory=dict)
    pool_of: Callable[[str], str] = staticmethod(lambda name: name)
    #: The FleetRollout to take grants from and report completions to; "":
    #: sharding alone (no orchestrator; the worker's own policy budget
    #: governs its shards).
    rollout_name: str = ""
    #: The peers' identities: the preferred shards are the ring's
    #: assignment of shards to workers. None, and no ``preferred_shards``:
    #: prefer every shard, the one-worker shape.
    workers: Optional[Sequence[str]] = None
    #: The preferred shards outright (the command's round robin by index);
    #: wins over ``workers``.
    preferred_shards: Optional[Sequence[str]] = None
    lease_namespace: str = "kube-system"
    lease_name_prefix: str = "fleet"
    lease_duration_s: float = 15.0
    renew_deadline_s: float = 10.0
    retry_period_s: float = 2.0
    #: How often a shard that is not preferred is probed (the failover
    #: path); default one Lease duration, so a dead peer's shard is taken
    #: about one Lease after it went stale, without hammering live Leases.
    failover_probe_s: Optional[float] = None
    resync_period_s: float = DEFAULT_RESYNC_PERIOD_S
    verify_every_n: int = 0
    #: Run a shard-scoped HealthSource (the NodeHealthReport informer
    #: filtered to the owned shards) and attach it to every snapshot;
    #: register it with the orchestrator's aggregator for the global fold.
    with_health: bool = False
    #: A shared watch source for the worker's informers: a ``WatchHub``
    #: for workers in one process, a ``RelayWatchSource`` for worker
    #: processes of one host. N workers then cost one upstream watch a
    #: kind, not N; the lists stay on the client.
    watch_hub: Optional[Any] = None
    #: The device of the worker's own machine: NVIDIA GPUs where None.
    device: Optional[DeviceClass] = None
    #: Route the worker's own machine's writes through the write batcher
    #: and fan each bucket out ``apply_width`` wide. Ignored where a
    #: ``manager`` is passed: its own options govern.
    batch_writes: bool = False
    apply_width: int = 8

    def resolved_failover_probe_s(self) -> float:
        return self.failover_probe_s if self.failover_probe_s is not None else self.lease_duration_s


class _ShardClaim:
    """The campaign's pace around one shard's LeaderElector.

    The elector's protocol round (``try_acquire_or_renew``) is driven
    synchronously with the worker's clocks; this adds the pace: held and
    preferred shards renew every retry period, others are probed at the
    failover cadence (the first probe a full period late, so at a clean
    start the preferred owner wins its shard uncontested), and a held
    claim is given up when renewals failed past the renew deadline, as the
    threaded elector does.
    """

    def __init__(
        self,
        shard: str,
        elector: LeaderElector,
        preferred: bool,
        retry_period_s: float,
        renew_deadline_s: float,
        failover_probe_s: float,
    ) -> None:
        self.shard = shard
        self.elector = elector
        self.preferred = preferred
        self.held = False
        #: Transitions into held, the failover part of them (a shard that
        #: is not preferred, taken from a stale owner) and losses.
        self.acquisitions = 0
        self.failover_acquisitions = 0
        self.losses = 0
        self._retry = retry_period_s
        self._deadline = renew_deadline_s
        self._probe = failover_probe_s
        self._last_attempt: Optional[float] = None
        self._last_success: Optional[float] = None

    def tick(self, now: float) -> bool:
        if self._last_attempt is None and not self.preferred:
            self._last_attempt = now  # the first failover probe waits a period
            return False
        if self._last_attempt is not None:
            cadence = self._retry if (self.preferred or self.held) else self._probe
            if now - self._last_attempt < cadence:
                return self.held
        self._last_attempt = now
        if self.elector.try_acquire_or_renew():
            if not self.held:
                log.info("worker %r claimed %s", self.elector.config.identity, self.shard)
                self.acquisitions += 1
                if not self.preferred:
                    self.failover_acquisitions += 1
            self.held = True
            self._last_success = now
        elif self.held and (self._last_success is None
                            or now - self._last_success > self._deadline):
            log.warning("worker %r lost %s (no renewal within %.1fs)",
                        self.elector.config.identity, self.shard, self._deadline)
            self.held = False
            self.losses += 1
        return self.held

    def release(self) -> None:
        if self.held:
            self.held = False
            self.elector.release()


class GrantGatedInplaceManager(InplaceNodeStateManager):
    """The fleet's planner: start upgrade-required nodes only in pools the
    ledger grants, a whole pool at once.

    The slice planner's batching one tier up: a granted pool's disruption
    is charged to the global budget already, so starting its nodes one by
    one would multiply the windows for no safety. The base class's per-node
    budget does not run here: the grant is the budget, so pass a permissive
    policy.
    """

    def __init__(self, common, pool_of: Callable[[str], str],
                 granted: Callable[[], frozenset]) -> None:
        super().__init__(common)
        self.pool_of = pool_of
        self.granted = granted

    def process_upgrade_required_nodes(self, state, policy) -> None:
        common = self.common
        candidates = state.nodes_in(UpgradeState.UPGRADE_REQUIRED)
        if not candidates:
            return
        granted = self.granted()
        started: dict[str, int] = {}
        with common._bucket_scope("upgrade-start", len(candidates)):
            for ns in candidates:
                node = ns.node
                # An explicit upgrade request's ack rides the start's PATCH
                # where the node starts; a node without a grant, or that
                # skips, gets it on a write of its own.
                ack = (
                    {common.keys.upgrade_requested_annotation: NULL_STRING}
                    if common.is_upgrade_requested(node) else {}
                )
                if self.pool_of(node.name) not in granted:
                    if ack:
                        common.provider.change_node_upgrade_annotation(
                            node, common.keys.upgrade_requested_annotation, NULL_STRING
                        )
                    continue  # waits for its grant
                if common.skip_node_upgrade(node):
                    if ack:
                        common.provider.change_node_upgrade_annotation(
                            node, common.keys.upgrade_requested_annotation, NULL_STRING
                        )
                    log.info("node %s is marked to skip upgrades", node.name)
                    continue
                common.provider.change_node_state_and_annotations(
                    node, UpgradeState.CORDON_REQUIRED, ack
                )
                pool = self.pool_of(node.name)
                started[pool] = started.get(pool, 0) + 1
        if started:
            log.info("fleet planner: started %s (granted=%d pools)", started, len(granted))


@dataclass
class TickStats:
    """What one :meth:`ShardWorker.tick` did."""

    owned: frozenset
    reconciled: bool = False
    scope_changed: bool = False
    pools_completed: list[str] = field(default_factory=list)
    state: Any = None


@lifecycle_resource(acquire="start", release="stop")
class ShardWorker:
    """One fleet worker: shard Leases, scoped passes, grant I/O.

    Pass a configured ``manager`` to keep its validation and planners; the
    worker swaps in the scoped snapshot source and, with a ledger, the
    grant-gated planner. The clocks go down to each shard's elector, so
    failover is deterministic under a test's clock.
    """

    def __init__(
        self,
        client: Client,
        config: FleetWorkerConfig,
        manager: Optional[ClusterUpgradeStateManager] = None,
        now_fn: Callable[[], float] = time.monotonic,
        wall_fn: Callable[[], float] = wall_now,
    ) -> None:
        if config.shards < 1:
            raise ValueError("fleet needs at least one shard")
        self.client = client
        self.config = config
        self._now = now_fn
        self.shards = [shard_id(i) for i in range(config.shards)]
        self.pool_ring = HashRing(self.shards)
        self._pool_of = config.pool_of
        self.source = ShardScopedSnapshotSource(
            client,
            config.namespace,
            dict(config.driver_labels),
            shard_of_node=self._shard_of_node,
            resync_period_s=config.resync_period_s,
            verify_every_n=config.verify_every_n,
            watch_hub=config.watch_hub,
        )
        if manager is None:
            device = config.device or DeviceClass.nvidia("gpu")
            if config.batch_writes:
                # Batching needs a fan-out to gather nodes (a serial caller
                # makes batches of one), so the threaded runner.
                manager = ClusterUpgradeStateManager(
                    client, device, runner=TaskRunner(),
                    options=StateOptions(apply_width=config.apply_width, batch_writes=True),
                )
            else:
                manager = ClusterUpgradeStateManager(
                    client, device, runner=TaskRunner(inline=True)
                )
        self.mgr = manager
        self.mgr.snapshot_source = self.source
        self.mgr.provider.set_write_through(self.source.record_write)
        self.mgr.common.pod_manager.revision_source = self.source
        # The pass spans carry the worker's identity: workers in one
        # process stay apart in a trace.
        self.mgr.trace_attrs = {"worker": config.identity}
        if config.rollout_name:
            if self.mgr.options.use_maintenance_operator:
                # In the requestor mode the machine hands upgrade-required
                # nodes to the requestor, which would bypass the grants:
                # every pool would start at once. The two are registered
                # policies with a declared conflict, so the registry's
                # validator refuses, naming them.
                from ..policy import validate_composition

                validate_composition(("fleet-grant-gate", "requestor-delegation"))
                raise AssertionError(
                    "policy registry failed to refuse fleet-grant-gate + requestor-delegation"
                )  # pragma: no cover - validate_composition raises
            self.mgr.inplace = GrantGatedInplaceManager(
                self.mgr.common, self._pool_of, self.granted_pools
            )
        self.health = None
        preferred = self._preferred_shards()
        probe = config.resolved_failover_probe_s()
        self._claims: dict[str, _ShardClaim] = {}
        for shard in self.shards:
            elector = LeaderElector(
                client,
                LeaderElectionConfig(
                    name=f"{config.lease_name_prefix}-{shard}",
                    namespace=config.lease_namespace,
                    identity=config.identity,
                    lease_duration_s=config.lease_duration_s,
                    renew_deadline_s=config.renew_deadline_s,
                    retry_period_s=config.retry_period_s,
                ),
                now_fn=now_fn,
                wall_fn=wall_fn,
            )
            self._claims[shard] = _ShardClaim(
                shard, elector, preferred=shard in preferred,
                retry_period_s=config.retry_period_s,
                renew_deadline_s=config.renew_deadline_s,
                failover_probe_s=probe,
            )
        self._rollout_raw: Optional[dict] = None
        self.passes = 0
        self.pools_reported_done = 0
        #: Each shard's passes under this worker's Lease: the per-shard
        #: series the fleet's exporter renders.
        self.shard_passes: dict[str, int] = {s: 0 for s in self.shards}

    def _preferred_shards(self) -> frozenset:
        cfg = self.config
        if cfg.preferred_shards is not None:
            unknown = set(cfg.preferred_shards) - set(self.shards)
            if unknown:
                raise ValueError(f"unknown preferred shards {sorted(unknown)}")
            return frozenset(cfg.preferred_shards)
        if cfg.workers:
            if cfg.identity not in cfg.workers:
                raise ValueError("config.workers must include this worker's identity")
            worker_ring = HashRing(cfg.workers)
            return frozenset(s for s in self.shards if worker_ring.owner(s) == cfg.identity)
        return frozenset(self.shards)

    def _shard_of_node(self, node_name: str) -> str:
        return self.pool_ring.owner(self._pool_of(node_name))

    # -- the lifecycle ---------------------------------------------------------------
    def start(self, sync_timeout: float = 30.0) -> "ShardWorker":
        self.source.start(sync_timeout=sync_timeout)
        if self.config.with_health:
            from ..upgrade.health_source import HealthSource

            self.health = HealthSource(self.client, node_filter=self.source.in_scope,
                                       watch_hub=self.config.watch_hub)
            self.mgr.with_health_telemetry(self.health, sync_timeout=sync_timeout)
        return self

    def stop(self, release: bool = True) -> None:
        """Stop the informers; with ``release``, clear every held shard
        Lease first, so that a peer takes the shards at once. A caller whose
        manager may still write (a drain in flight) passes False: the
        Leases then expire, and no peer writes a node before they do."""
        if release:
            for claim in self._claims.values():
                claim.release()
        if self.health is not None:
            self.health.stop()
        self.source.stop()

    def __enter__(self) -> "ShardWorker":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- introspection ---------------------------------------------------------------
    def owned_shards(self) -> frozenset:
        return frozenset(s for s, c in self._claims.items() if c.held)

    def lease_stats(self) -> dict[str, int]:
        """The Lease transitions summed over the claims (the
        ``tpu_operator_fleet_*`` exporter's failover signal)."""
        return {
            "acquisitions": sum(c.acquisitions for c in self._claims.values()),
            "failover_acquisitions": sum(c.failover_acquisitions for c in self._claims.values()),
            "losses": sum(c.losses for c in self._claims.values()),
        }

    def granted_pools(self) -> frozenset:
        raw = self._rollout_raw
        if raw is None:
            return frozenset()
        return frozenset(pools_in_phase(raw, POOL_GRANTED))

    # -- the tick ----------------------------------------------------------------------
    def tick(self, policy, wake_traces: Optional[Sequence[str]] = None) -> TickStats:
        """Campaign, scope, reconcile, report: one idempotent round. A
        reconcile error propagates (the caller's loop owns the retry, as
        with build and apply); Lease and ledger I/O degrade to a skipped
        step, never a crashed worker.

        ``wake_traces``: the traces of the deliveries that woke the caller
        (``fleet/wakeup.py``), typically the orchestrator's grant write;
        they enter the snapshot source's wake book, so this tick's pass
        links to the grant."""
        for trace_id in wake_traces or ():
            self.source.note_wake_trace(trace_id)
        now = self._now()
        held = frozenset(shard for shard, claim in self._claims.items() if claim.tick(now))
        stats = TickStats(owned=held)
        stats.scope_changed = self.source.set_owned_shards(held)
        if stats.scope_changed and self.health is not None:
            # The scoped fold follows the scope: newly owned shards' reports
            # enter from the store, lost ones leave.
            self.health.refold()
        if self.config.rollout_name:
            try:
                obj = get_or_none(self.client, FLEET_ROLLOUT_KIND, self.config.rollout_name)
                self._rollout_raw = obj.raw if obj is not None else None
            except Exception as e:  # noqa: BLE001 - the client's own classes
                if not is_api_error(e):
                    raise
                # Keep acting on the last ledger seen: grants only move
                # forward, so a stale view can roll too little, never
                # disrupt too much.
                log.warning("fleet ledger read failed: %s", e)
        if not held:
            return stats
        state = self.mgr.build_state(self.config.namespace, dict(self.config.driver_labels))
        self.mgr.apply_state(state, policy)
        self.passes += 1
        for shard in held:
            self.shard_passes[shard] = self.shard_passes.get(shard, 0) + 1
        stats.reconciled = True
        stats.state = state
        if self.config.rollout_name and self._rollout_raw is not None:
            stats.pools_completed = self._report_done_pools(state)
        return stats

    # -- the completion report -----------------------------------------------------------
    def _live_revision_hash(self, ds, cache: dict) -> str:
        """The driver DaemonSet's latest revision hash, from a live read
        (kept per uid for one report).

        Not the informer's revision source: ``done`` is the one write of the
        protocol that is never undone, and a worker whose ControllerRevision
        watch is a delivery behind the new revision would see nothing to
        roll and retire the grant unrolled. One LIST a completion is the
        price of reading the truth for that step."""
        uid = ds.uid
        if uid in cache:
            return cache[uid]
        latest = None
        for obj in self.client.list("ControllerRevision", namespace=self.config.namespace,
                                    label_selector=dict(ds.match_labels)):
            cr = ControllerRevision(obj.raw)
            if latest is None or cr.revision > latest.revision:
                latest = cr
        hash_value = ""
        if latest is not None:
            hash_value = latest.hash_label() or latest.name.removeprefix(f"{ds.name}-")
        cache[uid] = hash_value
        return hash_value

    def _pool_converged(self, entries, hash_cache: dict) -> bool:
        """Every entry upgrade-done, schedulable, with a Ready driver pod
        current against the live revision. The pod check is what makes a
        report safe on the first pass after a grant: a node whose label
        says done from before the driver's bump must not let its pool
        report done unrolled."""
        common = self.mgr.common
        for bucket, ns in entries:
            if bucket != UpgradeState.DONE or ns.node.unschedulable:
                return False
            try:
                if not common.is_driver_pod_in_sync(ns):
                    return False
                if ns.driver_daemonset is None:
                    return False
                live_hash = self._live_revision_hash(ns.driver_daemonset, hash_cache)
                if not live_hash or ns.driver_pod.controller_revision_hash() != live_hash:
                    return False
            except Exception as e:  # noqa: BLE001 - not converged
                # A missing hash label or a failed read is not done: the
                # report retries next tick, and a done never rides an error.
                log.debug("pool convergence check failed for node %s: %s", ns.node.name, e)
                return False
        return True

    def _report_done_pools(self, state) -> list[str]:
        raw = self._rollout_raw
        assert raw is not None
        granted = set(pools_in_phase(raw, POOL_GRANTED))
        if not granted:
            return []
        by_pool: dict[str, list] = {}
        for bucket, node_states in state.node_states.items():
            for ns in node_states:
                pool = self._pool_of(ns.node.name)
                if pool in granted:
                    by_pool.setdefault(pool, []).append((bucket, ns))
        hash_cache: dict = {}
        done = [pool for pool, entries in by_pool.items()
                if self._pool_converged(entries, hash_cache)]
        # A granted pool with no node in its shard's scope is done
        # vacuously, and only its shard's owner may say so (for any other
        # worker no node means not its shard). Else a ghost pool (a typo in
        # spec.pools, or a pool whose nodes went after its grant) would hold
        # a budget slot for ever. The informers are synced (start waits),
        # so the scoped store speaks for the owned shards.
        owned = self.source.owned_shards()
        for pool in granted:
            if pool not in by_pool and self.pool_ring.owner(pool) in owned:
                log.warning("granted pool %r has no nodes in its shard; retiring "
                            "the grant as vacuously done", pool)
                done.append(pool)
        if not done:
            return []

        report_scope = tracing.span("fleet.report_done", category="grant",
                                    worker=self.config.identity, pools=sorted(done))

        def report() -> None:
            act = fault_point("fleet.status_write", rollout=self.config.rollout_name,
                              identity=self.config.identity)
            if act is not None and act.exc is not None:
                # The report fails mid-protocol: completion stays derived
                # from the level and is reported again next tick.
                raise act.exc
            obj = self.client.get(FLEET_ROLLOUT_KIND, self.config.rollout_name)
            changed = False
            for pool in done:
                if pool_phase(obj.raw, pool) == POOL_GRANTED:
                    changed = set_pool_phase(obj.raw, pool, POOL_DONE,
                                             completedBy=self.config.identity) or changed
            if changed:
                # The ledger is the status subresource's.
                self.client.update_status(obj)

        try:
            with report_scope:
                retry_on_conflict(report)
        except Exception as e:  # noqa: BLE001 - the client's own classes
            if not is_api_error(e):
                raise
            # Reported again next tick: completion is derived from the node
            # labels and the pods, not from this write.
            log.warning("fleet completion report failed: %s", e)
            return []
        self.pools_reported_done += len(done)
        log.info("worker %r reported pools done: %s", self.config.identity, done)
        return done
