"""The deterministic chaos harness: seeded fleet-scale fault schedules.

A copy of the JAX package's ``testing/chaos.py``. The per-call failure
tests prove that each API surface absorbs one transient fault; the
failures that break control planes at scale are *schedules*: a worker
dying between grant and pool-done, a Lease stolen mid-apply, a watch
stream lagging the grant ledger, a partition splitting the orchestrator
from half its workers. This module drives the fleet (``fleet/worker.py``
and ``fleet/orchestrator.py`` over a ``FakeCluster`` or a
``LocalApiServer``) under a **seeded, deterministic fault schedule** and
checks the global invariants under every interleaving it explores:

* **budget**: never more than ``maxUnavailablePools`` pools disrupted,
  sampled every step;
* **no grant retired unrolled**: every pool the ledger marks ``done`` is
  rolled (state label, schedulability, pod currency) at the moment of the
  transition;
* **no node lost**: the run ends with every node schedulable, ready and
  upgrade-done;
* **incremental equals full**: each surviving worker's incremental book
  agrees with a fresh full classification
  (``ClusterUpgradeStateManager.audit_incremental``), and completeness
  aborts stay a bounded, counted signal, never a wedge.

Determinism comes from three things:

* **virtual time**: one :class:`~..utils.faultpoints.ChaosClock` feeds
  every elector and claim (``now_fn``/``wall_fn``) and the durable-clock
  helpers (``faultpoints.wall_now``), advanced only by the driver: Lease
  expiry and deadline escalation happen when the schedule says;
* **step-armed faults**: every fault is armed and disarmed at a schedule
  step, never by a racing visit counter, so the decision stream is a pure
  function of (seed, config);
* **settle barriers**: after each step the driver waits until every live
  informer's store matches the cluster's truth for its scope and nothing
  is pending dispatch (informers held by an armed fault exempted), so the
  next step starts from one well-defined world.

Same seed, same schedule JSON, same step trace, same final cluster state;
the schedules and digests equal the JAX harness's seed by seed (the same
TPU device class keys the nodes in both). One command reproduces a run::

    python -m k8s_operator_libs_tpu_torch.tools.chaos_run --seed S --schedule-json out.json

The harness imports no kernel and probes no card: it drives the
simulators of ``kube/sim.py``.
"""

from __future__ import annotations

import hashlib
import json
import random
import threading
import time as _time
from dataclasses import asdict, dataclass, field, replace
from typing import Any, Callable, Mapping, Optional, Sequence

from ..api.fleet_v1alpha1 import (
    FLEET_ROLLOUT_KIND,
    POOL_DONE,
    POOL_GRANTED,
    make_fleet_rollout,
    pools_in_phase,
    rollout_spec,
)
from ..api.upgrade_v1alpha1 import CheckpointSpec, DrainSpec, DriverUpgradePolicySpec
from ..kube.client import ApiError, Client, ConflictError
from ..kube.fake import FakeCluster
from ..kube.objects import KubeObject, Node
from ..kube.sim import CheckpointingWorkloadSimulator, DaemonSetSimulator
from ..upgrade.consts import DeviceClass, UpgradeKeys, UpgradeState
from ..upgrade.state_manager import BuildStateError
from ..utils import faultpoints
from ..utils.faultpoints import DENY, HOLD, OVERFLOW, RAISE, ChaosClock, FaultAction
from ..utils.intstr import IntOrString
from ..utils.log import get_logger

log = get_logger("testing.chaos")

#: The schedule-drivable fault points: consulted in the package's code
#: through ``utils.faultpoints.fault_point`` (the sites are named there),
#: or applied by the driver itself (process death and TCP teardown have no
#: in-process consult site).
POINT_LEASE = "lease"                # kube/leader.py protocol round
POINT_GRANT_WRITE = "grant_write"    # fleet/orchestrator.py ledger write
POINT_STATUS_WRITE = "status_write"  # fleet/worker.py pool-done report
POINT_WATCH = "watch"                # kube/informer.py delivery hold
POINT_HUB_REPLAY = "hub_replay"      # kube/watchhub.py forced overflow
POINT_PARTITION = "partition"        # per-client request blackholing
POINT_WORKER_KILL = "worker_kill"    # driver: stop + optional restart
#: Graceful termination mid-roll (the kubelet's SIGTERM): the worker stops
#: through its real stop path and releases its Leases, so survivors take
#: over with no TTL wait, under the invariants the crash point checks.
POINT_SIGTERM = "sigterm"            # driver: graceful stop + optional restart
POINT_WIRE_KILL = "wire_kill"        # driver: LocalApiServer.kill_connections
#: One PATCH of a write batch fails mid-flush while its batchmates land
#: (``upgrade/write_batch.py`` consults this per entry).
POINT_WRITE_BATCH = "write_batch_partial"
#: The host-local WatchRelay loses every subscriber connection mid-stream
#: (driver: ``WatchRelay.kill_connections``): each worker's
#: ``RelayWatchSource`` degrades to a bounded direct-watch window and then
#: re-adopts the relay.
POINT_RELAY_KILL = "relay_kill"      # driver: WatchRelay.kill_connections
#: A read replica dies mid-roll and is revived on the same port at the
#: window's end (driver: replica stop and rebind): clients fail the read
#: over to the primary and keep every watch and Lease renewal flowing.
POINT_REPLICA_FAILOVER = "replica_failover"

ALL_POINTS = (
    POINT_LEASE, POINT_GRANT_WRITE, POINT_STATUS_WRITE, POINT_WATCH,
    POINT_HUB_REPLAY, POINT_PARTITION, POINT_WORKER_KILL, POINT_SIGTERM,
    POINT_WIRE_KILL, POINT_WRITE_BATCH, POINT_RELAY_KILL,
    POINT_REPLICA_FAILOVER,
)

SCHEDULE_VERSION = 1

NS = "driver-ns"
LABELS = {"app": "driver"}
ROLLOUT = "chaos-roll"
#: The JAX harness's device class (``DeviceClass.tpu()`` there): the node
#: keys, and so the final digests, equal the JAX harness's.
DEVICE = DeviceClass(name="tpu", driver="libtpu")
KEYS = UpgradeKeys(DEVICE)
ORCH_IDENTITY = "orchestrator"


class ChaosServerTimeoutError(ApiError):
    """The injected 504-shaped transient, under schedule control."""


def pool_of(node_name: str) -> str:
    return node_name.split("-")[0]


# ---------------------------------------------------------------------------
# Schedule: seeded fault specs, byte-stable JSON
# ---------------------------------------------------------------------------


@dataclass
class FaultSpec:
    """One scheduled fault: ``point`` armed for ``duration`` steps from
    ``step``. ``target`` picks the participant (Lease name, worker
    identity); ``param`` narrows further (informer kind); ``error`` picks
    the injected exception of a raise point; ``count`` bounds how many
    consults fire within the window (0: every consult)."""

    step: int
    point: str
    duration: int = 1
    target: str = ""
    param: str = ""
    error: str = ""
    count: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "FaultSpec":
        return cls(**{k: raw[k] for k in (
            "step", "point", "duration", "target", "param", "error", "count"
        )})


@dataclass
class ChaosConfig:
    """The fleet's shape and the schedule's envelope. Everything that
    shapes the run is here (echoed into the schedule JSON), so a schedule
    file is a complete recipe."""

    pools: int = 16
    hosts: int = 1
    workers: int = 2
    shards: int = 4
    budget: str = "25%"
    max_steps: int = 0          # 0: derived from pools
    step_dt: float = 0.6
    fault_window: int = 80      # faults arm within the first N steps
    faults_min: int = 2
    faults_max: int = 5
    hub: bool = False           # co-hosted workers behind one WatchHub
    checkpoint: bool = False    # checkpoint-coordinated drains and workloads
    checkpoint_timeout_s: int = 120
    wire: bool = False          # run over a LocalApiServer
    #: Co-hosted workers stream their watches through one WatchRelay
    #: (``kube/relay.py``) and arm ``relay_kill``. In wire mode the
    #: relay's upstream is the LocalApiServer's socket; otherwise it sits
    #: on the fake.
    relay: bool = False
    #: With ``wire``: N read replicas over the primary's journal, worker
    #: reads spread across them by ``RestConfig.read_servers``, and
    #: ``replica_failover`` armed.
    replicas: int = 0
    #: Route the workers' provider writes through the write batcher
    #: (``upgrade/write_batch.py``). The harness keeps the inline runner,
    #: so every stage is a batch of one: what runs is the
    #: stage, flush and rejoin path and the ``write_batch_partial`` point.
    batch_writes: bool = True
    #: The registered policy composition the pools' upgrade policy runs;
    #: empty: the default policy. :func:`run_policy_matrix` sweeps the
    #: shipped compositions over one seed corpus.
    policy: tuple = ()

    def __post_init__(self) -> None:
        # JSON gives the composition back as a list; a reloaded schedule's
        # config must compare and serialize equal.
        self.policy = tuple(self.policy)

    def resolved_max_steps(self) -> int:
        return self.max_steps or (240 + 5 * self.pools)

    def identities(self) -> list[str]:
        return [f"w{i}" for i in range(self.workers)]

    def pool_names(self) -> list[str]:
        return [f"p{i}" for i in range(self.pools)]

    def node_names(self) -> list[str]:
        return [f"{pool}-h{h}" for pool in self.pool_names() for h in range(self.hosts)]

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "ChaosConfig":
        return cls(**dict(raw))


@dataclass
class FaultSchedule:
    seed: int
    config: ChaosConfig
    faults: list[FaultSpec] = field(default_factory=list)

    def to_json(self) -> str:
        """Byte-stable: the same schedule gives the same bytes (the file
        ``chaos_run --schedule-json`` writes)."""
        return json.dumps(
            {
                "version": SCHEDULE_VERSION,
                "seed": self.seed,
                "config": self.config.to_dict(),
                "faults": [f.to_dict() for f in self.faults],
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        raw = json.loads(text)
        if raw.get("version") != SCHEDULE_VERSION:
            raise ValueError(f"unsupported schedule version {raw.get('version')!r}")
        return cls(
            seed=int(raw["seed"]),
            config=ChaosConfig.from_dict(raw["config"]),
            faults=[FaultSpec.from_dict(f) for f in raw["faults"]],
        )

    def last_armed_step(self) -> int:
        return max((f.step + max(1, f.duration) for f in self.faults), default=0)


def generate_schedule(seed: int, config: ChaosConfig) -> FaultSchedule:
    """Draw a fault schedule from the seed, the only randomness of a chaos
    run (``random.Random(seed)``, drawn in the JAX harness's order, so
    both give the same bytes). Drawn within envelopes that can converge:
    fault windows close well before ``max_steps``, at most ``workers - 1``
    workers are down at once, watch holds are short enough that the fake's
    bounded per-watch queue (1024 events) cannot overflow at the
    configured fleet size, and a restart never lands inside its own
    worker's partition window (the restarted informers must sync)."""
    rng = random.Random(seed)
    cfg = config
    points = [
        POINT_LEASE, POINT_GRANT_WRITE, POINT_STATUS_WRITE,
        POINT_WATCH, POINT_PARTITION, POINT_WORKER_KILL, POINT_SIGTERM,
    ]
    if cfg.hub:
        points.append(POINT_HUB_REPLAY)
    if cfg.wire:
        points.append(POINT_WIRE_KILL)
    if cfg.relay:
        points.append(POINT_RELAY_KILL)
    if cfg.wire and cfg.replicas:
        points.append(POINT_REPLICA_FAILOVER)
    if cfg.batch_writes:
        points.append(POINT_WRITE_BATCH)
    identities = cfg.identities()
    faults: list[FaultSpec] = []
    perma_killed: set[str] = set()
    partition_windows: dict[str, list[tuple[int, int]]] = {}
    kill_windows: dict[str, list[tuple[int, int]]] = {}

    def overlaps(windows, step, duration):
        return any(step < end and start < step + duration for start, end in windows)

    n_faults = rng.randint(cfg.faults_min, cfg.faults_max)
    for _ in range(n_faults):
        point = rng.choice(points)
        step = rng.randint(2, max(3, cfg.fault_window))
        if point == POINT_LEASE:
            shard = rng.randrange(cfg.shards)
            faults.append(FaultSpec(
                step=step, point=point, duration=rng.randint(3, 12),
                target=f"fleet-shard-{shard:02d}",
            ))
        elif point == POINT_GRANT_WRITE:
            faults.append(FaultSpec(
                step=step, point=point, duration=rng.randint(1, 6),
                error=rng.choice(("conflict", "server_timeout")),
                count=rng.randint(1, 4),
            ))
        elif point == POINT_STATUS_WRITE:
            faults.append(FaultSpec(
                step=step, point=point, duration=rng.randint(1, 6),
                target=rng.choice(["", *identities]),
                error=rng.choice(("conflict", "server_timeout")),
                count=rng.randint(1, 4),
            ))
        elif point == POINT_WATCH:
            # Short holds only: events queue upstream while held, and the
            # fake's per-watch queue drops past 1024, so the window is
            # bounded for a held informer never to lose events.
            faults.append(FaultSpec(
                step=step, point=point, duration=rng.randint(2, 6),
                target=rng.choice(identities),
                param=rng.choice(("", "Node", "Pod")),
            ))
        elif point == POINT_HUB_REPLAY:
            faults.append(FaultSpec(
                step=step, point=point, duration=rng.randint(1, 3),
                param=rng.choice(("", "Node", "Pod")),
                count=rng.randint(1, 2),
            ))
        elif point == POINT_PARTITION:
            target = rng.choice([ORCH_IDENTITY, *identities])
            duration = rng.randint(3, 12)
            if overlaps(kill_windows.get(target, []), step, duration):
                continue  # the restart inside would fail its sync
            partition_windows.setdefault(target, []).append((step, step + duration))
            faults.append(FaultSpec(step=step, point=point, duration=duration, target=target))
        elif point in (POINT_WORKER_KILL, POINT_SIGTERM):
            # One envelope for both exits: at most workers-1 down at once
            # and no restart inside its own partition. They differ only in
            # how the worker leaves: a crash (the Leases expire) or the
            # graceful stop (the Leases released).
            alive = [i for i in identities if i not in perma_killed]
            if len(alive) <= 1:
                continue  # someone must survive to finish the roll
            target = rng.choice(alive)
            permanent = rng.random() < 0.3
            duration = rng.randint(6, 30)
            if overlaps(partition_windows.get(target, []), step + duration, 1):
                continue  # the restart would sync through its own partition
            if permanent:
                perma_killed.add(target)
            else:
                # The restart's instant, so that a later partition draw
                # for this worker cannot bracket it (the overlaps() check
                # above covers a kill drawn after the partition).
                kill_windows.setdefault(target, []).append(
                    (step + duration, step + duration + 1)
                )
            faults.append(FaultSpec(
                step=step, point=point, duration=duration, target=target,
                param="perma" if permanent else "restart",
            ))
        elif point == POINT_WIRE_KILL:
            faults.append(FaultSpec(step=step, point=point, duration=rng.randint(1, 2)))
        elif point == POINT_RELAY_KILL:
            # The wire_kill envelope: the relay's subscriber connections
            # die for the window while the relay stays up, so resumes race
            # fallbacks, and both paths must converge.
            faults.append(FaultSpec(step=step, point=point, duration=rng.randint(1, 2)))
        elif point == POINT_REPLICA_FAILOVER:
            # The replica is down for the window and revived on its port
            # at the end: long enough that reads route around it, bounded
            # so that the revival runs too.
            faults.append(FaultSpec(
                step=step, point=point, duration=rng.randint(3, 10),
                target=str(rng.randrange(cfg.replicas)),
            ))
        elif point == POINT_WRITE_BATCH:
            # Empty target: any node's slot in any flush; a node target
            # narrows to that node's entries.
            faults.append(FaultSpec(
                step=step, point=point, duration=rng.randint(1, 6),
                target=rng.choice(["", *cfg.node_names()[:4]]),
                error=rng.choice(("conflict", "server_timeout")),
                count=rng.randint(1, 4),
            ))
    faults.sort(key=lambda f: (f.step, f.point, f.target, f.param))
    return FaultSchedule(seed=seed, config=cfg, faults=faults)


# ---------------------------------------------------------------------------
# Plan: what fault_point() consults
# ---------------------------------------------------------------------------


class FaultPlan:
    """The armed-window matcher behind ``faultpoints.fault_point``. The
    driver moves :attr:`step`; consults, from any thread, match the armed
    specs: a pure function of (schedule, step, ctx), which keeps the
    decision stream replayable."""

    def __init__(self, schedule: FaultSchedule) -> None:
        self.schedule = schedule
        self._lock = threading.Lock()
        self.step = -1
        #: spec index -> fires inside its window (count-bounded points).
        self.fires: dict[int, int] = {}
        #: point name -> lifetime fires (the synchronous ones land in the
        #: trace).
        self.fired: dict[str, int] = {}

    def begin_step(self, step: int) -> None:
        with self._lock:
            self.step = step

    def _armed(self, spec: FaultSpec) -> bool:
        return spec.step <= self.step < spec.step + max(1, spec.duration)

    @staticmethod
    def _error_for(spec: FaultSpec) -> BaseException:
        if spec.error == "conflict":
            return ConflictError("chaos: injected conflict")
        if spec.error == "server_timeout":
            return ChaosServerTimeoutError("chaos: injected server timeout")
        return ApiError("chaos: injected api error")

    def consult(self, point: str, ctx: Mapping[str, Any]):
        with self._lock:
            for idx, spec in enumerate(self.schedule.faults):
                if not self._armed(spec):
                    continue
                action = self._match(spec, point, ctx)
                if action is None:
                    continue
                if spec.count and self.fires.get(idx, 0) >= spec.count:
                    continue
                self.fires[idx] = self.fires.get(idx, 0) + 1
                self.fired[spec.point] = self.fired.get(spec.point, 0) + 1
                return action
        return None

    def _match(self, spec: FaultSpec, point: str, ctx: Mapping[str, Any]) -> Optional[FaultAction]:
        if spec.point == POINT_LEASE and point == "lease.round":
            if spec.target in ("", ctx.get("name")):
                return FaultAction(DENY)
        elif spec.point == POINT_GRANT_WRITE and point == "fleet.grant_write":
            return FaultAction(RAISE, self._error_for(spec))
        elif spec.point == POINT_STATUS_WRITE and point == "fleet.status_write":
            if spec.target in ("", ctx.get("identity")):
                return FaultAction(RAISE, self._error_for(spec))
        elif spec.point == POINT_WATCH and point == "watch.deliver":
            # A watch hold needs a target: an informer with the default
            # empty chaos_tag cannot be targeted (kube/informer.py), or an
            # empty-target spec would hold every untagged informer of the
            # process.
            if spec.target and spec.target == ctx.get("tag") and (
                spec.param in ("", ctx.get("kind"))
            ):
                return FaultAction(HOLD)
        elif spec.point == POINT_HUB_REPLAY and point == "watchhub.deliver":
            if spec.param in ("", ctx.get("kind")):
                return FaultAction(OVERFLOW)
        elif spec.point == POINT_WRITE_BATCH and point == "upgrade.write_batch_partial":
            if spec.target in ("", ctx.get("node")):
                return FaultAction(RAISE, self._error_for(spec))
        elif spec.point == POINT_PARTITION and point == "wire.partition":
            if spec.target == ctx.get("identity"):
                return FaultAction(
                    RAISE, ApiError(f"chaos: {spec.target} partitioned from the apiserver")
                )
        return None

    def record_driver_fire(self, point: str) -> None:
        """The points the driver applies (worker_kill, wire_kill, ...)
        have no consult in the code: the driver records their firing here,
        so the trace sees them like any other point. Driver thread only,
        hence step-deterministic."""
        with self._lock:
            self.fired[point] = self.fired.get(point, 0) + 1

    # -- the driver's queries ----------------------------------------------------
    def held_watch(self, tag: str, kind: str) -> bool:
        """True while a watch hold is armed for this informer: the settle
        barrier exempts it (its store is meant to lag)."""
        with self._lock:
            return any(
                self._armed(s)
                and s.point == POINT_WATCH
                and s.target == tag
                and s.param in ("", kind)
                for s in self.schedule.faults
            )

    def partitioned(self, identity: str) -> bool:
        with self._lock:
            return any(
                self._armed(s) and s.point == POINT_PARTITION and s.target == identity
                for s in self.schedule.faults
            )

    def sync_fire_counts(self) -> dict[str, int]:
        """Cumulative fires of the step-synchronous points (consulted only
        from the driver's thread), safe to put in the trace. The
        asynchronous points (watch hold and hub overflow, consulted from
        watch and pump threads) are reported once a run instead."""
        with self._lock:
            return {
                p: n
                for p, n in sorted(self.fired.items())
                if p not in (POINT_WATCH, POINT_HUB_REPLAY)
            }

    def async_points_engaged(self) -> dict[str, bool]:
        with self._lock:
            return {
                POINT_WATCH: self.fired.get(POINT_WATCH, 0) > 0,
                POINT_HUB_REPLAY: self.fired.get(POINT_HUB_REPLAY, 0) > 0,
            }


class PartitionedClient:
    """Per-participant request blackholing: every API call this client
    carries consults the ``wire.partition`` point first, so a schedule can
    split the orchestrator from some workers while the cluster stays
    healthy. Established watch streams are not cut (the half-open
    partition: a TCP stream lives on while new connections fail); cutting
    streams is the ``watch`` and ``wire_kill`` points' work. The base
    ``Client`` protocol does not declare every verb below (``apply``,
    ``update_status``, ``delete_collection``); the concrete clients have
    them, and the delegation reaches them by name."""

    _INTERCEPTED = frozenset({
        "get", "get_or_none", "list", "list_with_revision", "list_delta",
        "watch", "create", "update", "update_status", "patch", "patch_many",
        "apply", "delete", "delete_collection", "delete_if_exists", "evict",
        "discover",
    })

    def __init__(self, inner: Client, identity: str) -> None:
        self._inner = inner
        self.identity = identity

    def _check(self) -> None:
        act = faultpoints.fault_point("wire.partition", identity=self.identity)
        if act is not None:
            raise act.exc if act.exc is not None else ApiError(
                f"chaos: {self.identity} partitioned"
            )

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name in self._INTERCEPTED and callable(attr):
            def guarded(*args, **kwargs):
                self._check()
                return attr(*args, **kwargs)

            return guarded
        return attr


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------


@dataclass
class ChaosResult:
    seed: int
    converged: bool
    steps: int
    #: invariant name -> violation count; all must be zero.
    violations: dict[str, int]
    #: Each step's observables (cluster truth only), compared run to run.
    trace: list[dict]
    fired: dict[str, int]
    async_engaged: dict[str, bool]
    completeness_aborts: int
    final_digest: str
    schedule_json: str
    wall_s: float

    @property
    def total_violations(self) -> int:
        return sum(self.violations.values())

    def summary(self) -> dict:
        return {
            "seed": self.seed,
            "converged": self.converged,
            "steps": self.steps,
            "violations": dict(self.violations),
            "total_violations": self.total_violations,
            "fired": dict(self.fired),
            "async_engaged": dict(self.async_engaged),
            "completeness_aborts": self.completeness_aborts,
            "final_digest": self.final_digest,
            "wall_s": round(self.wall_s, 3),
        }


class _WorkerSlot:
    """One worker identity's life across kills and restarts."""

    def __init__(self, identity: str) -> None:
        self.identity = identity
        self.worker = None
        self.alive = False
        self.restart_at: Optional[int] = None
        self.ticks = 0
        self.aborts = 0
        #: Completeness aborts summed over dead incarnations (each restart
        #: builds a fresh manager, whose counter starts at 0).
        self.aborts_retired = 0
        #: The same for checkpoint escalations: an incarnation that
        #: escalated and was then killed still fails the invariant.
        self.escalations_retired = 0


class ChaosFleetHarness:
    """Build a fleet (cluster, simulator, rollout, N shard workers, one
    orchestrator), run it under a :class:`FaultSchedule` and check the
    global invariants. One harness a run: it installs the plan and the
    clock and tears everything down."""

    def __init__(self, config: ChaosConfig) -> None:
        self.cfg = config
        self.clock = ChaosClock()
        self.cluster: FakeCluster = None  # type: ignore[assignment]
        self.sim: DaemonSetSimulator = None  # type: ignore[assignment]
        self.workload: Optional[CheckpointingWorkloadSimulator] = None
        self.hub = None
        self.server = None
        self.relay = None
        self.replicas: list = []
        self._relay_sources: list = []
        self.orch = None
        self.slots: dict[str, _WorkerSlot] = {}
        self.budget = 0

    # -- construction ------------------------------------------------------------
    def _client_for(self, identity: str) -> Client:
        if self.server is not None:
            from ..kube.rest import RestClient, RestConfig

            inner: Client = RestClient(RestConfig(
                server=self.server.url,
                read_servers=tuple(r.url for r in self.replicas),
            ))
        else:
            inner = self.cluster
        return PartitionedClient(inner, identity)

    def _build_cluster(self) -> None:
        if self.cfg.wire:
            from ..kube.apiserver import LocalApiServer

            self.server = LocalApiServer().start()
            self.cluster = self.server.cluster
            # The read replicas share the primary's journal; every client
            # built after this spreads its reads across them.
            self.replicas = [
                self.server.read_replica().start() for _ in range(self.cfg.replicas)
            ]
        else:
            self.cluster = FakeCluster()
        if self.cfg.relay:
            from ..kube.relay import WatchRelay
            from ..kube.rest import RestConfig

            # In wire mode the relay subscribes upstream over a socket; on
            # the fake it sits on the cluster. Either way its subscribers
            # speak the watch wire protocol to its socket.
            upstream = (
                RestConfig(server=self.server.url) if self.server is not None else self.cluster
            )
            self.relay = WatchRelay(upstream).start()
        for name in self.cfg.node_names():
            node = Node.new(name)
            node.set_ready(True)
            self.cluster.create(node)
        self.sim = DaemonSetSimulator(
            self.cluster, name="driver", namespace=NS, match_labels=LABELS
        )
        self.sim.settle()
        rollout = make_fleet_rollout(ROLLOUT, self.cfg.pool_names(), self.cfg.budget)
        self.budget = rollout_spec(rollout).resolved_budget()
        self.cluster.create(KubeObject(rollout))
        if self.cfg.checkpoint:
            self.workload = CheckpointingWorkloadSimulator(
                self.cluster, KEYS, pod_labels={"app": "trainer"}
            )

    def _policy(self) -> DriverUpgradePolicySpec:
        kwargs: dict[str, Any] = {}
        if self.cfg.checkpoint:
            kwargs["drain"] = DrainSpec(enable=True, force=True, timeout_seconds=30)
            kwargs["checkpoint"] = CheckpointSpec(
                enable=True,
                pod_selector="app=trainer",
                timeout_seconds=self.cfg.checkpoint_timeout_s,
            )
        return DriverUpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            # The grant is the budget in the fleet's shape.
            max_unavailable=IntOrString("100%"),
            policy=self.cfg.policy,
            **kwargs,
        )

    def _start_worker(self, identity: str):
        from ..fleet.worker import FleetWorkerConfig, ShardWorker

        client = self._client_for(identity)
        watch_hub = self.hub
        if self.relay is not None:
            from ..kube.relay import RelayWatchSource

            # A source per worker: its fallback windows and counters are
            # its own, as in separate processes. The virtual clock keeps
            # the retry-the-relay decision a function of the step.
            watch_hub = RelayWatchSource(self.relay.url, direct=client, mono=self.clock.now)
            self._relay_sources.append(watch_hub)
        worker = ShardWorker(
            client,
            FleetWorkerConfig(
                identity=identity,
                shards=self.cfg.shards,
                namespace=NS,
                driver_labels=LABELS,
                pool_of=pool_of,
                rollout_name=ROLLOUT,
                workers=tuple(self.cfg.identities()),
                lease_duration_s=3.0,
                renew_deadline_s=2.0,
                retry_period_s=0.5,
                watch_hub=watch_hub,
                device=DEVICE,
            ),
            now_fn=self.clock.now,
            wall_fn=self.clock.wall,
        )
        if self.cfg.batch_writes:
            # Batching on the inline runner: batches of one, the stage,
            # flush and rejoin path and the write_batch_partial point
            # under every interleaving.
            worker.mgr.enable_write_batching()
        # Tag the informers, so that a watch hold can target exactly this
        # worker's streams (kube/informer.py chaos_tag).
        for informer in worker.source._informers.values():
            informer.chaos_tag = identity
        worker.start(sync_timeout=30)
        return worker

    def _build_fleet(self) -> None:
        from ..fleet.orchestrator import FleetOrchestrator

        if self.cfg.hub:
            from ..kube.watchhub import WatchHub

            # The hub rides its own client, never partitioned: it stands
            # for the co-hosted fan-out process, whose upstream is another
            # connection than each worker's requests.
            self.hub = WatchHub(self.cluster)
        for identity in self.cfg.identities():
            slot = _WorkerSlot(identity)
            slot.worker = self._start_worker(identity)
            slot.alive = True
            self.slots[identity] = slot
        self.orch = FleetOrchestrator(self._client_for(ORCH_IDENTITY), ROLLOUT)

    # -- the settle barrier --------------------------------------------------------
    def _informer_settled(self, informer) -> bool:
        expected = {
            (obj.namespace, obj.name): str(obj.resource_version)
            for obj in self.cluster.list(
                informer.kind,
                namespace=informer.namespace,
                label_selector=informer.label_selector,
                field_selector=informer.field_selector,
            )
        }
        with informer._lock:
            have = {
                key: str((raw.get("metadata") or {}).get("resourceVersion", ""))
                for key, raw in informer._store.items()
            }
        if have != expected:
            return False
        pending, gone = informer.pending_dispatch()
        return not pending and not gone

    def _settled(self, plan: FaultPlan) -> bool:
        for slot in self.slots.values():
            if not slot.alive:
                continue
            for informer in slot.worker.source._informers.values():
                if plan.held_watch(slot.identity, informer.kind):
                    continue  # lagging by schedule: exempt until the heal
                if not self._informer_settled(informer):
                    return False
        return True

    def settle(self, plan: FaultPlan, timeout: float = 30.0) -> bool:
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if self._settled(plan):
                return True
            _time.sleep(0.002)
        return False

    # -- observations --------------------------------------------------------------
    def _disrupted_pools(self) -> set[str]:
        out = set()
        for raw in self.cluster.list_peek("Node"):
            node = Node(raw)
            if node.unschedulable or not node.is_ready():
                out.add(pool_of(node.name))
        return out

    def _ledger_phases(self) -> dict[str, list[str]]:
        raw = self.cluster.peek(FLEET_ROLLOUT_KIND, ROLLOUT) or {}
        return {
            "granted": sorted(pools_in_phase(raw, POOL_GRANTED)),
            "done": sorted(pools_in_phase(raw, POOL_DONE)),
        }

    def _node_record(self, name: str) -> tuple:
        raw = self.cluster.peek("Node", name) or {}
        node = Node(raw)
        pod_raw = self.cluster.peek("Pod", self.sim.pod_name(name), NS) or {}
        pod_hash = ((pod_raw.get("metadata") or {}).get("labels") or {}).get(
            "controller-revision-hash", ""
        )
        return (
            node.labels.get(KEYS.state_label, ""),
            bool(node.unschedulable),
            node.is_ready(),
            pod_hash,
        )

    def _pool_rolled(self, pool: str) -> bool:
        """The cluster's truth behind the no-grant-retired-unrolled
        invariant: when a pool flips ``done`` every node is upgrade-done,
        schedulable, ready, and runs a pod at the current template hash."""
        for name in (f"{pool}-h{h}" for h in range(self.cfg.hosts)):
            state, unsched, ready, pod_hash = self._node_record(name)
            if state != str(UpgradeState.DONE) or unsched or not ready:
                return False
            if pod_hash != self.sim.current_hash:
                return False
        return True

    def _converged(self, phases: dict) -> bool:
        if len(phases["done"]) != self.cfg.pools:
            return False
        for name in self.cfg.node_names():
            state, unsched, ready, _ = self._node_record(name)
            if state != str(UpgradeState.DONE) or unsched or not ready:
                return False
        return self.sim.all_pods_ready_and_current()

    def final_digest(self) -> str:
        payload = {
            "nodes": {name: self._node_record(name) for name in self.cfg.node_names()},
            "ledger": self._ledger_phases(),
        }
        return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()

    # -- the driver's events -----------------------------------------------------
    def _kill(self, identity: str, restart_at: Optional[int], graceful: bool = False) -> None:
        slot = self.slots[identity]
        if not slot.alive:
            return
        log.info("chaos: %s worker %s (restart_at=%s)",
                 "gracefully stopping" if graceful else "killing", identity, restart_at)
        # A crash releases nothing: the Leases go stale and are resumed by
        # the restarted identity or taken by a survivor. The graceful
        # (sigterm) exit releases them, so survivors take over with no TTL
        # wait; the invariants are the same.
        mgr = slot.worker.mgr
        slot.aborts_retired += mgr.completeness_aborts_total
        slot.escalations_retired += mgr.common.checkpoint_manager.totals()["escalations"]
        slot.worker.stop(release=graceful)
        slot.worker = None
        slot.alive = False
        slot.restart_at = restart_at

    def _try_restart(self, identity: str) -> None:
        slot = self.slots[identity]
        try:
            slot.worker = self._start_worker(identity)
            slot.alive = True
            slot.restart_at = None
            log.info("chaos: restarted worker %s", identity)
        except Exception as e:  # noqa: BLE001 - retried next step
            # A restart into a partition still armed (or any transient) is
            # retried next step: a crashed process crashing again.
            log.warning("chaos: restart of %s failed (%s); retrying", identity, e)
            if slot.worker is not None:
                try:
                    slot.worker.stop(release=False)
                except Exception:  # noqa: BLE001 - teardown best-effort
                    log.exception("chaos: half-started %s teardown failed", identity)
                slot.worker = None

    def _apply_driver_events(self, step: int, plan: FaultPlan) -> None:
        for spec in self.schedule.faults:
            armed = spec.step <= step < spec.step + max(1, spec.duration)
            if spec.point in (POINT_WORKER_KILL, POINT_SIGTERM) and spec.step == step:
                if self.slots[spec.target].alive:
                    plan.record_driver_fire(spec.point)
                restart_at = None if spec.param == "perma" else step + max(1, spec.duration)
                self._kill(spec.target, restart_at, graceful=spec.point == POINT_SIGTERM)
            elif spec.point == POINT_WIRE_KILL and armed:
                if self.server is not None and self.server.kill_connections():
                    plan.record_driver_fire(POINT_WIRE_KILL)
            elif spec.point == POINT_RELAY_KILL and armed:
                if self.relay is not None and self.relay.kill_connections():
                    plan.record_driver_fire(POINT_RELAY_KILL)
            elif spec.point == POINT_REPLICA_FAILOVER:
                idx = int(spec.target or 0)
                if not (0 <= idx < len(self.replicas)):
                    continue
                if spec.step == step:
                    # The replica dies mid-roll: reads in flight fail over
                    # to the primary; the client marks it down and routes
                    # around it.
                    self.replicas[idx].stop()
                    plan.record_driver_fire(POINT_REPLICA_FAILOVER)
                elif step == spec.step + max(1, spec.duration):
                    # Revive on the same port (the clients hold the URL)
                    # and let the down mark's expiry adopt it again.
                    assert self.server is not None
                    port = self.replicas[idx].server_address[1]
                    self.replicas[idx] = self.server.read_replica(port=port).start()
        for slot in self.slots.values():
            if not slot.alive and slot.restart_at is not None and step >= slot.restart_at:
                self._try_restart(slot.identity)

    # -- the run -------------------------------------------------------------------
    def run(self, schedule: FaultSchedule) -> ChaosResult:
        started = _time.perf_counter()
        self.schedule = schedule
        plan = FaultPlan(schedule)
        # What this run installed: a refused second install (another
        # owner's plan or clock registered) must not have the finally
        # below tear down what it never owned.
        plan_installed = clock_installed = False
        violations = {
            "budget": 0,
            "grant_retired_unrolled": 0,
            "node_lost_or_cordoned": 0,
            "incremental_vs_full": 0,
            "checkpoint_spurious_escalations": 0,
            "settle_timeouts": 0,
            "not_converged": 0,
            "completeness_races_unbounded": 0,
            "audit_errors": 0,
        }
        trace: list[dict] = []
        converged = False
        steps = 0
        policy = self._policy()
        try:
            # Installed inside the try: a refused clock install must still
            # roll back the plan this run did install, and only that.
            faultpoints.install_plan(plan)
            plan_installed = True
            faultpoints.install_clock(self.clock)
            clock_installed = True
            self._build_cluster()
            self._build_fleet()
            plan.begin_step(-1)
            if not self.settle(plan):
                violations["settle_timeouts"] += 1
            self.sim.set_template_hash("v2")
            prev_done: set[str] = set()
            last_armed = schedule.last_armed_step()
            for step in range(self.cfg.resolved_max_steps()):
                steps = step + 1
                plan.begin_step(step)
                self._apply_driver_events(step, plan)
                self.sim.step()
                if self.workload is not None:
                    self.workload.step()
                self.orch.tick()
                for identity in self.cfg.identities():
                    slot = self.slots[identity]
                    if not slot.alive:
                        continue
                    # Quiesce the watch deliveries before every tick: the
                    # writes above (and the previous worker's) are
                    # otherwise in flight, and whether one lands during
                    # this build_state would decide a completeness abort
                    # by thread timing.
                    if not self.settle(plan):
                        violations["settle_timeouts"] += 1
                    slot.ticks += 1
                    try:
                        slot.worker.tick(policy)
                    except (ApiError, BuildStateError):
                        # The tick's contract: a pass aborts, the next one
                        # resumes from the labels. Counted, for the
                        # bounded-race invariant below.
                        slot.aborts += 1
                self.sim.step()
                if not self.settle(plan):
                    violations["settle_timeouts"] += 1
                disrupted = self._disrupted_pools()
                if len(disrupted) > self.budget:
                    violations["budget"] += 1
                phases = self._ledger_phases()
                newly_done = set(phases["done"]) - prev_done
                for pool in newly_done:
                    if self.cfg.hosts and not self._pool_rolled(pool):
                        violations["grant_retired_unrolled"] += 1
                prev_done = set(phases["done"])
                trace.append({
                    "step": step,
                    "disrupted": sorted(disrupted),
                    "granted": phases["granted"],
                    "done": phases["done"],
                    "alive": sorted(s.identity for s in self.slots.values() if s.alive),
                    "fired": plan.sync_fire_counts(),
                })
                self.clock.advance(self.cfg.step_dt)
                if step >= last_armed and self._converged(phases):
                    converged = True
                    break
            if not converged:
                violations["not_converged"] += 1
            # The invariants after every heal: the world reads consistent.
            if converged:
                if not self.settle(plan):
                    violations["settle_timeouts"] += 1
                for slot in self.slots.values():
                    if not slot.alive:
                        continue
                    try:
                        violations["incremental_vs_full"] += (
                            slot.worker.mgr.audit_incremental(NS, LABELS)
                        )
                    except BuildStateError:
                        # The audit's own completeness walk raced a
                        # delivery (only after a settle timeout): a named
                        # violation, and the seed stays reportable.
                        violations["audit_errors"] += 1
                    if slot.worker.mgr.completeness_aborts_total >= max(1, slot.ticks):
                        # Every pass aborting is the wedge the counter is
                        # there to catch; aborts must stay a minority.
                        violations["completeness_races_unbounded"] += 1
                for name in self.cfg.node_names():
                    state, unsched, ready, _ = self._node_record(name)
                    if state != str(UpgradeState.DONE) or unsched or not ready:
                        violations["node_lost_or_cordoned"] += 1
                if self.cfg.checkpoint:
                    for slot in self.slots.values():
                        # Dead incarnations count too (_kill kept their
                        # totals): a spurious escalation does not vanish
                        # with the process that made it.
                        violations["checkpoint_spurious_escalations"] += (
                            slot.escalations_retired
                        )
                        if not slot.alive:
                            continue
                        totals = slot.worker.mgr.common.checkpoint_manager.totals()
                        violations["checkpoint_spurious_escalations"] += totals["escalations"]
            completeness_aborts = sum(
                s.aborts_retired + (s.worker.mgr.completeness_aborts_total if s.alive else 0)
                for s in self.slots.values()
            )
            return ChaosResult(
                seed=schedule.seed,
                converged=converged,
                steps=steps,
                violations=violations,
                trace=trace,
                fired=plan.sync_fire_counts(),
                async_engaged=plan.async_points_engaged(),
                completeness_aborts=completeness_aborts,
                final_digest=self.final_digest(),
                schedule_json=schedule.to_json(),
                wall_s=_time.perf_counter() - started,
            )
        finally:
            if plan_installed:
                faultpoints.clear_plan()
            if clock_installed:
                faultpoints.clear_clock()
            self._teardown()

    def _teardown(self) -> None:
        for slot in self.slots.values():
            if slot.worker is not None:
                try:
                    slot.worker.stop(release=False)
                except Exception:  # noqa: BLE001 - teardown best-effort
                    log.exception("chaos: worker %s teardown failed", slot.identity)
        for source in self._relay_sources:
            try:
                source.close()
            except Exception:  # noqa: BLE001 - teardown best-effort
                log.exception("chaos: relay source teardown failed")
        if self.relay is not None:
            self.relay.stop()
        if self.hub is not None:
            self.hub.stop()
        for replica in self.replicas:
            replica.stop()
        if self.server is not None:
            self.server.stop()


# ---------------------------------------------------------------------------
# Entry points (tools/chaos_run.py and the tests)
# ---------------------------------------------------------------------------


def run_schedule(schedule: FaultSchedule) -> ChaosResult:
    """Run one schedule on a fresh fleet (a schedule JSON is a complete
    recipe: the config rides inside it)."""
    return ChaosFleetHarness(schedule.config).run(schedule)


def run_seed(seed: int, config: Optional[ChaosConfig] = None) -> ChaosResult:
    return run_schedule(generate_schedule(seed, config or ChaosConfig()))


def run_corpus(
    seeds: range,
    config: Optional[ChaosConfig] = None,
    on_result: Optional[Callable[[ChaosResult], None]] = None,
) -> dict:
    """One schedule a seed; returns the corpus's summary (schedules
    explored, violations by kind, seeds that failed)."""
    cfg = config or ChaosConfig()
    results: list[ChaosResult] = []
    fired_points: set[str] = set()
    for seed in seeds:
        result = run_seed(seed, cfg)
        results.append(result)
        fired_points.update(p for p, n in result.fired.items() if n)
        fired_points.update(p for p, ok in result.async_engaged.items() if ok)
        if on_result is not None:
            on_result(result)
    return {
        "schedules_explored": len(results),
        "invariant_violations": sum(r.total_violations for r in results),
        "not_converged": sum(0 if r.converged else 1 for r in results),
        "fault_points_fired": sorted(fired_points),
        "completeness_aborts": sum(r.completeness_aborts for r in results),
        "failing_seeds": [r.seed for r in results if r.total_violations or not r.converged],
        "wall_s": round(sum(r.wall_s for r in results), 3),
        "violations_by_kind": {
            k: sum(r.violations.get(k, 0) for r in results)
            for k in (results[0].violations if results else {})
        },
    }


def run_policy_matrix(
    seeds: range,
    config: Optional[ChaosConfig] = None,
    compositions: Optional[Sequence[tuple]] = None,
    on_result: Optional[Callable[[ChaosResult], None]] = None,
) -> dict:
    """Sweep the shipped policy compositions (``policy``
    ``standard_compositions``) over one seed corpus: every (composition,
    seed) cell replays the same schedule with the pools' upgrade policy
    composed. ``budget_violations`` must stay 0: no registered
    composition may widen a disruption past the grant budget under any
    explored interleaving."""
    from ..policy import standard_compositions, validate_composition

    cfg = config or ChaosConfig()
    comps = tuple(
        tuple(c) for c in (compositions if compositions is not None else standard_compositions())
    )
    for comp in comps:
        validate_composition(comp or ("default",))
    cells: dict[str, dict] = {}
    for comp in comps:
        cells["+".join(comp) or "default"] = run_corpus(
            seeds, replace(cfg, policy=comp), on_result=on_result
        )
    summaries = list(cells.values())
    return {
        "compositions": len(comps),
        "schedules_explored": sum(c["schedules_explored"] for c in summaries),
        "invariant_violations": sum(c["invariant_violations"] for c in summaries),
        "budget_violations": sum(c["violations_by_kind"].get("budget", 0) for c in summaries),
        "not_converged": sum(c["not_converged"] for c in summaries),
        "wall_s": round(sum(c["wall_s"] for c in summaries), 3),
        "cells": cells,
    }
