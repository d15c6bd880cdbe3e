"""The fleet tier: a sharded control plane over many pools.

The JAX package's ``fleet`` package. Everything below it reconciles one
pool from one process; this package composes those units: consistent-hash
partitioning of pool keys (:mod:`.hashring`), a Lease a shard with
failover and shard-scoped snapshots (:mod:`.worker`, :mod:`.scope`), and
one global disruption budget kept in the FleetRollout grant ledger
(:mod:`.orchestrator`; the contract in ``api/fleet_v1alpha1.py``), so N
workers roll many pools, degraded first, with no worker holding the
fleet's state in memory.
"""

from .hashring import HashRing, stable_hash
from .metrics import FleetMetrics
from .orchestrator import FleetHealthAggregator, FleetOrchestrator
from .scope import ShardScopedSnapshotSource
from .wakeup import WatchWake
from .worker import (
    FleetWorkerConfig,
    GrantGatedInplaceManager,
    ShardWorker,
    TickStats,
    shard_id,
)

__all__ = [
    "FleetHealthAggregator",
    "FleetMetrics",
    "FleetOrchestrator",
    "FleetWorkerConfig",
    "GrantGatedInplaceManager",
    "HashRing",
    "ShardScopedSnapshotSource",
    "ShardWorker",
    "TickStats",
    "WatchWake",
    "shard_id",
    "stable_hash",
]
