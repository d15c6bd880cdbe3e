"""The API types the port reads and writes: the driver upgrade policy, the
NodeHealthReport telemetry contract and the FleetRollout grant ledger."""

from .fleet_v1alpha1 import (
    DEFAULT_MAX_UNAVAILABLE_POOLS,
    FLEET_ROLLOUT_API_VERSION,
    FLEET_ROLLOUT_KIND,
    FLEET_ROLLOUT_PLURAL,
    POOL_DONE,
    POOL_GRANTED,
    POOL_PENDING,
    POOL_PHASES,
    FleetRolloutSpec,
    make_fleet_rollout,
    pool_phase,
    pools_in_phase,
    rollout_spec,
    set_pool_phase,
    spec_pool_names,
)

__all__ = [
    "DEFAULT_MAX_UNAVAILABLE_POOLS",
    "FLEET_ROLLOUT_API_VERSION",
    "FLEET_ROLLOUT_KIND",
    "FLEET_ROLLOUT_PLURAL",
    "POOL_DONE",
    "POOL_GRANTED",
    "POOL_PENDING",
    "POOL_PHASES",
    "FleetRolloutSpec",
    "make_fleet_rollout",
    "pool_phase",
    "pools_in_phase",
    "rollout_spec",
    "set_pool_phase",
    "spec_pool_names",
]
