"""The FleetRollout contract (v1alpha1): the fleet tier's grant ledger.

The JAX package's ``api/fleet_v1alpha1.py``. The fleet tier
(``fleet/``) rolls many node pools from N cooperating shard workers under
one *global* disruption budget, and the state they share is a Kubernetes
object, never a worker's memory:

* the **spec** names the pools to roll and the global budget
  (``maxUnavailablePools``, int or percent of the pool count: the pool
  grain's ``DriverUpgradePolicySpec.maxUnavailable``);
* the **status** is the grant ledger: each pool's phase (``pending`` ->
  ``granted`` -> ``done``), written by the fleet orchestrator (grants,
  degraded first) and by the shard workers (completions), both at the
  read's resourceVersion. A worker that dies mid-roll loses nothing: its
  successor reads the same grants, and the node labels carry each node's
  progress.

The names and shapes live here, free of any client; the resource
registry (``kube/resources.py``) registers the kind. The object is cluster-scoped: a
rollout spans pools.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

from ..utils.intstr import IntOrString

FLEET_ROLLOUT_KIND = "FleetRollout"
FLEET_ROLLOUT_API_VERSION = "fleet.tpu-operator.dev/v1alpha1"
FLEET_ROLLOUT_PLURAL = "fleetrollouts"

#: The pool phases of the ledger. ``pending`` is the phase of a pool with
#: no status entry: a fresh object is all pending.
POOL_PENDING = "pending"
POOL_GRANTED = "granted"
POOL_DONE = "done"

POOL_PHASES = (POOL_PENDING, POOL_GRANTED, POOL_DONE)

#: The default global budget: a quarter of the rollout's pools at once.
DEFAULT_MAX_UNAVAILABLE_POOLS = "25%"


@dataclass
class FleetRolloutSpec:
    """The parsed and validated spec. ``pools`` is the explicit roll set:
    the orchestrator never discovers pools itself, so a node that grows a
    label cannot widen a rollout.

    A spec pool is a plain name (the canonical serialization) or a mapping
    ``{"name": ..., "policy": [...]}`` that selects the pool's own
    policy-plugin composition by registry name. ``pools`` keeps the plain
    names; the selections are in ``pool_policies``.
    """

    pools: list[str] = field(default_factory=list)
    #: None: no limit (every pool may be in flight at once, the explicit
    #: opt-out, as ``maxUnavailable: null`` on the policy).
    max_unavailable_pools: Optional[IntOrString] = field(
        default_factory=lambda: IntOrString(DEFAULT_MAX_UNAVAILABLE_POOLS)
    )
    #: pool -> policy composition (registry names, most significant first).
    #: A pool absent here runs the rollout's policy.
    pool_policies: dict[str, tuple[str, ...]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.pools:
            raise ValueError("FleetRollout spec.pools must be non-empty")
        if any(not p or not isinstance(p, str) for p in self.pools):
            raise ValueError("FleetRollout spec.pools entries must be non-empty strings")
        if len(set(self.pools)) != len(self.pools):
            raise ValueError("FleetRollout spec.pools must not repeat a pool")
        self.pool_policies = {
            pool: tuple(names) for pool, names in self.pool_policies.items() if names
        }
        unknown = sorted(set(self.pool_policies) - set(self.pools))
        if unknown:
            raise ValueError(
                "FleetRollout spec names a policy for pool(s) outside "
                f"the roll set: {unknown!r}"
            )

    def policy_for(self, pool: str) -> tuple[str, ...]:
        """The pool's policy composition; empty: the rollout's."""
        return self.pool_policies.get(pool, ())

    def resolved_budget(self) -> int:
        """The global budget in pools: a percent scaled against the roll
        set and rounded up, clamped to [1, len(pools)]. The floor of 1 is
        deliberate: a ledger that can only deny is a deadlock."""
        total = len(self.pools)
        if self.max_unavailable_pools is None:
            return total
        scaled = self.max_unavailable_pools.scaled_value(total, round_up=True)
        return max(1, min(scaled, total))

    def to_dict(self) -> dict[str, Any]:
        # A pool with a policy is the mapping entry; the others stay plain
        # names, so a spec without policies round-trips to the plain shape.
        out: dict[str, Any] = {
            "pools": [
                {"name": p, "policy": list(self.pool_policies[p])}
                if p in self.pool_policies
                else p
                for p in self.pools
            ]
        }
        out["maxUnavailablePools"] = (
            self.max_unavailable_pools.value if self.max_unavailable_pools is not None else None
        )
        return out

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "FleetRolloutSpec":
        # As DriverUpgradePolicySpec.from_dict: an explicit null is "no
        # limit" and survives a round trip; a missing key is the default.
        if "maxUnavailablePools" in d:
            raw = d["maxUnavailablePools"]
            max_unavailable = IntOrString.parse(raw) if raw is not None else None
        else:
            max_unavailable = IntOrString(DEFAULT_MAX_UNAVAILABLE_POOLS)
        pools: list[str] = []
        pool_policies: dict[str, tuple[str, ...]] = {}
        for entry in d.get("pools") or []:
            if isinstance(entry, Mapping):
                name = entry.get("name")
                pools.append(name if isinstance(name, str) else "")
                names = tuple(entry.get("policy") or ())
                if names and isinstance(name, str):
                    pool_policies[name] = names
            else:
                pools.append(entry)
        return FleetRolloutSpec(
            pools=pools, max_unavailable_pools=max_unavailable, pool_policies=pool_policies
        )


def make_fleet_rollout(
    name: str,
    pools: list[str],
    max_unavailable_pools: Any = DEFAULT_MAX_UNAVAILABLE_POOLS,
    pool_policies: Optional[Mapping[str, Any]] = None,
) -> dict[str, Any]:
    """A FleetRollout object, its spec validated through the dataclass."""
    spec = FleetRolloutSpec(
        pools=list(pools),
        max_unavailable_pools=(
            IntOrString.parse(max_unavailable_pools) if max_unavailable_pools is not None
            else None
        ),
        pool_policies={pool: tuple(names) for pool, names in (pool_policies or {}).items()},
    )
    return {
        "apiVersion": FLEET_ROLLOUT_API_VERSION,
        "kind": FLEET_ROLLOUT_KIND,
        "metadata": {"name": name},
        "spec": spec.to_dict(),
        "status": {"pools": {}, "grantsIssued": 0},
    }


def rollout_spec(raw: Mapping[str, Any]) -> FleetRolloutSpec:
    return FleetRolloutSpec.from_dict(raw.get("spec") or {})


def _status_pools(raw: Mapping[str, Any]) -> Mapping[str, Any]:
    status = raw.get("status") or {}
    pools = status.get("pools")
    return pools if isinstance(pools, Mapping) else {}


def pool_phase(raw: Mapping[str, Any], pool: str) -> str:
    """A pool's ledger phase. No entry, or a mangled one, reads
    ``pending``: an unknown pool is never granted, so a hand-edited object
    can only withhold disruption."""
    entry = _status_pools(raw).get(pool)
    phase = entry.get("phase") if isinstance(entry, Mapping) else None
    return phase if phase in POOL_PHASES else POOL_PENDING


def spec_pool_names(raw: Mapping[str, Any]) -> list[str]:
    """The spec's pool names in spec order, from either entry shape."""
    out = []
    for entry in (raw.get("spec") or {}).get("pools") or []:
        if isinstance(entry, Mapping):
            name = entry.get("name")
            if isinstance(name, str):
                out.append(name)
        else:
            out.append(entry)
    return out


def pools_in_phase(raw: Mapping[str, Any], phase: str) -> list[str]:
    """The spec's pools in ``phase``, in spec order. Keyed by the spec,
    not the status map, so a stale entry of a pool no longer in the roll
    set never counts against the budget."""
    return [p for p in spec_pool_names(raw) if pool_phase(raw, p) == phase]


def set_pool_phase(raw: dict[str, Any], pool: str, phase: str, **extra: Any) -> bool:
    """Move one pool's ledger entry to ``phase``, merging ``extra``
    (``grantedSeq``, ``completedBy``); False, the object untouched, where
    the pool is there already, so a caller skips the write."""
    if phase not in POOL_PHASES:
        raise ValueError(f"unknown pool phase {phase!r}")
    status = raw.setdefault("status", {})
    pools = status.setdefault("pools", {})
    entry = pools.setdefault(pool, {})
    if entry.get("phase") == phase:
        return False
    entry["phase"] = phase
    entry.update(extra)
    return True
