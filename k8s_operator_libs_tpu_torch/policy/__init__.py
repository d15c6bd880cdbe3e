"""Upgrade policies: pure functions over frozen views that decide the
disruption budget, which candidates may start and in what order.

The JAX package's ``policy`` package, for the port's slice planner: the
views and protocol (:mod:`.api`), the registry and composition
(:mod:`.registry`), the default policy (:mod:`.defaults`) and the shipped
plugins (:mod:`.plugins`). Importing the package registers every shipped
policy; callers resolve a spec's names with :func:`for_spec`.
"""

from .api import (
    ALLOW,
    DEFAULT_TIER,
    Budget,
    BudgetView,
    CandidateView,
    Decision,
    UpgradePolicy,
    tier_of,
)
from .defaults import DEFAULT_POLICY_NAME, DefaultPolicy
from .plugins import (
    CostTierPolicy,
    FleetGrantGatePolicy,
    MaintenanceWindowPolicy,
    RequestorDelegationPolicy,
)
from .registry import (
    CONFLICTS,
    PolicyCompositionError,
    compose,
    for_spec,
    register_policy,
    registered_policies,
    standard_compositions,
    validate_composition,
)

__all__ = [
    "ALLOW",
    "DEFAULT_TIER",
    "Budget",
    "BudgetView",
    "CandidateView",
    "Decision",
    "UpgradePolicy",
    "tier_of",
    "DEFAULT_POLICY_NAME",
    "DefaultPolicy",
    "CostTierPolicy",
    "FleetGrantGatePolicy",
    "MaintenanceWindowPolicy",
    "RequestorDelegationPolicy",
    "CONFLICTS",
    "PolicyCompositionError",
    "compose",
    "for_spec",
    "register_policy",
    "registered_policies",
    "standard_compositions",
    "validate_composition",
]
