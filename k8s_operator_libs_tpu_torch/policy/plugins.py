"""The shipped policies beside the default. Each inherits
:class:`DefaultPolicy`, so it can tighten the budget or reorder the
candidates, never widen a disruption window.
"""

from __future__ import annotations

from typing import Sequence

from .api import ALLOW, Budget, BudgetView, CandidateView, Decision
from .defaults import DefaultPolicy
from .registry import register_policy


@register_policy("maintenance-window")
class MaintenanceWindowPolicy(DefaultPolicy):
    """Roll only inside wall-clock windows: ``(start_hour, end_hour)``
    pairs in UTC hours of the day, half-open, wrapping midnight when
    ``start > end``. The default window is the whole day. The clock is the
    view's ``now``, never read here."""

    def __init__(
        self, windows: Sequence[tuple[float, float]] = ((0.0, 24.0),)
    ) -> None:
        self.windows = tuple((float(a), float(b)) for a, b in windows)

    def _open_at(self, now: float) -> bool:
        hour = (now % 86400.0) / 3600.0
        for start, end in self.windows:
            if start <= end:
                if start <= hour < end:
                    return True
            elif hour >= start or hour < end:
                return True
        return False

    def admit(self, candidate: CandidateView, view: BudgetView) -> Decision:
        if self._open_at(view.now):
            return ALLOW
        return Decision(
            False,
            f"outside maintenance windows {self.windows!r} "
            f"(now={view.now:.0f})",
        )

    def budget(self, view: BudgetView) -> Budget:
        base = super().budget(view)
        if self._open_at(view.now):
            return base
        return Budget(available=0, max_unavailable=base.max_unavailable)


@register_policy("cost-tiers")
class CostTierPolicy(DefaultPolicy):
    """Rollout classes sharing one budget: lower ``tier`` rolls first, the
    default order within a class (the outer sort is stable)."""

    def order(self, candidates: Sequence[CandidateView]) -> list[CandidateView]:
        return sorted(super().order(candidates), key=lambda c: c.tier)


@register_policy("fleet-grant-gate")
class FleetGrantGatePolicy(DefaultPolicy):
    """Marker: the pool's rolls wait for fleet grants. It behaves as the
    default; its name lets the validator refuse compositions that cannot
    hold (``registry.CONFLICTS``)."""


@register_policy("requestor-delegation")
class RequestorDelegationPolicy(DefaultPolicy):
    """Marker: an external maintenance operator holds cordon authority.
    Conflicts with ``fleet-grant-gate``."""
