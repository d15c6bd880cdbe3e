"""The default policy: the budget clamp, the degraded-first order and an
admit that always allows.

* :meth:`DefaultPolicy.budget` is the upgrade-start clamp: the parallel
  slots, then the unavailability cap counting units already unavailable
  and those about to be disrupted;
* :meth:`DefaultPolicy.order`: already disrupted first, then ascending
  health score, a degrading trend breaking ties, then the name;
* :meth:`DefaultPolicy.admit` allows every candidate.
"""

from __future__ import annotations

from typing import Sequence

from .api import ALLOW, Budget, BudgetView, CandidateView, Decision
from .registry import register_policy

#: The name an empty policy spec resolves to.
DEFAULT_POLICY_NAME = "default"


@register_policy("default")
class DefaultPolicy:
    """The behavior every shipped policy starts from."""

    def admit(self, candidate: CandidateView, view: BudgetView) -> Decision:
        return ALLOW

    def order(self, candidates: Sequence[CandidateView]) -> list[CandidateView]:
        return sorted(
            candidates,
            key=lambda c: (not c.disrupted, c.score, c.trend, c.name),
        )

    def budget(self, view: BudgetView) -> Budget:
        if view.max_parallel == 0:
            available = view.candidates
        else:
            available = view.max_parallel - view.in_progress
        if available > view.max_unavailable:
            available = view.max_unavailable
        if view.unavailable >= view.max_unavailable:
            available = 0
        elif (
            view.max_unavailable < view.total
            and view.unavailable + available > view.max_unavailable
        ):
            available = view.max_unavailable - view.unavailable
        return Budget(available=available, max_unavailable=view.max_unavailable)
