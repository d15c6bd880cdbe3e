"""The policy contract: pure functions of frozen views.

Every method of a policy is a deterministic function of its arguments: it
reads no cluster, no clock and no random source, and keeps no state
between calls. The calling tier freezes what the policy may see into a
view; the one nondeterministic input a policy may need, wall time, comes
in on the view (``BudgetView.now``). The same three methods serve every
grain: a "candidate" is a node, a slice or a pool.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, Sequence, runtime_checkable


@dataclass(frozen=True)
class Decision:
    """An admit verdict; ``reason`` says why on a deny."""

    allowed: bool
    reason: str = ""


#: The unconditional admit.
ALLOW = Decision(True)


@dataclass(frozen=True)
class Budget:
    """How many fresh disruptions this pass may start, and the resolved
    unavailability cap that produced it (a percent scales with the pool,
    so the log must carry the cap)."""

    available: int
    max_unavailable: int


@dataclass(frozen=True)
class BudgetView:
    """The budget's inputs, in the calling tier's units (nodes, slices or
    pools). ``now`` is wall-clock seconds stamped by the caller."""

    total: int
    in_progress: int
    unavailable: int
    candidates: int
    max_parallel: int
    max_unavailable: int
    now: float = 0.0


@dataclass(frozen=True)
class CandidateView:
    """One unit to order or admit, reduced to its health facts. ``tier``
    is its rollout class, parsed from its name by :func:`tier_of` when the
    view is built."""

    name: str
    score: float = 100.0
    trend: int = 0
    disrupted: bool = False
    tier: int = 0


#: The class of a candidate whose name carries no ``tier<k>-`` prefix:
#: after every explicit class.
DEFAULT_TIER = 1_000_000


def tier_of(name: str) -> int:
    """The rollout class of a candidate named ``tier<k>-...``; otherwise
    :data:`DEFAULT_TIER`."""
    if name.startswith("tier"):
        digits = ""
        for ch in name[4:]:
            if ch.isdigit():
                digits += ch
            else:
                break
        if digits and len(name) > 4 + len(digits) and name[4 + len(digits)] == "-":
            return int(digits)
    return DEFAULT_TIER


@runtime_checkable
class UpgradePolicy(Protocol):
    """A policy: three pure methods."""

    #: Registry name (set by ``@register_policy``).
    name: str

    def admit(self, candidate: CandidateView, view: BudgetView) -> Decision:
        """May this candidate start a disruption under this budget?"""
        ...

    def order(self, candidates: Sequence[CandidateView]) -> list[CandidateView]:
        """Roll order, most urgent first: a stable reordering."""
        ...

    def budget(self, view: BudgetView) -> Budget:
        """How many fresh disruptions this pass may start."""
        ...
