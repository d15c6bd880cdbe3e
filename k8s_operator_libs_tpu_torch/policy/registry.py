"""The policy registry, the composition of policies and its validator.

Registration is explicit, by literal name. A composition of listed names:

* **admit** — every member must allow; the first deny is the answer;
* **order** — the last-listed member sorts first and each earlier one
  sorts its result again, so the first-listed is the most significant key;
* **budget** — the smallest of the members' budgets.

A name the registry does not know, a repeated name and a declared
conflict raise :class:`PolicyCompositionError`: an unknown policy never
quietly becomes the default.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

from .api import Budget, BudgetView, CandidateView, Decision, UpgradePolicy

_REGISTRY: dict[str, type] = {}
#: names -> the composed instance (policies keep no state, so one serves).
_COMPOSED: dict[tuple[str, ...], UpgradePolicy] = {}

#: Pairs that must not run together: fleet grant gating and delegation to
#: a maintenance operator would both claim cordon authority over a node.
CONFLICTS: frozenset[frozenset[str]] = frozenset(
    {frozenset({"fleet-grant-gate", "requestor-delegation"})}
)


class PolicyCompositionError(ValueError):
    """A composition that must not run; ``policies`` names the offenders."""

    def __init__(self, message: str, policies: Iterable[str] = ()) -> None:
        super().__init__(message)
        self.policies = tuple(policies)


def register_policy(name: str) -> Callable[[type], type]:
    """Class decorator registering ``cls`` under ``name``."""

    def deco(cls: type) -> type:
        existing = _REGISTRY.get(name)
        if existing is not None and existing is not cls:
            raise ValueError(
                f"policy name {name!r} already registered by {existing.__name__}"
            )
        cls.name = name  # type: ignore[attr-defined]
        _REGISTRY[name] = cls
        _COMPOSED.clear()
        return cls

    return deco


def registered_policies() -> dict[str, type]:
    """The registry: name -> class."""
    return dict(_REGISTRY)


def validate_composition(names: Sequence[str]) -> tuple[str, ...]:
    """Refuse unknown names, repeats and declared conflicts."""
    names = tuple(names)
    unknown = [n for n in names if n not in _REGISTRY]
    if unknown:
        raise PolicyCompositionError(
            f"unknown policy name(s) {unknown!r}; registered: {sorted(_REGISTRY)}",
            policies=unknown,
        )
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise PolicyCompositionError(
            f"policy composition repeats {dupes!r}", policies=dupes
        )
    for pair in CONFLICTS:
        if pair <= set(names):
            clash = tuple(sorted(pair))
            raise PolicyCompositionError(
                f"policies {clash[0]!r} and {clash[1]!r} do not compose: "
                "fleet grant gating and requestor/maintenance-operator "
                "delegation would both claim cordon authority over one node",
                policies=clash,
            )
    return names


class _ComposedPolicy:
    """Members combined as the module docstring says."""

    def __init__(self, members: Sequence[UpgradePolicy]) -> None:
        self.members = tuple(members)
        self.name = "+".join(m.name for m in self.members)

    def admit(self, candidate: CandidateView, view: BudgetView) -> Decision:
        for member in self.members:
            decision = member.admit(candidate, view)
            if not decision.allowed:
                return decision
        return Decision(True)

    def order(self, candidates: Sequence[CandidateView]) -> list[CandidateView]:
        ordered = list(candidates)
        for member in reversed(self.members):
            ordered = member.order(ordered)
        return ordered

    def budget(self, view: BudgetView) -> Budget:
        budgets = [m.budget(view) for m in self.members]
        return Budget(
            available=min(b.available for b in budgets),
            max_unavailable=min(b.max_unavailable for b in budgets),
        )


def compose(names: Sequence[str]) -> UpgradePolicy:
    """The validated composition of ``names``; none means the default."""
    names = tuple(names) or ("default",)
    validate_composition(names)
    if len(names) == 1:
        return _REGISTRY[names[0]]()
    return _ComposedPolicy([_REGISTRY[n]() for n in names])


def for_spec(names: Sequence[str]) -> UpgradePolicy:
    """:func:`compose`, memoized by names."""
    key = tuple(names)
    cached = _COMPOSED.get(key)
    if cached is None:
        cached = _COMPOSED[key] = compose(key)
    return cached


def standard_compositions() -> tuple[tuple[str, ...], ...]:
    """The shipped compositions: each plugin alone, and two pairs."""
    return (
        ("default",),
        ("maintenance-window",),
        ("cost-tiers",),
        ("default", "maintenance-window"),
        ("cost-tiers", "maintenance-window"),
    )
