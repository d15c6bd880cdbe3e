"""The port's upgrade policies against the JAX package's: for every
standard composition and seeded budget and candidate views, ``budget``,
``admit`` and ``order`` give the JAX answers. A name the registry does not
know raises; it never becomes the default policy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from k8s_operator_libs_tpu import policy as jax_policy
from k8s_operator_libs_tpu_torch import policy as port


def _views(rng, module):
    budgets = []
    for _ in range(12):
        total = int(rng.integers(1, 12))
        budgets.append(module.BudgetView(
            total=total,
            in_progress=int(rng.integers(0, total + 1)),
            unavailable=int(rng.integers(0, total + 1)),
            candidates=int(rng.integers(0, total + 1)),
            max_parallel=int(rng.integers(0, 4)),
            max_unavailable=int(rng.integers(0, total + 2)),
            now=float(rng.uniform(0, 3 * 86400)),
        ))
    names = [f"tier{int(rng.integers(0, 3))}-pool-{i}" if rng.random() < 0.5 else f"pool-{i}"
             for i in range(8)]
    candidates = [
        module.CandidateView(
            name=name,
            score=float(rng.choice([100.0, 40.0, 0.0, rng.uniform(0, 100)])),
            trend=int(rng.integers(-1, 2)),
            disrupted=bool(rng.random() < 0.3),
            tier=module.tier_of(name),
        )
        for name in names
    ]
    return budgets, candidates


@pytest.mark.parametrize("names", port.standard_compositions(), ids="+".join)
@pytest.mark.parametrize("seed", range(3))
def test_composition_decides_as_jax_does(names, seed):
    assert port.standard_compositions() == jax_policy.standard_compositions()
    ours, theirs = port.for_spec(names), jax_policy.for_spec(names)
    assert ours.name == theirs.name
    our_budgets, our_cands = _views(np.random.default_rng(seed), port)
    their_budgets, their_cands = _views(np.random.default_rng(seed), jax_policy)
    for mine, ref in zip(our_budgets, their_budgets):
        assert dataclasses.asdict(ours.budget(mine)) == dataclasses.asdict(theirs.budget(ref))
        for cand, ref_cand in zip(our_cands, their_cands):
            assert dataclasses.asdict(ours.admit(cand, mine)) == dataclasses.asdict(
                theirs.admit(ref_cand, ref)
            )
    assert [c.name for c in ours.order(our_cands)] == [c.name for c in theirs.order(their_cands)]


def test_closed_window_refuses_as_jax_does():
    window = ((22.0, 6.0),)
    ours = port.MaintenanceWindowPolicy(window)
    theirs = jax_policy.MaintenanceWindowPolicy(window)
    for hour in range(24):
        now = 86400.0 * 3 + hour * 3600.0
        view = dict(total=4, in_progress=0, unavailable=0, candidates=2,
                    max_parallel=1, max_unavailable=1, now=now)
        assert dataclasses.asdict(ours.budget(port.BudgetView(**view))) == dataclasses.asdict(
            theirs.budget(jax_policy.BudgetView(**view))
        )
        assert dataclasses.asdict(
            ours.admit(port.CandidateView("p"), port.BudgetView(**view))
        ) == dataclasses.asdict(
            theirs.admit(jax_policy.CandidateView("p"), jax_policy.BudgetView(**view))
        )


@pytest.mark.parametrize(
    "names",
    [("no-such-policy",), ("default", "default"), ("fleet-grant-gate", "requestor-delegation")],
    ids=["unknown", "repeated", "conflict"],
)
def test_bad_compositions_raise_as_jax_does(names):
    with pytest.raises(port.PolicyCompositionError) as ours:
        port.for_spec(names)
    with pytest.raises(jax_policy.PolicyCompositionError) as theirs:
        jax_policy.for_spec(names)
    assert ours.value.policies == theirs.value.policies


def test_registry_and_tiers_equal_jax():
    assert sorted(port.registered_policies()) == sorted(jax_policy.registered_policies())
    assert port.for_spec(()).name == "default"
    for name in ("tier0-a", "tier12-b", "tier-c", "tier3", "tierx-1", "pool"):
        assert port.tier_of(name) == jax_policy.tier_of(name)
