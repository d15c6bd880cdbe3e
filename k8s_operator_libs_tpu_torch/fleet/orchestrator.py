"""The fleet orchestrator: pool roll grants under one global budget.

The JAX package's ``fleet/orchestrator.py``. The slice planner
(``tpu/planner.py``) orders slices degraded first within a pool; this
module does so one tier up: many pools, one *global* disruption budget,
the most degraded pool first. The FleetRollout object
(``api/fleet_v1alpha1.py``) coordinates: the orchestrator writes grants
into its status ledger, the shard workers (``fleet/worker.py``) act on
grants and report completions, and no participant keeps state between
ticks: kill any of them mid-roll and its successor resumes from the object
and the node labels.

A grant is permission to disrupt one pool. It is charged against
``maxUnavailablePools`` from its issue until the worker reports the pool
``done`` (every node upgrade-done and schedulable again), so a worker that
dies mid-roll leaves it charged: the budget holds across the failover,
because the ledger carries it, not the worker.

:class:`FleetHealthAggregator` folds the shards' ``HealthSource`` maps
into each pool's worst member (a straggler host throttles its pool's
collectives, so a pool is as healthy as its sickest member), and the
orchestrator grants in that order.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, Optional, Sequence

from ..api.fleet_v1alpha1 import (
    FLEET_ROLLOUT_KIND,
    POOL_DONE,
    POOL_GRANTED,
    POOL_PENDING,
    pools_in_phase,
    rollout_spec,
    set_pool_phase,
)
from ..api.telemetry_v1alpha1 import NodeHealth, effective_scores, sicker_link, trend_value
from ..kube.client import (
    Client,
    ConflictError,
    get_or_none,
    has_reason,
    is_api_error,
    retry_on_conflict,
)
from ..policy import BudgetView, CandidateView, for_spec, tier_of
from ..utils import tracing
from ..utils.faultpoints import fault_point, wall_now
from ..utils.log import get_logger

log = get_logger("fleet.orchestrator")


class FleetHealthAggregator:
    """Fold N (shard-scoped) HealthSource maps into each pool's score.

    A source (:meth:`add_source`) offers ``snapshot()``, the map node ->
    NodeHealth its informer keeps, so a fold over a settled fleet is N dict
    walks: no read, no parse. ``pool_of`` maps a node's name to its pool,
    the same pure mapping the shard workers partition by, so the fold and
    the partition never disagree on a node's pool.
    """

    def __init__(self, pool_of: Callable[[str], str]) -> None:
        self._pool_of = pool_of
        self._lock = threading.Lock()
        self._sources: list[Any] = []

    def add_source(self, source: Any) -> None:
        """Register an object with ``snapshot()``, as a HealthSource."""
        with self._lock:
            if source not in self._sources:
                self._sources.append(source)

    def pool_health(self) -> dict[str, tuple[float, int]]:
        """pool -> (its worst member's score, its worst member's trend).

        The maps merge into one fleet view first, and the link topology is
        folded over the merged map (the two endpoints of a link across
        shards are in different sources); a node's score is the worse of
        its own and its worst link's. A node named only as a link peer
        degrades its pool too. A node in several sources (a shard mid
        failover) merges per axis, the lower score and each link's sicker
        observation: duplication can only make a pool look sicker."""
        with self._lock:
            sources = list(self._sources)
        scores: dict[str, float] = {}
        links: dict[str, dict[str, Any]] = {}
        trends: dict[str, int] = {}
        for source in sources:
            for node_name, health in source.snapshot().items():
                previous = scores.get(node_name)
                if previous is None or health.score < previous:
                    scores[node_name] = health.score
                for peer, link in health.links.items():
                    per_node = links.setdefault(node_name, {})
                    current = per_node.get(peer)
                    per_node[peer] = link if current is None else sicker_link(link, current)
                trend = trend_value(health.trend)
                trends[node_name] = min(trend, trends.get(node_name, trend))
        merged = {
            name: NodeHealth(name, score=score, links=links.get(name, {}))
            for name, score in scores.items()
        }
        out: dict[str, tuple[float, int]] = {}
        for node_name, score in effective_scores(merged).items():
            try:
                pool = self._pool_of(node_name)
            except Exception:
                # Skipped for a peer that published nothing (a device tag,
                # say): it carries no pool a strict mapper must resolve. A
                # node with its own report stays loud: dropping it would
                # hide a degraded pool.
                if node_name in scores:
                    raise
                log.debug("pool mapping rejected link peer %r; skipped", node_name)
                pool = ""
            if not pool:
                continue
            trend = trends.get(node_name, 0)
            previous = out.get(pool)
            if previous is not None:
                score = min(score, previous[0])
                trend = min(trend, previous[1])
            out[pool] = (score, trend)
        return out

    def candidate_views(self, pools: Iterable[str]) -> list[Any]:
        """Each pool as the policy's view: the fold's worst-member score
        and trend (no telemetry: a healthy 100), the cost tier from the
        pool's name. ``disrupted`` is always False: a granted pool never
        returns to the pending set."""
        health = self.pool_health()
        return [
            CandidateView(
                name=pool,
                score=health.get(pool, (100.0, 0))[0],
                trend=health.get(pool, (100.0, 0))[1],
                tier=tier_of(pool),
            )
            for pool in pools
        ]

    def ordered(self, pools: Iterable[str], plugin: Optional[Any] = None) -> list[str]:
        """``pools`` degraded first, by the policy plugin's ``order``: the
        default keys on the worst member's score, a degrading trend
        breaking ties, then the name (the slice planner's key at pool
        grain)."""
        if plugin is None:
            plugin = for_spec(())
        return [view.name for view in plugin.order(self.candidate_views(pools))]


class FleetOrchestrator:
    """Grant pool rolls from the FleetRollout object's pending set.

    Drive it with :meth:`tick` at any cadence. A tick never raises on an
    API error (a flaky API server is a skipped round, not a crashed control
    plane, as with ``LeaderElector``) and keeps nothing: every decision is
    derived from the object, so a restart, or replicas behind their own
    leader election, cost nothing.
    """

    def __init__(
        self,
        client: Client,
        rollout_name: str,
        aggregator: Optional[FleetHealthAggregator] = None,
        policy: Sequence[str] = (),
    ) -> None:
        self.client = client
        self.rollout_name = rollout_name
        self.aggregator = aggregator
        #: The rollout's policy composition (registry names), which orders
        #: the pending pools and gates grants; a pool's own
        #: ``spec.pools[].policy`` overrides it for that pool's admission.
        #: Empty: the default policy.
        self.policy = tuple(policy)
        #: The pools this instance granted, in order (the durable record is
        #: the object's ``grantedSeq``).
        self.grant_order: list[str] = []
        self.grants_issued = 0
        self.budget_denials = 0
        self.ticks = 0
        self.api_errors = 0
        #: The ledger after the last successful round: what
        #: ``tpu_operator_fleet_*`` reads, with no GET of its own a scrape.
        self.last_summary: dict[str, Any] = {}

    def tick(self, wake_traces: Optional[Sequence[str]] = None) -> dict[str, Any]:
        """One grant round; the ledger's summary after it.

        ``wake_traces`` are the traces of the deliveries that woke the
        caller (``fleet/wakeup.py``): the grant span links to them."""
        self.ticks += 1
        try:
            # One span a round: the ledger write under it records this
            # trace as the write's origin, so a worker's next pass links
            # back here.
            with tracing.span("fleet.grant_round", category="grant",
                              rollout=self.rollout_name) as grant_span:
                if grant_span is not None and wake_traces:
                    tracer = tracing.tracer()
                    if tracer is not None:
                        for trace_id in wake_traces:
                            tracer.add_link(grant_span, trace_id)
                summary = self._grant_round()
                if grant_span is not None:
                    grant_span.attrs.update(
                        grants=len(summary.get("new_grants", []) or []),
                        pending=summary.get("pending", 0),
                    )
                    for pool in summary.get("new_grants", []) or []:
                        tracing.add_event("fleet.grant", pool=pool)
            if "error" not in summary and "missing" not in summary:
                self.last_summary = dict(summary)
            return summary
        except Exception as e:  # noqa: BLE001 - the client's own classes
            if not is_api_error(e):
                raise
            self.api_errors += 1
            if has_reason(e, ConflictError):
                # retry_on_conflict ran out: the workers' reports contended
                # for the status this round. The next tick reads again.
                log.info("fleet orchestrator: grant round lost its conflicts")
                return {"error": "conflict"}
            log.warning("fleet orchestrator: tick failed: %s", e)
            return {"error": str(e)}

    def _grant_round(self) -> dict[str, Any]:
        summary: dict[str, Any] = {}
        plugin = for_spec(self.policy)

        def attempt() -> None:
            obj = get_or_none(self.client, FLEET_ROLLOUT_KIND, self.rollout_name)
            if obj is None:
                summary.clear()
                summary["missing"] = True
                return
            raw = obj.raw
            spec = rollout_spec(raw)
            granted = pools_in_phase(raw, POOL_GRANTED)
            done = pools_in_phase(raw, POOL_DONE)
            pending = pools_in_phase(raw, POOL_PENDING)
            budget = spec.resolved_budget()
            slots = budget - len(granted)
            if self.aggregator is not None:
                order = self.aggregator.ordered(pending, plugin=plugin)
            else:
                # No health fold: every view reads healthy, so the default
                # order is the names'.
                order = [
                    view.name
                    for view in plugin.order(
                        [CandidateView(name=pool, tier=tier_of(pool)) for pool in pending]
                    )
                ]
            # Each grant's admission: a pool's own composition overrides
            # the rollout's for its own gate. The default admits all, so a
            # rollout without policies grants order[:slots].
            view = BudgetView(
                total=len(spec.pools),
                in_progress=len(granted),
                unavailable=len(granted),
                candidates=len(pending),
                max_parallel=0,
                max_unavailable=budget,
                now=wall_now(),
            )
            grants: list[str] = []
            for pool in order:
                if len(grants) >= max(0, slots):
                    break
                gate = for_spec(spec.policy_for(pool)) if spec.policy_for(pool) else plugin
                decision = gate.admit(CandidateView(name=pool, tier=tier_of(pool)), view)
                if not decision.allowed:
                    log.info("fleet orchestrator: pool %s refused by policy %s: %s",
                             pool, gate.name, decision.reason)
                    continue
                grants.append(pool)
            denied = len(pending) - len(grants)
            summary.clear()
            summary.update({
                "budget": budget,
                "granted": len(granted) + len(grants),
                "done": len(done),
                "pending": denied,
                "new_grants": list(grants),
            })
            if not grants:
                # Nothing to write: a settled ledger costs one GET.
                self.budget_denials += denied
                return
            status = raw.setdefault("status", {})
            seq = int(status.get("grantsIssued", 0) or 0)
            for pool in grants:
                seq += 1
                set_pool_phase(raw, pool, POOL_GRANTED, grantedSeq=seq)
            status["grantsIssued"] = seq
            act = fault_point("fleet.grant_write", rollout=self.rollout_name)
            if act is not None and act.exc is not None:
                # The grant write fails where an API server would fail it:
                # after the decision, before the ledger moved, so the retry
                # derives again from a fresh read.
                raise act.exc
            # A status write at the read's resourceVersion (the ledger is the
            # status subresource's: a plain update drops it), so a worker's
            # concurrent report conflicts this attempt and the retry derives
            # again from the fresh ledger.
            self.client.update_status(obj)
            self.grants_issued += len(grants)
            self.grant_order.extend(grants)
            self.budget_denials += denied
            log.info("fleet orchestrator: granted %s (budget=%d granted=%d done=%d pending=%d)",
                     grants, budget, summary["granted"], len(done), denied)

        retry_on_conflict(attempt)
        return summary
