"""The NodeHealthReport contract (v1alpha1): what the monitor publishes and
the planner, the health source and the quarantine arc read.

A NodeHealthReport is the structured form of one probe battery on one
node: per-check verdicts, numeric metrics, a bounded rolling history, a
derived 0-100 score with a trend over that history, and a per-neighbor
link map. It is cluster-scoped and named after its node. The strings,
defaults and derivations are the contract's own, so a report published by
this package reads the same as one from the JAX package, and either
package's publisher continues the other's history.

The link map does not fold into the score: a sick link between two healthy
hosts lives only there. Consumers localize it with
:func:`fold_link_topology`, which degrades both endpoints of a link even
when only one of them observed it, and :func:`effective_scores`, which
takes for each node the worse of its own score and its worst link's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

NODE_HEALTH_REPORT_KIND = "NodeHealthReport"
NODE_HEALTH_REPORT_API_VERSION = "telemetry.tpu-operator.dev/v1alpha1"
NODE_HEALTH_REPORT_PLURAL = "nodehealthreports"

#: Bounded rolling history: a report must not grow with every cycle.
DEFAULT_HISTORY_WINDOW = 12

TREND_IMPROVING = "improving"
TREND_STABLE = "stable"
TREND_DEGRADING = "degrading"

#: Score weights: the check verdicts carry most of the signal; the graded
#: bandwidth and latency let a slowing node score below a healthy one
#: before any check flips.
CHECK_WEIGHT = 60.0
BANDWIDTH_WEIGHT = 25.0
LATENCY_WEIGHT = 15.0

#: Full bandwidth credit at or above this ring rate, full latency credit
#: at or under this battery time. Derivation inputs, not gates.
DEFAULT_HEALTHY_RING_GBYTES_PER_S = 40.0
DEFAULT_LATENCY_BUDGET_S = 30.0

#: Score points the window halves' means must move before the trend
#: leaves "stable" (a flapping trend would flap the planner's order).
TREND_EPSILON = 5.0

#: Metric keys inside ``status.metrics`` and the history rows.
METRIC_RING_GBYTES_PER_S = "ring_gbytes_per_s"
METRIC_PROBE_LATENCY_S = "probe_latency_s"
METRIC_TOKENS_PER_S = "tokens_per_s"
METRIC_MXU_TFLOPS = "mxu_tflops"
#: The worst incident link, as scalars beside the link map.
METRIC_WORST_LINK_GBYTES_PER_S = "worst_link_gbytes_per_s"
METRIC_WORST_LINK_LATENCY_S = "worst_link_latency_s"

# ---------------------------------------------------------------------------
# Per-link contract
# ---------------------------------------------------------------------------

#: Graded link verdicts, worst first: the hop's numerics or transport
#: broke; it carried traffic below the references; it is fine.
LINK_OK = "ok"
LINK_DEGRADED = "degraded"
LINK_FAILED = "failed"

#: One hop is graded against the ring's healthy bandwidth and a per-hop
#: latency budget far below the whole battery's.
DEFAULT_HEALTHY_LINK_GBYTES_PER_S = DEFAULT_HEALTHY_RING_GBYTES_PER_S
DEFAULT_LINK_LATENCY_BUDGET_S = 1.0
#: A passing hop below this share of healthy bandwidth, or above this
#: multiple of the latency budget, grades ``degraded``.
LINK_DEGRADED_BANDWIDTH_FRACTION = 0.5
LINK_DEGRADED_LATENCY_FACTOR = 2.0

#: Bounded per-link rolling window of bandwidth samples.
DEFAULT_LINK_WINDOW = 8

#: A link verdict in the planner's 0-100 ordering space: a failed link
#: reads 0, a degraded one below every quarantine threshold.
LINK_VERDICT_SCORES = {LINK_OK: 100.0, LINK_DEGRADED: 40.0, LINK_FAILED: 0.0}


def _link_rank(verdict: str) -> int:
    """Worst-first order for folds: failed < degraded < ok."""
    return {LINK_FAILED: 0, LINK_DEGRADED: 1}.get(verdict, 2)


def link_verdict_value(verdict: str) -> int:
    """A verdict as a metric: failed -1, degraded 0, ok 1."""
    return {LINK_FAILED: -1, LINK_OK: 1}.get(verdict, 0)


def sicker_link(a: "LinkHealth", b: "LinkHealth") -> "LinkHealth":
    """The sicker of two observations of one directed link: the worse
    verdict, the lower bandwidth breaking a tie. Two copies of one node's
    report merge by this, so a duplicate can only make a link look
    sicker."""
    if _link_rank(a.verdict) != _link_rank(b.verdict):
        return a if _link_rank(a.verdict) < _link_rank(b.verdict) else b
    return a if a.gbytes_per_s <= b.gbytes_per_s else b


def raw_link_entries(links: Mapping[str, "LinkHealth"]) -> dict:
    """Parsed :class:`LinkHealth` entries back to the raw ``status.links``
    shape: a publisher that ran no link probe carries the live map forward
    with this, instead of erasing the other tier's signal."""
    return {
        peer: {
            "latencyS": link.latency_s,
            "gbytesPerS": link.gbytes_per_s,
            "verdict": link.verdict,
            "window": list(link.window),
        }
        for peer, link in links.items()
    }


def grade_link(
    ok: bool,
    latency_s: float,
    gbytes_per_s: float,
    healthy_link_gbytes_per_s: float = DEFAULT_HEALTHY_LINK_GBYTES_PER_S,
    link_latency_budget_s: float = DEFAULT_LINK_LATENCY_BUDGET_S,
) -> str:
    """Grade one timed neighbor exchange: ``failed`` when its check failed,
    whatever its timing; ``degraded`` on collapsed bandwidth or ballooned
    latency; ``ok`` otherwise. A number of 0.0 (no timing taken) grades
    ``ok``: a missing measurement is not a sick link."""
    if not ok:
        return LINK_FAILED
    if (
        gbytes_per_s > 0
        and healthy_link_gbytes_per_s > 0
        and gbytes_per_s
        < LINK_DEGRADED_BANDWIDTH_FRACTION * healthy_link_gbytes_per_s
    ):
        return LINK_DEGRADED
    if (
        latency_s > 0
        and link_latency_budget_s > 0
        and latency_s > LINK_DEGRADED_LATENCY_FACTOR * link_latency_budget_s
    ):
        return LINK_DEGRADED
    return LINK_OK


def node_health_report_name(node_name: str) -> str:
    """A report is named after its node, so one node never has two."""
    return node_name


def derive_score(
    checks: Mapping[str, bool],
    metrics: Mapping[str, float],
    healthy_ring_gbytes_per_s: float = DEFAULT_HEALTHY_RING_GBYTES_PER_S,
    latency_budget_s: float = DEFAULT_LATENCY_BUDGET_S,
) -> float:
    """One observation as a 0-100 score: the share of passing checks, the
    ring rate against the healthy reference and the latency budget against
    the battery's time, each clamped to [0, 1] and weighted. An absent
    component (no checks, no ring on one device, no latency) is full
    credit: what was not measured does not read as degraded."""
    if checks:
        check_component = sum(1 for ok in checks.values() if ok) / len(checks)
    else:
        check_component = 1.0
    ring = metrics.get(METRIC_RING_GBYTES_PER_S)
    if ring is None or healthy_ring_gbytes_per_s <= 0:
        bandwidth_component = 1.0
    else:
        bandwidth_component = min(
            1.0, max(0.0, float(ring) / healthy_ring_gbytes_per_s)
        )
    latency = metrics.get(METRIC_PROBE_LATENCY_S)
    if latency is None or latency <= 0 or latency_budget_s <= 0:
        latency_component = 1.0
    else:
        latency_component = min(1.0, latency_budget_s / float(latency))
    score = (
        CHECK_WEIGHT * check_component
        + BANDWIDTH_WEIGHT * bandwidth_component
        + LATENCY_WEIGHT * latency_component
    )
    return round(min(100.0, max(0.0, score)), 2)


def derive_trend(scores: list[float], epsilon: float = TREND_EPSILON) -> str:
    """The newer half's mean against the older half's, with ``epsilon``
    points of hysteresis; fewer than two samples are stable."""
    if len(scores) < 2:
        return TREND_STABLE
    half = len(scores) // 2
    older = scores[:half] or scores[:1]
    newer = scores[half:]
    delta = sum(newer) / len(newer) - sum(older) / len(older)
    if delta > epsilon:
        return TREND_IMPROVING
    if delta < -epsilon:
        return TREND_DEGRADING
    return TREND_STABLE


def trend_value(trend: str) -> int:
    """degrading -1, stable 0, improving 1: in ascending order a slice
    still getting worse rolls first among equal scores."""
    return {TREND_DEGRADING: -1, TREND_IMPROVING: 1}.get(trend, 0)


@dataclass(frozen=True)
class LinkHealth:
    """One parsed link entry: the peer (a node name for a link to another
    host, a device tag such as ``device-3`` within the node), the timed
    numbers, the verdict and the rolling bandwidth window."""

    peer: str
    latency_s: float = 0.0
    gbytes_per_s: float = 0.0
    verdict: str = LINK_OK
    window: tuple = ()


@dataclass(frozen=True)
class NodeHealth:
    """One parsed report status: what the planner reads."""

    node_name: str
    score: float = 100.0
    trend: str = TREND_STABLE
    checks: Mapping[str, bool] = field(default_factory=dict)
    metrics: Mapping[str, float] = field(default_factory=dict)
    observed_at: float = 0.0
    source: str = ""
    #: peer id -> LinkHealth; empty when no link probe ran.
    links: Mapping[str, LinkHealth] = field(default_factory=dict)

    def worst_link(self) -> Optional[LinkHealth]:
        """The sickest link this node observed itself (``None`` without a
        link map)."""
        if not self.links:
            return None
        return min(
            self.links.values(),
            key=lambda link: (_link_rank(link.verdict), link.gbytes_per_s),
        )


def make_link_entries(
    links: Mapping[str, Mapping[str, Any]],
    prior_links: Optional[Mapping[str, LinkHealth]] = None,
    link_window: int = DEFAULT_LINK_WINDOW,
    healthy_link_gbytes_per_s: float = DEFAULT_HEALTHY_LINK_GBYTES_PER_S,
    link_latency_budget_s: float = DEFAULT_LINK_LATENCY_BUDGET_S,
) -> dict[str, dict[str, Any]]:
    """Raw ``status.links`` entries from per-hop observations (``peer ->
    {ok, latency_s, gbytes_per_s}``), graded by :func:`grade_link`, each
    with its bandwidth appended to the live report's window. A peer absent
    from this observation drops out: membership is observed, not kept."""
    out: dict[str, dict[str, Any]] = {}
    for peer, obs in links.items():
        ok = bool(obs.get("ok", True))
        latency = float(obs.get("latency_s", 0.0) or 0.0)
        gbps = float(obs.get("gbytes_per_s", 0.0) or 0.0)
        prior = (prior_links or {}).get(str(peer))
        window = list(prior.window) if prior is not None else []
        window.append(round(gbps, 4))
        window = window[-max(1, int(link_window)):]
        out[str(peer)] = {
            "latencyS": round(latency, 6),
            "gbytesPerS": round(gbps, 4),
            "verdict": grade_link(
                ok,
                latency,
                gbps,
                healthy_link_gbytes_per_s=healthy_link_gbytes_per_s,
                link_latency_budget_s=link_latency_budget_s,
            ),
            "window": window,
        }
    return out


def make_node_health_report(
    node_name: str,
    checks: Mapping[str, bool],
    metrics: Mapping[str, float],
    source: str = "monitor",
    observed_at: float = 0.0,
    history: Optional[list[dict[str, Any]]] = None,
    history_window: int = DEFAULT_HISTORY_WINDOW,
    healthy_ring_gbytes_per_s: float = DEFAULT_HEALTHY_RING_GBYTES_PER_S,
    latency_budget_s: float = DEFAULT_LATENCY_BUDGET_S,
    links: Optional[Mapping[str, Mapping[str, Any]]] = None,
    prior_links: Optional[Mapping[str, LinkHealth]] = None,
    link_window: int = DEFAULT_LINK_WINDOW,
    healthy_link_gbytes_per_s: float = DEFAULT_HEALTHY_LINK_GBYTES_PER_S,
    link_latency_budget_s: float = DEFAULT_LINK_LATENCY_BUDGET_S,
) -> dict[str, Any]:
    """The raw report for one observation, appended to the live report's
    ``history`` and bounded to ``history_window`` rows. ``links`` is the
    per-hop observation map (:func:`make_link_entries`); the score does
    not read it."""
    score = derive_score(
        checks,
        metrics,
        healthy_ring_gbytes_per_s=healthy_ring_gbytes_per_s,
        latency_budget_s=latency_budget_s,
    )
    entry: dict[str, Any] = {"score": score, "observedAt": float(observed_at)}
    for key in (
        METRIC_RING_GBYTES_PER_S,
        METRIC_PROBE_LATENCY_S,
        METRIC_TOKENS_PER_S,
        METRIC_MXU_TFLOPS,
    ):
        if key in metrics:
            entry[key] = round(float(metrics[key]), 4)
    window = list(history or [])
    window.append(entry)
    window = window[-max(1, int(history_window)):]
    trend = derive_trend(
        [float(h.get("score", 0.0)) for h in window if "score" in h]
    )
    status: dict[str, Any] = {
        "score": score,
        "trend": trend,
        "checks": {k: bool(v) for k, v in checks.items()},
        "metrics": {k: float(v) for k, v in metrics.items()},
        "history": window,
        "observedAt": float(observed_at),
    }
    if links is not None:
        status["links"] = make_link_entries(
            links,
            prior_links=prior_links,
            link_window=link_window,
            healthy_link_gbytes_per_s=healthy_link_gbytes_per_s,
            link_latency_budget_s=link_latency_budget_s,
        )
    return {
        "apiVersion": NODE_HEALTH_REPORT_API_VERSION,
        "kind": NODE_HEALTH_REPORT_KIND,
        "metadata": {"name": node_health_report_name(node_name)},
        "spec": {"nodeName": node_name, "source": source},
        "status": status,
    }


def report_history(raw: Mapping[str, Any]) -> list[dict[str, Any]]:
    """The rolling window of a raw report (empty when malformed)."""
    history = (raw.get("status") or {}).get("history")
    return list(history) if isinstance(history, list) else []


def _parse_links(links_raw: Any) -> dict[str, LinkHealth]:
    links: dict[str, LinkHealth] = {}
    if not isinstance(links_raw, Mapping):
        return links
    for peer, entry in links_raw.items():
        if not isinstance(entry, Mapping):
            continue
        verdict = entry.get("verdict")
        if verdict not in (LINK_OK, LINK_DEGRADED, LINK_FAILED):
            verdict = LINK_OK
        try:
            latency = float(entry.get("latencyS", 0.0) or 0.0)
            gbps = float(entry.get("gbytesPerS", 0.0) or 0.0)
        except (TypeError, ValueError):
            continue
        samples = []
        window_raw = entry.get("window")
        for v in window_raw if isinstance(window_raw, list) else ():
            try:
                samples.append(float(v))
            except (TypeError, ValueError):
                continue
        links[str(peer)] = LinkHealth(
            peer=str(peer),
            latency_s=latency,
            gbytes_per_s=gbps,
            verdict=verdict,
            window=tuple(samples),
        )
    return links


def parse_node_health(raw: Mapping[str, Any]) -> Optional[NodeHealth]:
    """A raw report as :class:`NodeHealth`; ``None`` when it names no node.
    Each field is read defensively: a hand-edited report degrades, it does
    not crash the reader."""
    meta = raw.get("metadata") or {}
    spec = raw.get("spec") or {}
    node_name = spec.get("nodeName") or meta.get("name") or ""
    if not node_name:
        return None
    status = raw.get("status") or {}
    try:
        score = float(status.get("score", 100.0))
    except (TypeError, ValueError):
        score = 100.0
    trend = status.get("trend")
    if trend not in (TREND_IMPROVING, TREND_STABLE, TREND_DEGRADING):
        trend = TREND_STABLE
    checks_raw = status.get("checks")
    checks = (
        {str(k): bool(v) for k, v in checks_raw.items()}
        if isinstance(checks_raw, Mapping)
        else {}
    )
    metrics: dict[str, float] = {}
    metrics_raw = status.get("metrics")
    for k, v in metrics_raw.items() if isinstance(metrics_raw, Mapping) else ():
        try:
            metrics[str(k)] = float(v)
        except (TypeError, ValueError):
            continue
    try:
        observed_at = float(status.get("observedAt", 0.0))
    except (TypeError, ValueError):
        observed_at = 0.0
    return NodeHealth(
        node_name=str(node_name),
        score=min(100.0, max(0.0, score)),
        trend=trend,
        checks=checks,
        metrics=metrics,
        observed_at=observed_at,
        source=str(spec.get("source", "")),
        links=_parse_links(status.get("links")),
    )


# ---------------------------------------------------------------------------
# The fleet's link topology: the symmetric view of every node's link map.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LinkObservation:
    """One link after the fold: its endpoints (sorted; ``b`` may be a
    device tag within a node), the worst observation either endpoint made,
    and the endpoints that reported it."""

    a: str
    b: str
    latency_s: float
    gbytes_per_s: float
    verdict: str
    reporters: tuple

    @property
    def key(self) -> tuple:
        return (self.a, self.b)


def link_key(node_a: str, node_b: str) -> tuple:
    """An undirected link's identity: A's report about B and B's about A
    land on one key."""
    return (node_a, node_b) if node_a <= node_b else (node_b, node_a)


def fold_link_topology(
    health: Mapping[str, NodeHealth],
) -> dict[tuple, LinkObservation]:
    """Every node's link map folded into one view keyed by undirected link.
    Endpoints that disagree take the worst on every axis (verdict, lowest
    bandwidth, highest latency): a link sick in one direction reads sick,
    and a duplicate report can only make a link look sicker."""
    out: dict[tuple, LinkObservation] = {}
    for node_name, entry in (health or {}).items():
        for peer, link in entry.links.items():
            key = link_key(node_name, peer)
            prev = out.get(key)
            if prev is None:
                out[key] = LinkObservation(
                    a=key[0],
                    b=key[1],
                    latency_s=link.latency_s,
                    gbytes_per_s=link.gbytes_per_s,
                    verdict=link.verdict,
                    reporters=(node_name,),
                )
                continue
            verdict = min(prev.verdict, link.verdict, key=_link_rank)
            gbps = (
                min(prev.gbytes_per_s, link.gbytes_per_s)
                if prev.gbytes_per_s > 0 and link.gbytes_per_s > 0
                else max(prev.gbytes_per_s, link.gbytes_per_s)
            )
            reporters = prev.reporters
            if node_name not in reporters:
                reporters = tuple(sorted((*reporters, node_name)))
            out[key] = LinkObservation(
                a=key[0],
                b=key[1],
                latency_s=max(prev.latency_s, link.latency_s),
                gbytes_per_s=gbps,
                verdict=verdict,
                reporters=reporters,
            )
    return out


def node_link_scores(
    topology: Mapping[tuple, LinkObservation],
) -> dict[str, float]:
    """node -> the score (``LINK_VERDICT_SCORES``) of its worst incident
    link in the folded topology. Both endpoints of every link have an
    entry, also one that published no report of its own; a node whose
    links are all ok reads 100."""
    out: dict[str, float] = {}
    for obs in topology.values():
        score = LINK_VERDICT_SCORES.get(obs.verdict, 100.0)
        for endpoint in (obs.a, obs.b):
            prev = out.get(endpoint)
            if prev is None or score < prev:
                out[endpoint] = score
    return out


def effective_scores(health: Mapping[str, NodeHealth]) -> dict[str, float]:
    """node -> the lower of its own score and its worst incident link's:
    what the planner orders by and the quarantine arc judges. Nodes named
    only as a peer have an entry too; so do device tags, which a reader
    keyed by node name never looks up."""
    out = node_link_scores(fold_link_topology(health))
    for name, entry in (health or {}).items():
        prev = out.get(name)
        if prev is None or entry.score < prev:
            out[name] = entry.score
    return out


def effective_node_score(node_name: str, health: Mapping[str, NodeHealth]) -> Optional[float]:
    """One node's effective score; ``None`` when neither its own report
    nor any link names it (no telemetry is no verdict)."""
    return effective_scores(health).get(node_name)


def sick_links_from_topology(
    node_name: str, topology: Mapping[tuple, LinkObservation]
) -> list[dict[str, Any]]:
    """The node's incident links that are not ok, over a topology folded
    already, as JSON (peer, verdict, and the bandwidth and latency where
    measured), sorted by peer. A caller walking many nodes folds once and
    extracts each node's in O(links)."""
    out: list[dict[str, Any]] = []
    for obs in topology.values():
        if node_name not in (obs.a, obs.b) or obs.verdict == LINK_OK:
            continue
        entry: dict[str, Any] = {
            "peer": obs.b if obs.a == node_name else obs.a,
            "verdict": obs.verdict,
        }
        if obs.gbytes_per_s > 0:
            entry["gbytesPerS"] = round(obs.gbytes_per_s, 3)
        if obs.latency_s > 0:
            entry["latencyS"] = round(obs.latency_s, 6)
        out.append(entry)
    return sorted(out, key=lambda e: e["peer"])


def sick_links_for(node_name: str, health: Mapping[str, NodeHealth]) -> list[dict[str, Any]]:
    """The node's sick incident links over the folded topology, a link
    only the peer reported included: the ``worstLinks`` the requestor
    writes into a NodeMaintenance's ``spec.nodeHealth``. Empty when every
    incident link is ok. One fold a call; see
    :func:`sick_links_from_topology` for many nodes."""
    return sick_links_from_topology(node_name, fold_link_topology(health))
