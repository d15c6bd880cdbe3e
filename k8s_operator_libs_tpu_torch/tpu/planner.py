"""Slice-aware upgrade planning: the disruption budget counted in NVLink
domains.

On a multi-node NVLink domain (the nodes of one ``nvidia.com/gpu.clique``)
cordoning one node takes the whole domain's collectives down, so counting
unavailability in nodes understates the disruption by up to the number of
nodes in the domain. The slice-aware strategies replace the upgrade-start
budget of the operator's state machine with slice arithmetic:

* **unit**: ``maxUnavailable`` and ``maxParallelUpgrades`` count slices;
* **accounting**: a slice is unavailable or in progress when any of its
  nodes is;
* **batching**: a selected slice starts all its upgrade-required nodes
  together, one disruption window per slice;
* **order**: already disrupted slices first, then ascending health score
  (the worst member's telemetry score, the worst incident link, 0 for a
  slice the monitor flagged ``TpuIciHealthy=False``), a degrading trend
  breaking ties; the policy plugins decide the budget, admission and
  order from these views.

Slices come from the node detector (``tpu/detector.py``): the explicit
slice-id label, then ``gpu.clique``, then the node itself; never the node
pool. Everything downstream (cordon, drain, restart, validate, uncordon)
is the state machine's own.

No state machine and no strategy class is imported here, so the planner
serves this package's ``upgrade.ClusterUpgradeStateManager`` and the JAX
package's alike. The slice-aware strategies wrap the manager's own
strategy objects,
override ``process_upgrade_required_nodes`` and hand every other call to
the wrapped object; the manager's state, policy and health views are read
by attribute.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..api.telemetry_v1alpha1 import LINK_VERDICT_SCORES, fold_link_topology, trend_value
from ..kube.objects import condition_status
from ..policy import BudgetView, CandidateView, UpgradePolicy, for_spec, tier_of
from ..upgrade.consts import NULL_STRING, TRUE_STRING, UpgradeState
from ..utils.faultpoints import wall_now
from ..utils.log import get_logger
from .detector import TpuNodeDetector

log = get_logger("tpu.planner")

#: Bucket states that are not an upgrade in flight. A quarantined node is
#: cordoned capacity (disrupted), but it takes no parallel-upgrade slot.
_IDLE_BUCKETS = frozenset(
    {
        UpgradeState.UNKNOWN,
        UpgradeState.DONE,
        UpgradeState.UPGRADE_REQUIRED,
        UpgradeState.QUARANTINED,
    }
)


def _node_ici_unhealthy(ns) -> bool:
    """The monitor reported a dead link on the node. A soft signal: the
    slice rolls first, but it still takes a budget slot, so a monitor
    false positive across the fleet cannot cordon every flagged slice in
    one pass."""
    from .monitor import ICI_HEALTHY_CONDITION

    return condition_status(ns.node.status, ICI_HEALTHY_CONDITION) == "False"


@dataclass
class SliceAssessment:
    """One pass's slice-level view of the cluster, shared by both
    slice-aware strategies."""

    total_slices: int = 0
    #: Any member cordoned or NotReady, or already in the upgrade pipeline
    #: (cordon-required onward: the cordon may not have landed yet).
    disrupted: set[str] = field(default_factory=set)
    in_progress: set[str] = field(default_factory=set)
    #: ``TpuIciHealthy=False`` on any member.
    wounded: set[str] = field(default_factory=set)
    #: slice -> its upgrade-required members.
    candidates: dict[str, list] = field(default_factory=dict)
    #: slice -> worst member health score (absent: fully healthy).
    scores: dict[str, float] = field(default_factory=dict)
    #: slice -> worst member trend (-1 degrading, 0 stable, 1 improving).
    trends: dict[str, int] = field(default_factory=dict)
    #: slice -> worst incident link score over the symmetric link fold: a
    #: sick link between two healthy hosts lives only here.
    link_scores: dict[str, float] = field(default_factory=dict)
    #: slice -> the (a, b) key of that link, for the planner's log.
    worst_links: dict[str, tuple] = field(default_factory=dict)

    def budget_view(self, policy) -> BudgetView:
        """The budget inputs in slice units, with the wall clock stamped
        here so the policy stays a pure function."""
        return BudgetView(
            total=self.total_slices,
            in_progress=len(self.in_progress),
            unavailable=len(self.disrupted),
            candidates=len(self.candidates),
            max_parallel=policy.max_parallel_upgrades,
            max_unavailable=policy.resolved_max_unavailable(self.total_slices),
            now=wall_now(),
        )

    def budget(self, policy, plugin: Optional[UpgradePolicy] = None) -> tuple[int, int]:
        """``(available, resolved max_unavailable)`` in slice units, from
        the policy plugin of ``policy.policy``."""
        if plugin is None:
            plugin = for_spec(policy.policy)
        verdict = plugin.budget(self.budget_view(policy))
        return verdict.available, verdict.max_unavailable

    def effective_score(self, slice_id: str) -> float:
        """0 for a wounded slice, else the worse of its members' telemetry
        score and its worst incident link's score (100 without either)."""
        if slice_id in self.wounded:
            return 0.0
        return min(
            self.scores.get(slice_id, 100.0),
            self.link_scores.get(slice_id, 100.0),
        )

    def candidate_views(self) -> list[CandidateView]:
        return [
            CandidateView(
                name=slice_id,
                score=self.effective_score(slice_id),
                trend=self.trends.get(slice_id, 0),
                disrupted=slice_id in self.disrupted,
                tier=tier_of(slice_id),
            )
            for slice_id in self.candidates
        ]

    def ordered_candidates(self, plugin: Optional[UpgradePolicy] = None):
        """``(slice, members)`` in the plugin's order."""
        if plugin is None:
            plugin = for_spec(())
        return [
            (view.name, self.candidates[view.name])
            for view in plugin.order(self.candidate_views())
        ]


def _node_links(node_health) -> dict[str, tuple[float, tuple]]:
    """node -> (worst incident link score, its key), for links that are
    not ok; both endpoints of a link carry it, even one that never
    reported."""
    out: dict[str, tuple[float, tuple]] = {}
    for key, obs in fold_link_topology(node_health).items():
        score = LINK_VERDICT_SCORES.get(obs.verdict, 100.0)
        if score >= 100.0:
            continue
        for endpoint in (obs.a, obs.b):
            previous = out.get(endpoint)
            if previous is None or score < previous[0]:
                out[endpoint] = (score, key)
    return out


def assess_slices(detector: TpuNodeDetector, state) -> SliceAssessment:
    """Group ``state.node_states`` by slice and assess each slice."""

    def slice_of(node) -> str:
        info = detector.detect(node)
        return info.slice_id if info is not None else node.name

    out = SliceAssessment()
    slices: dict[str, list] = {}
    for bucket, node_states in state.node_states.items():
        for ns in node_states:
            slices.setdefault(slice_of(ns.node), []).append((bucket, ns))
    out.total_slices = len(slices)
    node_links = _node_links(state.node_health) if state.node_health else {}
    for slice_id, members in slices.items():
        for bucket, ns in members:
            if ns.node.unschedulable or not ns.node.is_ready():
                out.disrupted.add(slice_id)
            if _node_ici_unhealthy(ns):
                out.wounded.add(slice_id)
            health = state.health_of(ns.node.name)
            if health is not None:
                # The worst member: one straggler throttles the slice.
                previous = out.scores.get(slice_id)
                if previous is None or health.score < previous:
                    out.scores[slice_id] = health.score
                trend = trend_value(health.trend)
                out.trends[slice_id] = min(trend, out.trends.get(slice_id, trend))
            incident = node_links.get(ns.node.name)
            if incident is not None:
                link_score, link = incident
                previous = out.link_scores.get(slice_id)
                if previous is None or link_score < previous:
                    out.link_scores[slice_id] = link_score
                    out.worst_links[slice_id] = link
            if bucket not in _IDLE_BUCKETS:
                out.in_progress.add(slice_id)
                out.disrupted.add(slice_id)
            if bucket == UpgradeState.UPGRADE_REQUIRED:
                out.candidates.setdefault(slice_id, []).append(ns)
    return out


def start_slices_within_budget(
    common, detector: TpuNodeDetector, state, policy, start_slice, log_label: str
) -> None:
    """The slice walk both strategies share: assess, budget in slices,
    order, the per-node skip and requested bookkeeping, and whole-slice
    starts; a slice already disrupted takes no budget slot.
    ``start_slice(ns)`` starts one node."""
    plugin = for_spec(policy.policy)
    assessment = assess_slices(detector, state)
    available, max_unavailable = assessment.budget(policy, plugin=plugin)
    budget_view = assessment.budget_view(policy)
    admitted = {
        view.name
        for view in assessment.candidate_views()
        if plugin.admit(view, budget_view).allowed
    }
    log.info(
        "%s: slices=%d in_progress=%d disrupted=%d max_unavailable=%d "
        "slots=%d policy=%s",
        log_label, assessment.total_slices, len(assessment.in_progress),
        len(assessment.disrupted), max_unavailable, available, plugin.name,
    )
    for slice_id, members in assessment.ordered_candidates(plugin=plugin):
        if slice_id not in admitted:
            log.info("%s: slice %s refused by policy %s", log_label, slice_id, plugin.name)
            continue
        startable = []
        for ns in members:
            if common.is_upgrade_requested(ns.node):
                common.provider.change_node_upgrade_annotation(
                    ns.node, common.keys.upgrade_requested_annotation, NULL_STRING
                )
            if common.skip_node_upgrade(ns.node):
                log.info("node %s is marked to skip upgrades", ns.node.name)
                continue
            startable.append(ns)
        if not startable:
            continue
        already_disrupted = slice_id in assessment.disrupted
        if available <= 0 and not already_disrupted:
            continue
        for ns in startable:
            start_slice(ns)
        sick_link = assessment.worst_links.get(slice_id)
        log.info(
            "%s: slice %s started %d node(s)%s%s",
            log_label, slice_id, len(startable),
            " (already disrupted)" if already_disrupted else "",
            f" (sick link {sick_link[0]}<->{sick_link[1]})" if sick_link else "",
        )
        if not already_disrupted:
            available -= 1


class _Wrapped:
    """A strategy that overrides ``process_upgrade_required_nodes`` and
    hands every other attribute to the strategy it wraps."""

    def __init__(self, base, detector: Optional[TpuNodeDetector]) -> None:
        self.base = base
        self.detector = detector or TpuNodeDetector()

    @property
    def common(self):
        return self.base.common

    def __getattr__(self, name):
        # Only reached for attributes this class lacks.
        return getattr(self.base, name)


class SliceAwareInplaceManager(_Wrapped):
    """In-place upgrades started a whole slice at a time, within a budget
    counted in slices. Wraps the manager's in-place strategy."""

    def process_upgrade_required_nodes(self, state, policy) -> None:
        common = self.common

        def start(ns) -> None:
            common.provider.change_node_upgrade_state(ns.node, UpgradeState.CORDON_REQUIRED)

        start_slices_within_budget(common, self.detector, state, policy, start, "slice planner")


class SliceAwareRequestorManager(_Wrapped):
    """Requestor mode with the NodeMaintenance requests aligned to slices:
    the same budget, order and whole-slice batches as the in-place
    planner, so the external maintenance operator receives a slice's
    requests together. Wraps the manager's requestor strategy."""

    def process_upgrade_required_nodes(self, state, policy) -> None:
        common = self.common

        def start(ns) -> None:
            self.base.create_or_update_node_maintenance(
                ns, policy,
                health=state.health_of(ns.node.name),
                sick_links=state.sick_links_of(ns.node.name),
            )
            common.provider.change_node_upgrade_annotation(
                ns.node, common.keys.requestor_mode_annotation, TRUE_STRING
            )
            common.provider.change_node_upgrade_state(
                ns.node, UpgradeState.NODE_MAINTENANCE_REQUIRED
            )

        start_slices_within_budget(common, self.detector, state, policy, start, "slice requestor")


@dataclass
class DisruptionStats:
    """Windows over a series of disrupted-slice sets: a window opens when a
    slice enters the set; a slice that flaps opens one at each entry."""

    windows: int
    #: Slices in the order their first window opened.
    first_order: list[str]
    #: slice -> windows it opened.
    per_slice: dict[str, int]
    #: Most slices disrupted at once.
    max_at_once: int


def disruption_stats(samples) -> DisruptionStats:
    """``samples``: the per-pass sets of disrupted slice ids."""
    windows = 0
    previously: set = set()
    first_order: list[str] = []
    per_slice: dict[str, int] = {}
    for current in samples:
        for slice_id in current - previously:
            windows += 1
            per_slice[slice_id] = per_slice.get(slice_id, 0) + 1
            if slice_id not in first_order:
                first_order.append(slice_id)
        previously = set(current)
    return DisruptionStats(
        windows=windows,
        first_order=first_order,
        per_slice=per_slice,
        max_at_once=max((len(s) for s in samples), default=0),
    )


class _RequestorSlot:
    """The ``requestor`` attribute of a manager with slice planning on:
    whatever requestor is assigned to it, now or later, is held wrapped in
    a :class:`SliceAwareRequestorManager`."""

    def __get__(self, manager, owner=None):
        if manager is None:
            return self
        return manager.__dict__.get("requestor")

    def __set__(self, manager, requestor) -> None:
        if requestor is not None and not isinstance(requestor, SliceAwareRequestorManager):
            requestor = SliceAwareRequestorManager(requestor, manager.__dict__["_slice_detector"])
        manager.__dict__["requestor"] = requestor


#: manager class -> its subclass with the requestor slot.
_SLOTTED: dict[type, type] = {}


def _slotted(cls: type) -> type:
    if cls in _SLOTTED.values():
        return cls
    if cls not in _SLOTTED:
        _SLOTTED[cls] = type(
            cls.__name__, (cls,),
            {"requestor": _RequestorSlot(), "__module__": cls.__module__,
             "__qualname__": cls.__qualname__, "__doc__": cls.__doc__},
        )
    return _SLOTTED[cls]


def enable_slice_aware_planning(manager, detector: Optional[TpuNodeDetector] = None):
    """Plan ``manager``'s upgrades by slice: its in-place strategy is
    wrapped now, and its requestor strategy whenever it has one, whether
    requestor mode was enabled before or is enabled after (the manager's
    ``requestor`` attribute wraps what is assigned to it). Returns the
    manager."""
    detector = detector or TpuNodeDetector()
    if isinstance(manager.inplace, SliceAwareInplaceManager):
        manager.inplace.detector = detector
    else:
        manager.inplace = SliceAwareInplaceManager(manager.inplace, detector)
    manager.__dict__["_slice_detector"] = detector
    requestor = getattr(manager, "requestor", None)
    manager.__class__ = _slotted(type(manager))
    if isinstance(requestor, SliceAwareRequestorManager):
        requestor.detector = detector
    else:
        manager.requestor = requestor
    return manager
