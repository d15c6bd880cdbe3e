"""HealthSource: the NodeHealthReports read through an informer.

The JAX package's ``upgrade/health_source.py``. Probes publish one
``NodeHealthReport`` a node (``api/telemetry_v1alpha1.py``; the monitor's
``ReportPublisher``); this module keeps them as a map node name ->
:class:`NodeHealth`, fed by an :class:`~..kube.informer.Informer` (one
list, then the watch), which the state machine attaches to every snapshot
(``ClusterUpgradeState.node_health``). The planner orders by it and the
quarantine arc judges its thresholds against it.

``HealthMetrics`` exports the ``tpu_operator_health_*`` family (each
node's score and trend, a histogram of the probe latency, the quarantine
counters) and ``LinkMetrics`` the ``tpu_operator_link_*`` family (each
link of the folded topology, a histogram of the hop latency), both served
by the ``MetricsServer``.

Not here yet: :meth:`HealthSource.attach`, which feeds report deltas into
an incremental snapshot source's dirty set, waits for that source
(ROADMAP A14) and raises; a shared watch hub as the informer's stream
waits for ROADMAP A18 and is refused; the informer's tracing spans wait
for ROADMAP A15.
"""

from __future__ import annotations

import threading
from typing import Callable, Mapping, Optional

from ..api.telemetry_v1alpha1 import (
    LINK_OK,
    METRIC_PROBE_LATENCY_S,
    NODE_HEALTH_REPORT_KIND,
    LinkObservation,
    NodeHealth,
    fold_link_topology,
    link_verdict_value,
    parse_node_health,
    trend_value,
)
from ..kube.client import Client
from ..kube.informer import Informer
from ..kube.objects import KubeObject
from ..utils.lifecycle import lifecycle_resource
from ..utils.log import get_logger
from .metrics import (
    DEFAULT_LATENCY_BUCKETS,
    DEFAULT_LINK_LATENCY_BUCKETS,
    Histogram,
    merge_label,
    prom_label,
    render_rows,
    render_samples,
)
from .state_manager import not_ported

log = get_logger("upgrade.health")


def report_node_name(obj) -> str:
    """The node a report concerns: ``spec.nodeName``, else its name (the
    contract makes them equal)."""
    raw = obj.raw if isinstance(obj, KubeObject) else obj
    spec = raw.get("spec") or {}
    return spec.get("nodeName") or (raw.get("metadata") or {}).get("name", "")


def report_concerned_nodes(obj) -> list:
    """Every node a report's change concerns: its own, and each peer its
    link map names (a link's health is both endpoints'). A peer that is a
    device tag names no node, which costs a reader nothing."""
    raw = obj.raw if isinstance(obj, KubeObject) else obj
    names = [report_node_name(obj)]
    links = (raw.get("status") or {}).get("links")
    if isinstance(links, Mapping):
        names += [str(peer) for peer in links]
    return names


@lifecycle_resource(acquire="start", release="stop")
class HealthSource:
    """One informer over ``NodeHealthReport``, folded into a map node ->
    :class:`NodeHealth` under a leaf lock.

    ``snapshot()`` is memoized by a count of updates: a pass over a
    settled pool gets the same mapping again, with nothing copied.
    Observers (:meth:`add_observer`) see each parsed update on the
    informer's thread; the metrics' histograms feed from there.
    """

    def __init__(
        self,
        client: Client,
        resync_period_s: float = 0.0,
        node_filter: Optional[Callable[[str], bool]] = None,
        watch_hub=None,
    ) -> None:
        if watch_hub is not None:
            raise not_ported("a HealthSource on a shared watch hub", "A18")
        self._informer = Informer(
            client, NODE_HEALTH_REPORT_KIND, resync_period_s=resync_period_s
        )
        #: Only reports of nodes the filter accepts enter the map. The
        #: filter may change (a shard's owned scope); its owner then calls
        #: :meth:`refold`.
        self._node_filter = node_filter
        self._lock = threading.Lock()
        self._health: dict[str, NodeHealth] = {}
        self._updates = 0
        self._snapshot_version = -1
        self._snapshot: Mapping[str, NodeHealth] = {}
        self._topology_version = -1
        self._topology: Mapping[tuple, LinkObservation] = {}
        self._observers: list[Callable[[NodeHealth], None]] = []
        # Before start(): the first list's ADDEDs come through the handler,
        # so the map is whole from the first sync.
        self._informer.add_event_handler(self._on_event)

    # -- lifecycle -----------------------------------------------------------
    def start(self, sync_timeout: float = 30.0) -> "HealthSource":
        if not self._informer.started:
            self._informer.start()
        if not self._informer.wait_for_sync(timeout=sync_timeout):
            self._informer.stop()
            raise TimeoutError(
                f"NodeHealthReport informer did not sync within {sync_timeout}s"
            )
        return self

    def stop(self) -> None:
        if self._informer.started:
            self._informer.stop()

    @property
    def started(self) -> bool:
        return self._informer.started

    def __enter__(self) -> "HealthSource":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def informer(self) -> Informer:
        return self._informer

    # -- wiring ----------------------------------------------------------------
    def attach(self, snapshot_source) -> None:
        """Would feed each report's change into an incremental snapshot
        source's dirty set (its node and its link peers); that source is
        not in the port yet."""
        raise not_ported("HealthSource.attach to an incremental snapshot source", "A14")

    def add_observer(self, fn: Callable[[NodeHealth], None]) -> None:
        """``fn`` is called with every parsed update on the informer's
        thread (one at a time). It owns its errors."""
        self._observers.append(fn)

    # -- intake (the informer's thread) ----------------------------------------
    def _on_event(self, event_type: str, obj, old) -> None:
        name = report_node_name(obj)
        if not name:
            log.warning("NodeHealthReport with no node attribution ignored")
            return
        if self._node_filter is not None and not self._node_filter(name):
            # Out of scope: drop it, and an entry left from a wider scope.
            with self._lock:
                if name in self._health:
                    self._health.pop(name, None)
                    self._updates += 1
            return
        if event_type == "DELETED":
            with self._lock:
                self._health.pop(name, None)
                self._updates += 1
            return
        health = parse_node_health(obj.raw)
        if health is None:
            return
        with self._lock:
            self._health[name] = health
            self._updates += 1
        for observer in self._observers:
            try:
                observer(health)
            except Exception:  # noqa: BLE001 - observers own their errors
                log.exception("health observer failed for node %s", name)

    def refold(self) -> None:
        """The map rebuilt from the informer's store under the filter as it
        is now (after a change of scope). The store is listed before the
        map's lock is taken."""
        rebuilt: dict[str, NodeHealth] = {}
        for obj in self._informer.list():
            name = report_node_name(obj)
            if not name:
                continue
            if self._node_filter is not None and not self._node_filter(name):
                continue
            health = parse_node_health(obj.raw)
            if health is not None:
                rebuilt[name] = health
        with self._lock:
            self._health = rebuilt
            self._updates += 1

    # -- reads (the reconcile thread, scrapers) --------------------------------
    def _snapshot_locked(self) -> tuple[Mapping[str, NodeHealth], int]:
        """(memoized snapshot, its version), read together under the lock
        the caller holds, so a fold is cached under the version it folded."""
        if self._snapshot_version != self._updates:
            self._snapshot = dict(self._health)
            self._snapshot_version = self._updates
        return self._snapshot, self._snapshot_version

    def snapshot(self) -> Mapping[str, NodeHealth]:
        """node -> NodeHealth now; the same object until an event lands."""
        with self._lock:
            return self._snapshot_locked()[0]

    def link_topology(self) -> Mapping[tuple, LinkObservation]:
        """The folded link view of the current map
        (``fold_link_topology``), memoized like :meth:`snapshot`. The fold
        runs outside the lock; a slower fold of an older snapshot never
        replaces a newer cached one."""
        with self._lock:
            snapshot, version = self._snapshot_locked()
            if self._topology_version == version:
                return self._topology
        topology = fold_link_topology(snapshot)
        with self._lock:
            if version > self._topology_version:
                self._topology = topology
                self._topology_version = version
                return self._topology
            return topology

    def health_of(self, node_name: str) -> Optional[NodeHealth]:
        with self._lock:
            return self._health.get(node_name)

    @property
    def updates(self) -> int:
        with self._lock:
            return self._updates


_PREFIX = "tpu_operator_health"


class HealthMetrics:
    """The ``tpu_operator_health_*`` family: ``score`` and ``trend``
    gauges a reported node (trend -1 degrading, 0 stable, 1 improving),
    ``probe_latency_seconds``, a histogram observed from every update that
    carries a probe latency, and, when wired, the quarantine counters of a
    ``totals()`` callable (``QuarantineManager.totals``)."""

    def __init__(
        self,
        source: HealthSource,
        quarantine_totals: Optional[Callable[[], Mapping[str, int]]] = None,
        latency_buckets=DEFAULT_LATENCY_BUCKETS,
    ) -> None:
        self._source = source
        self._quarantine_totals = quarantine_totals
        self._latency = Histogram(latency_buckets)
        source.add_observer(self._observe)

    def _observe(self, health: NodeHealth) -> None:
        latency = health.metrics.get(METRIC_PROBE_LATENCY_S)
        if latency is not None and latency >= 0:
            self._latency.observe(latency)

    def set_quarantine_totals(self, totals: Callable[[], Mapping[str, int]]) -> None:
        self._quarantine_totals = totals

    def render(self) -> str:
        snapshot = self._source.snapshot()
        labeled = [(prom_label("node", node), snapshot[node]) for node in sorted(snapshot)]
        per_node = render_samples(_PREFIX, [
            ("score", "gauge",
             "Derived 0-100 node health score (NodeHealthReport)",
             [(label, h.score) for label, h in labeled]),
            ("trend", "gauge",
             "Health trend over the rolling window "
             "(-1 degrading, 0 stable, 1 improving)",
             [(label, trend_value(h.trend)) for label, h in labeled]),
        ])
        rows: list = [
            ("reported_nodes", "gauge",
             "Nodes with a live NodeHealthReport", len(snapshot)),
            ("probe_latency_seconds", "histogram",
             "Probe battery latency reported through NodeHealthReports",
             self._latency.snapshot()),
        ]
        if self._quarantine_totals is not None:
            totals = self._quarantine_totals()
            rows.extend([
                ("quarantined_nodes", "gauge",
                 "Nodes currently in telemetry quarantine",
                 totals.get("in_quarantine", 0)),
                ("quarantine_entries_total", "counter",
                 "Nodes cordoned into quarantine since start",
                 totals.get("entered", 0)),
                ("quarantine_releases_total", "counter",
                 "Quarantined nodes released on score recovery",
                 totals.get("released", 0)),
                ("quarantine_handoffs_total", "counter",
                 "Quarantined nodes handed to the upgrade pipeline",
                 totals.get("handed_off", 0)),
                ("quarantine_budget_denials_total", "counter",
                 "Quarantine admissions deferred by the disruption budget",
                 totals.get("budget_denied", 0)),
            ])
        return per_node + render_rows(_PREFIX, "", rows)


_LINK_PREFIX = "tpu_operator_link"


def link_label(obs: LinkObservation) -> str:
    """One link's label set: both endpoints, in the fold's sorted order, so
    A's and B's observations are one series."""
    return merge_label(prom_label("a", obs.a), "b", obs.b)


class LinkMetrics:
    """The ``tpu_operator_link_*`` family: per-link gauges over the folded
    topology (``HealthSource.link_topology``: bandwidth, latency and
    verdict, -1 failed, 0 degraded, 1 ok; one series an undirected link,
    the worse endpoint's observation), the count of links and of sick
    ones, and ``hop_latency_seconds``, a histogram of every link entry a
    report update brings."""

    def __init__(self, source: HealthSource, latency_buckets=DEFAULT_LINK_LATENCY_BUCKETS) -> None:
        self._source = source
        self._latency = Histogram(latency_buckets)
        #: node -> its last link map. Observers run one at a time on the
        #: informer's thread, so no lock. An entry equal to the last one
        #: (windows included) was carried forward by a publish without a
        #: link probe, not measured again, and is not observed twice.
        self._last: dict[str, Mapping] = {}
        source.add_observer(self._observe)

    def _observe(self, health: NodeHealth) -> None:
        previous = self._last.get(health.node_name)
        self._last[health.node_name] = health.links
        for peer, link in health.links.items():
            if previous is not None and previous.get(peer) == link:
                continue
            if link.latency_s > 0:
                self._latency.observe(link.latency_s)

    def render(self) -> str:
        topology = self._source.link_topology()
        labeled = [(link_label(obs), obs) for _, obs in sorted(topology.items())]
        per_link = render_samples(_LINK_PREFIX, [
            ("gbytes_per_s", "gauge",
             "Per-link bandwidth (worst observation from either "
             "endpoint of the folded topology)",
             [(label, round(obs.gbytes_per_s, 4)) for label, obs in labeled]),
            ("latency_seconds", "gauge",
             "Per-link hop latency (worst observation from either "
             "endpoint)",
             [(label, round(obs.latency_s, 6)) for label, obs in labeled]),
            ("verdict", "gauge",
             "Graded link verdict (-1 failed, 0 degraded, 1 ok)",
             [(label, link_verdict_value(obs.verdict)) for label, obs in labeled]),
        ])
        return per_link + render_rows(_LINK_PREFIX, "", [
            ("links", "gauge",
             "Links in the folded fleet topology", len(topology)),
            ("sick_links", "gauge",
             "Links grading degraded or failed",
             sum(1 for obs in topology.values() if obs.verdict != LINK_OK)),
            ("hop_latency_seconds", "histogram",
             "Per-hop link latencies reported through NodeHealthReports",
             self._latency.snapshot()),
        ])
