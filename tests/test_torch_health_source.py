"""The port's health telemetry read side against the JAX package's.

Reports are published into the JAX package's in-memory cluster by the JAX
``ReportPublisher``. The JAX ``HealthSource`` reads them from the cluster
itself; the port's reads them through the port's ``RestClient`` and a
``LocalApiServer`` serving the same cluster. Compared on equal inputs:

* the seven contract functions the arc reads
  (``api/telemetry_v1alpha1.py``: ``link_verdict_value``, ``sicker_link``,
  ``node_link_scores``, ``effective_scores``, ``effective_node_score``,
  ``sick_links_from_topology``, ``sick_links_for``) on report documents
  drawn from a seeded ``numpy`` generator: scores, verdicts, link maps and
  nodes that appear only as a peer;
* ``TestHealthSource`` and ``TestHealthMetricsEndpoint`` of
  ``tests/test_telemetry.py``, and its ``TestDegradedFirstPlanning`` case
  that goes through ``with_health_telemetry``: the JAX machine and the
  port's, each with the port's ``enable_slice_aware_planning``, on twin
  GPU pools, start the same nodes;
* ``TestLinkMetricsDedup`` and ``TestPlannerLinkLocalization`` of
  ``tests/test_link_health.py``;
* ``TestHistogram``, ``test_merge_label_escapes`` and ``TestLinkFamily``
  of ``tests/test_metrics.py``, on the rendered text;
* the requestor's ``NodeMaintenance.spec.nodeHealth``, ``worstLinks``
  included, written by each machine from its own health source.

``TestFleetLinkFold`` and ``TestFleetMetricsFamily`` of
``tests/test_link_health.py`` need the fleet tier, which waits for
ROADMAP A18.
"""

from __future__ import annotations

import contextlib
import urllib.request

import numpy as np
import pytest

from builders import make_node
from k8s_operator_libs_tpu.api import telemetry_v1alpha1 as jax_tel
from k8s_operator_libs_tpu.api import DriverUpgradePolicySpec as JaxPolicy
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube import Pod as JaxPod
from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator
from k8s_operator_libs_tpu.tpu import planner as jax_planner
from k8s_operator_libs_tpu.tpu.detector import TpuNodeDetector as JaxDetector
from k8s_operator_libs_tpu.tpu.monitor import ReportPublisher
from k8s_operator_libs_tpu.upgrade import ClusterUpgradeState as JaxClusterUpgradeState
from k8s_operator_libs_tpu.upgrade import ClusterUpgradeStateManager as JaxManager
from k8s_operator_libs_tpu.upgrade import DeviceClass as JaxDeviceClass
from k8s_operator_libs_tpu.upgrade import HealthMetrics as JaxHealthMetrics
from k8s_operator_libs_tpu.upgrade import HealthSource as JaxHealthSource
from k8s_operator_libs_tpu.upgrade import LinkMetrics as JaxLinkMetrics
from k8s_operator_libs_tpu.upgrade import NodeUpgradeState as JaxNodeUpgradeState
from k8s_operator_libs_tpu.upgrade import RequestorOptions as JaxOptions
from k8s_operator_libs_tpu.upgrade import TaskRunner as JaxRunner
from k8s_operator_libs_tpu.upgrade import UpgradeState as JaxState
from k8s_operator_libs_tpu.upgrade import enable_requestor_mode as jax_enable_requestor
from k8s_operator_libs_tpu.upgrade import metrics as jax_metrics
from k8s_operator_libs_tpu_torch.api import telemetry_v1alpha1 as tel
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from k8s_operator_libs_tpu_torch.kube.objects import Node, Pod
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.parallel.topology import (
    GPU_CLIQUE_LABEL,
    GPU_COUNT_LABEL,
    GPU_PRESENT_LABEL,
    GPU_PRODUCT_LABEL,
)
from k8s_operator_libs_tpu_torch.tpu import planner
from k8s_operator_libs_tpu_torch.tpu.detector import TpuNodeDetector
from k8s_operator_libs_tpu_torch.upgrade import (
    ClusterUpgradeState,
    ClusterUpgradeStateManager,
    DeviceClass,
    HealthMetrics,
    HealthSource,
    LinkMetrics,
    NodeUpgradeState,
    RequestorOptions,
    TaskRunner,
    UpgradeKeys,
    UpgradeState,
    enable_requestor_mode,
)
from k8s_operator_libs_tpu_torch.upgrade import metrics
from k8s_operator_libs_tpu_torch.upgrade.metrics import MetricsServer
from test_informer import wait_until

NS = "driver-ns"
LABELS = {"app": "driver"}
MAINT_NS = "maintenance-ns"
KEYS = UpgradeKeys(DeviceClass.nvidia("gpu"))
SICK = {"ok": True, "latency_s": 5.0, "gbytes_per_s": 1.0}
HEALTHY = {"ok": True, "latency_s": 0.001, "gbytes_per_s": 42.0}


@pytest.fixture
def served():
    """``served(cluster)``: the port's REST client of a ``LocalApiServer``
    serving ``cluster``, stopped at the test's end."""
    with contextlib.ExitStack() as stack:
        def serve(cluster):
            server = stack.enter_context(LocalApiServer(cluster=cluster))
            return RestClient(RestConfig(server=server.url))

        yield serve


@pytest.fixture
def sources(served):
    """``sources(cluster)``: the JAX source over ``cluster`` and the port's
    over its REST client, both stopped at the test's end."""
    started = []

    def make(cluster):
        pair = JaxHealthSource(cluster), HealthSource(served(cluster))
        started.extend(pair)
        return pair

    yield make
    for source in started:
        source.stop()


def health_view(node_health) -> dict:
    """A health map as plain values: score, trend, checks, links."""
    return {
        name: (h.score, h.trend, dict(h.checks), sorted(
            (peer, link.latency_s, link.gbytes_per_s, link.verdict, tuple(link.window))
            for peer, link in h.links.items()
        ))
        for name, h in node_health.items()
    }


# ----------------------------------------------------------------------
# The contract functions on seeded documents
# ----------------------------------------------------------------------

VERDICTS = (tel.LINK_OK, tel.LINK_DEGRADED, tel.LINK_FAILED, "gibberish")


def seeded_reports(seed: int) -> list[dict]:
    """Report documents: nodes ``n0..n5`` (some without a report), each
    report's checks, ring rate and latency, and a link map to other nodes
    (reported or not) and device tags, with hops ok, slow, failed or
    untimed."""
    rng = np.random.default_rng(seed)
    names = [f"n{i}" for i in range(6)]
    reports = []
    for name in names[: int(rng.integers(2, 6))]:
        checks = {f"c{j}": bool(rng.random() < 0.8) for j in range(int(rng.integers(0, 4)))}
        metrics = {}
        if rng.random() < 0.7:
            metrics["ring_gbytes_per_s"] = float(rng.uniform(0.5, 60.0))
        if rng.random() < 0.7:
            metrics["probe_latency_s"] = float(rng.uniform(0.1, 90.0))
        peers = [p for p in names if p != name] + ["device-0", "device-1"]
        links = {}
        for peer in rng.choice(peers, size=int(rng.integers(0, 4)), replace=False):
            kind = int(rng.integers(4))
            links[str(peer)] = {
                "ok": kind != 2,
                "latency_s": 0.0 if kind == 3 else float(rng.choice([1e-3, 3.0])),
                "gbytes_per_s": 0.0 if kind == 3 else float(rng.choice([1.0, 42.0])),
            }
        reports.append(jax_tel.make_node_health_report(
            name, checks, metrics, links=links if links or rng.random() < 0.5 else None,
        ))
    return reports


@pytest.mark.parametrize("seed", range(6))
def test_contract_functions_equal_jax_on_seeded_reports(seed):
    reports = seeded_reports(seed)
    ours = {r["metadata"]["name"]: tel.parse_node_health(r) for r in reports}
    theirs = {r["metadata"]["name"]: jax_tel.parse_node_health(r) for r in reports}
    assert health_view(ours) == health_view(theirs)
    topo, jax_topo = tel.fold_link_topology(ours), jax_tel.fold_link_topology(theirs)
    assert tel.node_link_scores(topo) == jax_tel.node_link_scores(jax_topo)
    scores = tel.effective_scores(ours)
    assert scores == jax_tel.effective_scores(theirs)
    names = sorted(set(scores) | {"absent"})
    for name in names:
        assert tel.effective_node_score(name, ours) == jax_tel.effective_node_score(name, theirs)
        assert tel.sick_links_from_topology(name, topo) == jax_tel.sick_links_from_topology(
            name, jax_topo
        )
        assert tel.sick_links_for(name, ours) == jax_tel.sick_links_for(name, theirs)
    # A peer without a report of its own still has an effective score.
    peers_only = {obs.b for obs in topo.values()} | {obs.a for obs in topo.values()}
    for name in peers_only - set(ours):
        assert scores[name] == tel.node_link_scores(topo)[name]
    assert tel.effective_node_score("absent", ours) is None


@pytest.mark.parametrize("seed", range(3))
def test_verdict_values_and_sicker_link_equal_jax(seed):
    rng = np.random.default_rng(100 + seed)
    for verdict in VERDICTS:
        assert tel.link_verdict_value(verdict) == jax_tel.link_verdict_value(verdict)
    for _ in range(40):
        fields = [
            dict(peer="p", latency_s=float(rng.uniform(0, 2)),
                 gbytes_per_s=float(rng.choice([0.0, 1.0, 20.0, 42.0])),
                 verdict=str(rng.choice(VERDICTS[:3])), window=(1.0,))
            for _ in range(2)
        ]
        ours = tel.sicker_link(tel.LinkHealth(**fields[0]), tel.LinkHealth(**fields[1]))
        theirs = jax_tel.sicker_link(jax_tel.LinkHealth(**fields[0]),
                                     jax_tel.LinkHealth(**fields[1]))
        assert ours.__dict__ == theirs.__dict__


# ----------------------------------------------------------------------
# TestHealthSource (tests/test_telemetry.py)
# ----------------------------------------------------------------------


def make_harness(served, nodes=4):
    """The JAX tests' ``make_harness``, and the port's machine over the REST
    client of the same cluster."""
    cluster = FakeCluster()
    for i in range(nodes):
        cluster.create(make_node(f"node-{i}"))
    sim = DaemonSetSimulator(cluster, name="driver", namespace=NS, match_labels=LABELS)
    sim.settle()
    mgr = ClusterUpgradeStateManager(served(cluster), DeviceClass.nvidia("gpu"),
                                     runner=TaskRunner(inline=True))
    return cluster, sim, mgr


def test_snapshot_tracks_events_and_memoizes(sources):
    cluster = FakeCluster()
    pub = ReportPublisher(cluster, "node-1", heartbeat_seconds=0.0)
    pub.publish({"a": True}, {})
    jax_source, source = sources(cluster)
    for src in (jax_source, source):
        src.start()
    assert wait_until(lambda: "node-1" in source.snapshot())
    first = source.snapshot()
    assert source.snapshot() is first  # no event: the same object
    pub.publish({"a": False}, {})
    assert wait_until(
        lambda: source.snapshot().get("node-1") is not None
        and not source.snapshot()["node-1"].checks["a"]
    )
    assert source.snapshot() is not first
    assert wait_until(lambda: jax_source.updates == source.updates)
    assert health_view(source.snapshot()) == health_view(jax_source.snapshot())
    cluster.delete("NodeHealthReport", "node-1")
    assert wait_until(lambda: "node-1" not in source.snapshot())
    assert wait_until(lambda: jax_source.updates == source.updates)


def test_build_state_attaches_health(served):
    cluster, sim, mgr = make_harness(served)
    ReportPublisher(cluster, "node-2", heartbeat_seconds=0.0).publish(
        {"a": False}, {"ring_gbytes_per_s": 1.0}
    )
    jax_mgr = JaxManager(cluster, JaxDeviceClass.nvidia("gpu"), runner=JaxRunner(inline=True))
    with contextlib.ExitStack() as stack:
        for m in (mgr, jax_mgr):
            stack.callback(m.with_health_telemetry().stop)
        state, jax_state = mgr.build_state(NS, LABELS), jax_mgr.build_state(NS, LABELS)
    assert state.node_health is not None
    assert state.health_of("node-2").score < 50.0
    assert state.health_of("node-0") is None
    assert health_view(state.node_health) == health_view(jax_state.node_health)


def test_no_telemetry_pool_has_no_health(served):
    _, _, mgr = make_harness(served, nodes=2)
    state = mgr.build_state(NS, LABELS)
    assert state.node_health is None
    assert state.health_of("node-0") is None
    assert mgr.health_source is None


def test_unported_wirings_name_their_roadmap_items(served):
    source = HealthSource(served(FakeCluster()))
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        source.attach(object())
    with pytest.raises(NotImplementedError, match="ROADMAP A18"):
        HealthSource(served(FakeCluster()), watch_hub=object())


# ----------------------------------------------------------------------
# TestHealthMetricsEndpoint (tests/test_telemetry.py)
# ----------------------------------------------------------------------

QUARANTINE_TOTALS = {
    "in_quarantine": 1, "entered": 2, "released": 1, "handed_off": 0, "budget_denied": 3,
}


def test_family_served_with_histogram(sources):
    cluster = FakeCluster()
    for name, latency in (("node-0", 0.3), ("node-1", 45.0)):
        ReportPublisher(cluster, name, heartbeat_seconds=0.0).publish(
            {"a": name == "node-0"}, {"probe_latency_s": latency}
        )
    jax_source, source = sources(cluster)
    jax_family = JaxHealthMetrics(jax_source, quarantine_totals=lambda: QUARANTINE_TOTALS)
    family = HealthMetrics(source, quarantine_totals=lambda: QUARANTINE_TOTALS)
    for src in (jax_source, source):
        src.start()
    assert wait_until(lambda: len(source.snapshot()) == 2 == len(jax_source.snapshot()))
    with MetricsServer(family) as server:
        body = urllib.request.urlopen(server.url, timeout=5).read().decode()
    assert body == jax_family.render()
    assert 'tpu_operator_health_score{node="node-0"} 100.0' in body
    assert 'tpu_operator_health_trend{node="node-1"} 0' in body
    assert "tpu_operator_health_reported_nodes 2" in body
    assert "# TYPE tpu_operator_health_probe_latency_seconds histogram" in body
    assert 'tpu_operator_health_probe_latency_seconds_bucket{le="0.5"} 1' in body
    assert 'tpu_operator_health_probe_latency_seconds_bucket{le="+Inf"} 2' in body
    assert "tpu_operator_health_probe_latency_seconds_count 2" in body
    assert "tpu_operator_health_quarantined_nodes 1" in body
    assert "tpu_operator_health_quarantine_entries_total 2" in body
    assert "tpu_operator_health_quarantine_budget_denials_total 3" in body


# ----------------------------------------------------------------------
# Degraded-first and link-localized planning through with_health_telemetry
# ----------------------------------------------------------------------

POOLS = ("pool-a", "pool-b", "pool-c")


def gpu_pool() -> tuple:
    """Three NVLink domains of two GPU nodes each (the JAX tests' three node
    pools of two TPU hosts), the driver settled on them."""
    cluster = FakeCluster()
    for pool in POOLS:
        for i in range(2):
            cluster.create(make_node(f"{pool}-{i}", labels={
                GPU_PRESENT_LABEL: "true", GPU_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3",
                GPU_COUNT_LABEL: "8", GPU_CLIQUE_LABEL: pool,
            }))
    sim = DaemonSetSimulator(cluster, name="driver", namespace=NS, match_labels=LABELS)
    sim.settle()
    return cluster, sim


def planned_roll(served, publish) -> dict:
    """The same pool and reports for the JAX machine and the port's, each
    with the port's slice planner and its own health source; the rollout
    lands and two passes run. Each machine's node states."""
    policy = {"autoUpgrade": True, "maxParallelUpgrades": 1, "maxUnavailable": 1}
    out = {}
    for machine in ("jax", "port"):
        cluster, sim = gpu_pool()
        publish(cluster)
        if machine == "jax":
            mgr = JaxManager(cluster, JaxDeviceClass.nvidia("gpu"), runner=JaxRunner(inline=True))
            pol = JaxPolicy.from_dict(policy)
        else:
            mgr = ClusterUpgradeStateManager(served(cluster), DeviceClass.nvidia("gpu"),
                                             runner=TaskRunner(inline=True))
            pol = DriverUpgradePolicySpec.from_dict(policy)
        planner.enable_slice_aware_planning(mgr)
        source = mgr.with_health_telemetry()
        try:
            sim.set_template_hash("rev-2")
            for _ in range(2):
                mgr.apply_state(mgr.build_state(NS, LABELS), pol)
        finally:
            source.stop()
        out[machine] = {n.name: n.labels.get(KEYS.state_label, "") for n in cluster.list("Node")}
    assert out["port"] == out["jax"]
    return out["port"]


def publish(cluster, node, links=None, score_bad=False) -> None:
    """``tests/test_link_health.py``'s ``publish``."""
    metrics = (
        {"ring_gbytes_per_s": 1.0, "probe_latency_s": 120.0}
        if score_bad
        else {"ring_gbytes_per_s": 45.0, "probe_latency_s": 2.0}
    )
    ReportPublisher(cluster, node, heartbeat_seconds=0.0).publish(
        {"ring_allreduce": not score_bad}, metrics, links=links
    )


def test_worst_score_slice_rolls_first(served):
    def reports(cluster):
        # pool-c the straggler (worst), pool-b mildly degraded.
        ReportPublisher(cluster, "pool-c-0", heartbeat_seconds=0.0).publish(
            {"ring_allreduce": False}, {"ring_gbytes_per_s": 1.0}
        )
        ReportPublisher(cluster, "pool-b-1", heartbeat_seconds=0.0).publish(
            {"ring_allreduce": True}, {"ring_gbytes_per_s": 20.0}
        )

    states = planned_roll(served, reports)
    assert states["pool-c-0"] == "cordon-required"
    assert states["pool-c-1"] == "cordon-required"
    assert states["pool-a-0"] == "upgrade-required"
    assert states["pool-b-0"] == "upgrade-required"


def test_sick_link_slice_rolls_first_despite_equal_aggregates(served):
    def reports(cluster):
        # Every node equally healthy; only pool-c-0 reports a degraded link
        # to pool-c-1.
        for pool in POOLS:
            for i in range(2):
                name = f"{pool}-{i}"
                links = ({"pool-c-1": dict(SICK)} if name == "pool-c-0"
                         else {f"{pool}-{1 - i}": dict(HEALTHY)})
                publish(cluster, name, links=links)

    states = planned_roll(served, reports)
    assert states["pool-c-0"] == "cordon-required"
    assert states["pool-c-1"] == "cordon-required"
    assert states["pool-a-0"] == "upgrade-required"
    assert states["pool-b-0"] == "upgrade-required"


def test_cross_slice_link_degrades_both_slices():
    names = ("pool-a-0", "pool-b-0", "pool-c-0")
    raw = jax_tel.make_node_health_report("pool-a-0", {}, {}, links={"pool-b-0": dict(SICK)})
    state, jax_state = ClusterUpgradeState(), JaxClusterUpgradeState()
    for name in names:
        state.node_states[UpgradeState.DONE].append(NodeUpgradeState(
            node=Node.new(name), driver_pod=Pod.new(f"driver-{name}", namespace=NS),
            driver_daemonset=None,
        ))
        jax_state.node_states[JaxState.DONE].append(JaxNodeUpgradeState(
            node=make_node(name), driver_pod=JaxPod.new(f"driver-{name}", namespace=NS),
            driver_daemonset=None,
        ))
    state.node_health = {"pool-a-0": tel.parse_node_health(raw)}
    jax_state.node_health = {"pool-a-0": jax_tel.parse_node_health(raw)}
    out = planner.assess_slices(TpuNodeDetector(), state)
    theirs = jax_planner.assess_slices(JaxDetector(), jax_state)
    for name in names:
        assert out.effective_score(name) == theirs.effective_score(name)
    assert out.worst_links == theirs.worst_links
    assert out.effective_score("pool-a-0") == 40.0
    assert out.effective_score("pool-b-0") == 40.0
    assert out.effective_score("pool-c-0") == 100.0
    assert out.worst_links["pool-b-0"] == tel.link_key("pool-a-0", "pool-b-0")


def test_no_link_maps_is_byte_identical_old_ordering():
    ours = planner.SliceAssessment(candidates={"a": [], "b": []}, scores={"a": 50.0})
    theirs = jax_planner.SliceAssessment(candidates={"a": [], "b": []}, scores={"a": 50.0})
    for a in (ours, theirs):
        assert a.effective_score("a") == 50.0
        assert a.effective_score("b") == 100.0
        assert a.link_scores == {}
    assert [s for s, _ in ours.ordered_candidates()] == [
        s for s, _ in theirs.ordered_candidates()
    ]


# ----------------------------------------------------------------------
# TestLinkMetricsDedup (tests/test_link_health.py)
# ----------------------------------------------------------------------


def test_carried_forward_map_is_not_reobserved(sources):
    """A publish without a link probe carries the map forward; the informer
    delivers it again, but the histogram counts each measurement once."""
    cluster = FakeCluster()
    pub = ReportPublisher(cluster, "a", heartbeat_seconds=0.0)
    jax_source, source = sources(cluster)
    jax_family, family = JaxLinkMetrics(jax_source), LinkMetrics(source)
    for src in (jax_source, source):
        src.start()
    assert pub.publish({"x": True}, {}, links={"b": dict(SICK)})
    assert pub.publish({"x": False}, {}, links=None)  # carried forward
    assert pub.publish({"x": True}, {}, links=None)  # carried forward
    assert wait_until(lambda: source.updates >= 3 and jax_source.updates == source.updates)
    assert family._latency.snapshot()["count"] == 1
    assert pub.publish({"x": True}, {}, links={"b": {"ok": True, "latency_s": 4.0,
                                                      "gbytes_per_s": 1.5}})
    assert wait_until(lambda: family._latency.snapshot()["count"] == 2)
    assert wait_until(lambda: jax_source.updates == source.updates)
    assert family.render() == jax_family.render()


# ----------------------------------------------------------------------
# TestHistogram, test_merge_label_escapes, TestLinkFamily (tests/test_metrics.py)
# ----------------------------------------------------------------------


def _histogram_text(module, buckets, values, label) -> str:
    hist = module.Histogram(buckets=buckets)
    for v in values:
        hist.observe(v)
    return module.render_rows(
        "tpu_operator_health", label,
        [("probe_latency_seconds", "histogram", "Probe latency", hist.snapshot())],
    )


def test_exposition_format():
    values = (0.1, 0.7, 0.7, 3.0, 99.0)
    text = _histogram_text(metrics, (0.5, 1.0, 5.0), values, metrics.prom_label("node", "n1"))
    assert text == _histogram_text(jax_metrics, (0.5, 1.0, 5.0), values,
                                   jax_metrics.prom_label("node", "n1"))
    name = "tpu_operator_health_probe_latency_seconds"
    assert text.strip().splitlines() == [
        f"# HELP {name} Probe latency",
        f"# TYPE {name} histogram",
        f'{name}_bucket{{node="n1",le="0.5"}} 1',
        f'{name}_bucket{{node="n1",le="1"}} 3',
        f'{name}_bucket{{node="n1",le="5"}} 4',
        f'{name}_bucket{{node="n1",le="+Inf"}} 5',
        f'{name}_sum{{node="n1"}} 103.5',
        f'{name}_count{{node="n1"}} 5',
    ]


def test_empty_histogram_and_no_label():
    texts = [
        m.render_rows("t", "", [("h", "histogram", "x", m.Histogram((1.0,)).snapshot())])
        for m in (metrics, jax_metrics)
    ]
    assert texts[0] == texts[1]
    assert 't_h_bucket{le="1"} 0' in texts[0]
    assert 't_h_bucket{le="+Inf"} 0' in texts[0]
    assert "t_h_sum 0.0" in texts[0]
    assert "t_h_count 0" in texts[0]


def test_merge_label_escapes():
    label = metrics.prom_label("node", 'a"b')
    assert metrics.merge_label(label, "le", "0.5") == '{node="a\\"b",le="0.5"}'
    assert metrics.merge_label("", "le", "+Inf") == '{le="+Inf"}'
    for args in ((label, "le", "0.5"), ("", "le", "+Inf"), (label, 'q"', 'x\ny\\')):
        assert metrics.merge_label(*args) == jax_metrics.merge_label(*args)


def test_exposition_pinned_byte_exact(sources):
    cluster = FakeCluster()
    # One report, two links: a degraded hop to another node and a healthy
    # hop within the node, published before the sources start so that the
    # first list delivers one observation a link.
    ReportPublisher(cluster, "a", heartbeat_seconds=0.0).publish(
        {"ring_allreduce": True}, {},
        links={
            "b": {"ok": True, "latency_s": 5.0, "gbytes_per_s": 1.0},
            "device-2": {"ok": True, "latency_s": 0.001, "gbytes_per_s": 42.0},
        },
    )
    jax_source, source = sources(cluster)
    jax_family, family = JaxLinkMetrics(jax_source), LinkMetrics(source)
    for src in (jax_source, source):
        src.start()
    text = family.render()
    assert text == jax_family.render()
    assert text == (
        "# HELP tpu_operator_link_gbytes_per_s Per-link bandwidth "
        "(worst observation from either endpoint of the folded "
        "topology)\n"
        "# TYPE tpu_operator_link_gbytes_per_s gauge\n"
        'tpu_operator_link_gbytes_per_s{a="a",b="b"} 1.0\n'
        'tpu_operator_link_gbytes_per_s{a="a",b="device-2"} 42.0\n'
        "# HELP tpu_operator_link_latency_seconds Per-link hop "
        "latency (worst observation from either endpoint)\n"
        "# TYPE tpu_operator_link_latency_seconds gauge\n"
        'tpu_operator_link_latency_seconds{a="a",b="b"} 5.0\n'
        'tpu_operator_link_latency_seconds{a="a",b="device-2"} 0.001\n'
        "# HELP tpu_operator_link_verdict Graded link verdict "
        "(-1 failed, 0 degraded, 1 ok)\n"
        "# TYPE tpu_operator_link_verdict gauge\n"
        'tpu_operator_link_verdict{a="a",b="b"} 0\n'
        'tpu_operator_link_verdict{a="a",b="device-2"} 1\n'
        "# HELP tpu_operator_link_links Links in the folded fleet "
        "topology\n"
        "# TYPE tpu_operator_link_links gauge\n"
        "tpu_operator_link_links 2\n"
        "# HELP tpu_operator_link_sick_links Links grading degraded "
        "or failed\n"
        "# TYPE tpu_operator_link_sick_links gauge\n"
        "tpu_operator_link_sick_links 1\n"
        "# HELP tpu_operator_link_hop_latency_seconds Per-hop link "
        "latencies reported through NodeHealthReports\n"
        "# TYPE tpu_operator_link_hop_latency_seconds histogram\n"
        'tpu_operator_link_hop_latency_seconds_bucket{le="0.0001"} 0\n'
        'tpu_operator_link_hop_latency_seconds_bucket{le="0.00025"} 0\n'
        'tpu_operator_link_hop_latency_seconds_bucket{le="0.0005"} 0\n'
        'tpu_operator_link_hop_latency_seconds_bucket{le="0.001"} 1\n'
        'tpu_operator_link_hop_latency_seconds_bucket{le="0.0025"} 1\n'
        'tpu_operator_link_hop_latency_seconds_bucket{le="0.005"} 1\n'
        'tpu_operator_link_hop_latency_seconds_bucket{le="0.01"} 1\n'
        'tpu_operator_link_hop_latency_seconds_bucket{le="0.05"} 1\n'
        'tpu_operator_link_hop_latency_seconds_bucket{le="0.1"} 1\n'
        'tpu_operator_link_hop_latency_seconds_bucket{le="0.5"} 1\n'
        'tpu_operator_link_hop_latency_seconds_bucket{le="1"} 1\n'
        'tpu_operator_link_hop_latency_seconds_bucket{le="5"} 2\n'
        'tpu_operator_link_hop_latency_seconds_bucket{le="+Inf"} 2\n'
        "tpu_operator_link_hop_latency_seconds_sum 5.001\n"
        "tpu_operator_link_hop_latency_seconds_count 2\n"
    )


# ----------------------------------------------------------------------
# The requestor's nodeHealth, from each machine's own health source
# ----------------------------------------------------------------------


def test_node_maintenance_carries_the_same_worst_links_as_jax(served):
    """node-0 reports a sick link to node-1, which never reports, and node-2
    a degraded score: each machine's NodeMaintenance objects carry the same
    ``spec.nodeHealth``, node-1's ``worstLinks`` (a link only its peer
    reported) included."""
    policy = {"autoUpgrade": True, "maxParallelUpgrades": 0, "maxUnavailable": "100%"}
    specs = {}
    for machine in ("jax", "port"):
        cluster = FakeCluster()
        for i in range(4):
            cluster.create(make_node(f"node-{i}"))
        sim = DaemonSetSimulator(cluster, name="driver", namespace=NS, match_labels=LABELS)
        sim.settle()
        publish(cluster, "node-0", links={"node-1": dict(SICK), "device-1": dict(HEALTHY)})
        publish(cluster, "node-2", score_bad=True)
        if machine == "jax":
            mgr = JaxManager(cluster, JaxDeviceClass.nvidia("gpu"), runner=JaxRunner(inline=True))
            jax_enable_requestor(mgr, JaxOptions(use_maintenance_operator=True,
                                                 namespace=MAINT_NS))
            pol = JaxPolicy.from_dict(policy)
        else:
            mgr = ClusterUpgradeStateManager(served(cluster), DeviceClass.nvidia("gpu"),
                                             runner=TaskRunner(inline=True))
            enable_requestor_mode(mgr, RequestorOptions(use_maintenance_operator=True,
                                                        namespace=MAINT_NS))
            pol = DriverUpgradePolicySpec.from_dict(policy)
        source = mgr.with_health_telemetry()
        try:
            sim.set_template_hash("rev-2")
            for _ in range(3):
                sim.step()
                mgr.apply_state(mgr.build_state(NS, LABELS), pol)
        finally:
            source.stop()
        specs[machine] = {
            o.raw["spec"]["nodeName"]: o.raw["spec"].get("nodeHealth")
            for o in cluster.list("NodeMaintenance", MAINT_NS)
        }
    assert specs["port"] == specs["jax"]
    assert sorted(specs["port"]) == [f"node-{i}" for i in range(4)]
    assert specs["port"]["node-1"] == {
        "worstLinks": [{"peer": "node-0", "verdict": "degraded", "gbytesPerS": 1.0,
                        "latencyS": 5.0}],
    }
    assert specs["port"]["node-0"]["worstLinks"][0]["peer"] == "node-1"
    assert specs["port"]["node-2"]["score"] < 50.0
    assert specs["port"]["node-3"] is None
