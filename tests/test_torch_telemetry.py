"""The port's NodeHealthReport contract against the JAX package's.

Seeded observations (checks, metrics, per-hop link maps, prior history and
link windows) go through the JAX and the port's ``make_node_health_report``,
``parse_node_health`` and ``fold_link_topology``: the documents, the parsed
views and the folds must be equal. ``grade_link`` is held band by band.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from k8s_operator_libs_tpu.api import telemetry_v1alpha1 as jax_tel
from k8s_operator_libs_tpu_torch.api import telemetry_v1alpha1 as port

NODES = [f"gpu-{i}" for i in range(5)]
CHECKS = ("psum", "all_gather", "reduce_scatter", "ppermute_ring", "mxu", "burnin", "links")
METRICS = (
    port.METRIC_RING_GBYTES_PER_S,
    port.METRIC_PROBE_LATENCY_S,
    port.METRIC_TOKENS_PER_S,
    port.METRIC_MXU_TFLOPS,
    port.METRIC_WORST_LINK_GBYTES_PER_S,
)


def _observation(rng, node):
    checks = {k: bool(rng.random() > 0.15) for k in CHECKS if rng.random() > 0.2}
    metrics = {
        k: float(rng.choice([0.0, rng.uniform(0.01, 120.0)]))
        for k in METRICS if rng.random() > 0.3
    }
    links = None
    if rng.random() > 0.25:
        peers = [p for p in NODES + ["device-1", "device-2"] if p != node]
        links = {
            p: {
                "ok": bool(rng.random() > 0.2),
                "latency_s": float(rng.choice([0.0, rng.uniform(1e-5, 4.0)])),
                "gbytes_per_s": float(rng.choice([0.0, rng.uniform(0.5, 80.0)])),
            }
            for p in rng.choice(peers, size=int(rng.integers(0, 4)), replace=False)
        }
    return checks, metrics, links


def _as_dict(health):
    out = dataclasses.asdict(health)
    out["links"] = {p: dataclasses.asdict(link) for p, link in health.links.items()}
    return out


@pytest.mark.parametrize("seed", range(6))
def test_reports_parses_and_folds_equal_jax(seed):
    rng = np.random.default_rng(seed)
    jax_live: dict = {}
    port_live: dict = {}
    for cycle in range(8):
        for node in NODES:
            checks, metrics, links = _observation(rng, node)
            kwargs = dict(
                source="monitor" if cycle % 2 else "quick-probe",
                observed_at=1000.0 + 60.0 * cycle,
                history_window=int(rng.integers(1, 6)),
                link_window=int(rng.integers(1, 5)),
                links=links,
            )
            theirs = jax_tel.make_node_health_report(
                node, checks, metrics,
                history=jax_tel.report_history(jax_live.get(node, {})),
                prior_links=(jax_tel.parse_node_health(jax_live[node]).links
                             if node in jax_live else None),
                **kwargs,
            )
            ours = port.make_node_health_report(
                node, checks, metrics,
                history=port.report_history(port_live.get(node, {})),
                prior_links=(port.parse_node_health(port_live[node]).links
                             if node in port_live else None),
                **kwargs,
            )
            assert ours == theirs
            jax_live[node], port_live[node] = theirs, ours
        jax_health = {n: jax_tel.parse_node_health(raw) for n, raw in jax_live.items()}
        port_health = {n: port.parse_node_health(raw) for n, raw in port_live.items()}
        assert {n: _as_dict(h) for n, h in port_health.items()} == {
            n: _as_dict(h) for n, h in jax_health.items()
        }
        theirs_fold = jax_tel.fold_link_topology(jax_health)
        ours_fold = port.fold_link_topology(port_health)
        assert {k: dataclasses.asdict(v) for k, v in ours_fold.items()} == {
            k: dataclasses.asdict(v) for k, v in theirs_fold.items()
        }
        # The port's fold reads JAX's parsed views as they are.
        assert port.fold_link_topology(jax_health).keys() == theirs_fold.keys()
        for name in NODES:
            worst_ours, worst_theirs = port_health[name].worst_link(), jax_health[name].worst_link()
            assert (worst_ours and dataclasses.asdict(worst_ours)) == (
                worst_theirs and dataclasses.asdict(worst_theirs)
            )
            assert port.raw_link_entries(port_health[name].links) == jax_tel.raw_link_entries(
                jax_health[name].links
            )


def test_malformed_reports_parse_as_jax_does():
    docs = [
        {},
        {"metadata": {"name": "n"}},
        {"metadata": {"name": "n"}, "status": {"score": "x", "trend": "up", "checks": [1]}},
        {"spec": {"nodeName": "n"}, "status": {
            "score": 250, "metrics": {"a": "1.5", "b": "nan?"}, "observedAt": None,
            "links": {"p": {"verdict": "weird", "latencyS": "x"},
                      "q": {"gbytesPerS": 3, "window": [1, "a", 2.5]}, "r": 5},
        }},
    ]
    for doc in docs:
        ours, theirs = port.parse_node_health(doc), jax_tel.parse_node_health(doc)
        assert (ours and _as_dict(ours)) == (theirs and _as_dict(theirs))


def test_contract_constants_equal_jax():
    for name in (
        "NODE_HEALTH_REPORT_KIND", "NODE_HEALTH_REPORT_API_VERSION", "NODE_HEALTH_REPORT_PLURAL",
        "DEFAULT_HISTORY_WINDOW", "DEFAULT_HEALTHY_RING_GBYTES_PER_S", "DEFAULT_LATENCY_BUDGET_S",
        "DEFAULT_HEALTHY_LINK_GBYTES_PER_S", "DEFAULT_LINK_LATENCY_BUDGET_S",
        "DEFAULT_LINK_WINDOW", "LINK_VERDICT_SCORES", "TREND_EPSILON",
        "LINK_OK", "LINK_DEGRADED", "LINK_FAILED",
    ):
        assert getattr(port, name) == getattr(jax_tel, name), name


@pytest.mark.parametrize(
    "ok,latency_s,gbytes_per_s,expected",
    [
        (False, 0.001, 40.0, "failed"),
        (False, 0.0, 0.0, "failed"),
        (True, 0.0, 0.0, "ok"),  # no timing taken: not a sick link
        (True, 0.001, 40.0, "ok"),
        (True, 0.001, 20.0, "ok"),  # exactly half the healthy rate
        (True, 0.001, 19.99, "degraded"),  # below half
        (True, 2.0, 40.0, "ok"),  # exactly twice the latency budget
        (True, 2.01, 40.0, "degraded"),  # above it
        (True, 5.0, 1.0, "degraded"),
    ],
    ids=["failed", "failed-untimed", "untimed", "healthy", "half-rate", "slow",
         "twice-budget", "late", "slow-and-late"],
)
def test_grade_link_bands(ok, latency_s, gbytes_per_s, expected):
    assert port.grade_link(ok, latency_s, gbytes_per_s) == expected
    assert jax_tel.grade_link(ok, latency_s, gbytes_per_s) == expected


def test_derive_trend_and_value_equal_jax():
    rng = np.random.default_rng(11)
    for _ in range(50):
        scores = list(rng.uniform(0, 100, size=int(rng.integers(0, 10))))
        assert port.derive_trend(scores) == jax_tel.derive_trend(scores)
    for trend in ("improving", "stable", "degrading", "other"):
        assert port.trend_value(trend) == jax_tel.trend_value(trend)
