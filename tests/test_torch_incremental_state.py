"""The port's incremental reconcile, held case by case against the JAX
package's.

Each case of ``tests/test_incremental_state.py`` runs on twin clusters
(``torch_twins.Side``): the JAX machine over one ``FakeCluster``, the
port's over its ``RestClient`` and a ``LocalApiServer`` serving the other,
each with ``with_snapshot_from_informers(..., incremental=True)``. The
JAX case's assertions hold on both sides, and the sides are compared
exactly: the classification each incremental book serves (bucket, pod,
owned or not, by node), ``PassStats`` (reads, writes, the incremental
flags and counts), the client calls a settled pass makes (the serving
cluster's call log records the port's HTTP requests), and every node's
upgrade labels, annotations and cordon bit.

``TestEquivalenceFuzzer`` keeps the JAX file's seeds: each step is drawn
once and done to both clusters, and after it the port's incremental
machine must classify as the port's full rebuild (the LIST source over
the same client) and as the JAX incremental machine, which must classify
as the JAX full rebuild. The hub-fed seeds run each side's informers on
its own package's ``WatchHub`` (the port's over its ``RestClient``). The
roll cases compare each node's state-label sequence, as
each cluster's journal saw it, with the JAX machine's full-rebuild roll.
"""

from __future__ import annotations

import contextlib
import random
import threading

import pytest

from builders import make_node, make_pod
from k8s_operator_libs_tpu.api import effective_scores as jax_effective_scores
from k8s_operator_libs_tpu.kube.sim import CheckpointingWorkloadSimulator
from k8s_operator_libs_tpu.tpu.monitor import ReportPublisher
from k8s_operator_libs_tpu_torch.api.telemetry_v1alpha1 import effective_scores
from torch_twins import (
    KEYS,
    LABELS,
    NS,
    STAT_FIELDS,
    Side,
    deliveries_caught_up,
    node_view,
    pass_stats,
    state_shape,
    stores_caught_up,
    wait_until,
)

#: Calls a settled pass must not make.
TRAFFIC = ("get", "list", "patch", "update", "create")


@pytest.fixture
def sides():
    with contextlib.ExitStack() as stack:
        yield lambda **kw: {name: Side(name, stack, **kw) for name in ("jax", "port")}


def incremental(side, verify_every_n=0, width=None, runner=None, batch_writes=False,
                watch_hub=None):
    up = side.pkg.upgrade
    options = None
    if width or batch_writes:
        options = up.StateOptions(apply_width=width or up.StateOptions().apply_width,
                                  batch_writes=batch_writes)
    mgr = side.manager(runner=runner, options=options)
    kwargs = {"watch_hub": watch_hub} if watch_hub is not None else {}
    source = mgr.with_snapshot_from_informers(
        NS, LABELS, resync_period_s=0.0, incremental=True, verify_every_n=verify_every_n,
        **kwargs,
    )
    side.stack.callback(source.stop)
    return mgr, source


def own_hub(side):
    """A ``WatchHub`` of the side's own package over the side's client,
    stopped with the side."""
    hub = side.pkg.WatchHub(side.client)
    side.stack.callback(hub.stop)
    return hub


def full(side, width=None, runner=None):
    up = side.pkg.upgrade
    options = up.StateOptions(apply_width=width) if width else None
    return side.manager(runner=runner, options=options)


def build_shape(side, mgr):
    try:
        return state_shape(mgr.build_state(NS, LABELS))
    except side.pkg.upgrade.BuildStateError:
        return "BUILD_STATE_ERROR"


def settle(side, mgr, source, passes=4):
    """build and apply until the pool makes no more deltas."""
    for _ in range(passes):
        side.sim.step()
        assert wait_until(lambda: stores_caught_up(source, side.cluster))
        try:
            mgr.apply_state(mgr.build_state(NS, LABELS), side.pkg.policy)
        except side.pkg.upgrade.BuildStateError:
            continue
    assert wait_until(lambda: stores_caught_up(source, side.cluster))
    assert wait_until(lambda: not source.dirty().nodes)


def settled(sides, nodes, **kw):
    """Twin pools settled under incremental machines."""
    out = {}
    for name, side in sides(nodes=nodes).items():
        mgr, source = incremental(side, **kw)
        settle(side, mgr, source)
        out[name] = (side, mgr, source)
    return out


def stats_of(mgr) -> dict:
    return pass_stats(mgr.last_pass_stats, *STAT_FIELDS)


# ----------------------------------------------------------------------
# TestEquivalenceFuzzer
# ----------------------------------------------------------------------

STATES = [
    "", "upgrade-done", "upgrade-required", "cordon-required",
    "wait-for-jobs-required", "pod-restart-required",
    "uncordon-required", "upgrade-failed", "validation-required",
]


def fuzz(sides, seed, hub=False, batch_writes=False, steps=50):
    rng = random.Random(seed)
    s = sides(nodes=6)
    machines = {}
    for name, side in s.items():
        watch_hub = None
        if hub:
            watch_hub = own_hub(side)
        mgr_inc, source = incremental(side, batch_writes=batch_writes, watch_hub=watch_hub)
        machines[name] = (mgr_inc, source, full(side))
    extra_nodes: list[str] = []
    rollouts = 0

    def each(fn):
        for side in s.values():
            fn(side)

    def flip_state_label():
        name, value = f"node-{rng.randrange(6)}", rng.choice(STATES)

        def do(side):
            node = side.cluster.get("Node", name)
            if value:
                node.labels[KEYS.state_label] = value
            else:
                node.labels.pop(KEYS.state_label, None)
            side.cluster.update(node)
        each(do)

    def flip_cordon():
        name = f"node-{rng.randrange(6)}"

        def do(side):
            node = side.cluster.get("Node", name)
            node.unschedulable = not node.unschedulable
            side.cluster.update(node)
        each(do)

    def flip_request_annotation():
        name = f"node-{rng.randrange(6)}"

        def do(side):
            node = side.cluster.get("Node", name)
            key = KEYS.upgrade_requested_annotation
            if node.annotations.get(key):
                node.annotations.pop(key)
            else:
                node.annotations[key] = "true"
            side.cluster.update(node)
        each(do)

    def rollout():
        nonlocal rollouts
        rollouts += 1
        each(lambda side: side.sim.set_template_hash(f"v{rollouts}"))

    def kubelet_step():
        each(lambda side: side.sim.step())

    def delete_driver_pod():
        name = f"node-{rng.randrange(6)}"

        def do(side):
            pod = side.cluster.get_or_none("Pod", side.sim.pod_name(name), NS)
            if pod is not None:
                side.cluster.delete("Pod", pod.name, NS)
        each(do)

    def churn_node():
        if extra_nodes and rng.random() < 0.5:
            name = extra_nodes.pop()

            def do(side):
                pod = side.cluster.get_or_none("Pod", side.sim.pod_name(name), NS)
                if pod is not None:
                    side.cluster.delete("Pod", pod.name, NS)
                side.cluster.delete("Node", name)
        else:
            name = f"extra-{len(extra_nodes)}-{seed}"
            extra_nodes.append(name)

            def do(side):
                side.cluster.create(make_node(name))
        each(do)

    def watch_restart():
        for _, source, _ in machines.values():
            source.stop()
            source.start(sync_timeout=30)

    def resync_sweep():
        for _, source, _ in machines.values():
            for kind in ("Node", "Pod", "DaemonSet", "ControllerRevision"):
                source.informer(kind).resync_once()

    def provider_write():
        name, state = f"node-{rng.randrange(6)}", rng.choice(STATES)
        value = rng.choice(["true", "null"])
        for side_name, side in s.items():
            mgr_inc = machines[side_name][0]
            mgr_inc.provider.change_node_state_and_annotations(
                side.node(name), side.pkg.upgrade.UpgradeState(state),
                {KEYS.upgrade_requested_annotation: value},
            )

    ops = [flip_state_label, flip_state_label, flip_cordon, flip_request_annotation, rollout,
           kubelet_step, kubelet_step, delete_driver_pod, churn_node, watch_restart,
           resync_sweep]
    if batch_writes:
        ops += [provider_write, provider_write]
    for step in range(steps):
        rng.choice(ops)()
        shapes = {}
        for name, side in s.items():
            mgr_inc, source, mgr_full = machines[name]
            assert wait_until(lambda: deliveries_caught_up(source, side.cluster)), (
                f"seed={seed} step={step}: the {name} informers never caught up"
            )
            expected = build_shape(side, mgr_full)
            got = build_shape(side, mgr_inc)
            assert got == expected, f"seed={seed} step={step}: {name} incremental diverged"
            shapes[name] = got
        assert shapes["port"] == shapes["jax"], f"seed={seed} step={step}"
        assert node_view(s["port"].cluster) == node_view(s["jax"].cluster)
    if batch_writes:
        for name, (mgr_inc, _, _) in machines.items():
            assert mgr_inc.enable_write_batching().stats()["writes_flushed"] > 0, name


@pytest.mark.parametrize("seed", [7, 1234])
def test_incremental_matches_full_rebuild(sides, seed):
    fuzz(sides, seed)


@pytest.mark.parametrize("seed", [11, 2026])
def test_incremental_matches_full_rebuild_hub_fed(sides, seed):
    """Each side's informers on its own package's shared ``WatchHub``."""
    fuzz(sides, seed, hub=True)


@pytest.mark.parametrize("seed", [5, 3031])
def test_incremental_matches_full_rebuild_batched_writes(sides, seed):
    fuzz(sides, seed, batch_writes=True)


def test_port_rides_its_own_watch_hub(sides):
    """Each side's incremental machine on its own package's ``WatchHub``
    (the port's over its ``RestClient``) rolls each node through the JAX
    full-rebuild roll's state-label sequence, and each hub carries one
    upstream stream a kind for the source's four informers."""
    reference = roll(sides(nodes=4)["jax"], incremental_source=False)
    s = sides(nodes=4)
    hubs = {name: own_hub(side) for name, side in s.items()}
    got = {name: roll(side, True, watch_hub=hubs[name]) for name, side in s.items()}
    assert got["port"] == got["jax"] == reference
    for name, hub in hubs.items():
        stats = hub.stats()
        assert stats["upstream_streams"] == 4, (name, stats)
        assert sorted(scope["kind"] for scope in stats["scopes"].values()) == sorted(
            ("Node", "Pod", "DaemonSet", "ControllerRevision")), name
        assert stats["frames_upstream"] > 0, name


def test_resync_sweep_does_not_dirty_settled_pool(sides):
    for side, mgr, source in settled(sides, 4).values():
        invalidations, events = source.full_invalidations, source.delta_events
        delivered = sum(source.informer(kind).resync_once()
                        for kind in ("Node", "Pod", "DaemonSet", "ControllerRevision"))
        assert delivered == 0, side.name
        delta = source.dirty()
        assert not delta.nodes and not delta.full
        assert source.full_invalidations == invalidations
        assert source.delta_events == events


# ----------------------------------------------------------------------
# TestSettledAndSingleEvent
# ----------------------------------------------------------------------

def test_settled_pass_is_zero_work(sides):
    seen = {}
    for name, (side, mgr, source) in settled(sides, 8).items():
        log = side.cluster.start_call_log()
        state = mgr.build_state(NS, LABELS)
        mgr.apply_state(state, side.pkg.policy)
        side.cluster.stop_call_log()
        st = mgr.last_pass_stats
        assert st.snapshot_incremental and st.snapshot_skipped and not st.full_rebuild
        assert st.nodes_reclassified == st.dirty_node_count == 0
        assert st.reads_issued == st.writes_issued == 0
        assert state.dirty_nodes == frozenset()
        assert [c for c in log if c[0] in TRAFFIC] == []
        seen[name] = stats_of(mgr)
    assert seen["port"] == seen["jax"]


def test_single_node_event_reclassifies_exactly_one_node(sides):
    seen = {}
    for name, (side, mgr, source) in settled(sides, 8).items():
        node = side.cluster.get("Node", "node-3")
        node.annotations["example.com/poke"] = "1"
        side.cluster.update(node)
        assert wait_until(lambda: "node-3" in source.dirty().nodes)
        state = mgr.build_state(NS, LABELS)
        st = mgr.last_pass_stats
        assert st.nodes_reclassified == 1 and st.dirty_node_count == 1
        assert state.dirty_nodes == frozenset({"node-3"})
        assert [ns.node.name for ns in state.reactive_nodes_in(
            side.pkg.upgrade.UpgradeState.DONE)] == ["node-3"]
        seen[name] = (stats_of(mgr), state_shape(state))
    assert seen["port"] == seen["jax"]


def test_delta_pass_skips_pods_owned_outside_driver_ds(sides):
    seen = {}
    for name, (side, mgr, source) in settled(sides, 4).items():
        side.cluster.create(make_pod("stray", namespace=NS, node_name="node-2",
                                     labels=LABELS, controlled=True))
        assert wait_until(lambda: stores_caught_up(source, side.cluster))
        assert "node-2" in source.dirty().nodes
        shape = build_shape(side, mgr)
        assert not mgr.last_pass_stats.full_rebuild
        assert build_shape(side, full(side)) == shape
        seen[name] = shape
    assert seen["port"] == seen["jax"]


def test_delta_hit_rate_reported(sides):
    seen = {}
    for name, (side, mgr, source) in settled(sides, 4).items():
        for _ in range(3):
            mgr.apply_state(mgr.build_state(NS, LABELS), side.pkg.policy)
        st = mgr.last_pass_stats
        assert st.snapshot_incremental and 0.0 < st.delta_hit_rate <= 1.0
        seen[name] = stats_of(mgr)
    assert seen["port"] == seen["jax"]


# ----------------------------------------------------------------------
# TestTelemetryDeltas
# ----------------------------------------------------------------------

def publish(side, node, score_bad, links=None):
    metrics = ({"ring_gbytes_per_s": 1.0, "probe_latency_s": 120.0} if score_bad
               else {"ring_gbytes_per_s": 45.0, "probe_latency_s": 2.0})
    ReportPublisher(side.cluster, node, heartbeat_seconds=0.0).publish(
        {"ring_allreduce": not score_bad}, metrics, links=links
    )


def health_caught_up(health, cluster) -> bool:
    inf = health.informer()
    truth = {(o.namespace, o.name): str(o.resource_version)
             for o in cluster.list("NodeHealthReport")}
    with inf._dispatch_lock:
        dispatched = dict(inf._dispatched_rv)
    with inf._lock:
        store = {key: str((raw.get("metadata") or {}).get("resourceVersion", ""))
                 for key, raw in inf._store.items()}
    return store == truth and dispatched == truth


def scores(side, state) -> dict:
    fold = jax_effective_scores if side.name == "jax" else effective_scores
    return fold(state.node_health)


def telemetry(sides, nodes):
    out = {}
    for name, side in sides(nodes=nodes).items():
        mgr, source = incremental(side)
        health = mgr.with_health_telemetry()
        side.stack.callback(health.stop)
        out[name] = (side, mgr, source, health)
    return out


def test_health_only_delta_is_one_node_no_full_rebuild(sides):
    seen = {}
    for name, (side, mgr, source, health) in telemetry(sides, 8).items():
        settle(side, mgr, source)
        publish(side, "node-5", score_bad=True)
        assert wait_until(lambda: "node-5" in source.dirty().nodes)
        assert wait_until(lambda: health_caught_up(health, side.cluster))
        state = mgr.build_state(NS, LABELS)
        st = mgr.last_pass_stats
        assert not st.full_rebuild and st.nodes_reclassified == 1
        assert state.dirty_nodes == frozenset({"node-5"})
        assert state.node_health["node-5"].score < 50.0
        seen[name] = (stats_of(mgr), state.node_health["node-5"].score)
    assert seen["port"] == seen["jax"]


def test_link_only_delta_reclassifies_exactly_both_endpoints(sides):
    seen = {}
    for name, (side, mgr, source, health) in telemetry(sides, 8).items():
        publish(side, "node-5", score_bad=False)
        settle(side, mgr, source)
        assert wait_until(lambda: health_caught_up(health, side.cluster))
        mgr.apply_state(mgr.build_state(NS, LABELS), side.pkg.policy)
        assert wait_until(lambda: not source.dirty().nodes)
        publish(side, "node-5", score_bad=False,
                links={"node-2": {"ok": True, "latency_s": 5.0, "gbytes_per_s": 1.0}})
        assert wait_until(lambda: source.dirty().nodes >= {"node-5", "node-2"})
        assert wait_until(lambda: health_caught_up(health, side.cluster))
        state = mgr.build_state(NS, LABELS)
        st = mgr.last_pass_stats
        assert not st.full_rebuild
        assert state.dirty_nodes == frozenset({"node-5", "node-2"})
        assert st.nodes_reclassified == 2
        eff = scores(side, state)
        assert eff["node-5"] == eff["node-2"] == 40.0
        seen[name] = (stats_of(mgr), eff)
    assert seen["port"] == seen["jax"]


def test_link_peer_dropout_redirties_the_old_peer(sides):
    seen = {}
    for name, (side, mgr, source, health) in telemetry(sides, 8).items():
        publish(side, "node-5", score_bad=False,
                links={"node-2": {"ok": True, "latency_s": 5.0, "gbytes_per_s": 1.0}})
        settle(side, mgr, source)
        assert wait_until(lambda: health_caught_up(health, side.cluster))
        mgr.apply_state(mgr.build_state(NS, LABELS), side.pkg.policy)
        assert wait_until(lambda: not source.dirty().nodes)
        publish(side, "node-5", score_bad=False,
                links={"node-3": {"ok": True, "latency_s": 0.001, "gbytes_per_s": 42.0}})
        assert wait_until(lambda: source.dirty().nodes >= {"node-5", "node-2", "node-3"})
        assert wait_until(lambda: health_caught_up(health, side.cluster))
        state = mgr.build_state(NS, LABELS)
        assert not mgr.last_pass_stats.full_rebuild
        eff = scores(side, state)
        assert eff.get("node-2", 100.0) == 100.0
        seen[name] = (stats_of(mgr), eff)
    assert seen["port"] == seen["jax"]


def test_settled_telemetry_pool_stays_zero_client_work(sides):
    seen = {}
    for name, (side, mgr, source, health) in telemetry(sides, 6).items():
        publish(side, "node-2", score_bad=False)
        settle(side, mgr, source)
        mgr.apply_state(mgr.build_state(NS, LABELS), side.pkg.policy)
        log = side.cluster.start_call_log()
        state = mgr.build_state(NS, LABELS)
        mgr.apply_state(state, side.pkg.policy)
        side.cluster.stop_call_log()
        st = mgr.last_pass_stats
        assert st.snapshot_skipped and st.writes_issued == 0
        assert state.node_health["node-2"].score == 100.0
        assert [c for c in log if c[0] in TRAFFIC] == []
        assert mgr.build_state(NS, LABELS).node_health is state.node_health
        seen[name] = stats_of(mgr)
    assert seen["port"] == seen["jax"]


def test_non_telemetry_pool_pays_zero_for_the_feature(sides):
    seen = {}
    for name, (side, mgr, source) in settled(sides, 6).items():
        log = side.cluster.start_call_log()
        state = mgr.build_state(NS, LABELS)
        mgr.apply_state(state, side.pkg.policy)
        side.cluster.stop_call_log()
        assert mgr.health_source is None and state.node_health is None
        assert mgr.last_pass_stats.snapshot_skipped
        assert [c for c in log if c[0] in TRAFFIC] == []
        assert all(c[1] != "NodeHealthReport" for c in log)
        seen[name] = stats_of(mgr)
    assert seen["port"] == seen["jax"]


@pytest.mark.parametrize("seed", [21, 4242])
def test_fuzzer_with_health_report_steps(sides, seed):
    rng = random.Random(seed)
    t = telemetry(sides, 6)
    fulls = {name: full(side) for name, (side, _, _, _) in t.items()}
    rollouts = 0

    def each(fn):
        for side, _, _, _ in t.values():
            fn(side)

    def flip_state_label():
        name, value = f"node-{rng.randrange(6)}", rng.choice(STATES)

        def do(side):
            node = side.cluster.get("Node", name)
            if value:
                node.labels[KEYS.state_label] = value
            else:
                node.labels.pop(KEYS.state_label, None)
            side.cluster.update(node)
        each(do)

    def health_create_or_update():
        links = None
        if rng.random() < 0.5:
            sick = rng.random() < 0.5
            links = {f"node-{rng.randrange(6)}": {
                "ok": True, "latency_s": 5.0 if sick else 0.001,
                "gbytes_per_s": 1.0 if sick else 42.0,
            }}
        node, bad = f"node-{rng.randrange(6)}", rng.random() < 0.5
        each(lambda side: publish(side, node, score_bad=bad, links=links))

    def health_delete():
        name = f"node-{rng.randrange(6)}"

        def do(side):
            if side.cluster.get_or_none("NodeHealthReport", name) is not None:
                side.cluster.delete("NodeHealthReport", name)
        each(do)

    def rollout():
        nonlocal rollouts
        rollouts += 1
        each(lambda side: side.sim.set_template_hash(f"hv{rollouts}"))

    def kubelet_step():
        each(lambda side: side.sim.step())

    ops = [flip_state_label, health_create_or_update, health_create_or_update,
           health_delete, rollout, kubelet_step]
    for step in range(40):
        rng.choice(ops)()
        shapes = {}
        for name, (side, mgr, source, health) in t.items():
            assert wait_until(lambda: deliveries_caught_up(source, side.cluster)
                              and health_caught_up(health, side.cluster)), (
                f"seed={seed} step={step}: the {name} informers never caught up")
            expected = build_shape(side, fulls[name])
            got = build_shape(side, mgr)
            assert got == expected, f"seed={seed} step={step}: {name} incremental diverged"
            shapes[name] = got
        assert shapes["port"] == shapes["jax"], f"seed={seed} step={step}"


# ----------------------------------------------------------------------
# TestDeltaRetirement
# ----------------------------------------------------------------------

def test_remark_during_pass_survives_clean(sides):
    for side, mgr, source in settled(sides, 4).values():
        source._mark_node("node-1")
        delta = source.dirty()
        assert "node-1" in delta.nodes
        source._mark_node("node-1")
        source.clean(delta)
        assert "node-1" in source.dirty().nodes, side.name
        source.clean(source.dirty())
        assert not source.dirty().nodes


def test_double_clean_cannot_absorb_a_post_retirement_remark(sides):
    for side, mgr, source in settled(sides, 4).values():
        source._mark_node("node-1")
        delta = source.dirty()
        source.clean(delta)
        source._mark_node("node-1")
        source.clean(delta)
        assert "node-1" in source.dirty().nodes, side.name


def test_drifted_ds_pod_counts_self_heal_without_intervention(sides):
    seen = {}
    for name, (side, mgr, source) in settled(sides, 4).items():
        with source._delta_lock:
            uid = next(iter(source._ds_pod_counts))
            source._ds_pod_counts[uid] -= 1  # a lost event
        source._mark_node("node-0")
        with pytest.raises(side.pkg.upgrade.BuildStateError) as err:
            mgr.build_state(NS, LABELS)
        state = mgr.build_state(NS, LABELS)
        assert mgr.last_pass_stats.full_rebuild
        assert source.ds_pod_count(uid) == 4
        rebuilt = stats_of(mgr)
        mgr.apply_state(state, side.pkg.policy)
        source._mark_node("node-0")
        mgr.build_state(NS, LABELS)
        assert not mgr.last_pass_stats.full_rebuild
        seen[name] = (str(err.value), rebuilt, stats_of(mgr))
    assert seen["port"] == seen["jax"]


def test_write_through_dirties_the_written_node(sides):
    """A provider write marks its node dirty through the write-through
    itself, not only through the watch's echo: with the informers stopped
    the mark is there all the same (on both sides)."""
    for side, mgr, source in settled(sides, 4).values():
        source.stop()
        mgr.provider.change_node_upgrade_state(
            side.node("node-1"), side.pkg.upgrade.UpgradeState.UPGRADE_REQUIRED
        )
        assert source.dirty().nodes == frozenset({"node-1"}), side.name


def test_count_divergences_excludes_racing_nodes(sides):
    for side, mgr, source in settled(sides, 4).values():
        ours = {"node-1": [("a",)], "node-2": [("b",)]}
        truth = {"node-1": [("a",)], "node-2": [("CHANGED",)]}
        assert source.count_divergences(ours, truth, racing=frozenset({"node-2"})) == 0
        assert source.verify_divergences_total == 0
        assert source.count_divergences(ours, truth) == 1
        assert source.verify_divergences_total == 1


# ----------------------------------------------------------------------
# TestVerifyAudit
# ----------------------------------------------------------------------

def test_audit_repairs_and_counts_corruption(sides):
    seen = {}
    for name, (side, mgr, source) in settled(sides, 6).items():
        source.update_node("node-2", [])
        assert "node-2" not in state_shape(source.cached_state())
        source.verify_every_n = 1
        state = mgr.build_state(NS, LABELS)
        st = mgr.last_pass_stats
        assert st.full_rebuild and st.verify_divergences == 1
        assert source.verify_divergences_total == 1
        assert "node-2" in state_shape(state)
        audited = stats_of(mgr)
        mgr.build_state(NS, LABELS)
        assert mgr.last_pass_stats.verify_divergences == 0
        assert source.verify_divergences_total == 1
        assert mgr.audit_incremental(NS, LABELS) == 0
        seen[name] = (audited, stats_of(mgr))
    assert seen["port"] == seen["jax"]


def test_aborted_apply_invalidates_incremental_state(sides):
    for side, mgr, source in settled(sides, 4).values():
        state = mgr.build_state(NS, LABELS)

        def explode(*a, **k):
            raise RuntimeError("injected bucket failure")

        mgr.common.process_done_or_unknown_nodes = explode
        with pytest.raises(RuntimeError):
            mgr.apply_state(state, side.pkg.policy)
        assert source.dirty().full, side.name


# ----------------------------------------------------------------------
# TestRollEquivalence and TestPluginCompositionRolls
# ----------------------------------------------------------------------

def transitions_of(cluster) -> dict:
    transitions: dict = {}
    lock = threading.Lock()

    def record(event, obj, old):
        if obj.get("kind") != "Node":
            return
        label = (obj["metadata"].get("labels") or {}).get(KEYS.state_label)
        old_label = (((old or {}).get("metadata") or {}).get("labels") or {}).get(
            KEYS.state_label
        )
        if label != old_label:
            with lock:
                transitions.setdefault(obj["metadata"]["name"], []).append(label)

    cluster.subscribe(record)
    return transitions


def watch_unavailability(cluster, watermark: dict) -> None:
    """The high-water mark of nodes unschedulable at once."""
    unsched: set = set()
    lock = threading.Lock()

    def record(event, obj, old):
        if obj.get("kind") != "Node":
            return
        with lock:
            if (obj.get("spec") or {}).get("unschedulable"):
                unsched.add(obj["metadata"]["name"])
            else:
                unsched.discard(obj["metadata"]["name"])
            watermark["max"] = max(watermark.get("max", 0), len(unsched))

    cluster.subscribe(record)


CHECKPOINT_POLICY = {
    "autoUpgrade": True, "maxParallelUpgrades": 0, "maxUnavailable": "100%",
    "drain": {"enable": True, "force": True, "timeoutSeconds": 30},
    "checkpoint": {"enable": True, "podSelector": "app=trainer", "timeoutSeconds": 300},
}


def roll(side, incremental_source, width=1, threaded=False, checkpoint=False,
         policy=None, watermark=None, watch_hub=None) -> dict:
    """One v2 roll of the side's pool; each node's state-label sequence."""
    nodes = len(side.cluster.list("Node"))
    if watermark is not None:
        watch_unavailability(side.cluster, watermark)
    workload = None
    policy = side.pkg.policy_cls.from_dict(policy) if policy else side.pkg.policy
    if checkpoint:
        workload = CheckpointingWorkloadSimulator(side.cluster, KEYS, namespace="training")
        policy = side.pkg.policy_cls.from_dict(CHECKPOINT_POLICY)
    up = side.pkg.upgrade
    runner = up.TaskRunner(max_workers=max(width, 1)) if threaded else up.TaskRunner(inline=True)
    source = None
    if incremental_source:
        mgr, source = incremental(side, width=width, runner=runner, watch_hub=watch_hub)
    else:
        mgr = full(side, width=width, runner=runner)
    transitions = transitions_of(side.cluster)
    side.sim.set_template_hash("v2")
    try:
        for _ in range(120):
            if workload is not None:
                workload.step()
            side.sim.step()
            if source is not None:
                assert wait_until(lambda: stores_caught_up(source, side.cluster))
            try:
                mgr.apply_state(mgr.build_state(NS, LABELS), policy)
            except up.BuildStateError:
                continue
            side.sim.step()
            done = all(
                ((side.cluster.peek("Node", f"node-{i}") or {}).get("metadata", {})
                 .get("labels") or {}).get(KEYS.state_label) == "upgrade-done"
                for i in range(nodes)
            )
            if done and side.sim.all_pods_ready_and_current():
                break
        else:
            raise AssertionError(f"{side.name} incremental={incremental_source} "
                                 f"width={width}: the roll did not converge")
    finally:
        if threaded:
            runner.wait_idle(timeout=10)
            runner.shutdown()
        if source is not None:
            source.stop()
    return transitions


def test_terminal_sequences_match_full_rebuild_at_any_width(sides):
    """256 nodes: the port's incremental machine, serial and at width 8,
    rolls each node through the JAX full-rebuild roll's sequence."""
    reference = roll(sides(nodes=256)["jax"], False)
    serial = roll(sides(nodes=256)["port"], True)
    wide = roll(sides(nodes=256)["port"], True, width=8, threaded=True)
    assert set(reference) == set(serial) == set(wide)
    for name in reference:
        assert serial[name] == reference[name], f"{name}: {serial[name]} != {reference[name]}"
        assert wide[name] == reference[name], f"{name}: {wide[name]} != {reference[name]}"


def test_checkpoint_arc_sequences_match_full_rebuild(sides):
    """16 nodes through the checkpoint arc under an acking workload: the
    port's incremental roll and the JAX incremental roll each take the
    JAX full-rebuild roll's sequences."""
    reference = roll(sides(nodes=16)["jax"], False, checkpoint=True)
    s = sides(nodes=16)
    ckpt = "checkpoint-required"
    for side in s.values():
        inc = roll(side, True, checkpoint=True)
        assert set(inc) == set(reference), side.name
        for name in reference:
            assert ckpt in reference[name], f"{name} never checkpointed: {reference[name]}"
            assert inc[name] == reference[name], f"{side.name} {name}: {inc[name]}"
    assert node_view(s["port"].cluster) == node_view(s["jax"].cluster)


def test_every_standard_composition_equivalent_and_within_budget(sides):
    """Each shipped policy composition, 32 nodes under a 25% budget: the
    port's incremental roll takes the JAX full-rebuild roll's sequences
    and never has more than 8 nodes unschedulable at once."""
    from k8s_operator_libs_tpu.policy import standard_compositions as jax_compositions
    from k8s_operator_libs_tpu_torch.policy import standard_compositions

    assert list(standard_compositions()) == list(jax_compositions())
    for comp in standard_compositions():
        policy = {"autoUpgrade": True, "maxParallelUpgrades": 0, "maxUnavailable": "25%",
                  "policy": list(comp)}
        wm_ref: dict = {}
        wm_port: dict = {}
        reference = roll(sides(nodes=32)["jax"], False, policy=policy, watermark=wm_ref)
        ours = roll(sides(nodes=32)["port"], True, policy=policy, watermark=wm_port)
        assert set(ours) == set(reference), comp
        for name in reference:
            assert ours[name] == reference[name], f"{comp}: {name}"
        for label, wm in (("jax full", wm_ref), ("port incremental", wm_port)):
            assert 0 < wm["max"] <= 8, f"{comp}: {label} disrupted {wm.get('max')} at once"


# ----------------------------------------------------------------------
# chip_smoke.py's informer_roll phase, rehearsed on the CPU
# ----------------------------------------------------------------------

def test_chip_smoke_informer_roll_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """The informer_roll phase whole (``informer_roll_phase`` over
    ``DictClient`` and ``ApiStub``: the CRD utility's three runs as child
    processes, the 258-node cluster, the incremental machine with its
    writes batched, the settled passes, the audit, the LIST pass and every
    check), with node labels that need no card and each probe pod's
    payload replaced by a stub."""
    from k8s_operator_libs_tpu_torch.parallel import topology
    from test_torch_cuda import chip_smoke_module

    smoke = chip_smoke_module()
    monkeypatch.setattr(topology, "local_gpu_labels", lambda: {
        "nvidia.com/gpu.present": "true", "nvidia.com/gpu.count": "1",
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
    })
    monkeypatch.setattr(smoke, "ROLL_PASS_INTERVAL_S", 0.0)
    launches = {"matmul": 1165, "flash_attention": 4}
    pods = []

    def probe_pod(container, host_paths, workdir, label):
        pods.append((label, sorted(set(host_paths.values()))))
        return {"seconds_to_ready": 0.0, "launches": dict(launches),
                "build_s": {"matmul": 0.0, "flash_attention": 0.0}}

    monkeypatch.setattr(smoke, "run_probe_pod", probe_pod)
    result = smoke.informer_roll_phase("cpu", launches, str(tmp_path))
    assert result["cluster_nodes"] == 259  # 258 and the node that joins at the stale view
    assert sorted(r["node"] for r in result["probe_pods"].values()) == list(
        smoke.INFORMER_NODES
    )
    assert all(p["reads_issued"] == 0 and p["writes_issued"] == 0 for p in result["settled"])
    # Every fifth build audits; the others serve the kept state.
    assert sum(p["snapshot_skipped"] for p in result["settled"]) >= 7
    assert result["settled_client_calls"] == {}
    assert result["audit_divergences"] == 0
    assert result["batcher"]["writes_flushed"] == result["provider_writes"]["issued"] > 0
    assert result["list_pass"]["reads_issued"] >= 3
    crd = result["crdutil"]
    assert crd["apply"]["discovery_polls"] >= 2
    assert all(v is None for v in crd["after_delete"].values())
    assert result["pod_launches"] == {k: 2 * v for k, v in launches.items()}
    assert sorted({path for _, paths in pods for path in paths}) == sorted(
        str(tmp_path / name) for name in smoke.ROLL_NODES
    )
