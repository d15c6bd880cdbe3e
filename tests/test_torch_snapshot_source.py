"""The port's snapshot sources, held case by case against the JAX package's.

Each case of ``tests/test_snapshot_source.py`` runs on twin clusters
(``torch_twins.Side``): the JAX machine over one ``FakeCluster``, the
port's over its ``RestClient`` and a ``LocalApiServer`` serving the other.
The JAX case's assertions hold on both sides, and the sides are compared
exactly: the reads each snapshot made (the serving cluster's call log
records the port's HTTP requests as it records the JAX machine's calls),
the buckets, the errors' types and messages, ``PassStats`` and every
node's upgrade labels, annotations and cordon bit.

Two cases of ``TestZeroCopyReadsAreNonMutating`` read the JAX
``FakeCluster.list_peek``, which has no counterpart over HTTP: on the
port's side they read the informer snapshot source's stores, which it
serves uncopied (``Informer.list(copy=False)``), the same contract.
"""

from __future__ import annotations

import contextlib
import time

import pytest

from builders import make_daemonset, make_node, make_pod
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube.objects import ControllerRevision as JaxControllerRevision
from k8s_operator_libs_tpu.kube.objects import DaemonSet as JaxDaemonSet
from k8s_operator_libs_tpu.kube.objects import Pod as JaxPod
from k8s_operator_libs_tpu_torch.kube.objects import ControllerRevision, DaemonSet, Node, Pod
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from torch_twins import (
    KEYS,
    LABELS,
    NS,
    STAT_FIELDS,
    Side,
    node_view,
    pass_stats,
    state_shape,
)


@pytest.fixture
def sides():
    with contextlib.ExitStack() as stack:
        yield lambda **kw: {name: Side(name, stack, **kw) for name in ("jax", "port")}


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared, not handled
        return ("raised", type(e).__name__, str(e))


def same_nodes(s) -> None:
    assert node_view(s["port"].cluster) == node_view(s["jax"].cluster)


# ----------------------------------------------------------------------
# TestFallbackListPath
# ----------------------------------------------------------------------

def test_snapshot_is_three_lists_no_per_node_gets(sides):
    s = sides(nodes=5)
    reads = {}
    for name, side in s.items():
        mgr = side.manager()
        log = side.cluster.start_call_log()
        mgr.build_state(NS, LABELS)
        side.cluster.stop_call_log()
        reads[name] = [c for c in log if c[0] in ("get", "list")]
        assert mgr.last_pass_stats.reads_issued == 3
        assert mgr.last_pass_stats.snapshot_cached is False
    assert reads["port"] == reads["jax"] == [
        ("list", "DaemonSet", ""), ("list", "Pod", ""), ("list", "Node", ""),
    ]


def test_build_state_buckets_match_node_labels(sides):
    shapes = {}
    for name, side in sides(nodes=3).items():
        mgr = side.manager()
        up = side.pkg.upgrade
        mgr.provider.change_node_upgrade_state(
            side.node("node-1"), up.UpgradeState.CORDON_REQUIRED
        )
        state = mgr.build_state(NS, LABELS)
        assert [ns.node.name for ns in state.nodes_in(up.UpgradeState.CORDON_REQUIRED)] == [
            "node-1"
        ]
        assert len(state.nodes_in(up.UpgradeState.UNKNOWN)) == 2
        shapes[name] = state_shape(state)
    assert shapes["port"] == shapes["jax"]


def test_completeness_invariant_preserved(sides):
    results = {}
    for name, side in sides(nodes=0, driver=False).items():
        created = side.cluster.create(
            make_daemonset("driver", namespace=NS, match_labels=LABELS, desired=2)
        )
        pod = make_pod("driver-a", namespace=NS, node_name="n1", labels=dict(LABELS))
        pod.raw["metadata"]["ownerReferences"] = [{"uid": created.uid, "controller": True}]
        side.cluster.create(make_node("n1"))
        side.cluster.create(pod)
        results[name] = outcome(lambda: side.manager().build_state(NS, LABELS))
    assert results["port"] == results["jax"]
    assert results["jax"][:2] == ("raised", "BuildStateError")


# ----------------------------------------------------------------------
# TestOwnerReferencesGuard
# ----------------------------------------------------------------------

def _stray(side) -> None:
    stray = make_pod("stray", namespace=NS, node_name="node-0", labels=dict(LABELS))
    stray.raw["metadata"]["ownerReferences"] = []
    side.cluster.create(stray)


def test_pod_with_empty_owner_refs_lands_orphaned(sides):
    shapes = {}
    for name, side in sides(nodes=2).items():
        _stray(side)
        state = side.manager().build_state(NS, LABELS)  # must not raise
        orphans = [ns for b in state.node_states.values() for ns in b
                   if ns.driver_pod.name == "stray"]
        assert len(orphans) == 1
        assert orphans[0].driver_daemonset is None and orphans[0].is_orphaned_pod()
        shapes[name] = state_shape(state)
    assert shapes["port"] == shapes["jax"]


def test_guard_holds_even_if_orphan_classification_flips_mid_pass(sides):
    """A classifier that selects the refless pod as an orphan and calls it
    owned at the owner lookup must not raise an IndexError."""
    shapes = {}
    for name, side in sides(nodes=2).items():
        _stray(side)
        mgr = side.manager()
        calls = {"stray": 0}

        def flaky(pod, calls=calls):
            if pod.name != "stray":
                return len(pod.owner_references) < 1
            calls["stray"] += 1
            return calls["stray"] <= 2

        mgr.common.is_orphaned_pod = flaky
        state = mgr.build_state(NS, LABELS)  # must not raise
        strays = [ns for b in state.node_states.values() for ns in b
                  if ns.driver_pod.name == "stray"]
        assert strays and strays[0].driver_daemonset is None
        shapes[name] = state_shape(state)
    assert shapes["port"] == shapes["jax"]


# ----------------------------------------------------------------------
# TestInformerSnapshotSource
# ----------------------------------------------------------------------

def test_zero_client_reads_per_pass_once_synced(sides):
    s = sides(nodes=3)
    stats = {}
    for name, side in s.items():
        mgr = side.manager()
        source = mgr.with_snapshot_from_informers(NS, LABELS, resync_period_s=0.0)
        try:
            mgr.apply_state(mgr.build_state(NS, LABELS), side.pkg.policy)
            log = side.cluster.start_call_log()
            state = mgr.build_state(NS, LABELS)
            side.cluster.stop_call_log()
            assert [c for c in log if c[0] in ("get", "list")] == []
            assert mgr.last_pass_stats.reads_issued == 0
            assert mgr.last_pass_stats.snapshot_cached is True
            assert sum(len(v) for v in state.node_states.values()) == 3
            stats[name] = pass_stats(mgr.last_pass_stats, *STAT_FIELDS)
        finally:
            source.stop()
    assert stats["port"] == stats["jax"]
    same_nodes(s)


def test_read_your_writes_via_write_through(sides):
    """The write lands in the store with the watch stopped: the
    write-through, apart from any watch delivery."""
    s = sides(nodes=2)
    for side in s.values():
        mgr = side.manager()
        up = side.pkg.upgrade
        source = mgr.with_snapshot_from_informers(NS, LABELS, resync_period_s=0.0)
        source.stop()
        mgr.provider.change_node_upgrade_state(
            side.node("node-0"), up.UpgradeState.CORDON_REQUIRED
        )
        assert source.nodes()["node-0"].labels[KEYS.state_label] == "cordon-required"
        state = mgr.build_state(NS, LABELS)
        assert [ns.node.name for ns in state.nodes_in(up.UpgradeState.CORDON_REQUIRED)] == [
            "node-0"
        ]
    same_nodes(s)


def test_record_write_ignores_stale_revision(sides):
    cached = {}
    for name, side in sides(nodes=0, driver=False).items():
        side.cluster.create(make_node("n1"))
        informer = side.pkg.Informer(side.client, "Node")
        informer.record_write(side.client.get("Node", "n1"))
        stale = side.pkg.Node({"kind": "Node", "metadata": {
            "name": "n1", "resourceVersion": "0", "labels": {"poison": "true"}}})
        informer.record_write(stale)
        got = informer.get("n1")
        assert got is not None and "poison" not in got.labels
        cached[name] = dict(got.labels)
    assert cached["port"] == cached["jax"]


def test_scope_mismatch_is_loud(sides):
    errors = {}
    for name, side in sides(nodes=1).items():
        source = side.manager().with_snapshot_from_informers(NS, LABELS, resync_period_s=0.0)
        try:
            errors[name] = [
                outcome(lambda: source.pods("other-ns", LABELS)),
                outcome(lambda: source.daemonsets(NS, {"app": "other"})),
            ]
        finally:
            source.stop()
    assert errors["port"] == errors["jax"]
    assert [e[:2] for e in errors["jax"]] == [("raised", "ValueError")] * 2


def test_full_roll_converges_on_informer_snapshots(sides):
    """The informer read path drives a whole roll to the terminal state
    the LIST path reaches; both sides end alike."""
    s = sides(nodes=3)
    for side in s.values():
        mgr = side.manager()
        source = mgr.with_snapshot_from_informers(NS, LABELS, resync_period_s=0.0)
        try:
            side.sim.set_template_hash("v2")
            for _ in range(60):
                side.sim.step()
                time.sleep(0.01)  # the watch threads catch up
                try:
                    state = mgr.build_state(NS, LABELS)
                except side.pkg.upgrade.BuildStateError:
                    continue  # an informer a delivery behind
                mgr.apply_state(state, side.pkg.policy)
                side.sim.step()
                if all(side.state(f"node-{i}") == "upgrade-done" for i in range(3)) and (
                    side.sim.all_pods_ready_and_current()
                ):
                    break
            else:
                raise AssertionError(f"{side.name}: the informer-backed roll did not converge")
        finally:
            source.stop()
    same_nodes(s)


# ----------------------------------------------------------------------
# TestClientSourceUnit
# ----------------------------------------------------------------------

def test_consume_reads_resets(sides):
    for side in sides(nodes=1, driver=False).values():
        source = side.pkg.upgrade.ClientSnapshotSource(side.client)
        source.nodes()
        source.nodes()
        assert source.consume_reads() == 2
        assert source.consume_reads() == 0


def test_informer_source_requires_sync_before_snapshots(sides):
    for side in sides(nodes=0, driver=False).values():
        source = side.pkg.upgrade.InformerSnapshotSource(side.client, NS, LABELS)
        assert source.started is False


# ----------------------------------------------------------------------
# TestZeroCopyReadsAreNonMutating
# ----------------------------------------------------------------------

def test_status_less_daemonset_read_does_not_grow_store():
    """A DaemonSet with no status read uncopied must not grow ``status``
    in the store: the JAX view over ``list_peek``, the port's over the
    informer source's store."""
    cluster = FakeCluster()
    ds = make_daemonset("driver", namespace=NS, match_labels=LABELS)
    del ds.raw["status"]
    cluster.create(ds)
    frozen = cluster.list_peek("DaemonSet", namespace=NS)[0]
    view = JaxDaemonSet(frozen)
    assert view.desired_number_scheduled == 0 and view.match_labels == dict(LABELS)
    assert "status" not in frozen
    from k8s_operator_libs_tpu_torch.upgrade import InformerSnapshotSource

    with LocalApiServer(cluster=cluster) as server:
        source = InformerSnapshotSource(RestClient(RestConfig(server=server.url)), NS, LABELS)
        with source:
            (ours,) = source.daemonsets(NS, LABELS)
            assert ours.desired_number_scheduled == view.desired_number_scheduled
            assert ours.match_labels == view.match_labels
            (stored,) = source.informer("DaemonSet")._store.values()
            assert "status" not in stored, "a read inserted status into the store"


def test_snapshot_pass_leaves_store_keysets_untouched(sides):
    """A whole build_state over uncopied objects adds no key to the stored
    DaemonSet and Pod dicts: the JAX cluster's (``list_peek``), the port's
    informer stores."""
    s = sides(nodes=2)

    def keysets(raws) -> set:
        return {(o["metadata"]["name"], frozenset(o), frozenset(o["metadata"])) for o in raws}

    jax = s["jax"]
    before = {k: keysets(jax.cluster.list_peek(k, namespace=NS)) for k in ("DaemonSet", "Pod")}
    jax.manager().build_state(NS, LABELS)
    assert {k: keysets(jax.cluster.list_peek(k, namespace=NS))
            for k in ("DaemonSet", "Pod")} == before

    port = s["port"]
    mgr = port.manager()
    source = mgr.with_snapshot_from_informers(NS, LABELS, resync_period_s=0.0)
    try:
        stores = {k: source.informer(k)._store for k in ("DaemonSet", "Pod")}
        before = {k: keysets(store.values()) for k, store in stores.items()}
        mgr.build_state(NS, LABELS)
        assert {k: keysets(store.values()) for k, store in stores.items()} == before
    finally:
        source.stop()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_pure_read_accessors_do_not_insert(package):
    from k8s_operator_libs_tpu.kube import Node as JaxNode

    classes = {
        "jax": (JaxPod, JaxNode, JaxDaemonSet, JaxControllerRevision),
        "port": (Pod, Node, DaemonSet, ControllerRevision),
    }[package]
    pod, node, ds, cr = (
        cls({"metadata": {"name": name}}) for cls, name in zip(classes, "pndc")
    )
    assert pod.controller_revision_hash() == ""
    assert node.unschedulable is False
    assert node.is_ready() is True
    assert ds.desired_number_scheduled == 0
    assert ds.match_labels == {}
    assert cr.hash_label() == ""
    for obj in (pod, node, ds, cr):
        assert "status" not in obj.raw and "spec" not in obj.raw
        assert "labels" not in obj.raw["metadata"]
