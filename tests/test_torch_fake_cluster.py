"""The port's ``FakeCluster`` (``kube/fake.py``) held to the JAX package's.

Every case of ``tests/test_fake_cluster.py`` runs here once more, with
the JAX cluster and the port's in lockstep (``tests/torch_cluster_twins.py``):
each call's result, arguments after the call and error, and at the end
each cluster's store, journal, revision and subscriber streams, are
compared; the case's own assertions read the JAX side.
"""

import pytest

import test_fake_cluster
from torch_cluster_twins import adopt_cases, twin_world

adopt_cases(test_fake_cluster, globals())


@pytest.fixture(autouse=True)
def twins(twin_world):
    return twin_world


# -- the port's own cases: what the JAX file reaches only through its server
import threading  # noqa: E402
from collections import deque  # noqa: E402

from builders import make_node  # noqa: E402
from k8s_operator_libs_tpu.kube import fake as jax_fake  # noqa: E402
from k8s_operator_libs_tpu.kube import resources as jax_resources  # noqa: E402
from k8s_operator_libs_tpu.kube.events import FakeRecorder as JaxFakeRecorder  # noqa: E402
from k8s_operator_libs_tpu.kube.selectors import parse_field_selector as jax_fields  # noqa: E402
from k8s_operator_libs_tpu.kube.selectors import parse_selector as jax_selector  # noqa: E402
from k8s_operator_libs_tpu_torch.kube import cache as port_cache  # noqa: E402
from k8s_operator_libs_tpu_torch.kube import fake as port_fake  # noqa: E402
from k8s_operator_libs_tpu_torch.kube import resources as port_resources  # noqa: E402
from k8s_operator_libs_tpu_torch.kube.events import FakeRecorder  # noqa: E402
from k8s_operator_libs_tpu_torch.kube.objects import wrap as port_wrap  # noqa: E402
from k8s_operator_libs_tpu_torch.kube.selectors import parse_field_selector  # noqa: E402
from k8s_operator_libs_tpu_torch.kube.selectors import parse_selector  # noqa: E402

SIDES = {"jax": jax_fake, "port": port_fake}


def _node(side, name, **labels):
    node = make_node(name, labels=labels)
    return node if side == "jax" else port_wrap(node.raw)


def _frames(stream):
    return [(event, obj.name, obj.resource_version, dict(obj.raw["metadata"].get("labels") or {}))
            for event, obj in stream]


def _watch_scenario(side, scenario):
    """The frames (or the error) one cluster's ``watch`` yields for
    ``scenario``, after the same writes."""
    cluster = SIDES[side].FakeCluster()
    try:
        if scenario == "expired":
            cluster._history = deque(maxlen=4)
        cluster.create(_node(side, "n1", pool="a"))
        cluster.create(_node(side, "n2", pool="b"))
        cluster.patch("Node", "n1", patch={"metadata": {"labels": {"pool": "b"}}})
        cluster.patch("Node", "n2", patch={"metadata": {"labels": {"pool": "a"}}})
        cluster.patch("Node", "n1", patch={"metadata": {"labels": {"pool": "a"}}})
        cluster.delete("Node", "n2")
        if scenario == "expired":
            for i in range(6):
                cluster.patch("Node", "n1", patch={"metadata": {"labels": {"i": str(i)}}})
        kwargs = {"label_selector": "pool=a", "resource_version": "0", "timeout_seconds": 1}
        if scenario == "live":
            # Replay of the writes so far, then a write made while the
            # stream waits.
            kwargs["resource_version"] = "3"
            timer = threading.Timer(0.2, lambda: cluster.patch(
                "Node", "n1", patch={"metadata": {"labels": {"pool": "c"}}}))
            timer.start()
            try:
                return _frames(cluster.watch("Node", **kwargs))
            finally:
                timer.join()
        if scenario == "bookmarks":
            kwargs.update(allow_bookmarks=True, bookmark_interval_s=0.1, timeout_seconds=0.5)
            frames = _frames(cluster.watch("Node", **kwargs))
            marks = {(f[0], f[1], f[2]) for f in frames if f[0] == "BOOKMARK"}
            return [f for f in frames if f[0] != "BOOKMARK"], sorted(marks)
        try:
            return _frames(cluster.watch("Node", **kwargs))
        except Exception as e:  # noqa: BLE001 - compared by class and reason
            return type(e).__name__, getattr(e, "reason", None)
    finally:
        cluster.close()


@pytest.mark.parametrize("scenario", ["replay", "live", "bookmarks", "expired"])
def test_watch_streams_match(scenario):
    """``FakeCluster.watch`` on both clusters after the same writes: the
    selector scope's ADDED / MODIFIED / DELETED classification of replayed
    and live events, the bookmarks (which carry the current revision
    only), and the 410 of a revision compacted out of the journal."""
    ours, theirs = _watch_scenario("port", scenario), _watch_scenario("jax", scenario)
    assert ours == theirs
    if scenario == "expired":
        assert ours == ("WatchExpiredError", "Expired")
    if scenario == "bookmarks":
        assert ours[1] == [("BOOKMARK", "", "6")]


@pytest.mark.parametrize("event, old, new", [
    ("ADDED", None, {"pool": "a"}),
    ("MODIFIED", {"pool": "a"}, {"pool": "a"}),
    ("MODIFIED", {"pool": "a"}, {"pool": "b"}),
    ("MODIFIED", {"pool": "b"}, {"pool": "a"}),
    ("MODIFIED", {"pool": "b"}, {"pool": "b"}),
    ("DELETED", {"pool": "a"}, {"pool": "a"}),
])
def test_classify_watch_event_matches(event, old, new):
    def doc(labels):
        return None if labels is None else {"kind": "Node", "metadata": {"name": "n",
                                                                         "labels": labels}}

    ours = port_fake.classify_watch_event(event, doc(new), doc(old), parse_selector("pool=a"),
                                          parse_field_selector(None))
    theirs = jax_fake.classify_watch_event(event, doc(new), doc(old), jax_selector("pool=a"),
                                           jax_fields(None))
    assert ours == theirs


def test_peek_and_list_peek_hand_out_frozen_snapshots():
    """``peek`` and ``list_peek`` hand out the stored dicts themselves, and
    a later write swaps a fresh dict in (copy-on-write): what was handed
    out stays a point-in-time snapshot, on both clusters."""
    seen = {}
    for side, mod in SIDES.items():
        cluster = mod.FakeCluster()
        cluster.create(_node(side, "n1", pool="a"))
        cluster.create(_node(side, "n2", pool="b"))
        peeked = cluster.peek("Node", "n1")
        listed = cluster.list_peek("Node", label_selector={"pool": "a"})
        same = peeked is cluster._store[("Node", "", "n1")] and listed[0] is peeked
        cluster.patch("Node", "n1", patch={"metadata": {"labels": {"pool": "c"}}})
        seen[side] = (same, peeked["metadata"]["labels"], [o["metadata"]["name"] for o in listed],
                      cluster.peek("Node", "n1")["metadata"]["labels"],
                      cluster.list_peek("Node", label_selector="pool=a"),
                      cluster.peek("Node", "ghost"), cluster.object_names("Node"))
    assert seen["port"] == seen["jax"]
    assert seen["port"][:4] == (True, {"pool": "a"}, ["n1"], {"pool": "c"})


def test_resource_registry_matches_the_jax_registry():
    def table(mod):
        return {kind: (i.api_version, i.plural, i.namespaced, i.group, i.path_prefix)
                for kind, i in mod._REGISTRY.items()}

    assert table(port_resources) == table(jax_resources)
    for info in port_resources._REGISTRY.values():
        assert port_resources.resource_for_plural(info.group, info.plural) == info
    with pytest.raises(KeyError, match="register_resource"):
        port_resources.resource_for_kind("Gadget")


def test_fake_recorder_matches_the_jax_recorder():
    node = make_node("n1")
    recorders = {"jax": JaxFakeRecorder(capacity=3), "port": FakeRecorder(capacity=3)}
    for recorder in recorders.values():
        for i in range(5):
            recorder.eventf(node, "Normal", "Step", "step %d of %s", i, "n1")
        recorder.event(node, "Warning", "Odd", "odd")
    drained = {name: (r.drain(), r.drain()) for name, r in recorders.items()}
    assert drained["port"] == drained["jax"]
    assert drained["port"][0] == ["Normal Step step 3 of n1", "Normal Step step 4 of n1",
                                  "Warning Odd odd"]


def test_close_stops_every_timer_and_the_cache_thread():
    """No timer or thread outlives ``close``: the CRD establishment and
    discovery timers are cancelled, and the auto cache's thread ends."""
    cluster = port_fake.FakeCluster(crd_establish_delay=30.0, crd_discovery_delay=30.0)
    crd = {"apiVersion": "apiextensions.k8s.io/v1", "kind": "CustomResourceDefinition",
           "metadata": {"name": "gadgets.example.dev"},
           "spec": {"group": "example.dev", "scope": "Namespaced",
                    "names": {"plural": "gadgets", "kind": "Gadget"},
                    "versions": [{"name": "v1", "served": True, "storage": True}]}}
    cluster.create(port_wrap(crd))
    timers = list(cluster._pending_timers)
    cache = port_cache.CachedClient(cluster, sync_mode="auto", lag_seconds=0.01)
    assert timers and all(t.is_alive() for t in timers) and cache._thread.is_alive()
    cache.close()
    cluster.close()
    for timer in timers:
        timer.join(timeout=5)
    assert not any(t.is_alive() for t in timers) and cluster._pending_timers == []
    assert not cache._thread.is_alive()
