"""The port's event recorder against the JAX package's: every case of
``tests/test_event_correlation.py`` (dedup with count bumping, aggregation
of similar events, the per-object spam filter, the re-creation of an Event
the server collected, and the correlation keyed by the object's uid),
each recorder over one JAX ``FakeCluster`` in a namespace of its own, on
one clock given as ``now_fn``. Each case asserts what the JAX suite
asserts, for both recorders, and the two namespaces' Event objects must
then be equal, but for what each write draws at random or from the wall
clock (the name, uid and timestamps) and the revision. The tolerance is
exact equality.
"""

from __future__ import annotations

import pytest

from builders import make_node
from k8s_operator_libs_tpu.kube import FakeCluster
from k8s_operator_libs_tpu.kube.events import EventRecorder as JaxRecorder
from k8s_operator_libs_tpu_torch.kube.events import EventRecorder as PortRecorder

#: Keys each write draws at random or from the wall clock, and the
#: revision, which the two namespaces of one cluster interleave.
_DRAWN = ("name", "uid", "resourceVersion", "creationTimestamp")


class Clock:
    def __init__(self):
        self.t = 1000.0

    def now(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Side:
    """One recorder's view: its namespace of the shared cluster."""

    def __init__(self, cluster, recorder_cls, namespace, clock, **kw):
        self.cluster = cluster
        self.namespace = namespace
        self.rec = recorder_cls(cluster, namespace=namespace, now_fn=clock.now, **kw)

    def events(self):
        return self.cluster.list("Event", namespace=self.namespace)


def _comparable(ev) -> dict:
    raw = {k: v for k, v in ev.raw.items() if k not in ("firstTimestamp", "lastTimestamp")}
    meta = {k: v for k, v in raw["metadata"].items() if k not in _DRAWN}
    return {**raw, "metadata": meta}


def _both(scenario, **kw):
    """Run ``scenario(side, clock)`` for each recorder over one cluster,
    each on a clock that starts at the same time, and compare the Event
    objects the two left."""
    cluster = FakeCluster()
    sides = []
    for cls, namespace in ((JaxRecorder, "jax"), (PortRecorder, "port")):
        clock = Clock()
        side = Side(cluster, cls, namespace, clock, **kw)
        scenario(side, clock)
        sides.append(side)
    theirs, ours = ([_comparable(e) for e in s.events()] for s in sides)
    for doc in theirs + ours:
        doc["metadata"].pop("namespace")
    key = lambda d: (d["reason"], d["message"], d["involvedObject"]["uid"])  # noqa: E731
    assert sorted(ours, key=key) == sorted(theirs, key=key)
    return sides


def test_c16_thirty_identical_events_leave_one_event_of_count_25():
    """One Node and the same Normal event recorded 30 times at one instant:
    one Event object, its count 25; the spam filter's burst drops the other
    five, in both recorders."""

    def scenario(side, clock):
        node = make_node("c16-node")
        for _ in range(30):
            side.rec.event(node, "Normal", "Upgrade", "node upgrade started")
        evs = side.events()
        assert len(evs) == 1
        assert evs[0].raw["count"] == 25

    _both(scenario)


def test_identical_events_bump_count_not_objects():
    def scenario(side, clock):
        node = make_node("ev-node")
        for _ in range(5):
            side.rec.event(node, "Normal", "Cordon", "cordoned for upgrade")
            clock.advance(1)
        evs = side.events()
        assert len(evs) == 1
        assert evs[0].raw["count"] == 5
        assert evs[0].raw["firstTimestamp"]
        assert evs[0].raw["reason"] == "Cordon"

    _both(scenario)


def test_distinct_messages_create_distinct_events():
    def scenario(side, clock):
        node = make_node("ev-node")
        side.rec.event(node, "Normal", "Drain", "draining 3 pods")
        side.rec.event(node, "Normal", "Drain", "draining 1 pod")
        assert len(side.events()) == 2

    _both(scenario)


def test_server_side_gc_recreates():
    def scenario(side, clock):
        node = make_node("ev-node")
        side.rec.event(node, "Normal", "Cordon", "x")
        ev = side.events()[0]
        side.cluster.delete("Event", ev.name, ev.namespace)
        side.rec.event(node, "Normal", "Cordon", "x")
        fresh = side.events()
        assert len(fresh) == 1 and fresh[0].raw["count"] == 1

    _both(scenario)


def test_similar_events_collapse_after_threshold():
    def scenario(side, clock):
        node = make_node("ev-node")
        for i in range(8):
            side.rec.event(node, "Warning", "ProbeFailed", f"attempt {i} failed")
            clock.advance(1)
        evs = side.events()
        combined = [e for e in evs if e.raw["message"].startswith("(combined")]
        assert len(combined) == 1
        assert combined[0].raw["count"] == 5
        assert len(evs) == 4
        assert "attempt 7 failed" in combined[0].raw["message"]

    _both(scenario, aggregate_threshold=3)


def test_window_expiry_resets_aggregation():
    def scenario(side, clock):
        node = make_node("ev-node")
        for i in range(3):
            side.rec.event(node, "Warning", "Flaky", f"m{i}")
        assert any(e.raw["message"].startswith("(combined") for e in side.events())
        clock.advance(120)
        side.rec.event(node, "Warning", "Flaky", "fresh")
        assert len([e for e in side.events() if e.raw["message"] == "fresh"]) == 1

    _both(scenario, aggregate_threshold=2, aggregate_window_s=60)


def test_burst_exhaustion_drops_events():
    def scenario(side, clock):
        node = make_node("ev-node")
        for i in range(20):
            side.rec.event(node, "Normal", "Busy", f"m{i}")
        assert len(side.events()) == 5

    _both(scenario, spam_burst=5, spam_refill_s=10)


def test_tokens_refill_over_time():
    def scenario(side, clock):
        node = make_node("ev-node")
        for i in range(5):
            side.rec.event(node, "Normal", "Busy", f"m{i}")
        assert len(side.events()) == 2
        clock.advance(25)
        for suffix in ("", " 2", " 3"):
            side.rec.event(node, "Normal", "Busy", f"after refill{suffix}")
        assert len(side.events()) == 4

    _both(scenario, spam_burst=2, spam_refill_s=10)


def test_budget_is_per_object():
    def scenario(side, clock):
        a, b = make_node("node-a"), make_node("node-b")
        side.rec.event(a, "Normal", "X", "m")
        side.rec.event(a, "Normal", "X", "m2")
        side.rec.event(b, "Normal", "X", "m")
        assert len(side.events()) == 2

    _both(scenario, spam_burst=1, spam_refill_s=1000)


def test_identical_events_never_aggregate():
    def scenario(side, clock):
        node = make_node("ev-node")
        for _ in range(12):
            side.rec.event(node, "Normal", "Cordon", "cordoned")
            clock.advance(1)
        evs = side.events()
        assert len(evs) == 1
        assert evs[0].raw["count"] == 12
        assert evs[0].raw["message"] == "cordoned"

    _both(scenario, aggregate_threshold=3)


def test_recreated_object_gets_its_own_correlation():
    def scenario(side, clock):
        old = make_node("ev-node")
        old.metadata["uid"] = "uid-old"
        side.rec.event(old, "Normal", "Cordon", "x")
        side.rec.event(old, "Normal", "Cordon", "x2")
        fresh = make_node("ev-node")
        fresh.metadata["uid"] = "uid-new"
        side.rec.event(fresh, "Normal", "Cordon", "x")
        evs = side.events()
        assert len(evs) == 3
        assert {e.raw["involvedObject"]["uid"] for e in evs} == {"uid-old", "uid-new"}

    _both(scenario, spam_burst=2, spam_refill_s=1000)


def test_eventf_formats_as_jax_does():
    def scenario(side, clock):
        node = make_node("ev-node")
        side.rec.eventf(node, "Warning", "Probe", "probe %s failed after %d s", "mxu", 3)
        side.rec.eventf(node, "Warning", "Probe", "probe %s failed after %d s", "mxu", 3)
        (ev,) = side.events()
        assert ev.raw["message"] == "probe mxu failed after 3 s" and ev.raw["count"] == 2

    _both(scenario)


def test_a_failed_create_leaves_no_phantom_entry():
    """A create the server refuses raises, and the next identical event
    creates the object rather than patching one that never existed."""

    class Refusing:
        def __init__(self, cluster):
            self.cluster, self.refuse = cluster, True

        def __getattr__(self, name):
            return getattr(self.cluster, name)

        def create(self, obj, *args, **kwargs):
            if self.refuse:
                self.refuse = False
                raise RuntimeError("refused")
            return self.cluster.create(obj, *args, **kwargs)

    cluster = FakeCluster()
    for cls, namespace in ((JaxRecorder, "jax"), (PortRecorder, "port")):
        rec = cls(Refusing(cluster), namespace=namespace, now_fn=Clock().now)
        node = make_node("ev-node")
        with pytest.raises(RuntimeError):
            rec.event(node, "Normal", "Cordon", "x")
        rec.event(node, "Normal", "Cordon", "x")
        (ev,) = cluster.list("Event", namespace=namespace)
        assert ev.raw["count"] == 1


def test_defaults_equal_jax():
    from k8s_operator_libs_tpu.kube import events as jax_events
    from k8s_operator_libs_tpu_torch.kube import events as port_events

    for name in ("AGGREGATE_THRESHOLD", "AGGREGATE_WINDOW_S", "SPAM_BURST", "SPAM_REFILL_S",
                 "_CACHE_SIZE", "EVENT_TYPE_NORMAL", "EVENT_TYPE_WARNING"):
        assert getattr(port_events, name) == getattr(jax_events, name), name
