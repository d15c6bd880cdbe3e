"""The port's tracing (``utils/tracing.py``, the spans and events of its
machine, ``tools/trace_view.py``), held against the JAX package's.

* The span library: every case of ``tests/test_tracing.py::TestSpanLibrary``
  on the port's module, and the same sequence of calls under one virtual
  clock gives equal records in both libraries.
* The machine's trace, pass by pass, on twin clusters: the JAX machine over
  a ``FakeCluster`` with a JAX tracer installed, the port's over
  ``RestClient`` and a ``LocalApiServer`` serving its twin with a port
  tracer installed, one virtual clock in both packages' ``faultpoints``.
  After each pass each side's new records of the machine's categories
  (``reconcile``, ``drain``, ``probe``, ``checkpoint``, ``write``) are
  normalized by their own package's ``normalize_records`` and must be
  equal: names, categories, attributes, parentage, events. Links are
  compared as counts (their trace ids are each tracer's own). The JAX
  tracer of these tests (:class:`BridgedJaxTracer`) hands the origin of a
  write that reached the JAX server over HTTP to the port's tracer, so the
  port's informer deliveries join the port's writes' traces.
* ``TestSettledZeroSpan``, ``TestBucketSecondsStats``, the cases of
  ``TestWirePropagation`` (keep-alive, pipelined and pipelined patches,
  the 429 retry's attempt and backoff spans, the origins of a watch
  resumed after a killed connection and of a hub's resumed frames), and
  the ``TestTraceView`` cases, on the port.
* A held Pod stream (``chaos_hold`` at ``watch.deliver``) aborts the next
  pass on both machines alike; the release heals.
* ``chip_smoke.py``'s traced ``checkpoint_roll`` and ``informer_roll``
  phases (the latter with its stale view), rehearsed on the CPU.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

import pytest

from builders import make_node
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator
from k8s_operator_libs_tpu.utils import faultpoints as jax_faultpoints
from k8s_operator_libs_tpu.utils import tracing as jax_tracing
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from k8s_operator_libs_tpu_torch.kube.informer import Informer
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.tools import trace_view
from k8s_operator_libs_tpu_torch.upgrade import (
    BuildStateError,
    ClusterUpgradeStateManager,
    DeviceClass,
    TaskRunner,
)
from k8s_operator_libs_tpu_torch.utils import faultpoints, tracing
from tools import trace_view as jax_trace_view
from torch_twins import LABELS, NS, Side, deliveries_caught_up, wait_until

POLICY = DriverUpgradePolicySpec.from_dict(
    {"autoUpgrade": True, "maxParallelUpgrades": 0, "maxUnavailable": "100%"}
)
#: The categories a machine stamps; ``wire`` (HTTP requests, server
#: dispatch, deliveries) differs by transport and is left out.
MACHINE_CATEGORIES = ("reconcile", "drain", "probe", "checkpoint", "write")


class Clock:
    """A virtual wall clock both packages' spans and deadlines read."""

    def __init__(self, start: float = 1_760_000_000.0) -> None:
        self.now = start

    def wall(self) -> float:
        return self.now


@pytest.fixture
def clock():
    c = Clock()
    jax_faultpoints.install_clock(c)
    faultpoints.install_clock(c)
    try:
        yield c
    finally:
        jax_faultpoints.clear_clock()
        faultpoints.clear_clock()


@pytest.fixture
def tracer():
    t = tracing.Tracer()
    tracing.install_tracer(t)
    try:
        yield t
    finally:
        tracing.clear_tracer()


class BridgedJaxTracer(jax_tracing.Tracer):
    """The JAX tracer of the twin tests. A write that reached a JAX API
    server over HTTP (the current JAX span a ``server.request``, joined to
    the port client's trace by its ``traceparent``) is the port's: its
    origin goes to the port's tracer, under the port span the request
    named, and stays out of this book, which holds the JAX machine's
    in-process writes alone."""

    def __init__(self, port: tracing.Tracer) -> None:
        super().__init__()
        self.port = port

    def record_write_origin(self, rv: str, trace_id: str, span_id: str) -> None:
        current = jax_tracing.current_span()
        if current is not None and current.name == "server.request":
            self.port.record_write_origin(rv, trace_id, current.parent_id)
            return
        super().record_write_origin(rv, trace_id, span_id)


class TraceTap:
    """Both tracers, and each side's records since the last :meth:`take`."""

    def __init__(self, jax: jax_tracing.Tracer, port: tracing.Tracer) -> None:
        self.jax, self.port = jax, port
        self.seen = {"jax": 0, "port": 0}
        self.passes = 0

    def take(self) -> dict:
        out = {}
        for name, t in (("jax", self.jax), ("port", self.port)):
            records = t.records()
            out[name] = records[self.seen[name]:]
            self.seen[name] = len(records)
        return out

    def compare(self, what: str) -> list:
        """The machine's records of both sides since the last take, equal
        once normalized (links by count); the port's."""
        new = self.take()
        jax = machine_trace(new["jax"], jax_tracing.normalize_records)
        port = machine_trace(new["port"], tracing.normalize_records)
        assert port == jax, what
        self.passes += 1
        return port


def machine_trace(records: list, normalize) -> list:
    kept = [r for r in records if r["category"] in MACHINE_CATEGORIES]
    out = []
    for record in normalize(kept):
        record = dict(record)
        record["links"] = len(record["links"])
        out.append(record)
    return out


@pytest.fixture
def tap():
    port = tracing.Tracer()
    jax = BridgedJaxTracer(port)
    tracing.install_tracer(port)
    jax_tracing.install_tracer(jax)
    try:
        yield TraceTap(jax, port)
    finally:
        jax_tracing.clear_tracer()
        tracing.clear_tracer()


# ----------------------------------------------------------------------
# TestSpanLibrary, on the port's module and against the JAX module
# ----------------------------------------------------------------------

LIBS = {"jax": (jax_tracing, jax_faultpoints), "port": (tracing, faultpoints)}


def run_on_both(sequence) -> dict:
    """``sequence(lib)`` under a fresh tracer of each library and one
    virtual clock (advanced by the sequence); each library's records."""
    out = {}
    for name, (lib, fp) in LIBS.items():
        clock = Clock()
        fp.install_clock(clock)
        t = lib.Tracer()
        lib.install_tracer(t)
        try:
            sequence(lib, clock)
        finally:
            lib.clear_tracer()
            fp.clear_clock()
        out[name] = t.records()
    return out


def test_disabled_path_is_null_singleton():
    assert tracing.tracer() is None
    scope_a = tracing.span("x", category="wire")
    scope_b = tracing.span("y")
    assert scope_a is scope_b  # the zero-allocation singleton
    with scope_a as span:
        assert span is None
    tracing.add_event("nothing")  # no-op, no raise
    assert tracing.traceparent() is None
    assert tracing.current_span() is None
    assert tracing.use_span(None) is scope_a
    tracing.record_write_origin("1")  # no tracer: nothing, no raise


def test_install_refuses_stacking(tracer):
    with pytest.raises(RuntimeError):
        tracing.install_tracer(tracing.Tracer())


def test_span_ids_parentage_events(tracer):
    with tracing.span("parent", category="reconcile", k="v") as parent:
        assert len(parent.trace_id) == 32
        assert len(parent.span_id) == 16
        with tracing.span("child", category="wire") as child:
            assert child.trace_id == parent.trace_id
            assert child.parent_id == parent.span_id
            tracing.add_event("evt", node="n1")
    records = tracer.records()
    assert [r["name"] for r in records] == ["child", "parent"]
    child_rec = records[0]
    assert child_rec["events"][0]["name"] == "evt"
    assert child_rec["events"][0]["attrs"] == {"node": "n1"}
    assert records[1]["attrs"] == {"k": "v"}


def test_ring_is_bounded():
    t = tracing.Tracer(capacity=8)
    for i in range(20):
        t.end_span(t.start_span(f"s{i}"))
    assert len(t.records()) == 8
    assert t.records()[0]["name"] == "s12"
    assert t.finished == 20


def test_use_span_propagates_across_threads(tracer):
    seen = []

    def worker(span):
        with tracing.use_span(span):
            tracing.add_event("cross-thread", who="worker")
            seen.append(tracing.current_trace_id())

    with tracing.span("bucket") as span:
        thread = threading.Thread(target=worker, args=(span,))
        thread.start()
        thread.join()
    assert seen == [span.trace_id]
    assert tracer.records()[0]["events"][0]["attrs"]["who"] == "worker"


def test_traceparent_roundtrip_and_malformed(tracer):
    with tracing.span("s"):
        header = tracing.traceparent()
    trace_id, span_id = tracing.parse_traceparent(header)
    assert len(trace_id) == 32 and len(span_id) == 16
    assert f"00-{trace_id}-{span_id}-01" == header
    for bad in ("", "junk", "00-short-x-01", "01-" + "a" * 32 + "-" + "b" * 16 + "-01",
                "00-" + "g" * 32 + "-" + "b" * 16 + "-01"):
        assert tracing.parse_traceparent(bad) is None
        assert jax_tracing.parse_traceparent(bad) is None
    # Either library's header parses in the other.
    assert jax_tracing.parse_traceparent(header) == (trace_id, span_id)


def test_write_origin_book_bounded():
    t = tracing.Tracer(origin_capacity=4)
    for rv in range(10):
        t.record_write_origin(str(rv), "t", "s")
    assert t.write_origin("0") is None
    assert t.write_origin("9") is not None


def test_normalize_renumbers_by_content():
    # Two tracers allocate ids in opposite order; the same content
    # exports the same bytes.
    def build(order):
        t = tracing.Tracer()
        spans = {}
        for name in order:
            spans[name] = t.start_span(name, category="wire", start=1.0)
        for name in reversed(order):
            t.end_span(spans[name], end=2.0)
        return tracing.normalize_records(t.records())

    a = build(["alpha", "beta"])
    b = build(["beta", "alpha"])
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_normalize_sorts_events():
    record = {
        "trace": "t", "span": "s", "parent": "", "name": "s",
        "category": "", "start": 1.0, "end": 2.0, "attrs": {},
        "events": [
            {"ts": 1.0, "name": "b", "attrs": {"node": "2"}},
            {"ts": 1.0, "name": "a", "attrs": {"node": "1"}},
        ],
        "links": [],
    }
    events = tracing.normalize_records([record])[0]["events"]
    assert [e["name"] for e in events] == ["a", "b"]


def _sequence_nested(lib, clock):
    with lib.span("parent", category="reconcile", k="v"):
        clock.now += 1.5
        with lib.span("child", category="wire") as child:
            lib.add_event("evt", node="n1")
            lib.record_write_origin(7)
            clock.now += 0.25
        lib.add_event("after", n=2)
    t = lib.tracer()
    origin = t.write_origin("7")
    assert origin == (child.trace_id, child.span_id, 1_760_000_001.5)
    linked = t.start_span("linked", category="reconcile")
    t.add_link(linked, child.trace_id)
    t.add_link(linked, "f" * 32)
    t.add_link(linked, "f" * 32)
    t.end_span(linked)
    t.add_span("queued", "queue", start=clock.now - 3.0, end=clock.now - 1.0,
               trace_id="a" * 32, parent_id="b" * 16, attrs={"flow": "x"})


def _sequence_threads(lib, clock):
    with lib.span("bucket", category="reconcile", bucket="cordon") as span:
        def worker():
            with lib.use_span(span):
                lib.add_event("state.transition", node="n", frm="a", to="b",
                              cause="bucket.cordon")
        thread = threading.Thread(target=worker)
        thread.start()
        thread.join()
        activation = lib.activate(None)
        assert lib.current_span() is None
        activation.close()
        assert lib.current_span() is span


def _sequence_ring(lib, clock):
    t = lib.tracer()
    for i in range(5):
        t.end_span(t.start_span(f"s{i}", category="write", attrs={"writes": i}))
        clock.now += 0.001


@pytest.mark.parametrize(
    "sequence", [_sequence_nested, _sequence_threads, _sequence_ring],
    ids=["nested-events-origins-links", "threads-activation", "sequential"],
)
def test_same_calls_give_equal_records_in_both_libraries(sequence):
    out = run_on_both(sequence)
    assert out["port"] == out["jax"]
    assert tracing.normalize_records(out["port"]) == jax_tracing.normalize_records(out["jax"])


def test_normalize_records_equals_jax_on_equal_input():
    records = [
        {"trace": "t2", "span": "b", "parent": "a", "name": "bucket.cordon",
         "category": "reconcile", "start": 1.0, "end": 2.0, "attrs": {"nodes": 2},
         "events": [{"ts": 1.5, "name": "state.transition", "attrs": {"node": "y"}},
                    {"ts": 1.5, "name": "state.transition", "attrs": {"node": "x"}}],
         "links": ["t9", "t1"]},
        {"trace": "t2", "span": "a", "parent": "", "name": "reconcile.pass",
         "category": "reconcile", "start": 1.0, "end": 3.0, "attrs": {"pass": 4},
         "events": [], "links": ["t1", "zz"]},
        {"trace": "t1", "span": "c", "parent": "gone", "name": "informer.deliver",
         "category": "wire", "start": 0.5, "end": 0.75, "attrs": {"rv": "3"},
         "events": [], "links": []},
    ]
    assert tracing.normalize_records(records) == jax_tracing.normalize_records(records)
    t = tracing.Tracer()
    jt = jax_tracing.Tracer()
    assert tracing.CATEGORIES == jax_tracing.CATEGORIES
    assert (tracing.DEFAULT_CAPACITY, tracing.DEFAULT_ORIGIN_CAPACITY,
            tracing.CHAOS_EXPORT_CUTOFF) == (jax_tracing.DEFAULT_CAPACITY,
                                             jax_tracing.DEFAULT_ORIGIN_CAPACITY,
                                             jax_tracing.CHAOS_EXPORT_CUTOFF)
    for lib_t in (t, jt):
        lib_t.end_span(lib_t.start_span("x", start=1.0), end=2.0)
    assert t.export_bytes() == jt.export_bytes()


# ----------------------------------------------------------------------
# The machine's trace, pass by pass, against the JAX machine's
# ----------------------------------------------------------------------

def _state_manager_twin(name: str, clock: Clock, tap: TraceTap) -> int:
    from test_torch_state_manager import SCENARIOS
    from test_torch_state_manager import Side as SmSide

    sc = SCENARIOS[name]
    health: dict = {}
    with contextlib.ExitStack() as stack:
        a, b = SmSide(sc, health, stack), SmSide(sc, health, stack)
        tap.take()  # the set-up
        for p in range(sc.max_passes):
            clock.now += sc.tick_s
            if sc.hook is not None:
                for side in (a, b):
                    sc.hook(p, side, health)
            a.one_pass("jax")
            b.one_pass("port")
            tap.compare(f"{name}: pass {p}")
            if a.settled() and b.settled():
                return p + 1
    raise AssertionError(f"{name}: no convergence")


@pytest.mark.parametrize(
    "name", ["drain-pod-selector", "validation-passes", "pod-deletion-then-drain"]
)
def test_port_trace_equals_jax_trace_pass_by_pass(name, clock, tap):
    """An in-place roll with a drain, one with validation by probe pods, and
    one with pod deletion then a drain."""
    passes = _state_manager_twin(name, clock, tap)
    names = {r["name"] for r in tap.port.records()}
    wanted = {
        "drain-pod-selector": {"drain.node", "bucket.drain-sched"},
        "validation-passes": {"drain.node", "validate.node", "bucket.validation"},
        # Each node's pods go by deletion alone: no drain follows.
        "pod-deletion-then-drain": {"evict.node", "bucket.pod-deletion"},
    }[name]
    assert {"reconcile.pass", "bucket.cordon"} | wanted <= names, names
    assert tap.passes == passes


def test_checkpoint_arc_trace_equals_jax(clock, tap):
    from test_torch_checkpoint import NEW, Scenario, Twin, checkpoint_policy

    with contextlib.ExitStack() as stack:
        twin = Twin(Scenario(), clock, stack)
        tap.take()
        twin.a.sim.set_template_hash(NEW)
        twin.b.sim.set_template_hash(NEW)

        def after(p, side):
            if side is twin.b:
                tap.compare(f"checkpoint arc: pass {p}")

        twin.roll(checkpoint_policy(), after=after)
    events = [e["name"] for r in tap.port.records() for e in r["events"]]
    for name in ("checkpoint.request", "checkpoint.complete", "checkpoint.restore_verified"):
        assert name in events, events


def test_quarantine_arc_trace_equals_jax(clock, tap):
    from test_torch_quarantine import Twin, quarantine_policy

    clock.now = 1000.0
    with contextlib.ExitStack() as stack:
        h = Twin(4, clock, stack)
        policy = quarantine_policy(reprobe_backoff_seconds=10, handoff_after_seconds=100)
        tap.take()

        def passes(n: int, what: str) -> None:
            for i in range(n):
                h.one_pass(policy)
                tap.compare(f"quarantine arc: {what} {i}")

        passes(1, "settle")
        h.publish("node-1", bad=True)
        tap.take()  # the reports' deliveries
        passes(2, "quarantined")
        clock.now = 1101.0
        passes(1, "handed off")
        assert h.state_of("node-1") == "upgrade-required"
        passes(8, "rolled")
    names = {r["name"] for r in tap.port.records()}
    assert "bucket.quarantine" in names


def test_incremental_batched_trace_equals_jax(clock, tap):
    """The incremental informer source with batched writes: the pass and
    bucket spans, the ``write.flush`` spans and the wake links' counts."""
    from test_torch_incremental_state import incremental

    with contextlib.ExitStack() as stack:
        sides = {name: Side(name, stack, nodes=3) for name in ("jax", "port")}
        machines = {name: incremental(side, batch_writes=True)
                    for name, side in sides.items()}
        for side in sides.values():
            side.sim.set_template_hash("v2")
        tap.take()
        links = []
        for p in range(40):
            for name, side in sides.items():
                side.sim.step()
                mgr, source = machines[name]
                assert wait_until(lambda: deliveries_caught_up(source, side.cluster))
                try:
                    mgr.apply_state(mgr.build_state(NS, LABELS), side.pkg.policy)
                except side.pkg.upgrade.BuildStateError:
                    pass
            records = tap.compare(f"incremental: pass {p}")
            links += [r["links"] for r in records if r["name"] == "reconcile.pass"]
            if all(side.sim.all_pods_ready_and_current() and all(
                    side.state(f"node-{i}") == "upgrade-done" for i in range(3))
                   for side in sides.values()):
                break
        else:
            raise AssertionError("the incremental roll did not converge")
    names = {r["name"] for r in tap.port.records()}
    assert {"write.flush", "informer.deliver", "reconcile.pass"} <= names
    assert sum(links) > 0  # the passes link to the writes that woke them


# ----------------------------------------------------------------------
# TestSettledZeroSpan and TestBucketSecondsStats, on the port's machine
# ----------------------------------------------------------------------

def make_harness(stack: contextlib.ExitStack, nodes: int = 3, incremental: bool = True):
    """A pool in a ``FakeCluster`` served by a ``LocalApiServer``, the
    port's machine over ``RestClient`` on an incremental informer source."""
    cluster = FakeCluster()
    for i in range(nodes):
        cluster.create(make_node(f"node-{i}"))
    sim = DaemonSetSimulator(cluster, name="driver", namespace=NS, match_labels=LABELS)
    sim.settle()
    server = stack.enter_context(LocalApiServer(cluster=cluster))
    mgr = ClusterUpgradeStateManager(
        RestClient(RestConfig(server=server.url)), DeviceClass.nvidia("gpu"),
        runner=TaskRunner(inline=True),
    )
    source = mgr.with_snapshot_from_informers(
        NS, LABELS, resync_period_s=0.0, incremental=incremental
    )
    stack.callback(source.stop)
    return cluster, sim, mgr, source


def one_pass(mgr) -> bool:
    try:
        mgr.apply_state(mgr.build_state(NS, LABELS), POLICY)
        return True
    except BuildStateError:
        return False  # the completeness race; retried


def roll_to_done(cluster, sim, mgr, deadline_s: float = 30.0) -> None:
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        sim.step()
        one_pass(mgr)
        sim.step()
        if sim.all_pods_ready_and_current() and all(
            n.labels.get(mgr.keys.state_label) == "upgrade-done" for n in cluster.list("Node")
        ):
            return
        time.sleep(0.01)
    raise AssertionError("roll did not converge")


def settle(mgr, sim, deadline_s: float = 15.0) -> None:
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        sim.step()
        if one_pass(mgr) and mgr.last_pass_stats.snapshot_skipped:
            return
        time.sleep(0.01)
    raise AssertionError("pool did not settle")


def test_settled_passes_emit_zero_spans(tracer):
    with contextlib.ExitStack() as stack:
        cluster, sim, mgr, source = make_harness(stack)
        sim.set_template_hash("v2")
        roll_to_done(cluster, sim, mgr)
        settle(mgr, sim)
        time.sleep(0.2)  # drain stray watch echoes
        one_pass(mgr)
        started_before = tracer.started
        for _ in range(10):
            assert one_pass(mgr)
            assert mgr.last_pass_stats.snapshot_skipped
        assert tracer.started == started_before
        assert mgr.last_pass_stats.bucket_seconds == {}


def test_rolling_pass_emits_pass_and_bucket_spans(tracer):
    with contextlib.ExitStack() as stack:
        cluster, sim, mgr, source = make_harness(stack, nodes=2)
        sim.set_template_hash("v2")
        roll_to_done(cluster, sim, mgr)
    records = tracer.records()
    names = {r["name"] for r in records}
    assert "reconcile.pass" in names
    passes = {r["span"]: r for r in records if r["name"] == "reconcile.pass"}
    buckets = [r for r in records if r["name"].startswith("bucket.")]
    assert buckets
    assert all(b["parent"] in passes for b in buckets)
    assert [b for b in buckets if b["name"] == "bucket.cordon"], names
    # Each request of the machine is a wire span under the span that made it.
    requests = [r for r in records if r["name"] == "http.request"]
    assert requests and all(r["category"] == "wire" for r in requests)
    by_id = {r["span"]: r for r in records}
    assert any(by_id.get(r["parent"], {}).get("name", "").startswith("bucket.")
               for r in requests)


def test_state_transitions_ride_bucket_spans_with_cause(tracer):
    with contextlib.ExitStack() as stack:
        cluster, sim, mgr, source = make_harness(stack, nodes=2)
        sim.set_template_hash("v2")
        roll_to_done(cluster, sim, mgr)
    by_node: dict[str, list] = {}
    for record in tracer.records():
        for event in record["events"]:
            if event["name"] == "state.transition":
                attrs = event["attrs"]
                assert attrs["cause"] == record["name"]
                by_node.setdefault(attrs["node"], []).append(attrs)
    journey = [t["to"] for t in by_node["node-0"]]
    assert journey[-1] == "upgrade-done"
    assert "cordon-required" in journey


def test_pass_links_to_waking_write(tracer):
    """A write made under trace T (over HTTP: the port client's span, the
    server's write origin bridged back) dirties a node through the
    informer; a later pass span links to T."""
    with contextlib.ExitStack() as stack:
        jax = BridgedJaxTracer(tracer)
        jax_tracing.install_tracer(jax)
        stack.callback(jax_tracing.clear_tracer)
        cluster, sim, mgr, source = make_harness(stack, nodes=2)
        sim.set_template_hash("v2")
        roll_to_done(cluster, sim, mgr)
        settle(mgr, sim)
        time.sleep(0.2)
        one_pass(mgr)
        with tracing.span("external.write", category="grant") as ext:
            mgr.client.patch("Node", "node-0", patch={"metadata": {"labels": {"poke": "1"}}})
        deadline = time.time() + 10
        linked = None
        while time.time() < deadline and linked is None:
            one_pass(mgr)
            linked = next((r for r in tracer.records() if r["name"] == "reconcile.pass"
                           and ext.trace_id in r["links"]), None)
            time.sleep(0.02)
        assert linked is not None, "no pass linked the waking write"
        delivered = [r for r in tracer.records() if r["name"] == "informer.deliver"
                     and r["trace"] == ext.trace_id]
        assert delivered and delivered[0]["attrs"]["kind"] == "Node"


def test_pass_stats_carry_bucket_seconds():
    with contextlib.ExitStack() as stack:
        cluster, sim, mgr, source = make_harness(stack, nodes=2)
        sim.set_template_hash("v2")
        seen: set[str] = set()
        deadline = time.time() + 30
        while time.time() < deadline:
            sim.step()
            one_pass(mgr)
            seen.update(mgr.last_pass_stats.bucket_seconds)
            sim.step()
            if sim.all_pods_ready_and_current() and all(
                n.labels.get(mgr.keys.state_label) == "upgrade-done"
                for n in cluster.list("Node")
            ):
                break
            time.sleep(0.01)
        assert "cordon" in seen
        assert any(s.startswith("classify[") for s in seen)
        assert all(v >= 0.0 for v in mgr.last_pass_stats.bucket_seconds.values())
        assert mgr.last_pass_stats.snapshot_s >= 0.0 and mgr.last_pass_stats.apply_s >= 0.0


# ----------------------------------------------------------------------
# TestWirePropagation: the port's client under a port span, a JAX server
# ----------------------------------------------------------------------

@pytest.fixture
def both_tracers(tracer):
    jax = jax_tracing.Tracer()
    jax_tracing.install_tracer(jax)
    try:
        yield jax, tracer
    finally:
        jax_tracing.clear_tracer()


def _server_spans(jax, trace_id: str, n: int) -> list:
    # The last response can reach the client a beat before the server's
    # coroutine ends its span.
    deadline = time.time() + 5
    spans: list = []
    while time.time() < deadline and len(spans) < n:
        spans = [r for r in jax.records()
                 if r["name"] == "server.request" and r["trace"] == trace_id]
        time.sleep(0.01)
    return spans


def test_keepalive_requests_carry_traceparent(both_tracers):
    """Every request of the port's client under a port span, all on one
    kept-alive connection, reaches the server as a span of the client's
    trace, each a child of its own ``http.request`` span."""
    jax, port = both_tracers
    with LocalApiServer() as server:
        client = RestClient(RestConfig(server=server.url))
        with tracing.span("client.op") as op:
            for i in range(5):
                client.create(make_node(f"w{i}"))
            client.list("Node")
        server_spans = _server_spans(jax, op.trace_id, 6)
        assert client.transport_stats()["connections_opened"] == 1
        client.close()
    assert len(server_spans) >= 6
    requests = {r["span"]: r for r in port.records() if r["name"] == "http.request"}
    assert len(requests) == 6
    assert all(r["trace"] == op.trace_id and r["parent"] == op.span_id
               for r in requests.values())
    assert {r["parent"] for r in server_spans} == set(requests)
    assert sorted(r["attrs"]["method"] for r in requests.values()) == ["GET"] + ["POST"] * 5
    assert all(r["attrs"]["status"] in (200, 201) for r in requests.values())


def test_apf_queue_wait_is_child_span(both_tracers):
    jax, port = both_tracers
    with LocalApiServer() as server:  # priority and fairness on by default
        client = RestClient(RestConfig(server=server.url))
        with tracing.span("client.op") as op:
            client.create(make_node("apf-node"))
        server_spans = _server_spans(jax, op.trace_id, 1)
    assert server_spans
    queue_spans = [r for r in jax.records()
                   if r["name"] == "apf.queue" and r["trace"] == op.trace_id]
    assert queue_spans, "queue wait not decomposed"
    by_id = {r["span"]: r for r in jax.records()}
    for q in queue_spans:
        assert by_id[q["parent"]]["name"] == "server.request"
        assert q["attrs"]["flow"] == "reconcile"


def test_error_status_is_recorded_and_watch_carries_traceparent(both_tracers):
    jax, port = both_tracers
    with LocalApiServer() as server:
        client = RestClient(RestConfig(server=server.url))
        with tracing.span("client.op") as op:
            assert client.get_or_none("Node", "absent") is None
            events = client.watch("Node", timeout_seconds=1)
            assert list(events) == []
        server_spans = _server_spans(jax, op.trace_id, 2)
    (request,) = [r for r in port.records() if r["name"] == "http.request"]
    assert request["attrs"]["status"] == 404
    assert len(server_spans) == 2  # the GET and the watch


def test_pipelined_request_many_carries_traceparent(both_tracers):
    """A primed batch of lists and a batch of patches, each pipelined on
    one connection: every request of them joins the caller's trace, and
    the patches sit under one ``http.request_many`` span."""
    jax, port = both_tracers
    with LocalApiServer() as server:
        client = RestClient(RestConfig(server=server.url))
        for i in range(3):
            client.create(make_node(f"p{i}"))
        with tracing.span("seed") as seed:
            assert client.prime_list_cache([("Node", "", None, None), ("Pod", NS, None, None)]) == 2
        assert len(_server_spans(jax, seed.trace_id, 2)) == 2
        with tracing.span("flush") as flush:
            results = client.patch_many("Node", [
                (f"p{i}", {"metadata": {"labels": {"x": "1"}}}, "merge") for i in range(3)])
        assert [r.name for r in results] == ["p0", "p1", "p2"]
        assert len(_server_spans(jax, flush.trace_id, 3)) == 3
        assert client.transport_stats()["pipelined_batches"] == 2
        client.close()
    (batch,) = [r for r in port.records() if r["name"] == "http.request_many"]
    assert batch["trace"] == flush.trace_id and batch["parent"] == flush.span_id
    assert batch["attrs"] == {"method": "PATCH", "requests": 3, "errors": 0}


def test_429_retries_are_children_of_one_logical_span(tracer):
    """A stub server sheds the first attempt with 429 and Retry-After,
    then answers: one ``http.request`` span, the retry an ``http.attempt``
    child, the wait an ``http.backoff`` (category ``queue``); each attempt
    carried a traceparent of its own in the request's trace."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)
    port = sock.getsockname()[1]
    hits = []

    def serve():
        for attempt in range(2):
            conn, _ = sock.accept()
            data = b""
            while b"\r\n\r\n" not in data:
                data += conn.recv(65536)
            hits.append(data)
            if attempt == 0:
                body = json.dumps({"kind": "Status", "reason": "TooManyRequests",
                                   "message": "shed", "code": 429}).encode()
                head = ("HTTP/1.1 429 Too Many Requests\r\nRetry-After: 0.05\r\n"
                        f"Content-Length: {len(body)}\r\nContent-Type: application/json\r\n\r\n")
            else:
                body = json.dumps({"kind": "Node",
                                   "metadata": {"name": "ok", "resourceVersion": "1"}}).encode()
                head = ("HTTP/1.1 200 OK\r\n"
                        f"Content-Length: {len(body)}\r\nContent-Type: application/json\r\n\r\n")
            conn.sendall(head.encode() + body)
            conn.close()
        sock.close()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    client = RestClient(RestConfig(server=f"http://127.0.0.1:{port}"))
    try:
        assert client.get("Node", "ok").name == "ok"
    finally:
        client.close()
    thread.join(timeout=5)
    assert all(b"traceparent:" in hit.lower() for hit in hits)
    records = tracer.records()
    (logical,) = [r for r in records if r["name"] == "http.request"]
    assert logical["attrs"]["status"] == 200
    (attempt,) = [r for r in records if r["name"] == "http.attempt"]
    assert attempt["parent"] == logical["span"]
    (backoff,) = [r for r in records if r["name"] == "http.backoff"]
    assert backoff["category"] == "queue"
    tps = [[line for line in hit.split(b"\r\n") if line.lower().startswith(b"traceparent:")][0]
           for hit in hits]
    assert tps[0] != tps[1] and all(logical["trace"] in tp.decode() for tp in tps)


def test_killed_connection_watch_resume_keeps_origins(tap):
    """A watch killed and resumed (no re-list) delivers the write made
    after the kill with that write's trace: origins are keyed by rv."""
    with LocalApiServer() as server:
        client = RestClient(RestConfig(server=server.url))
        server.cluster.create(make_node("w0"))
        informer = Informer(client, "Node")
        informer.start()
        try:
            assert informer.wait_for_sync(10)
            with tracing.span("writer.one") as one:
                client.patch("Node", "w0", patch={"metadata": {"labels": {"a": "1"}}})
            assert wait_until(lambda: informer.get("w0").labels.get("a") == "1")
            assert server.kill_connections() >= 1
            with tracing.span("writer.two") as two:
                rv = client.patch("Node", "w0",
                                  patch={"metadata": {"labels": {"a": "2"}}}).resource_version
            deliveries: list = []
            assert wait_until(lambda: bool(deliveries.extend(
                r for r in tap.port.records()
                if r["name"] == "informer.deliver" and r["attrs"].get("rv") == rv) or deliveries))
            assert deliveries[0]["trace"] == two.trace_id != one.trace_id
            assert informer.full_relists == 1
        finally:
            informer.stop()
            client.close()


def test_hub_resume_frames_keep_origins(tap):
    """A subscriber of the port's hub with a buffer of two, a burst of
    eight writes: each delivery, replayed from the hub's journal or not,
    joins its own write's trace."""
    from k8s_operator_libs_tpu_torch.kube.watchhub import WatchHub

    with LocalApiServer() as server:
        client = RestClient(RestConfig(server=server.url))
        server.cluster.create(make_node("h0"))
        hub = WatchHub(client, buffer_limit=2, idle_linger_s=0.0)
        informer = Informer(client, "Node", stream_source=hub)
        informer.start()
        try:
            assert informer.wait_for_sync(10)
            traces = {}
            for i in range(8):
                with tracing.span(f"writer.{i}") as w:
                    patched = client.patch("Node", "h0",
                                           patch={"metadata": {"labels": {"i": str(i)}}})
                    traces[patched.resource_version] = w.trace_id
            last_rv = max(traces, key=int)
            delivered: dict = {}

            def caught_up() -> bool:
                delivered.update({r["attrs"]["rv"]: r["trace"] for r in tap.port.records()
                                  if r["name"] == "informer.deliver"
                                  and r["attrs"].get("rv") in traces})
                return last_rv in delivered

            assert wait_until(caught_up), "the burst was never delivered"
            assert all(trace_id == traces[rv] for rv, trace_id in delivered.items())
        finally:
            informer.stop()
            hub.stop()
            client.close()


# ----------------------------------------------------------------------
# chaos_hold: a held Pod stream aborts the next pass on both machines
# ----------------------------------------------------------------------

class HoldPods:
    def __init__(self, fp) -> None:
        self.fp = fp
        self.holds = 0

    def consult(self, point: str, ctx: dict):
        if point == "watch.deliver" and ctx.get("kind") == "Pod":
            self.holds += 1
            return self.fp.FaultAction(self.fp.HOLD)
        return None


def test_held_pod_stream_aborts_the_pass_on_both_machines():
    from test_torch_incremental_state import incremental

    with contextlib.ExitStack() as stack:
        sides = {name: Side(name, stack, nodes=3) for name in ("jax", "port")}
        machines = {name: incremental(side) for name, side in sides.items()}
        for name, side in sides.items():
            mgr, source = machines[name]
            assert wait_until(lambda: deliveries_caught_up(source, side.cluster))
            mgr.apply_state(mgr.build_state(NS, LABELS), side.pkg.policy)
        plans = {"jax": HoldPods(jax_faultpoints), "port": HoldPods(faultpoints)}
        jax_faultpoints.install_plan(plans["jax"])
        faultpoints.install_plan(plans["port"])
        try:
            for name, side in sides.items():
                side.cluster.create(make_node("node-3"))
                side.sim.step()  # the driver pod, and the desired count 4
                source = machines[name][1]

                def stale(side=side, source=source, plan=plans[name]) -> bool:
                    ds = source.informer("DaemonSet").list()
                    return plan.holds > 0 and [
                        (d.raw.get("status") or {}).get("desiredNumberScheduled") for d in ds
                    ] == [4]

                assert wait_until(stale)
            for name, side in sides.items():
                mgr = machines[name][0]
                with pytest.raises(side.pkg.upgrade.BuildStateError):
                    mgr.build_state(NS, LABELS)
        finally:
            jax_faultpoints.clear_plan()
            faultpoints.clear_plan()
        counters = {
            name: (m.completeness_aborts_total, m.last_pass_stats.aborted_completeness_races)
            for name, (m, _) in machines.items()
        }
        assert counters["port"] == counters["jax"] == (1, 1)
        for name, side in sides.items():
            mgr, source = machines[name]
            assert wait_until(lambda: deliveries_caught_up(source, side.cluster))
            state = mgr.build_state(NS, LABELS)
            assert mgr.last_pass_stats.full_rebuild
            assert mgr.last_pass_stats.aborted_completeness_races == 1
            assert "node-3" in {ns.node.name for group in state.node_states.values()
                                for ns in group}
            mgr.apply_state(state, side.pkg.policy)
        assert sides["port"].state("node-3") == sides["jax"].state("node-3") == "upgrade-done"


def test_chaos_hold_returns_without_a_plan_and_yields_to_stop():
    calls = []
    faultpoints.chaos_hold("watch.deliver", lambda: False, kind="Pod")  # no plan: returns

    class Always:
        def consult(self, point, ctx):
            calls.append((point, ctx))
            return faultpoints.FaultAction(faultpoints.HOLD)

    stop = threading.Event()
    faultpoints.install_plan(Always())
    try:
        threading.Timer(0.05, stop.set).start()
        faultpoints.chaos_hold("watch.deliver", stop.is_set, poll_s=0.005, kind="Pod", tag="t")
    finally:
        faultpoints.clear_plan()
    assert calls and calls[0] == ("watch.deliver", {"kind": "Pod", "tag": "t"})
    assert (faultpoints.DENY, faultpoints.RAISE, faultpoints.HOLD, faultpoints.OVERFLOW) == (
        jax_faultpoints.DENY, jax_faultpoints.RAISE, jax_faultpoints.HOLD,
        jax_faultpoints.OVERFLOW)


# ----------------------------------------------------------------------
# TestTraceView, on the port's tool and against the JAX repository's
# ----------------------------------------------------------------------

def _spans():
    return [
        {"trace": "t1", "span": "a", "parent": "", "name": "pass",
         "category": "reconcile", "start": 0.0, "end": 10.0,
         "attrs": {"pass": 1, "worker": "w0"}, "events": [], "links": []},
        {"trace": "t1", "span": "b", "parent": "a", "name": "bucket.drain-sched",
         "category": "drain", "start": 2.0, "end": 6.0, "attrs": {},
         "events": [{"ts": 2.5, "name": "state.transition",
                     "attrs": {"node": "n1", "frm": "a", "to": "b",
                               "cause": "bucket.drain-sched"}}],
         "links": ["t9"]},
        {"trace": "t2", "span": "c", "parent": "", "name": "q", "category": "queue",
         "start": 12.0, "end": 14.0, "attrs": {}, "events": [], "links": []},
    ]


def test_attribution_deepest_span_wins():
    result = trace_view.attribution(_spans())
    categories = result["categories"]
    assert categories["reconcile"] == pytest.approx(6.0)
    assert categories["drain"] == pytest.approx(4.0)
    assert categories["queue"] == pytest.approx(2.0)
    assert categories["idle"] == pytest.approx(2.0)
    assert result["coverage"] == pytest.approx(12.0 / 14.0)
    assert result == jax_trace_view.attribution(_spans())


def test_node_journey_resolves_pass_and_links():
    spans = _spans()
    spans[0]["name"] = "reconcile.pass"
    spans[0]["links"] = ["t9"]
    journey = trace_view.node_journey(spans, "n1")
    assert len(journey) == 1
    leg = journey[0]
    assert leg["cause"] == "bucket.drain-sched"
    assert leg["pass"] == 1
    assert leg["worker"] == "w0"
    assert leg["woken_by"] == ["t9"]
    assert journey == jax_trace_view.node_journey(spans, "n1")


def test_cli_assert_coverage(tmp_path, capsys):
    path = tmp_path / "trace.jsonl"
    with open(path, "w") as f:
        for span in _spans():
            f.write(json.dumps(span) + "\n")
    for argv in ([str(path), "--assert-coverage", "0.5"],
                 [str(path), "--assert-coverage", "0.99"],
                 [str(path), "--node", "n1"],
                 [str(path), "--json"],
                 [str(path), "--node", "n1", "--json"]):
        rc = trace_view.main(argv)
        ours = capsys.readouterr()
        assert rc == jax_trace_view.main(argv), argv
        theirs = capsys.readouterr()
        assert (ours.out, ours.err) == (theirs.out, theirs.err), argv
    assert trace_view.main([str(path), "--assert-coverage", "0.5"]) == 0
    assert trace_view.main([str(path), "--assert-coverage", "0.99"]) == 1


def test_port_export_reads_alike_in_both_tools(tmp_path, clock, tap):
    """A JSONL the port's tracer exported from a twin roll: the port's tool
    and the JAX repository's give the same attribution and journeys."""
    _state_manager_twin("validation-passes", clock, tap)
    path = str(tmp_path / "port.jsonl")
    assert tap.port.export_jsonl(path) == len(tap.port.records())
    spans = trace_view.load_spans(path)
    assert spans == jax_trace_view.load_spans(path)
    assert trace_view.attribution(spans) == jax_trace_view.attribution(spans)
    for node in ("gpu-00", "gpu-01", "gpu-02", "gpu-03"):
        journey = trace_view.node_journey(spans, node)
        assert journey == jax_trace_view.node_journey(spans, node)
        assert journey[-1]["to"] == "upgrade-done"
        assert all(leg["pass"] is not None for leg in journey)
    deterministic = str(tmp_path / "normalized.jsonl")
    tap.port.export_jsonl(deterministic, deterministic=True)
    assert trace_view.load_spans(deterministic) == tracing.normalize_records(tap.port.records())


# ----------------------------------------------------------------------
# chip_smoke.py's traced phases, rehearsed on the CPU
# ----------------------------------------------------------------------

@pytest.fixture
def smoke(monkeypatch):
    from k8s_operator_libs_tpu_torch.parallel import topology
    from test_torch_cuda import chip_smoke_module

    module = chip_smoke_module()
    monkeypatch.setattr(topology, "local_gpu_labels", lambda: {
        "nvidia.com/gpu.present": "true", "nvidia.com/gpu.count": "1",
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
    })
    monkeypatch.setattr(module, "ROLL_PASS_INTERVAL_S", 0.0)
    return module


def _printed(out: str, key: str) -> list:
    """The ``{key: ...}`` lines of what the phase printed."""
    return [json.loads(line)[key] for line in out.splitlines()
            if line.startswith("{") and f'"{key}"' in line.split(":", 1)[0]]


def test_chip_smoke_traced_checkpoint_roll_on_the_cpu(smoke, tmp_path, capsys):
    """The checkpoint phase's roll under ``TracedPhase``: whole journeys, the
    arc's events, every pass observed and scraped over HTTP."""
    from k8s_operator_libs_tpu_torch.kube.sim import CheckpointingWorkloadSimulator
    from test_torch_checkpoint import SMALL

    nodes = smoke.CHECKPOINT_NODES
    client = smoke.DictClient()
    installer = smoke.roll_pool(client, nodes)
    mgr = ClusterUpgradeStateManager(client, DeviceClass.nvidia("gpu"),
                                     runner=TaskRunner(inline=True))
    workload = CheckpointingWorkloadSimulator(client, mgr.keys, namespace=smoke.TRAINING_NS,
                                              name="trainer")
    trainer = smoke.Trainer(client, workload, mgr.keys, SMALL, "cpu", smoke.TRAINER_SEED,
                            str(tmp_path), nodes)
    kubelet = smoke.RollKubelet(client, installer, nodes, "", {}, {})
    traced = smoke.TracedPhase("checkpoint_roll")
    try:
        traced.serve(mgr)
        run = smoke.checkpoint_roll(client, mgr, installer, kubelet, workload, trainer,
                                    observe=traced.observe)
        report = traced.report(str(tmp_path), nodes, "cpu")
    finally:
        traced.close()
    assert tracing.tracer() is None
    (trace,) = _printed(capsys.readouterr().out, "trace")
    assert trace == report["trace"]
    assert traced.observed == run["passes"] - run["build_state_retries"]
    gauges = report["metrics"]["gauges"]
    assert gauges["reconcile_passes_total"] == traced.observed
    assert gauges["checkpoint_escalations_total"] == 0
    assert gauges["checkpoint_completed_total"] == 2
    events = trace["events_by_name"]
    assert events["checkpoint.complete"] == events["checkpoint.restore_verified"] == 2
    assert "checkpoint.escalate" not in events
    for node in nodes:
        legs = trace["journeys"][node]
        assert [leg[2] for leg in legs][-1] == "upgrade-done"
        assert "checkpoint-required" in [leg[2] for leg in legs]
        assert all(leg[4].startswith("bucket.") for leg in legs)
    assert trace["attribution"]["categories"]


def _settled_run(smoke) -> list:
    """What ``settled_passes`` gives for a settled pool: the roll's last
    write consumed by the first pass, an audit every ``VERIFY_EVERY_N``-th
    build, every other pass served from the kept state."""
    out = []
    for i in range(smoke.SETTLED_PASSES):
        audit = (i + 2) % smoke.VERIFY_EVERY_N == 0
        work = audit or i == 0
        ended = [("bucket.classify[upgrade-done]", "reconcile"),
                 ("reconcile.pass", "reconcile")] if work else []
        out.append({"audit": audit, "snapshot_skipped": not work, "full_rebuild": audit,
                    "spans": len(ended), "ended": ended,
                    "bucket_seconds": {"classify[upgrade-done]": 1e-4} if work else {}})
    return out


def _more_spans(p):
    p["ended"] = [*p["ended"], ("drain.node", "drain")]
    p["spans"] += 1


def _open_span(p):
    p["spans"] += 1


def _second_pass_span(p):
    p["ended"] = [*p["ended"], ("reconcile.pass", "reconcile")]
    p["spans"] += 1


def _skipped_bucket(p):
    p["bucket_seconds"] = {"classify[upgrade-done]": 1e-4}


@pytest.mark.parametrize("index, fault", [
    (None, None),
    (0, _more_spans),
    (3, _open_span),
    (3, _second_pass_span),
    (1, _skipped_bucket),
    (1, _open_span),
])
def test_chip_smoke_settled_span_check(smoke, index, fault):
    """``check_settled_spans`` passes a settled run and refuses a pass that
    traced more than its kind allows."""
    settled = _settled_run(smoke)
    if fault is None:
        smoke.check_settled_spans(settled)
        return
    fault(settled[index])
    with pytest.raises(AssertionError):
        smoke.check_settled_spans(settled)


def test_chip_smoke_settled_span_check_counts_the_audits(smoke):
    """An audit fewer, or a delta pass after the first, is refused."""
    settled = _settled_run(smoke)
    settled[3]["audit"] = False
    with pytest.raises(AssertionError):
        smoke.check_settled_spans(settled)
    settled = _settled_run(smoke)
    settled[1].update(snapshot_skipped=False, spans=1, ended=[("reconcile.pass", "reconcile")])
    with pytest.raises(AssertionError):
        smoke.check_settled_spans(settled)


def test_chip_smoke_traced_informer_roll_and_stale_view_on_the_cpu(smoke, monkeypatch, tmp_path,
                                                                  capsys):
    """The informer_roll phase whole, traced, with each probe pod's payload
    replaced by a stub: the settled passes served from the kept state start
    no span, the held Pod stream aborts one pass (counted), the heal's first
    pass is a full rebuild, the joining node needs no probe pod."""
    launches = {"matmul": 1165, "flash_attention": 4}

    def probe_pod(container, host_paths, workdir, label):
        return {"seconds_to_ready": 0.0, "launches": dict(launches),
                "build_s": {"matmul": 0.0, "flash_attention": 0.0}}

    monkeypatch.setattr(smoke, "run_probe_pod", probe_pod)
    result = smoke.informer_roll_phase("cpu", launches, str(tmp_path))
    assert tracing.tracer() is None and faultpoints._plan is None
    stale = result["stale_view"]
    assert stale["abort"]["aborted_completeness_races"] == 1
    assert stale["completeness_aborts_total"] == 1
    assert stale["heal"][0]["full_rebuild"] and stale["heal"][-1]["snapshot_skipped"]
    assert stale["joined_state"] == "upgrade-done"
    assert not stale["probe_pod_for_joined"]
    assert stale["pods_in_store_at_abort"] == len(smoke.INFORMER_NODES)
    skipped = [p for p in result["settled"] if p["snapshot_skipped"]]
    assert len(skipped) >= 7
    assert all(p["spans"] == 0 and p["bucket_seconds"] == {} for p in skipped)
    audits = [p for p in result["settled"] if p["audit"]]
    assert len(audits) == smoke.SETTLED_PASSES // smoke.VERIFY_EVERY_N
    for p in result["settled"]:
        if not p["snapshot_skipped"]:
            assert [name for name, _ in p["ended"]].count("reconcile.pass") == 1
            assert {category for _, category in p["ended"]} == {"reconcile"}
    assert all(p["spans"] is None for p in result["settled_untraced"])
    assert result["cluster_nodes"] == 259
    out = capsys.readouterr().out
    (trace,) = _printed(out, "trace")
    (metrics,) = _printed(out, "metrics")
    assert metrics["gauges"]["reconcile_passes_total"] == result["observed_passes"]
    assert metrics["gauges"]["pass_aborted_completeness_races"] == 1
    assert metrics["pass_bucket_seconds"]
    assert trace["spans_by_name"]["informer.deliver"] > 0
    assert trace["spans_by_name"]["write.flush"] > 0
    for node in smoke.INFORMER_NODES:
        legs = trace["journeys"][node]
        assert legs[-1][2] == "upgrade-done"
        assert any(leg[6] for leg in legs)  # woken by the writes before it

