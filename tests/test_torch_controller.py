"""The port's controller runtime against the JAX package's, case by case.

Every case of ``tests/test_controller.py`` runs once with each package's
``Controller`` and ``Informer`` on the same writes: the JAX pair over a
``FakeCluster`` in process, the port's over the port's ``RestClient`` at a
``LocalApiServer`` serving another one (the JAX case's list outage, a
cluster reactor, reaches the port's informer as an HTTP 500). Each run
makes the JAX case's checks and returns what it observed (the requests
reconciled, their counts where the case bounds them), and the two
packages' observations must be equal.
"""

from __future__ import annotations

import contextlib
import threading
import time

import pytest

from builders import make_pod
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer, Node, NotFoundError
from k8s_operator_libs_tpu.kube import controller as jax_controller
from k8s_operator_libs_tpu.kube import informer as jax_informer
from k8s_operator_libs_tpu.kube import workqueue as jax_wq
from k8s_operator_libs_tpu_torch.kube import controller as port_controller
from k8s_operator_libs_tpu_torch.kube import informer as port_informer
from k8s_operator_libs_tpu_torch.kube import workqueue as port_wq
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig


def wait_until(cond, timeout=10.0, interval=0.01, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


def make_node(name, **labels):
    return Node.new(name, labels=labels)


class Side:
    """One package's controller runtime, a cluster the case writes to, and
    the client its informers read: the cluster itself (``jax``) or a
    ``RestClient`` at a server of it (``port``)."""

    def __init__(self, name: str, stack: contextlib.ExitStack) -> None:
        self.name = name
        ctl = jax_controller if name == "jax" else port_controller
        self.Controller, self.Request, self.Result = ctl.Controller, ctl.Request, ctl.Result
        self.Informer = (jax_informer if name == "jax" else port_informer).Informer
        wq = jax_wq if name == "jax" else port_wq
        self.ItemExponentialFailureRateLimiter = wq.ItemExponentialFailureRateLimiter
        self.cluster = FakeCluster()
        self.client = self.cluster
        if name == "port":
            server = stack.enter_context(LocalApiServer(cluster=self.cluster))
            self.client = RestClient(RestConfig(server=server.url))

    def informer(self, kind: str, **kwargs):
        return self.Informer(self.client, kind, **kwargs)


def on_both(case):
    """``case(side)`` for each package's side; equal outcomes."""
    outcomes = {}
    for name in ("jax", "port"):
        with contextlib.ExitStack() as stack:
            outcomes[name] = case(Side(name, stack))
    assert outcomes["port"] == outcomes["jax"]
    return outcomes["port"]


def names(requests) -> list:
    return sorted((r.namespace, r.name) for r in requests)


class TestEnqueueForObject:
    def test_reconciles_every_object(self):
        def case(s):
            for i in range(5):
                s.cluster.create(make_node(f"node-{i}"))
            seen = set()
            lock = threading.Lock()

            def reconcile(req):
                with lock:
                    seen.add(req)

            ctrl = s.Controller(reconcile, name="nodes")
            ctrl.watch(s.informer("Node"))
            with ctrl:
                wait_until(lambda: len(seen) >= 5, message="initial reconciles")
            assert seen == {s.Request("", f"node-{i}") for i in range(5)}
            return names(seen)

        on_both(case)

    def test_delete_still_enqueues(self):
        def case(s):
            s.cluster.create(make_node("node-a"))
            events = []
            lock = threading.Lock()

            def reconcile(req):
                try:
                    s.cluster.get("Node", req.name)
                    exists = True
                except NotFoundError:
                    exists = False
                with lock:
                    events.append((req, exists))

            ctrl = s.Controller(reconcile, name="nodes")
            ctrl.watch(s.informer("Node"))
            with ctrl:
                wait_until(lambda: len(events) >= 1, message="add reconcile")
                first = events[0]
                s.cluster.delete("Node", "node-a")
                wait_until(lambda: any(not exists for _, exists in events),
                           message="deletion reconcile")
            return (tuple(first[0]), first[1]), any(not e for _, e in events)

        on_both(case)

    def test_event_storm_coalesces(self):
        def case(s):
            s.cluster.create(make_node("hot"))
            passes = []
            lock = threading.Lock()

            def reconcile(req):
                with lock:
                    passes.append(req)
                time.sleep(0.02)

            ctrl = s.Controller(reconcile, name="nodes")
            ctrl.watch(s.informer("Node"))
            with ctrl:
                wait_until(lambda: len(passes) >= 1, message="first pass")
                for i in range(40):
                    node = s.cluster.get("Node", "hot")
                    node.labels["spin"] = str(i)
                    s.cluster.update(node)
                # At least one reconcile after the last write...
                wait_until(lambda: s.cluster.get("Node", "hot").labels.get("spin") == "39"
                           and len(passes) >= 2, message="post-storm reconcile")
                ctrl.stop(drain_timeout=5.0)
            # ...but far fewer passes than events: the queue coalesced them.
            assert len(passes) < 40
            return len(passes) < 40, set(names(passes))

        on_both(case)

    def test_informer_reuse_external_start(self):
        def case(s):
            s.cluster.create(make_node("n1"))
            inf = s.informer("Node").start()
            assert inf.wait_for_sync(10)
            seen = []
            ctrl = s.Controller(lambda req: seen.append(req), name="reuse")
            ctrl.watch(inf)  # already running: the controller must not restart it
            with ctrl:
                # The cached n1 is replayed to the late handler.
                wait_until(lambda: s.Request("", "n1") in seen,
                           message="replayed reconcile for a cached object")
                s.cluster.create(make_node("n2"))
                wait_until(lambda: s.Request("", "n2") in seen,
                           message="reconcile via the external informer")
            still = inf.started and inf._thread.is_alive()  # stop() left it running
            inf.stop()
            assert still
            return still, sorted(set(names(seen)))

        on_both(case)

    def test_stop_without_start_leaves_informer_usable(self):
        def case(s):
            s.cluster.create(make_node("n1"))
            inf = s.informer("Node")
            ctrl = s.Controller(lambda req: None, name="never-started")
            ctrl.watch(inf)
            ctrl.stop()  # never started: must not touch the informer
            inf.start()
            synced = inf.wait_for_sync(10)
            found = inf.get("n1") is not None
            inf.stop()
            assert synced and found, "informer poisoned by a foreign stop()"
            return synced, found

        on_both(case)


class TestPredicatesAndMappers:
    def test_predicate_filters(self):
        def case(s):
            seen = []

            def only_team_tpu(event, obj, old):
                return (obj.labels or {}).get("team") == "tpu"

            ctrl = s.Controller(lambda req: seen.append(req), name="filtered")
            ctrl.watch(s.informer("Node"), predicate=only_team_tpu)
            with ctrl:
                s.cluster.create(make_node("skip-me", team="gpu"))
                s.cluster.create(make_node("take-me", team="tpu"))
                wait_until(lambda: s.Request("", "take-me") in seen,
                           message="filtered reconcile")
                ctrl.stop(drain_timeout=5.0)
            assert s.Request("", "skip-me") not in seen
            return sorted(set(names(seen)))

        on_both(case)

    def test_mapper_pod_to_node(self):
        def case(s):
            seen = []

            def pod_to_node(event, obj, old):
                node = (obj.raw.get("spec") or {}).get("nodeName")
                return [s.Request("", node)] if node else []

            ctrl = s.Controller(lambda req: seen.append(req), name="mapped")
            ctrl.watch(s.informer("Pod", namespace="default"), mapper=pod_to_node)
            with ctrl:
                s.cluster.create(make_pod(name="driver-1", namespace="default",
                                          node_name="node-7"))
                wait_until(lambda: s.Request("", "node-7") in seen,
                           message="mapped reconcile")
            return sorted(set(names(seen)))

        on_both(case)

    def test_mapper_fanout(self):
        def case(s):
            seen = set()

            def fan(event, obj, old):
                return [s.Request("", f"{obj.name}-{i}") for i in range(3)]

            ctrl = s.Controller(lambda req: seen.add(req), name="fan")
            ctrl.watch(s.informer("Node"), mapper=fan)
            with ctrl:
                s.cluster.create(make_node("n"))
                wait_until(lambda: len(seen) >= 3, message="fan-out reconciles")
            assert seen == {s.Request("", f"n-{i}") for i in range(3)}
            return names(seen)

        on_both(case)


class TestRetrySemantics:
    def test_error_retries_with_backoff_then_succeeds(self):
        def case(s):
            s.cluster.create(make_node("flaky"))
            attempts = []

            def reconcile(req):
                attempts.append(time.monotonic())
                if len(attempts) < 4:
                    raise RuntimeError("transient")

            ctrl = s.Controller(reconcile,
                                rate_limiter=s.ItemExponentialFailureRateLimiter(0.02, 1.0),
                                name="retry")
            ctrl.watch(s.informer("Node"))
            with ctrl:
                wait_until(lambda: len(attempts) >= 4, message="retries")
                # Success resets the backoff.
                wait_until(lambda: ctrl.queue.num_requeues(s.Request("", "flaky")) == 0,
                           message="forget after success")
            gaps = [b - a for a, b in zip(attempts, attempts[1:])]
            assert len(attempts) >= 4 and gaps[2] > gaps[0]  # exponential spacing
            return len(attempts) >= 4, gaps[2] > gaps[0]

        on_both(case)

    def test_requeue_after_schedules_revisit(self):
        def case(s):
            s.cluster.create(make_node("periodic"))
            visits = []

            def reconcile(req):
                visits.append(time.monotonic())
                return s.Result(requeue_after=0.1) if len(visits) == 1 else None

            ctrl = s.Controller(reconcile, name="periodic")
            ctrl.watch(s.informer("Node"))
            with ctrl:
                wait_until(lambda: len(visits) >= 2, message="timed revisit")
            spaced = visits[1] - visits[0] >= 0.09
            # A timed revisit is no failure: no backoff accumulated.
            requeues = ctrl.queue.num_requeues(s.Request("", "periodic"))
            assert spaced and requeues == 0
            return spaced, requeues

        on_both(case)

    def test_result_requeue_uses_rate_limiter(self):
        def case(s):
            s.cluster.create(make_node("again"))
            visits = []

            def reconcile(req):
                visits.append(req)
                return s.Result(requeue=True) if len(visits) < 3 else None

            ctrl = s.Controller(reconcile,
                                rate_limiter=s.ItemExponentialFailureRateLimiter(0.01, 1.0),
                                name="requeue")
            ctrl.watch(s.informer("Node"))
            with ctrl:
                wait_until(lambda: len(visits) >= 3, message="requeue loop")
            return names(visits[:3])

        on_both(case)


class TestConcurrency:
    def test_distinct_keys_reconcile_in_parallel(self):
        def case(s):
            s.cluster.create(make_node("a"))
            s.cluster.create(make_node("b"))
            barrier = threading.Barrier(2, timeout=10)
            met = []

            def reconcile(req):
                try:
                    barrier.wait()
                    met.append(req.name)
                except threading.BrokenBarrierError:
                    pass

            ctrl = s.Controller(reconcile, max_concurrent_reconciles=2, name="par")
            ctrl.watch(s.informer("Node"))
            with ctrl:
                wait_until(lambda: len(met) >= 2,
                           message="parallel reconciles met at the barrier")
            return sorted(met)

        on_both(case)

    def test_same_key_never_parallel(self):
        def case(s):
            s.cluster.create(make_node("single"))
            in_flight = {"n": 0, "max": 0}
            lock = threading.Lock()

            def reconcile(req):
                with lock:
                    in_flight["n"] += 1
                    in_flight["max"] = max(in_flight["max"], in_flight["n"])
                time.sleep(0.01)
                with lock:
                    in_flight["n"] -= 1

            ctrl = s.Controller(reconcile, max_concurrent_reconciles=4, name="serial")
            ctrl.watch(s.informer("Node"))
            with ctrl:
                for i in range(30):
                    node = s.cluster.get("Node", "single")
                    node.labels["spin"] = str(i)
                    s.cluster.update(node)
                ctrl.stop(drain_timeout=10.0)
            assert in_flight["max"] == 1
            return in_flight["max"]

        on_both(case)

    def test_sync_timeout_unwinds_cleanly(self):
        """A failed start (an informer that never syncs) stops the
        informers it started and allows a retry."""

        class StuckInformer:
            kind = "Node"

            def __init__(self):
                self.started_calls = 0
                self.stopped = False

            @property
            def started(self):
                return self.started_calls > 0 and not self.stopped

            def add_event_handler(self, handler):
                pass

            def start(self):
                self.started_calls += 1
                self.stopped = False
                return self

            def wait_for_sync(self, timeout=None):
                return False  # never syncs

            def stop(self):
                self.stopped = True

        def case(s):
            inf = StuckInformer()
            ctrl = s.Controller(lambda req: None, name="stuck")
            ctrl.watch(inf)
            with pytest.raises(TimeoutError):
                ctrl.start(sync_timeout=0.05)
            leaked = not inf.stopped
            with pytest.raises(TimeoutError):  # a retry is possible
                ctrl.start(sync_timeout=0.05)
            ctrl.stop()  # a harmless no-op on the unwound state
            assert not leaked and inf.started_calls == 2
            return leaked, inf.started_calls

        on_both(case)

    def test_sync_timeout_retry_with_real_informer(self):
        """An API server outage (every list fails) times out start(); once
        it heals, the same controller and informer start cleanly."""

        def case(s):
            s.cluster.create(make_node("survivor"))
            outage = {"on": True}

            def broken_list(verb, kind, payload):
                if outage["on"]:
                    raise RuntimeError("apiserver down")

            s.cluster.add_reactor("list", "Node", broken_list)
            seen = []
            ctrl = s.Controller(lambda req: seen.append(req), name="healing")
            ctrl.watch(s.informer("Node", watch_timeout_seconds=1))
            with pytest.raises(TimeoutError):
                ctrl.start(sync_timeout=0.5)
            outage["on"] = False
            ctrl.start(sync_timeout=30)
            try:
                wait_until(lambda: s.Request("", "survivor") in seen,
                           message="reconcile after the outage healed")
            finally:
                ctrl.stop()
            return sorted(set(names(seen)))

        on_both(case)

    def test_start_twice_rejected(self):
        def case(s):
            ctrl = s.Controller(lambda req: None)
            ctrl.start()
            with pytest.raises(RuntimeError) as exc:
                ctrl.start()
            ctrl.stop()
            return str(exc.value)

        on_both(case)

    def test_manual_enqueue(self):
        def case(s):
            seen = []
            ctrl = s.Controller(lambda req: seen.append(req), name="manual")
            with ctrl:
                ctrl.enqueue(s.Request("ns", "obj"))
                wait_until(lambda: seen == [s.Request("ns", "obj")], message="manual reconcile")
                ctrl.enqueue_after(s.Request("ns", "later"), 0.05)
                wait_until(lambda: s.Request("ns", "later") in seen,
                           message="delayed manual reconcile")
            return names(seen)

        on_both(case)
