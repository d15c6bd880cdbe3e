"""The port's informer against the JAX package's, case by case.

Every case of ``tests/test_informer.py`` runs here with a JAX
``Informer`` and a port ``Informer`` side by side on the same writes: over
one ``LocalApiServer`` (the JAX informer through the JAX ``RestClient``,
the port's through the port's ``RestClient``) or over one ``FakeCluster``
where the JAX case runs in process. After each step the two must agree
exactly: the handlers' ``(type, name, resourceVersion, old
resourceVersion)`` sequences, the stores (raw documents), ``full_relists``
and ``delta_relists``, and ``by_index`` results. The one case that drives
a controller command,
``TestWatchDrivenController::test_roll_progresses_on_watch_triggers_alone``,
has its counterpart in ``tests/test_torch_upgrade_controller.py``, which
drives the port's ``upgrade_controller``.

Over HTTP the JAX client is shown with the port client's surface: its
``list_delta`` is hidden, because the port's ``RestClient`` has none
(until ROADMAP A18), and the informer takes the delta re-list only where
the client offers it. Both informers therefore take the same re-list
path; the delta path itself is compared over ``FakeCluster``, which has
``list_delta``. Where the JAX case races its writes against watch
windows (the relist after expiry, the API server's restart), the case
here waits until both informers stand at the same point first, so that
the comparison is exact and not a matter of timing.

The last tests rehearse ``chip_smoke.py``'s watch phase on the CPU over
its ``DictClient``.
"""

from __future__ import annotations

import importlib.util
import threading
import time
from pathlib import Path

import pytest

from builders import make_node, make_pod
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer, NodeMaintenance
from k8s_operator_libs_tpu.kube import Informer as JaxInformer
from k8s_operator_libs_tpu.kube import RestClient as JaxRestClient
from k8s_operator_libs_tpu.kube import RestConfig as JaxRestConfig
from k8s_operator_libs_tpu.kube import WatchExpiredError as JaxWatchExpiredError
from k8s_operator_libs_tpu.upgrade import condition_changed_predicate as jax_condition_changed
from k8s_operator_libs_tpu.utils.lifecycle import registered_resources as jax_resources
from k8s_operator_libs_tpu_torch.kube import Informer as PortInformer
from k8s_operator_libs_tpu_torch.kube.objects import Node
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.upgrade import condition_changed_predicate
from k8s_operator_libs_tpu_torch.utils.lifecycle import registered_resources


def wait_until(predicate, timeout=10.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


class PortSurface:
    """A client shown without ``list_delta``, the surface of the port's
    ``RestClient``. ``arm()`` parks the next watch call (``parked`` set)
    until ``release`` is set, then raises ``raises`` (``None``: opens the
    watch); the ``fail_next`` calls after it fail on the connection."""

    def __init__(self, inner) -> None:
        self._inner = inner
        self.watch_calls = 0
        self.parked = threading.Event()
        self.release = threading.Event()
        self.armed = False
        self.raises = None
        self.fail_next = 0

    def __getattr__(self, name):
        if name == "list_delta":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def arm(self, raises=None, fail_next: int = 0) -> None:
        self.parked.clear()
        self.release.clear()
        self.raises, self.fail_next, self.armed = raises, fail_next, True

    def watch(self, *args, **kwargs):
        self.watch_calls += 1
        if self.armed:
            self.armed = False
            self.parked.set()
            self.release.wait(30)
            if self.raises is not None:
                raise self.raises
        if self.fail_next:
            self.fail_next -= 1
            raise ConnectionError("the watch connection died")
        return self._inner.watch(*args, **kwargs)


class DeltaSurface(PortSurface):
    """``PortSurface`` that keeps the inner client's ``list_delta``."""

    def __getattr__(self, name):
        return getattr(self._inner, name)


class Pair:
    """A JAX informer and a port informer on the same writes, each with a
    handler that records ``(type, name, rv, old rv)``."""

    def __init__(self, jax_client, port_client, kind, sources=(None, None), **kw) -> None:
        self.jax = JaxInformer(jax_client, kind, stream_source=sources[0], **kw)
        self.port = PortInformer(port_client, kind, stream_source=sources[1], **kw)
        self.events = {id(self.jax): [], id(self.port): []}
        for inf in self.both:
            inf.add_event_handler(self._recorder(self.events[id(inf)]))

    @staticmethod
    def _recorder(out):
        def handler(event_type, obj, old):
            out.append((
                event_type, obj.name, obj.resource_version,
                old.resource_version if old is not None else None,
            ))

        return handler

    @property
    def both(self):
        return (self.jax, self.port)

    def __enter__(self):
        for inf in self.both:
            inf.start()
        return self

    def __exit__(self, *exc):
        for inf in self.both:
            inf.stop()

    def synced(self, timeout=10):
        return all(inf.wait_for_sync(timeout) for inf in self.both)

    def each(self, predicate, timeout=10.0) -> bool:
        return wait_until(lambda: all(predicate(inf) for inf in self.both), timeout)

    def seen(self, inf):
        return self.events[id(inf)]

    def assert_equal(self):
        """Handlers' sequences, stores and re-list counts, exactly."""
        jax, port = self.both
        assert self.seen(port) == self.seen(jax)
        assert port._store == jax._store
        assert (port.full_relists, port.delta_relists) == (jax.full_relists, jax.delta_relists)
        assert [o.raw for o in port.list()] == [o.raw for o in jax.list()]


@pytest.fixture()
def server():
    with LocalApiServer() as srv:
        yield srv


@pytest.fixture()
def clients(server):
    return (
        PortSurface(JaxRestClient(JaxRestConfig(server=server.url))),
        RestClient(RestConfig(server=server.url)),
    )


# -- TestCache ---------------------------------------------------------------


def test_initial_sync_populates_store(server, clients):
    server.cluster.create(make_node("pre-a"))
    server.cluster.create(make_node("pre-b"))
    with Pair(*clients, "Node") as pair:
        assert pair.synced()
        for inf in pair.both:
            assert {n.name for n in inf.list()} == {"pre-a", "pre-b"}
            assert inf.get("pre-a") is not None
            assert inf.get("ghost") is None
        assert pair.each(lambda inf: len(pair.seen(inf)) == 2)
        pair.assert_equal()
        assert isinstance(pair.port.get("pre-a"), Node)


def test_watch_keeps_store_current(server, clients):
    with Pair(*clients, "Node") as pair:
        assert pair.synced()
        server.cluster.create(make_node("live"))
        assert pair.each(lambda inf: inf.get("live") is not None)
        server.cluster.patch("Node", "live", patch={"metadata": {"labels": {"x": "1"}}})
        assert pair.each(lambda inf: (inf.get("live") or Node.new("z")).labels.get("x") == "1")
        server.cluster.delete("Node", "live")
        assert pair.each(lambda inf: inf.get("live") is None)
        assert pair.each(lambda inf: len(pair.seen(inf)) == 3)
        pair.assert_equal()
        assert [e[0] for e in pair.seen(pair.port)] == ["ADDED", "MODIFIED", "DELETED"]


def test_label_selector_scopes_cache(server, clients):
    server.cluster.create(make_node("tpu-n", labels={"team": "tpu"}))
    server.cluster.create(make_node("gpu-n", labels={"team": "gpu"}))
    with Pair(*clients, "Node", label_selector="team=tpu") as pair:
        assert pair.synced()
        for inf in pair.both:
            assert [n.name for n in inf.list()] == ["tpu-n"]
        server.cluster.patch("Node", "tpu-n", patch={"metadata": {"labels": {"team": "gpu"}}})
        assert pair.each(lambda inf: inf.get("tpu-n") is None)
        assert pair.each(lambda inf: len(pair.seen(inf)) == 2)
        pair.assert_equal()
        assert [e[0] for e in pair.seen(pair.port)] == ["ADDED", "DELETED"]


# -- TestHandlers ------------------------------------------------------------


def test_handlers_see_initial_adds_and_live_events(server, clients):
    server.cluster.create(make_node("seed"))
    with Pair(*clients, "Node") as pair:
        assert pair.synced()
        assert pair.each(lambda inf: ("ADDED", "seed") in [e[:2] for e in pair.seen(inf)])
        server.cluster.patch("Node", "seed", patch={"metadata": {"labels": {"x": "1"}}})
        assert pair.each(lambda inf: ("MODIFIED", "seed") in [e[:2] for e in pair.seen(inf)])
        pair.assert_equal()


def test_late_handler_gets_store_replayed_as_adds(server, clients):
    server.cluster.create(make_node("pre-1"))
    server.cluster.create(make_node("pre-2"))
    with Pair(*clients, "Node") as pair:
        assert pair.synced()
        late = {}
        for inf in pair.both:
            late[id(inf)] = []
            inf.add_event_handler(Pair._recorder(late[id(inf)]))
            assert {e[:2] for e in late[id(inf)]} == {("ADDED", "pre-1"), ("ADDED", "pre-2")}
        server.cluster.create(make_node("post"))
        assert pair.each(lambda inf: ("ADDED", "post") in [e[:2] for e in late[id(inf)]])
        assert late[id(pair.port)] == late[id(pair.jax)]
        pair.assert_equal()


def test_replay_not_gated_on_synced_flag(server, clients):
    server.cluster.create(make_node("holdover"))
    with Pair(*clients, "Node") as pair:
        assert pair.synced()
        replays = []
        for inf in pair.both:
            inf._synced.clear()  # the expiry window
            late = []
            inf.add_event_handler(Pair._recorder(late))
            replays.append(late)
        assert replays[1] == replays[0]
        assert [e[:2] for e in replays[1]] == [("ADDED", "holdover")]


def test_start_twice_rejected(clients):
    for cls, client in zip((JaxInformer, PortInformer), clients):
        inf = cls(client, "Node").start()
        try:
            with pytest.raises(RuntimeError):
                inf.start()
        finally:
            inf.stop()


def test_stop_is_prompt_on_a_quiet_watch(server, clients):
    """A watch parked on a quiet stream ends at once on stop(): the handle
    shuts the socket down."""
    server.cluster.create(make_node("quiet"))
    for cls, client in zip((JaxInformer, PortInformer), clients):
        inf = cls(client, "Node").start()
        assert inf.wait_for_sync(timeout=10)
        assert wait_until(lambda: inf._watch_handle is not None
                          and inf._watch_handle._sock is not None)
        t0 = time.monotonic()
        inf.stop()
        assert time.monotonic() - t0 < 3.0, f"{cls.__module__}: stop blocked on a parked recv"
        assert not inf.started


def test_stopped_informer_restarts(server, clients):
    server.cluster.create(make_node("before-stop"))
    pair = Pair(*clients, "Node")
    with pair:
        assert pair.synced()
        assert pair.each(lambda inf: len(pair.seen(inf)) == 1)
    assert not any(inf.started for inf in pair.both)
    server.cluster.create(make_node("while-down"))
    server.cluster.delete("Node", "before-stop")
    with pair:
        assert pair.synced()
        for inf in pair.both:
            assert inf.get("while-down") is not None
            assert inf.get("before-stop") is None
        assert pair.each(lambda inf: ("DELETED", "before-stop") in [e[:2] for e in pair.seen(inf)])
        server.cluster.create(make_node("post-restart"))
        assert pair.each(lambda inf: inf.get("post-restart") is not None)
        assert pair.each(lambda inf: len(pair.seen(inf)) == 4)
        pair.assert_equal()
        assert pair.port.full_relists == 2


def test_handler_gets_old_object_for_predicates(server, clients):
    """The informer's (obj, old) pair feeds each package's
    condition_changed_predicate: a spec change is ignored, the Ready flip
    reconciles."""
    fired = {"jax": [], "port": []}

    def handler(out, predicate):
        def on_event(event_type, obj, old):
            if event_type == "MODIFIED" and old is not None:
                out.append(predicate(old.raw, obj.raw))

        return on_event

    nm = NodeMaintenance.new("nm-1", namespace="default")
    nm.requestor_id = "tpu.operator.dev"
    nm.node_name = "node-1"
    server.cluster.create(nm)
    with Pair(*clients, "NodeMaintenance", namespace="default") as pair:
        pair.jax.add_event_handler(handler(fired["jax"], jax_condition_changed))
        pair.port.add_event_handler(handler(fired["port"], condition_changed_predicate))
        assert pair.synced()
        server.cluster.patch(
            "NodeMaintenance", "nm-1", "default",
            patch={"spec": {"additionalRequestors": ["x"]}},
        )
        server.cluster.patch(
            "NodeMaintenance", "nm-1", "default",
            patch={"status": {"conditions": [{"type": "Ready", "status": "True", "reason": "Ready"}]}},
        )
        assert wait_until(lambda: len(fired["jax"]) >= 2 and len(fired["port"]) >= 2)
        pair.assert_equal()
    assert fired["port"] == fired["jax"] == [False, True]


# -- TestRepair --------------------------------------------------------------


def test_relist_after_expiry_repairs_store(server, clients):
    """A watch resumed from a revision the journal no longer holds re-lists,
    and handlers see synthetic ADDEDs for what they missed. Both informers
    are held between windows while the journal churns and is cleared, so
    both expire on their next window."""
    with Pair(*clients, "Node", watch_timeout_seconds=1) as pair:
        assert pair.synced()
        jax_client, port_client = clients
        jax_client.arm()
        port_client_gate = PortSurface(port_client)
        pair.port._client = port_client_gate
        port_client_gate.arm()
        assert jax_client.parked.wait(10) and port_client_gate.parked.wait(10)
        server.cluster.create(make_node("missed"))
        for i in range(8):
            server.cluster.create(make_node(f"churn-{i}"))
        with server.cluster._lock:
            server.cluster._history.clear()
        server.cluster.create(make_node("after-expiry"))
        jax_client.release.set()
        port_client_gate.release.set()
        assert pair.each(lambda inf: inf.get("after-expiry") is not None)
        assert pair.each(lambda inf: len(pair.seen(inf)) == 10)
        for inf in pair.both:
            assert inf.get("missed") is not None
        pair.assert_equal()
        assert pair.port.full_relists == 2 and pair.port.delta_relists == 0
        assert ("ADDED", "missed") in [e[:2] for e in pair.seen(pair.port)]


# -- TestInProcessClient -----------------------------------------------------


def test_informer_over_fake_cluster_directly(server):
    cluster = server.cluster
    cluster.create(make_node("direct-seed"))
    with Pair(cluster, cluster, "Node") as pair:
        assert pair.synced()
        for inf in pair.both:
            assert inf.get("direct-seed") is not None
        cluster.create(make_node("direct-live"))
        assert pair.each(lambda inf: inf.get("direct-live") is not None)
        cluster.delete("Node", "direct-live")
        assert pair.each(lambda inf: inf.get("direct-live") is None)
        assert pair.each(lambda inf: len(pair.seen(inf)) == 3)
        pair.assert_equal()


def test_empty_store_seeds_resume_revision_over_fake(server):
    cluster = server.cluster
    cluster.create(make_node("pre"))
    cluster.delete("Node", "pre")
    with Pair(cluster, cluster, "Node") as pair:
        assert pair.synced()
        for inf in pair.both:
            assert inf.list() == []
            assert inf._resource_version == cluster.current_resource_version()
        pair.assert_equal()


def test_deletion_survives_watch_window_boundary(server, clients):
    """DELETED journals at a bumped revision, so a watch resuming from the
    pre-delete revision sees it, through either client."""
    cluster = server.cluster
    cluster.create(make_node("doomed"))
    cluster.patch("Node", "doomed", patch={"metadata": {"labels": {"x": "1"}}})
    seen_rv = cluster.get("Node", "doomed").resource_version
    cluster.delete("Node", "doomed")
    got = []
    for client in clients:
        for event_type, obj in client.watch("Node", resource_version=seen_rv, timeout_seconds=2):
            got.append((event_type, obj.name, obj.resource_version))
            break
    assert got[1] == got[0]
    assert got[1][:2] == ("DELETED", "doomed")


# -- TestApiserverRestart ----------------------------------------------------


def test_informer_survives_apiserver_restart():
    """The API server goes away mid-watch: each informer resumes, runs out
    of resume attempts, re-lists until the server is back over the same
    store, and catches up on what changed meanwhile."""
    store = FakeCluster()
    store.create(make_node("survivor"))
    server = LocalApiServer(cluster=store, port=0).start()
    port = server.server_address[1]
    clients = (
        PortSurface(JaxRestClient(JaxRestConfig(server=server.url))),
        RestClient(RestConfig(server=server.url)),
    )
    pair = Pair(*clients, "Node", watch_timeout_seconds=5)
    try:
        with pair:
            assert pair.synced()
            assert pair.each(lambda inf: inf.get("survivor") is not None)
            server.shutdown()
            server.server_close()
            for inf in pair.both:
                handle = inf._watch_handle
                if handle is not None:
                    handle.cancel()
            store.delete("Node", "survivor")
            store.create(make_node("post-restart"))
            # Both past their resume attempts, re-listing.
            assert pair.each(lambda inf: inf._resource_version is None, timeout=30)
            server = LocalApiServer(cluster=store, port=port).start()
            assert pair.each(lambda inf: inf.get("post-restart") is not None, timeout=30)
            assert pair.each(lambda inf: inf.get("survivor") is None)
            assert pair.each(lambda inf: len(pair.seen(inf)) == 3)
            pair.assert_equal()
            assert [e[:2] for e in pair.seen(pair.port)] == [
                ("ADDED", "survivor"), ("ADDED", "post-restart"), ("DELETED", "survivor"),
            ]
    finally:
        server.shutdown()
        server.server_close()


# -- TestResync --------------------------------------------------------------


def _push_ahead(inf, name, labels=None):
    """A store repair a newer revision ahead of dispatch (record_write)."""
    repaired = inf.get(name)
    rv = int(repaired.raw["metadata"]["resourceVersion"])
    repaired.raw["metadata"]["resourceVersion"] = str(rv + 1000)
    if labels:
        repaired.raw["metadata"].setdefault("labels", {}).update(labels)
    inf.record_write(repaired)


def test_resync_redelivers_only_store_ahead_of_dispatch():
    cluster = FakeCluster()
    cluster.create(make_node("rs-a"))
    cluster.create(make_node("rs-b"))
    with Pair(cluster, cluster, "Node") as pair:
        assert pair.synced()
        assert pair.each(lambda inf: len(pair.seen(inf)) == 2)
        for inf in pair.both:
            assert inf.resync_once() == 0
            _push_ahead(inf, "rs-a", {"x": "y"})
            assert inf.resync_once() == 1
            assert inf.resync_once() == 0
        pair.assert_equal()
        resyncs = [e for e in pair.seen(pair.port) if e[0] == "MODIFIED"]
        assert [e[1] for e in resyncs] == ["rs-a"] and resyncs[0][2] == resyncs[0][3]


def test_resync_redelivers_after_handler_failure():
    cluster = FakeCluster()
    cluster.create(make_node("rs-crash"))
    with Pair(cluster, cluster, "Node") as pair:
        fail_next = {}
        for inf in pair.both:
            fail_next[id(inf)] = [False]

            def fragile(t, obj, old, flag=fail_next[id(inf)]):
                if flag[0]:
                    flag[0] = False
                    raise RuntimeError("handler died mid-delivery")

            inf.add_event_handler(fragile)
        assert pair.synced()
        assert pair.each(lambda inf: len(pair.seen(inf)) == 1)
        for inf in pair.both:
            _push_ahead(inf, "rs-crash")
            fail_next[id(inf)][0] = True
            assert inf.resync_once() == 1
            assert inf.resync_once() == 1
            assert inf.resync_once() == 0
        pair.assert_equal()
        assert [e[0] for e in pair.seen(pair.port)] == ["ADDED", "MODIFIED", "MODIFIED"]


def test_periodic_resync_on_settled_store_stays_silent():
    cluster = FakeCluster()
    cluster.create(make_node("rs-quiet"))
    with Pair(cluster, cluster, "Node", resync_period_s=0.1) as pair:
        assert pair.synced()
        time.sleep(0.5)
    pair.assert_equal()
    assert [e[0] for e in pair.seen(pair.port)] == ["ADDED"]


def test_resync_disabled_by_default():
    cluster = FakeCluster()
    cluster.create(make_node("rs-solo"))
    with Pair(cluster, cluster, "Node") as pair:
        assert pair.synced()
        time.sleep(0.7)
    pair.assert_equal()
    assert [e[0] for e in pair.seen(pair.port)] == ["ADDED"]
    assert pair.port.resync_period_s == pair.jax.resync_period_s == 0.0


# -- TestIndexers ------------------------------------------------------------


def _by_node(obj):
    return [obj.raw.get("spec", {}).get("nodeName", "")]


def _pod(cluster, name, node):
    return cluster.create(make_pod(name, namespace="default", node_name=node))


def _index_names(pair, value):
    names = [[o.name for o in inf.by_index("by-node", value)] for inf in pair.both]
    assert names[1] == names[0]
    return names[1]


def test_index_tracks_adds_moves_and_deletes():
    cluster = FakeCluster()
    _pod(cluster, "p1", "host-a")
    _pod(cluster, "p2", "host-a")
    _pod(cluster, "p3", "host-b")
    pair = Pair(cluster, cluster, "Pod", namespace="default")
    for inf in pair.both:
        inf.add_indexer("by-node", _by_node)
    with pair:
        assert pair.synced()
        assert pair.each(lambda inf: len(inf.by_index("by-node", "host-a")) == 2)
        assert _index_names(pair, "host-a") == ["p1", "p2"]
        assert _index_names(pair, "host-b") == ["p3"]
        p2 = cluster.get("Pod", "p2", "default")
        p2.raw["spec"]["nodeName"] = "host-b"
        cluster.update(p2)
        assert pair.each(lambda inf: len(inf.by_index("by-node", "host-b")) == 2)
        assert _index_names(pair, "host-a") == ["p1"]
        cluster.delete("Pod", "p3", "default")
        assert pair.each(lambda inf: len(inf.by_index("by-node", "host-b")) == 1)
        assert _index_names(pair, "host-b") == ["p2"]
        assert pair.each(lambda inf: len(pair.seen(inf)) == 5)
        pair.assert_equal()


def test_indexer_added_after_start_builds_from_store():
    cluster = FakeCluster()
    _pod(cluster, "late", "host-z")
    with Pair(cluster, cluster, "Pod", namespace="default") as pair:
        assert pair.synced()
        for inf in pair.both:
            inf.add_indexer("by-node", _by_node)
        assert _index_names(pair, "host-z") == ["late"]
        pair.assert_equal()


def test_unknown_index_raises():
    cluster = FakeCluster()
    for cls in (JaxInformer, PortInformer):
        with pytest.raises(KeyError):
            cls(cluster, "Pod").by_index("nope", "x")


def test_index_rebuilt_by_410_relist():
    """A 410 raised by the JAX package's class (the client is another
    package's) takes the port's informer straight to a re-list, as it takes
    the JAX one: r2, written while both wait at the gate, reaches the index
    only through the re-list's rebuild, and each informer re-lists once."""
    cluster = FakeCluster()
    _pod(cluster, "r1", "host-a")
    shims = [DeltaSurface(cluster), DeltaSurface(cluster)]
    pair = Pair(*shims, "Pod", namespace="default", watch_timeout_seconds=1)
    for inf in pair.both:
        inf.add_indexer("by-node", _by_node)
    with pair:
        assert pair.synced()
        assert pair.each(lambda inf: inf.by_index("by-node", "host-a"))
        for shim in shims:
            shim.arm(raises=JaxWatchExpiredError("forced journal expiry"))
        assert all(shim.parked.wait(10) for shim in shims)
        _pod(cluster, "r2", "host-a")
        for shim in shims:
            shim.release.set()
        assert pair.each(lambda inf: len(inf.by_index("by-node", "host-a")) == 2)
        assert _index_names(pair, "host-a") == ["r1", "r2"]
        assert pair.each(lambda inf: len(pair.seen(inf)) == 2)
        pair.assert_equal()
        assert (pair.port.full_relists, pair.port.delta_relists) == (2, 0)


# -- What the JAX suite reaches only through its callers ---------------------


def test_dead_connections_resume_then_delta_relist():
    """Four watch calls in a row fail on the connection: three resume
    attempts, then a re-list, which over a client with ``list_delta`` asks
    for the changes since the informer's revision only."""
    cluster = FakeCluster()
    cluster.create(make_node("keep"))
    cluster.create(make_node("change"))
    cluster.create(make_node("drop"))
    shims = [DeltaSurface(cluster), DeltaSurface(cluster)]
    with Pair(*shims, "Node", watch_timeout_seconds=1) as pair:
        assert pair.synced()
        assert pair.each(lambda inf: len(pair.seen(inf)) == 3)
        for shim in shims:
            shim.arm(raises=ConnectionError("reset by peer"), fail_next=3)
        assert all(shim.parked.wait(10) for shim in shims)
        cluster.patch("Node", "change", patch={"metadata": {"labels": {"x": "1"}}})
        cluster.delete("Node", "drop")
        cluster.create(make_node("new"))
        for shim in shims:
            shim.release.set()
        assert pair.each(lambda inf: inf.delta_relists == 1, timeout=15)
        assert pair.each(lambda inf: len(pair.seen(inf)) == 6)
        pair.assert_equal()
        assert sorted(e[:2] for e in pair.seen(pair.port)[3:]) == [
            ("ADDED", "new"), ("DELETED", "drop"), ("MODIFIED", "change"),
        ]
        assert pair.port.full_relists == 1
        assert [s.watch_calls for s in shims][0] == shims[1].watch_calls


def test_record_write_and_settledness():
    """``record_write`` puts the store ahead of dispatch; while it is,
    ``pending_dispatch`` names it and ``with_settled_store`` refuses; a
    resync settles it. An older write than the store's is ignored."""
    cluster = FakeCluster()
    cluster.create(make_node("rw"))
    with Pair(cluster, cluster, "Node") as pair:
        assert pair.synced()
        assert pair.each(lambda inf: len(pair.seen(inf)) == 1)
        seen = []
        for inf in pair.both:
            assert inf.pending_dispatch() == ([], 0)
            assert inf.with_settled_store(lambda raws: seen.append(sorted(r["metadata"]["name"] for r in raws)))
            stale = inf.get("rw")
            stale.raw["metadata"]["resourceVersion"] = "0"
            stale.labels["stale"] = "1"
            inf.record_write(stale)
            assert "stale" not in inf.get("rw").labels
            _push_ahead(inf, "rw", {"fresh": "1"})
            pending, gone = inf.pending_dispatch()
            assert [r["metadata"]["name"] for r in pending] == ["rw"] and gone == 0
            assert not inf.with_settled_store(lambda raws: seen.append("ran"))
            assert inf.resync_once() == 1
            assert inf.pending_dispatch() == ([], 0)
        assert seen == [["rw"], ["rw"]]
        pair.assert_equal()


def test_stream_source_carries_the_watch_and_the_client_the_lists():
    cluster = FakeCluster()
    cluster.create(make_node("src"))
    sources = (DeltaSurface(cluster), DeltaSurface(cluster))
    with Pair(cluster, cluster, "Node", sources=sources) as pair:
        assert pair.synced()
        cluster.create(make_node("live"))
        assert pair.each(lambda inf: inf.get("live") is not None)
        pair.assert_equal()
    assert sources[0].watch_calls == sources[1].watch_calls >= 1
    assert pair.port.full_relists == pair.jax.full_relists == 1


def test_the_same_surface_as_the_jax_informer():
    public = lambda cls: {n for n in dir(cls) if not n.startswith("_")}  # noqa: E731
    assert public(PortInformer) == public(JaxInformer)
    cluster = FakeCluster()
    ours, theirs = PortInformer(cluster, "Node"), JaxInformer(cluster, "Node")
    for name in ("kind", "namespace", "watch_timeout_seconds", "max_resume_attempts",
                 "resync_period_s", "full_relists", "delta_relists", "chaos_tag"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert registered_resources()["Informer"] == jax_resources()["Informer"] == (("start",), ("stop",))


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_client_without_a_watch_fails_fast():
    """The NotImplementedError ends the informer's thread (it is raised
    there, not turned into a re-list loop)."""
    class NoWatch:
        def list(self, kind, **kw):
            return []

        def watch(self, *args, **kw):
            raise NotImplementedError("no watch")

    for cls in (JaxInformer, PortInformer):
        inf = cls(NoWatch(), "Node").start()
        assert wait_until(lambda: not inf.started)
        assert inf.full_relists == 1
        inf.stop()


# ----------------------------------------------------------------------
# chip_smoke.py's watch phase, rehearsed on the CPU
# ----------------------------------------------------------------------


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_watch_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _gpu_labels():
    return {"nvidia.com/gpu.present": "true", "nvidia.com/gpu.count": "8",
            "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3", "nvidia.com/gpu.memory": "81559"}


def test_dict_client_streams_what_fake_cluster_streams():
    """The same writes through ``DictClient`` and the JAX ``FakeCluster``:
    a label-scoped watch from before them yields the same events (an
    object leaving the selector arrives as DELETED), a field selector
    scopes lists alike, a resumed watch replays, and a compacted revision
    raises the port's ``WatchExpiredError``."""
    from k8s_operator_libs_tpu_torch.kube.client import WatchExpiredError, has_reason
    from k8s_operator_libs_tpu_torch.kube.rest import WatchHandle

    smoke = _chip_smoke()
    ours, theirs = smoke.DictClient(), FakeCluster()
    starts = [c.list_with_revision("Node")[1] for c in (ours, theirs)]

    def writes(c):
        c.create(make_node("a", labels={"team": "tpu"}))
        c.create(make_node("b", labels={"team": "gpu"}))
        c.patch("Node", "a", patch={"metadata": {"labels": {"x": "1"}}})
        c.patch("Node", "b", patch={"metadata": {"labels": {"team": "tpu"}}})
        c.patch("Node", "a", patch={"metadata": {"labels": {"team": "gpu"}}})
        c.delete("Node", "b")
        c.create(make_pod("p", namespace="default", node_name="b"))

    streams = []
    for c, since in zip((ours, theirs), starts):
        writes(c)
        streams.append([
            (t, o.name, dict(o.raw["metadata"].get("labels") or {}))
            for t, o in c.watch("Node", label_selector="team=tpu", resource_version=since,
                                timeout_seconds=1)
        ])
    assert streams[0] == streams[1]
    assert [e[:2] for e in streams[0]] == [
        ("ADDED", "a"), ("MODIFIED", "a"), ("ADDED", "b"), ("DELETED", "a"), ("DELETED", "b"),
    ]
    for selector in ("spec.nodeName=b", "spec.nodeName!=b", "metadata.name=p"):
        assert [p.name for p in ours.list("Pod", field_selector=selector)] == [
            p.name for p in theirs.list("Pod", field_selector=selector)
        ]
    assert [n.name for n in ours.list("Node", label_selector={"team": "gpu"})] == ["a"]
    handle = WatchHandle()
    handle.cancel()
    assert list(ours.watch("Node", handle=handle, timeout_seconds=30)) == []
    since = ours.list_with_revision("Node")[1]
    ours.create(make_node("c"))
    assert ours.compact() == int(since) + 1
    with pytest.raises(Exception) as expired:
        next(iter(ours.watch("Node", resource_version=since, timeout_seconds=1)))
    assert has_reason(expired.value, WatchExpiredError)
    assert list(ours.watch("Node", resource_version=str(ours.compacted), timeout_seconds=1)) == []


def test_dict_client_journal_under_concurrent_writers():
    """Eight writer threads, each on names of its own, against
    ``DictClient`` (a short switch interval) while a port informer follows:
    a watch from before the writes sees every revision once and in order,
    and the informer's store ends equal to the list."""
    import sys

    smoke = _chip_smoke()
    client = smoke.DictClient()
    since = client.list_with_revision("Node")[1]
    seen = []
    informer = PortInformer(client, "Node", watch_timeout_seconds=1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with informer:
            assert informer.wait_for_sync(10)

            def write(w):
                for i in range(25):
                    name = f"w{w}-{i % 5}"
                    if any(o.name == name for o in client.list("Node")):
                        client.patch("Node", name, patch={"metadata": {"labels": {"i": str(i)}}})
                    else:
                        client.create(make_node(name))
                    if i % 7 == 6:
                        client.delete("Node", name)

            writers = [threading.Thread(target=write, args=(w,)) for w in range(8)]
            for t in writers:
                t.start()
            for t in writers:
                t.join(30)
            assert not any(t.is_alive() for t in writers)
            last = int(client.list_with_revision("Node")[1])
            for _, obj in client.watch("Node", resource_version=since, timeout_seconds=1):
                seen.append(int(obj.resource_version))
                if seen[-1] == last:
                    break
            assert wait_until(lambda: [o.raw for o in informer.list()] == [
                o.raw for o in client.list("Node")
            ])
    finally:
        sys.setswitchinterval(interval)
    assert seen == list(range(int(since) + 1, last + 1))


def test_chip_smoke_watch_phase_runs_on_the_cpu(monkeypatch):
    """The watch phase's informers, checks and line over ``DictClient``,
    with node labels that need no card and the monitor's and the
    requestor roll's writes made by hand: the NodeMaintenance objects of
    both requestor nodes come and go (held by a finalizer), the monitored
    node's condition turns True and then False, the report is published,
    and a repeated Warning through the correlated recorder counts 2."""
    from k8s_operator_libs_tpu_torch.kube.events import EventRecorder
    from k8s_operator_libs_tpu_torch.kube.objects import NodeMaintenance, set_condition
    from k8s_operator_libs_tpu_torch.parallel import topology
    from k8s_operator_libs_tpu_torch.tpu.monitor import ICI_HEALTHY_CONDITION, ReportPublisher

    smoke = _chip_smoke()
    monkeypatch.setattr(topology, "local_gpu_labels", _gpu_labels)
    watch = smoke.WatchPhase()
    try:
        requestor = smoke.DictClient()
        watch.start_maintenance(requestor)
        for node in smoke.REQUESTOR_NODES:
            nm = NodeMaintenance.new(f"maintenance-{node}", namespace=smoke.MAINTENANCE_NS)
            nm.requestor_id, nm.node_name, nm.finalizers = smoke.REQUESTOR_ID, node, ["f"]
            requestor.create(nm)
        time.sleep(smoke.WATCH_WINDOW_S + 0.5)  # a window ends and resumes
        for node in smoke.REQUESTOR_NODES:
            name = f"maintenance-{node}"
            requestor.patch("NodeMaintenance", name, smoke.MAINTENANCE_NS, patch={
                "status": {"conditions": [{"type": "Ready", "status": "True", "reason": "Ready"}]},
            })
            requestor.delete("NodeMaintenance", name, smoke.MAINTENANCE_NS)
            held = requestor.get("NodeMaintenance", name, smoke.MAINTENANCE_NS)
            held.finalizers = []
            requestor.update(held)
        requestor.create(make_node(smoke.REQUESTOR_NODES[0]))
        watch.check_maintenance(requestor)

        client = smoke.monitor_client()
        watch.start_pool(client)
        recorder = EventRecorder(client)
        for status, tflops in (("True", 412.5), ("False", 3.0)):
            node = client.get("Node", smoke.MONITOR_NODE)
            set_condition(node.status, ICI_HEALTHY_CONDITION, status)
            client.update_status(node)
            ReportPublisher(client, smoke.MONITOR_NODE, heartbeat_seconds=0.0).publish(
                {"mxu": status == "True"}, {"mxu_tflops": tflops},
            )
            if status == "True":
                watch.check_report(client, tflops)
        for _ in range(2):
            recorder.event(client.get("Node", smoke.MONITOR_NODE), "Warning", "Probe", "failed")
        (warning,) = client.list("Event")
        assert warning.raw["count"] == 2
        watch.check_monitor(client)
    finally:
        info = watch.stop()
    assert info["node"]["synced"] == smoke.WATCH_POOL_NODES + 1
    assert 1500 < info["node"]["node_bytes_mean"] < 4096
    assert info["node"]["ici_healthy_transitions"] == ["True", "False"]
    assert info["node_health_report"]["mxu_tflops"] == 412.5
    maintenance = info["node_maintenance"]
    assert maintenance["events_by_node"] == {
        n: ["ADDED", "MODIFIED", "MODIFIED", "DELETED"] for n in smoke.REQUESTOR_NODES
    }
    assert maintenance["resumed_windows"] >= 1 and maintenance["relists_after_compaction"] >= 1
    assert all(not inf.started for inf in watch.informers.values())
    assert {"events", "events_per_s", "full_relists"} <= set(info["node_health_report"])
