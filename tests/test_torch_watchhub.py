"""The port's watch hub, delta list and shed retries against the JAX
package's.

Each case of ``tests/test_watchhub.py``'s ``TestHubMultiplexing``, the
client and informer cases of ``TestDeltaList``,
``TestServerSideFieldSelectors``, ``TestHubWireMetrics``,
``TestHubUnderScheduledLag`` and the client half of ``TestApf``
(``test_shed_surfaces_as_429_with_retry_after_honored``,
``test_retry_after_transparent_recovery``) runs once with each package:
its ``WatchHub`` over its ``RestClient`` (or over the JAX ``FakeCluster``,
in process) at a JAX ``LocalApiServer`` of its own, its ``Informer`` on
the hub. The JAX case's checks hold on both sides, and what each side
observed (the server's watch and list requests, the hub's counters, the
frames a subscriber saw, the stores) must be equal. The scheduled-lag
cases run the fleet roll of ``tests/test_torch_fleet.py`` on hub-fed
workers, a fault plan answering ``overflow`` at ``watchhub.deliver`` in
each package's ``utils.faultpoints`` for a window of the roll, the JAX
case's three seeds' windows; the JAX chaos harness that drew them waits
for ROADMAP A19 (c). The server half of ``TestApf``, ``TestDeltaList`` and
``TestServerSideFieldSelectors`` runs against the port's server in
``tests/test_torch_apiserver_apf.py``.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import pytest

from builders import make_node
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube import Informer as JaxInformer
from k8s_operator_libs_tpu.kube import ListDelta as JaxListDelta
from k8s_operator_libs_tpu.kube import RestClient as JaxRestClient
from k8s_operator_libs_tpu.kube import RestConfig as JaxRestConfig
from k8s_operator_libs_tpu.kube import TooManyRequestsError as JaxTooManyRequestsError
from k8s_operator_libs_tpu.kube import WatchExpiredError as JaxWatchExpiredError
from k8s_operator_libs_tpu.kube import WatchHub as JaxWatchHub
from k8s_operator_libs_tpu.kube import wrap as jax_wrap
from k8s_operator_libs_tpu.kube.apiserver import ApfConfig, FlowConfig
from k8s_operator_libs_tpu.kube.rest import WatchHandle as JaxWatchHandle
from k8s_operator_libs_tpu.kube.selectors import parse_field_selector
from k8s_operator_libs_tpu.upgrade.metrics import WireMetrics as JaxWireMetrics
from k8s_operator_libs_tpu.utils import faultpoints as jax_faultpoints
from k8s_operator_libs_tpu_torch.kube.client import (
    ListDelta,
    TooManyRequestsError,
    WatchExpiredError,
)
from k8s_operator_libs_tpu_torch.kube.informer import Informer
from k8s_operator_libs_tpu_torch.kube.loopwatch import install_wire_loop_watchdog
from k8s_operator_libs_tpu_torch.kube.objects import wrap
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig, WatchHandle
from k8s_operator_libs_tpu_torch.kube.watchhub import WatchHub
from k8s_operator_libs_tpu_torch.upgrade.metrics import WireMetrics
from k8s_operator_libs_tpu_torch.utils import faultpoints

PKGS = {
    "jax": SimpleNamespace(RestClient=JaxRestClient, RestConfig=JaxRestConfig,
                           Informer=JaxInformer, WatchHub=JaxWatchHub,
                           WatchHandle=JaxWatchHandle, WatchExpiredError=JaxWatchExpiredError,
                           TooManyRequestsError=JaxTooManyRequestsError, ListDelta=JaxListDelta,
                           WireMetrics=JaxWireMetrics, wrap=jax_wrap, faultpoints=jax_faultpoints),
    "port": SimpleNamespace(RestClient=RestClient, RestConfig=RestConfig, Informer=Informer,
                            WatchHub=WatchHub, WatchHandle=WatchHandle,
                            WatchExpiredError=WatchExpiredError,
                            TooManyRequestsError=TooManyRequestsError, ListDelta=ListDelta,
                            WireMetrics=WireMetrics, wrap=wrap, faultpoints=faultpoints),
}


def wait_until(predicate, timeout=10.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def node_raw(name, labels=None):
    raw = {"kind": "Node", "apiVersion": "v1", "metadata": {"name": name}}
    if labels:
        raw["metadata"]["labels"] = dict(labels)
    return raw


def watch_requests(log, plural="nodes"):
    return [e for e in log
            if e[0] == "GET" and plural in e[1] and e[2].get("watch") in ("true", "1")]


def full_list_requests(log, plural="nodes"):
    return [e for e in log
            if e[0] == "GET" and e[1].endswith(f"/{plural}") and e[2].get("watch") is None
            and "sinceResourceVersion" not in e[2]]


def on_served(case):
    """``case(p, server, client)`` once a package, each on a fresh
    ``LocalApiServer`` and its own package's client; equal observations."""
    outcomes = {}
    for name, p in PKGS.items():
        with LocalApiServer() as server:
            client = p.RestClient(p.RestConfig(server=server.url))
            try:
                outcomes[name] = case(p, server, client)
            finally:
                client.close()
    assert outcomes["port"] == outcomes["jax"]
    return outcomes["port"]


def create(server, raw):
    server.cluster.create(jax_wrap(raw))


# ----------------------------------------------------------------------
# TestHubMultiplexing
# ----------------------------------------------------------------------


def test_two_informers_one_upstream_stream():
    def case(p, server, client):
        for i in range(4):
            create(server, node_raw(f"n{i}"))
        log = server.start_request_log()
        with p.WatchHub(client) as hub:
            informers = [p.Informer(client, "Node", stream_source=hub).start() for _ in range(3)]
            try:
                for inf in informers:
                    assert inf.wait_for_sync(10)
                create(server, node_raw("n4"))
                assert wait_until(lambda: all(inf.get("n4") for inf in informers))
                stats = hub.stats()
                assert stats["frames_delivered"] >= 3 * stats["frames_upstream"] - 3
                return len(watch_requests(log)), stats["upstream_streams"], stats["subscribers"]
            finally:
                for inf in informers:
                    inf.stop()

    assert on_served(case) == (1, 1, 3)


def test_distinct_scopes_get_distinct_upstreams():
    def case(p, server, client):
        with p.WatchHub(client) as hub:
            a = p.Informer(client, "Node", stream_source=hub).start()
            b = p.Informer(client, "Node", label_selector="tier=x", stream_source=hub).start()
            try:
                assert a.wait_for_sync(10) and b.wait_for_sync(10)
                assert wait_until(lambda: hub.stats()["upstream_streams"] == 2)
                return sorted(hub.stats()["scopes"])
            finally:
                a.stop()
                b.stop()

    assert on_served(case) == ["Node", "Node/tier=x"]


def test_join_mid_stream_seeds_from_cursor():
    def case(p, server, client):
        create(server, node_raw("seed"))
        with p.WatchHub(client) as hub:
            first = p.Informer(client, "Node", stream_source=hub).start()
            try:
                assert first.wait_for_sync(10)
                _, rv_before = client.list_with_revision("Node")
                create(server, node_raw("mid-1"))
                create(server, node_raw("mid-2"))
                assert wait_until(lambda: first.get("mid-2") is not None)
                handle = p.WatchHandle()
                seen = []
                for event_type, obj in hub.watch("Node", resource_version=rv_before,
                                                 timeout_seconds=2, handle=handle):
                    seen.append((event_type, obj.name))
                    if len(seen) == 2:
                        handle.cancel()
                return seen
            finally:
                first.stop()

    assert on_served(case) == [("ADDED", "mid-1"), ("ADDED", "mid-2")]


def test_cursor_behind_replay_window_expires():
    def case(p, server, client):
        for i in range(8):
            create(server, node_raw(f"w{i}"))
        with p.WatchHub(client, journal_window=2) as hub:
            inf = p.Informer(client, "Node", stream_source=hub).start()
            try:
                assert inf.wait_for_sync(10)
                for i in range(8, 14):
                    create(server, node_raw(f"w{i}"))
                assert wait_until(lambda: inf.get("w13") is not None)
                with pytest.raises(p.WatchExpiredError) as expired:
                    for _ in hub.watch("Node", resource_version="1", timeout_seconds=1):
                        pass
                return str(expired.value)
            finally:
                inf.stop()

    assert "behind the hub replay window" in on_served(case)


def test_upstream_dead_connection_resume_is_shared():
    def case(p, server, client):
        create(server, node_raw("r0"))
        with p.WatchHub(client) as hub:
            informers = [p.Informer(client, "Node", stream_source=hub).start() for _ in range(2)]
            try:
                for inf in informers:
                    assert inf.wait_for_sync(10)
                assert wait_until(lambda: server.watch_streams >= 1)
                log = server.start_request_log()
                server.kill_connections()
                create(server, node_raw("r1"))
                assert wait_until(lambda: all(inf.get("r1") for inf in informers))
                return (len(watch_requests(log)), len(full_list_requests(log)),
                        hub.stats()["scopes"]["Node"]["upstream_resumes"] >= 1)
            finally:
                for inf in informers:
                    inf.stop()

    assert on_served(case) == (1, 0, True)


def test_slow_subscriber_goes_stale_and_self_resumes():
    def case(p, server, client):
        create(server, node_raw("s0"))
        with p.WatchHub(client, buffer_limit=4) as hub:
            fast = p.Informer(client, "Node", stream_source=hub).start()
            try:
                assert fast.wait_for_sync(10)
                _, rv = client.list_with_revision("Node")
                handle = p.WatchHandle()
                stream = hub.watch("Node", resource_version=rv, timeout_seconds=30,
                                   handle=handle)
                create(server, node_raw("burst-0"))
                assert next(stream)[1].name == "burst-0"
                log = server.start_request_log()
                for i in range(1, 12):
                    create(server, node_raw(f"burst-{i}"))
                assert wait_until(lambda: fast.get("burst-11") is not None)
                names = []
                for _event, obj in stream:
                    names.append(obj.name)
                    if obj.name == "burst-11":
                        handle.cancel()
                return (names, hub.stats()["stale_resumes"] >= 1, len(watch_requests(log)),
                        len(full_list_requests(log)))
            finally:
                fast.stop()

    assert on_served(case) == ([f"burst-{i}" for i in range(1, 12)], True, 0, 0)


def test_live_only_upstream_rewinds_for_cursor_joiner():
    def case(p, server, client):
        create(server, node_raw("base"))
        _, rv0 = client.list_with_revision("Node")
        create(server, node_raw("gap-1"))
        create(server, node_raw("gap-2"))
        with p.WatchHub(client) as hub:
            live_handle = p.WatchHandle()

            def consume_live():
                for _ in hub.watch("Node", timeout_seconds=20, handle=live_handle):
                    pass

            live = threading.Thread(target=consume_live, daemon=True)
            live.start()
            assert wait_until(lambda: server.watch_streams >= 1)
            handle = p.WatchHandle()
            seen = []
            for _event, obj in hub.watch("Node", resource_version=rv0, timeout_seconds=10,
                                         handle=handle):
                seen.append(obj.name)
                if obj.name == "gap-2":
                    handle.cancel()
            live_handle.cancel()
            live.join(timeout=10)
            return seen

    assert on_served(case) == ["gap-1", "gap-2"]


def test_hub_works_over_fake_cluster_in_process():
    """The port's hub multiplexes any ``watch``: here the JAX
    ``FakeCluster``'s, with no HTTP."""
    outcomes = {}
    for name, p in PKGS.items():
        cluster = FakeCluster()
        cluster.create(make_node("a"))
        with p.WatchHub(cluster) as hub:
            informers = [p.Informer(cluster, "Node", stream_source=hub).start()
                         for _ in range(2)]
            try:
                for inf in informers:
                    assert inf.wait_for_sync(10)
                cluster.create(make_node("b"))
                assert wait_until(lambda: all(inf.get("b") for inf in informers))
                outcomes[name] = hub.stats()["upstream_streams"]
            finally:
                for inf in informers:
                    inf.stop()
    assert outcomes == {"jax": 1, "port": 1}


def test_last_unsubscriber_retires_the_upstream():
    def case(p, server, client):
        with p.WatchHub(client, idle_linger_s=0) as hub:
            inf = p.Informer(client, "Node", stream_source=hub).start()
            assert inf.wait_for_sync(10)
            assert wait_until(lambda: hub.stats()["upstream_streams"] == 1)
            inf.stop()
            return wait_until(lambda: hub.stats()["upstream_streams"] == 0)

    assert on_served(case) is True


def test_subscriber_window_end_reuses_upstream_and_journal():
    def case(p, server, client):
        create(server, node_raw("w0"))
        with p.WatchHub(client) as hub:
            inf = p.Informer(client, "Node", watch_timeout_seconds=1, stream_source=hub).start()
            try:
                assert inf.wait_for_sync(10)
                assert wait_until(lambda: server.watch_streams >= 1)
                log = server.start_request_log()
                time.sleep(2.5)  # several subscriber windows roll over
                create(server, node_raw("w1"))
                assert wait_until(lambda: inf.get("w1") is not None)
                return (len(watch_requests(log)),
                        hub.stats()["scopes"]["Node"]["upstream_watches_opened"])
            finally:
                inf.stop()

    assert on_served(case) == (0, 1)


class Gate:
    """A stream source whose first ``watch`` waits for ``release``."""

    def __init__(self, inner) -> None:
        self._inner = inner
        self.parked = threading.Event()
        self.release = threading.Event()

    def watch(self, *args, **kwargs):
        if not self.parked.is_set():
            self.parked.set()
            self.release.wait(30)
        return self._inner.watch(*args, **kwargs)


def test_resumed_frames_keep_their_write_origins():
    """A frame the hub replays from its journal to a late subscriber keeps
    its resourceVersion, so that informer's delivery span joins the trace
    of the write that made it, as the live subscriber's does. The JAX
    server hands each write's origin to the port's tracer
    (``test_torch_tracing.BridgedJaxTracer``)."""
    from k8s_operator_libs_tpu.utils import tracing as jax_tracing
    from k8s_operator_libs_tpu_torch.utils import tracing
    from test_torch_tracing import BridgedJaxTracer

    tracer = tracing.Tracer()
    tracing.install_tracer(tracer)
    jax_tracing.install_tracer(BridgedJaxTracer(tracer))
    try:
        with LocalApiServer() as server:
            client = RestClient(RestConfig(server=server.url))
            with WatchHub(client) as hub:
                first = Informer(client, "Node", stream_source=hub).start()
                gate = Gate(hub)
                late = Informer(client, "Node", stream_source=gate).start()
                try:
                    assert first.wait_for_sync(10) and late.wait_for_sync(10)
                    assert gate.parked.wait(10)  # listed; its watch waits
                    with tracing.span("write", category="write") as write:
                        client.create(wrap(node_raw("traced")))
                    assert wait_until(lambda: first.get("traced") is not None)
                    gate.release.set()  # joins from its list's revision
                    assert wait_until(lambda: late.get("traced") is not None)
                    replayed = hub.stats()["frames_delivered"]
                finally:
                    gate.release.set()
                    late.stop()
                    first.stop()
            client.close()
    finally:
        jax_tracing.clear_tracer()
        tracing.clear_tracer()
    delivered = [r for r in tracer.records() if r["name"] == "informer.deliver"
                 and r["attrs"].get("name") == "traced"]
    assert len(delivered) == 2 and replayed >= 2
    assert {r["trace"] for r in delivered} == {write.trace_id}


# ----------------------------------------------------------------------
# TestApf, the client's half
# ----------------------------------------------------------------------

REPORT = {"kind": "NodeHealthReport", "apiVersion": "telemetry.tpu-operator.dev/v1alpha1",
          "metadata": {"name": "n1"}, "spec": {"nodeName": "n1"}}


def test_shed_surfaces_as_429_with_retry_after_honored():
    outcomes = {}
    for name, p in PKGS.items():
        apf = ApfConfig(retry_after_s=0.05)
        apf.flows["telemetry"] = FlowConfig(queue_depth=0)
        with LocalApiServer(apf=apf) as srv:
            cfg = p.RestConfig(server=srv.url)
            cfg.too_many_requests_retries = 2
            c = p.RestClient(cfg)
            try:
                create(srv, node_raw("n1"))
                started = time.monotonic()
                with pytest.raises(p.TooManyRequestsError) as exc_info:
                    c.create(p.wrap(dict(REPORT)))
                assert time.monotonic() - started >= 0.08
                assert exc_info.value.retry_after_s == pytest.approx(0.05)
                shed = srv.apf_stats()["telemetry"]["shed_429_total"]
                c.patch("Node", "n1", patch={"metadata": {"labels": {"x": "1"}}})
                c.create(p.wrap({"kind": "Lease", "apiVersion": "coordination.k8s.io/v1",
                                 "metadata": {"name": "l1", "namespace": "default"},
                                 "spec": {"holderIdentity": "w0"}}))
                stats = srv.apf_stats()
                outcomes[name] = (shed, stats["reconcile"]["shed_429_total"],
                                  stats["lease"]["shed_429_total"],
                                  stats["lease"]["admitted_total"] >= 1)
            finally:
                c.close()
    assert outcomes["port"] == outcomes["jax"] == (3, 0, 0, True)


def test_retry_after_transparent_recovery():
    outcomes = {}
    for name, p in PKGS.items():
        apf = ApfConfig(retry_after_s=0.05)
        apf.flows["telemetry"] = FlowConfig(queue_depth=0)
        with LocalApiServer(apf=apf) as srv:
            cfg = p.RestConfig(server=srv.url)
            cfg.too_many_requests_retries = 3
            c = p.RestClient(cfg)
            try:
                def relax():
                    time.sleep(0.07)
                    srv.apf.flows["telemetry"] = FlowConfig(queue_depth=64)

                relaxer = threading.Thread(target=relax)
                relaxer.start()
                try:
                    created = c.create(p.wrap(dict(REPORT, metadata={"name": "n9"})))
                finally:
                    relaxer.join()
                outcomes[name] = (created.name,
                                  srv.apf_stats()["telemetry"]["admitted_total"] >= 1)
            finally:
                c.close()
    assert outcomes["port"] == outcomes["jax"] == ("n9", True)


# ----------------------------------------------------------------------
# TestDeltaList, the client's and the informer's cases
# ----------------------------------------------------------------------


def test_http_delta_and_410_fallback():
    def case(p, server, client):
        create(server, node_raw("x0"))
        _, rv = client.list_with_revision("Node")
        create(server, node_raw("x1"))
        delta = client.list_delta("Node", rv)
        got = ([o.name for o in delta.items], delta.deleted, delta.full,
               int(delta.revision) > int(rv))
        server.cluster._history.clear()
        create(server, node_raw("x2"))
        server.cluster._history.clear()
        return got, client.list_delta("Node", rv)

    assert on_served(case) == ((["x1"], [], False, True), None)


def test_informer_delta_relist_matches_full():
    def case(p, server, client):
        for i in range(4):
            create(server, node_raw(f"p{i}", labels={"keep": "1"}))
        delta_inf = p.Informer(client, "Node", label_selector="keep=1")
        full_inf = p.Informer(client, "Node", label_selector="keep=1")
        delta_inf.start()
        full_inf.start()
        try:
            assert delta_inf.wait_for_sync(10) and full_inf.wait_for_sync(10)
            baseline_full = full_inf.full_relists
            create(server, node_raw("p4", labels={"keep": "1"}))
            server.cluster.delete("Node", "p0")
            server.cluster.patch("Node", "p1", patch={"metadata": {"labels": {"keep": "0"}}})
            assert wait_until(lambda: delta_inf.get("p4") is not None
                              and full_inf.get("p4") is not None and delta_inf.get("p1") is None)
            delta_inf.stop()
            full_inf.stop()
            create(server, node_raw("p5", labels={"keep": "1"}))
            server.cluster.delete("Node", "p2")
            log = server.start_request_log()
            stop = threading.Event()
            delta_inf._synced.clear()
            delta_inf._relist(stop)
            full_inf._delta_base_rv = None
            full_inf._synced.clear()
            full_inf._relist(stop)
            return (delta_inf.delta_relists, full_inf.full_relists - baseline_full,
                    sorted(o.name for o in delta_inf.list()),
                    sorted(o.name for o in full_inf.list()),
                    len([e for e in log if "sinceResourceVersion" in e[2]]))
        finally:
            delta_inf.stop()
            full_inf.stop()

    assert on_served(case) == (1, 1, ["p3", "p4", "p5"], ["p3", "p4", "p5"], 1)


def test_hub_expiry_keeps_the_delta_cursor():
    class ExpiringSource:
        def __init__(self, inner, expired):
            self._inner, self._expired, self.calls = inner, expired, 0

        def watch(self, *args, **kwargs):
            self.calls += 1
            if self.calls == 1:
                raise self._expired("hub replay window lapsed")
            return self._inner.watch(*args, **kwargs)

    def case(p, server, client):
        create(server, node_raw("k0"))
        inf = p.Informer(client, "Node",
                         stream_source=ExpiringSource(client, p.WatchExpiredError)).start()
        try:
            assert wait_until(lambda: inf.delta_relists + inf.full_relists >= 2)
            return inf.full_relists, inf.delta_relists, inf.get("k0") is not None
        finally:
            inf.stop()

    assert on_served(case) == (1, 1, True)


def test_old_server_full_list_is_salvaged_not_refetched():
    class OldServer:
        def __init__(self, inner, list_delta_cls):
            self._inner, self._cls, self.delta_calls = inner, list_delta_cls, 0

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def list_delta(self, kind, since, namespace="", label_selector=None,
                       field_selector=None):
            self.delta_calls += 1
            items, rv = self._inner.list_with_revision(kind, namespace, label_selector,
                                                       field_selector)
            return self._cls(items, [], rv, full=True)

    outcomes = {}
    for name, p in PKGS.items():
        cluster = FakeCluster()
        old = OldServer(cluster, p.ListDelta)
        cluster.create(make_node("s0"))
        cluster.create(make_node("s1"))
        inf = p.Informer(old, "Node").start()
        try:
            assert inf.wait_for_sync(10)
            inf.stop()
            cluster.create(make_node("s2"))
            cluster.delete("Node", "s0")
            list_log = cluster.start_call_log()
            inf._synced.clear()
            inf._relist(threading.Event())
            outcomes[name] = (old.delta_calls, [v for v, _, _ in list_log if v == "list"],
                              inf.delta_relists, inf.full_relists,
                              sorted(o.name for o in inf.list()))
        finally:
            inf.stop()
    assert outcomes["port"] == outcomes["jax"] == (1, ["list"], 0, 2, ["s1", "s2"])


def test_rest_client_salvages_an_old_servers_full_list():
    """The client's half of the salvage: a server that ignores
    ``sinceResourceVersion`` answers a whole list with no
    ``metadata.deltaSince``; each package's ``list_delta`` returns it as
    a ``full`` delta of the whole collection."""
    from test_torch_wire_transport import _JsonOnly, _Threading

    outcomes = {}
    for name, p in PKGS.items():
        httpd = _Threading(("127.0.0.1", 0), _JsonOnly)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            client = p.RestClient(p.RestConfig(server=f"http://127.0.0.1:{httpd.server_address[1]}"))
            try:
                delta = client.list_delta("Node", "5")
                outcomes[name] = (delta.full, delta.items, delta.deleted, delta.revision)
            finally:
                client.close()
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert outcomes["port"] == outcomes["jax"] == (True, [], [], "1")


def test_informer_falls_back_outside_window():
    def case(p, server, client):
        create(server, node_raw("f0"))
        inf = p.Informer(client, "Node").start()
        try:
            assert inf.wait_for_sync(10)
            inf.stop()
            create(server, node_raw("f1"))
            server.cluster._history.clear()
            inf._synced.clear()
            inf._relist(threading.Event())
            return inf.delta_relists, inf.full_relists, inf.get("f1") is not None
        finally:
            inf.stop()

    assert on_served(case) == (0, 2, True)


# ----------------------------------------------------------------------
# TestServerSideFieldSelectors
# ----------------------------------------------------------------------


def test_watch_filters_fields_server_side_with_parity():
    pod = {"kind": "Pod", "apiVersion": "v1", "metadata": {"name": "pod-a", "namespace": "d"},
           "spec": {"nodeName": "n1"}}

    def case(p, server, client):
        create(server, pod)
        _, rv = client.list_with_revision("Pod", namespace="d")
        handle = p.WatchHandle()
        scoped = client.watch("Pod", namespace="d", field_selector="spec.nodeName=n1",
                              resource_version=rv, timeout_seconds=5, handle=handle)
        create(server, dict(pod, metadata={"name": "pod-b", "namespace": "d"},
                            spec={"nodeName": "n2"}))
        create(server, dict(pod, metadata={"name": "pod-c", "namespace": "d"},
                            spec={"nodeName": "n1"}))
        seen = []
        for event_type, obj in scoped:
            seen.append((event_type, obj.name))
            if obj.name == "pod-c":
                handle.cancel()
        matcher = parse_field_selector("spec.nodeName=n1")
        unscoped = sorted(o.name for o in server.cluster.list("Pod", namespace="d")
                          if matcher.matches(o.raw))
        return seen, unscoped

    assert on_served(case) == ([("ADDED", "pod-c")], ["pod-a", "pod-c"])


def test_not_equals_field_selector_over_the_wire():
    def case(p, server, client):
        for name, node in (("pod-a", "n1"), ("pod-b", "n2")):
            create(server, {"kind": "Pod", "apiVersion": "v1",
                            "metadata": {"name": name, "namespace": "d"},
                            "spec": {"nodeName": node}})
        return [o.name for o in client.list("Pod", namespace="d",
                                            field_selector="spec.nodeName!=n1")]

    assert on_served(case) == ["pod-b"]


# ----------------------------------------------------------------------
# TestHubWireMetrics
# ----------------------------------------------------------------------


def test_hub_metrics_render():
    def case(p, server, client):
        with p.WatchHub(client) as hub:
            inf = p.Informer(client, "Node", stream_source=hub).start()
            try:
                assert inf.wait_for_sync(10)
                create(server, node_raw("m0"))
                assert wait_until(lambda: inf.get("m0") is not None)
                rendered = p.WireMetrics(hub=hub, apiserver=server).render()
                lines = [line for line in rendered.splitlines()
                         if line.startswith(("tpu_operator_wire_hub_upstream_streams",
                                             "tpu_operator_wire_hub_subscribers ",
                                             "tpu_operator_wire_hub_scope_subscribers"))]
                return lines, "tpu_operator_wire_apf_admitted_total" in rendered
            finally:
                inf.stop()

    lines, apf = on_served(case)
    assert apf and lines == ["tpu_operator_wire_hub_upstream_streams 1",
                             "tpu_operator_wire_hub_subscribers 1",
                             'tpu_operator_wire_hub_scope_subscribers{scope="Node"} 1']


def test_wire_metrics_render_byte_equal_to_jax():
    """Each half of the family from the same stats: the port's text is the
    JAX collector's, byte for byte."""

    class Stats:
        def __init__(self, stats):
            self._stats = stats

        def stats(self):
            return self._stats

        def apf_stats(self):
            return self._stats

    hub = Stats({"upstream_streams": 2, "subscribers": 5, "frames_upstream": 40,
                 "frames_delivered": 100, "fanout_ratio": 2.5, "stale_resumes": 1,
                 "scopes": {"Node": {"subscribers": 3, "buffer_depths": [0, 2, 1]},
                            "Pod/app=x": {"subscribers": 2, "buffer_depths": [4, 0]}}})
    relay = Stats({"clients_active": 2, "streams_total": 9, "streams_compact": 8,
                   "upstream_bytes": 1000, "bytes_fanned_out": 3000, "refused_requests": 1,
                   "hub": {"scopes": {"Node": {"subscribers": 2}, "Lease": {"subscribers": 0}}}})
    source = Stats({"relay_windows": 3, "direct_windows": 1, "fallbacks_to_direct": 1})
    apf = Stats({"lease": {"queued": 0, "max_queued": 1, "admitted_total": 7, "shed_429_total": 0},
                 "telemetry": {"queued": 2, "max_queued": 9, "admitted_total": 3,
                               "shed_429_total": 4}})
    watchdog = Stats({"stalls_over_threshold": 0, "max_stall_s": 0.0123, "threshold_s": 0.5,
                      "heartbeats": 10})
    kwargs = dict(hub=hub, apiserver=apf, loop_watchdog=watchdog, relay=relay,
                  relay_source=source)
    assert WireMetrics(**kwargs).render() == JaxWireMetrics(**kwargs).render()


def test_loop_stall_watchdog_metrics_render():
    with LocalApiServer() as server:
        watchdog = install_wire_loop_watchdog()
        watchdog.reset()
        assert wait_until(lambda: watchdog.heartbeats > 0)
        rendered = WireMetrics(apiserver=server, loop_watchdog=watchdog).render()
    assert "tpu_operator_wire_loop_stall_total 0" in rendered
    assert "tpu_operator_wire_loop_stall_max_seconds" in rendered
    assert "tpu_operator_wire_loop_stall_threshold_seconds" in rendered
    assert "tpu_operator_wire_apf_queue_depth" in rendered


# ----------------------------------------------------------------------
# TestHubUnderScheduledLag
# ----------------------------------------------------------------------


class OverflowPlan:
    """Answers ``overflow`` at ``watchhub.deliver`` while armed, at most
    ``count`` times; every other consult acts normally."""

    def __init__(self, action_cls, count: int) -> None:
        self._action_cls = action_cls
        self.remaining = count
        self.armed = False
        self.fired = 0
        self.lock = threading.Lock()

    def consult(self, point, ctx):
        if point != "watchhub.deliver":
            return None
        with self.lock:
            if not self.armed or self.remaining <= 0:
                return None
            self.remaining -= 1
            self.fired += 1
        return self._action_cls("overflow")


@pytest.mark.parametrize("overflow_step,duration", [(3, 2), (12, 3), (22, 2)],
                         ids=["grant-burst", "mid-roll", "completion"])
def test_overflow_during_grant_write_converges(overflow_step, duration):
    """Two hub-fed shard workers roll six pools under a budget of two; for
    ``duration`` iterations from ``overflow_step`` every live subscriber's
    buffer is forced over its bound (twice at most). Each subscriber takes
    the stale self-resume from the hub's journal; the roll converges with
    no budget violation, as it does on the JAX hub."""
    from test_torch_fleet import (
        Clock,
        assert_fleet_converged,
        build_fleet,
        drive_fleet,
        make_worker,
        on_both,
        roll_outcome,
    )

    def case(side):
        p = PKGS[side.name]
        sim, pool_names = build_fleet(side, pools=6, hosts=1, budget=2)
        hub = p.WatchHub(side.client)
        side.stack.callback(hub.stop)
        clock = Clock()
        idents = ("w-a", "w-b")
        workers = [make_worker(side, clock, ident, idents, watch_hub=hub) for ident in idents]
        orch = side.pkg.fleet.FleetOrchestrator(side.client, "fleet-roll")
        plan = OverflowPlan(p.faultpoints.FaultAction, count=2)

        def hook(i, current):
            # Armed for the window, and on until the first overflow, so
            # the schedule never runs dead.
            plan.armed = i >= overflow_step and (i < overflow_step + duration or not plan.fired)
            return current

        p.faultpoints.install_plan(plan)
        try:
            sim.set_template_hash("v2")
            _, violations = drive_fleet(side, sim, orch, workers, clock, pool_names, budget=2,
                                        mid_roll_hook=hook)
        finally:
            p.faultpoints.clear_plan()
        assert violations == 0
        assert_fleet_converged(side, sim)
        outcome = roll_outcome(side, workers, violations)
        outcome.pop("reported")  # which worker reports a pool depends on delivery timing
        return dict(outcome, engaged=plan.fired > 0,
                    self_resumed=hub.stats()["stale_resumes"] >= (1 if plan.fired else 0))

    got = on_both(case)
    assert got["engaged"] and got["self_resumed"]
