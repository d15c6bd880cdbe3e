"""The port's watch relay, its client side and read replicas against the
JAX package's.

Every case of ``tests/test_relay.py`` (``TestRelayProtocol``,
``TestRelayWatchSource``, ``TestRelayWireMetrics``, ``TestReadReplicas``)
runs once with each package: its ``WatchRelay`` over its own
``RestClient`` at a JAX ``LocalApiServer`` of its own, its clients,
``Informer`` and ``RelayWatchSource`` on the relay. The JAX case's checks
hold on both sides, and what each side observed (the primary's watch and
list requests, the relay's counters, the frames a subscriber saw) must be
equal. Across the packages, on one server: the JAX client watches through
the port's relay and the port's client through the JAX relay, each beside
a direct watch of its own package; the frames must be equal.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import pytest

from builders import make_node
from k8s_operator_libs_tpu.kube import Informer as JaxInformer
from k8s_operator_libs_tpu.kube import LocalApiServer
from k8s_operator_libs_tpu.kube import RelayWatchSource as JaxRelayWatchSource
from k8s_operator_libs_tpu.kube import RestClient as JaxRestClient
from k8s_operator_libs_tpu.kube import RestConfig as JaxRestConfig
from k8s_operator_libs_tpu.kube import WatchExpiredError as JaxWatchExpiredError
from k8s_operator_libs_tpu.kube import WatchRelay as JaxWatchRelay
from k8s_operator_libs_tpu.kube.client import ApiError as JaxApiError
from k8s_operator_libs_tpu.upgrade.metrics import WireMetrics as JaxWireMetrics
from k8s_operator_libs_tpu_torch.kube.client import ApiError, WatchExpiredError
from k8s_operator_libs_tpu_torch.kube.informer import Informer
from k8s_operator_libs_tpu_torch.kube.objects import wrap
from k8s_operator_libs_tpu_torch.kube.relay import RelayWatchSource, WatchRelay
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.upgrade.metrics import WireMetrics

PKGS = {
    "jax": SimpleNamespace(RestClient=JaxRestClient, RestConfig=JaxRestConfig,
                           WatchRelay=JaxWatchRelay, RelayWatchSource=JaxRelayWatchSource,
                           Informer=JaxInformer, ApiError=JaxApiError,
                           WatchExpiredError=JaxWatchExpiredError, WireMetrics=JaxWireMetrics,
                           node=make_node),
    "port": SimpleNamespace(RestClient=RestClient, RestConfig=RestConfig, WatchRelay=WatchRelay,
                            RelayWatchSource=RelayWatchSource, Informer=Informer,
                            ApiError=ApiError, WatchExpiredError=WatchExpiredError,
                            WireMetrics=WireMetrics,
                            node=lambda *a, **kw: wrap(make_node(*a, **kw).raw)),
}


def wait_until(predicate, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def watch_requests(log, plural="nodes"):
    return [e for e in log if e[0] == "GET" and plural in e[1] and e[2].get("watch") == "true"]


def list_requests(log, plural="nodes"):
    return [e for e in log if e[0] == "GET" and plural in e[1] and e[2].get("watch") != "true"]


def on_both(case):
    outcomes = {name: case(PKGS[name]) for name in ("jax", "port")}
    assert outcomes["port"] == outcomes["jax"]
    return outcomes["port"]


class _Consumer:
    """Drains a watch generator on a thread (a live subscriber keeping its
    scope open)."""

    def __init__(self, client, api_error=Exception, kind="Node", **kwargs):
        self.events = []
        self._done = threading.Event()

        def _run():
            try:
                for event_type, obj in client.watch(kind, **kwargs):
                    self.events.append((event_type, obj.name))
            except api_error:
                pass
            finally:
                self._done.set()

        threading.Thread(target=_run, daemon=True).start()

    def wait_events(self, n, timeout=10.0):
        return wait_until(lambda: len(self.events) >= n, timeout)


# ----------------------------------------------------------------------
# TestRelayProtocol
# ----------------------------------------------------------------------


def test_relay_is_just_another_watch_server():
    def case(p):
        with LocalApiServer() as server:
            direct = p.RestClient(p.RestConfig(server=server.url))
            relay = p.WatchRelay(p.RestConfig(server=server.url)).start()
            subs = []
            try:
                direct.create(p.node("seed-0"))
                log = server.start_request_log()
                consumers = []
                for _ in range(3):
                    sub = p.RestClient(p.RestConfig(server=relay.url, wire_encoding="compact"))
                    subs.append(sub)
                    consumers.append(_Consumer(sub, p.ApiError, timeout_seconds=30,
                                               resource_version="0", allow_bookmarks=False))
                for consumer in consumers:
                    assert consumer.wait_events(1)
                direct.create(p.node("seed-1"))
                for consumer in consumers:
                    assert consumer.wait_events(2)
                stats = relay.stats()
                return ([c.events[:2] for c in consumers], len(watch_requests(log)),
                        stats["hub"]["upstream_streams"], stats["clients_total"],
                        stats["streams_compact"], stats["upstream_bytes"] > 0)
            finally:
                server.stop_request_log()
                relay.stop()
                for sub in subs:
                    sub.close()
                direct.close()

    events, upstream, streams, clients, compact, upstream_bytes = on_both(case)
    assert events == [[("ADDED", "seed-0"), ("ADDED", "seed-1")]] * 3
    assert (upstream, streams, clients, compact, upstream_bytes) == (1, 1, 3, 3, True)


def test_non_watch_requests_refused():
    def case(p):
        with LocalApiServer() as server:
            relay = p.WatchRelay(p.RestConfig(server=server.url)).start()
            sub = p.RestClient(p.RestConfig(server=relay.url))
            try:
                with pytest.raises(p.ApiError, match="watch streams only"):
                    sub.list("Node")
                with pytest.raises(p.ApiError):
                    sub.create(p.node("rejected"))
                refused = relay.stats()["refused_requests"]
                return refused, list(sub.watch("Node", timeout_seconds=0))
            finally:
                relay.stop()
                sub.close()

    assert on_both(case) == (2, [])


def test_mid_stream_join_from_cursor():
    def case(p):
        with LocalApiServer() as server:
            direct = p.RestClient(p.RestConfig(server=server.url))
            relay = p.WatchRelay(p.RestConfig(server=server.url)).start()
            sub_a = p.RestClient(p.RestConfig(server=relay.url))
            sub_b = p.RestClient(p.RestConfig(server=relay.url))
            try:
                first = direct.create(p.node("j-0"))
                log = server.start_request_log()
                consumer = _Consumer(sub_a, p.ApiError, timeout_seconds=30, resource_version="0")
                assert consumer.wait_events(1)
                for i in range(1, 4):
                    direct.create(p.node(f"j-{i}"))
                assert consumer.wait_events(4)
                replayed = [obj.name for _, obj in sub_b.watch(
                    "Node", timeout_seconds=1, resource_version=first.resource_version)]
                return replayed, len(watch_requests(log)), list_requests(log)
            finally:
                server.stop_request_log()
                relay.stop()
                sub_a.close()
                sub_b.close()
                direct.close()

    assert on_both(case) == (["j-1", "j-2", "j-3"], 1, [])


def test_relay_kill_resumes_with_watch_not_list():
    def case(p):
        with LocalApiServer() as server:
            direct = p.RestClient(p.RestConfig(server=server.url))
            relay = p.WatchRelay(p.RestConfig(server=server.url)).start()
            stream = p.RestClient(p.RestConfig(server=relay.url))
            informer = None
            try:
                direct.create(p.node("k-0"))
                informer = p.Informer(direct, "Node", stream_source=stream,
                                      watch_timeout_seconds=30).start()
                assert wait_until(lambda: len(informer.list()) == 1)
                # The kill must find the informer's stream open through the
                # relay and delivering: a client is connected, and a write
                # made now reaches the informer only through that stream.
                assert wait_until(lambda: relay.active_clients() >= 1)
                direct.create(p.node("k-warm"))
                assert wait_until(lambda: len(informer.list()) == 2)
                log = server.start_request_log()
                killed = relay.kill_connections() >= 1
                direct.create(p.node("k-1"))
                assert wait_until(lambda: len(informer.list()) == 3)
                return killed, list_requests(log), len(watch_requests(log))
            finally:
                server.stop_request_log()
                if informer is not None:
                    informer.stop()
                relay.stop()
                stream.close()
                direct.close()

    assert on_both(case) == (True, [], 0)


def test_laggard_cursor_expiry_is_a_410():
    def case(p):
        with LocalApiServer() as server:
            direct = p.RestClient(p.RestConfig(server=server.url))
            relay = p.WatchRelay(p.RestConfig(server=server.url), journal_window=3).start()
            sub_a = p.RestClient(p.RestConfig(server=relay.url))
            sub_b = p.RestClient(p.RestConfig(server=relay.url))
            try:
                stale = direct.create(p.node("lag-0"))
                consumer = _Consumer(sub_a, p.ApiError, timeout_seconds=30, resource_version="0")
                assert consumer.wait_events(1)
                for i in range(1, 9):
                    direct.create(p.node(f"lag-{i}"))
                assert consumer.wait_events(9)
                with pytest.raises(p.WatchExpiredError) as expired:
                    list(sub_b.watch("Node", timeout_seconds=2,
                                     resource_version=stale.resource_version))
                return expired.value.reason
            finally:
                relay.stop()
                sub_a.close()
                sub_b.close()
                direct.close()

    assert on_both(case) == "Expired"


def test_expiry_inside_an_open_stream_is_an_error_frame():
    """A subscriber whose cursor falls off the relay's journal while its
    stream is open gets the in-stream ``ERROR`` frame (a 410 ``Status``),
    raised as ``WatchExpiredError`` after the frames before it."""

    def case(p):
        with LocalApiServer() as server:
            direct = p.RestClient(p.RestConfig(server=server.url))
            relay = p.WatchRelay(p.RestConfig(server=server.url), journal_window=2).start()
            sub = p.RestClient(p.RestConfig(server=relay.url))
            try:
                direct.create(p.node("x-0"))
                hub = relay._hub
                stream = sub.watch("Node", timeout_seconds=30, resource_version="0")
                assert next(stream)[1].name == "x-0"
                upstream = next(iter(hub._scopes.values()))
                with upstream.cond:
                    upstream._broadcast_expired_locked()
                with pytest.raises(p.WatchExpiredError) as expired:
                    next(stream)
                return expired.value.reason, relay.stats()["streams_total"]
            finally:
                relay.stop()
                sub.close()
                direct.close()

    assert on_both(case) == ("Expired", 1)


def test_a_quiet_scope_is_answered_at_once():
    """The port's relay answers a watch as soon as it has subscribed, not
    with the first frame: a scope with nothing to send (no event, no
    bookmark asked for) must not leave the subscriber waiting for the
    answer past its read timeout, which a ``RelayWatchSource`` takes for a
    dead relay. The window then ends cleanly, empty. (The JAX relay sends
    its head with the first frame.)"""
    with LocalApiServer() as server:
        relay = WatchRelay(RestConfig(server=server.url)).start()
        sub = RestClient(RestConfig(server=relay.url), timeout=1.0)
        direct = RestClient(RestConfig(server=server.url))
        source = RelayWatchSource(relay.url, direct=direct)
        source._relay_client = sub
        try:
            started = time.monotonic()
            assert list(source.watch("Node", label_selector="quiet=yes",
                                     timeout_seconds=3)) == []
            assert 2.5 <= time.monotonic() - started < 6
            assert source.stats() == {"relay_windows": 1, "direct_windows": 0,
                                      "fallbacks_to_direct": 0, "frames_via_relay": 0}
        finally:
            relay.stop()
            source.close()
            direct.close()


def test_component_protocol_and_idempotent_stop():
    def case(p):
        relay = p.WatchRelay(p.RestConfig(server="http://127.0.0.1:1"))
        seen = [relay.name, relay.healthy()]
        relay.start()
        seen.append(relay.healthy())
        relay.stop()
        seen.append(relay.healthy())
        relay.stop()  # idempotent
        return seen

    assert on_both(case) == ["watch-relay", False, True, False]


def test_stop_ends_the_accept_thread_at_once():
    """The port's ``stop`` shuts its listener down, which wakes the thread
    blocked in ``accept()``: the stop returns within a second and no
    accept thread is left (the JAX relay's waits out its 5 s join and
    leaves it; ROADMAP queue C, C19)."""
    relay = WatchRelay(RestConfig(server="http://127.0.0.1:1")).start()
    thread = relay._accept_thread
    assert thread.is_alive()
    time.sleep(0.2)  # let the thread block in accept()
    start = time.monotonic()
    relay.stop()
    assert time.monotonic() - start < 1.0
    assert not thread.is_alive()


# ----------------------------------------------------------------------
# TestRelayWatchSource
# ----------------------------------------------------------------------


def test_falls_back_to_direct_when_relay_dies():
    def case(p):
        with LocalApiServer() as server:
            direct = p.RestClient(p.RestConfig(server=server.url))
            relay = p.WatchRelay(p.RestConfig(server=server.url)).start()
            source = p.RelayWatchSource(relay.url, direct=direct)
            try:
                direct.create(p.node("f-0"))
                gen = source.watch("Node", timeout_seconds=30, resource_version="0")
                events = [next(gen)]
                relay.stop()
                direct.create(p.node("f-1"))
                events.append(next(gen))
                gen.close()
                return [(t, obj.name) for t, obj in events], source.stats()
            finally:
                relay.stop()
                source.close()
                direct.close()

    events, stats = on_both(case)
    assert events == [("ADDED", "f-0"), ("ADDED", "f-1")]
    assert stats["fallbacks_to_direct"] == 1 and stats["direct_windows"] == 1


def test_retries_relay_after_fallback_window():
    def case(p):
        with LocalApiServer() as server:
            direct = p.RestClient(p.RestConfig(server=server.url))
            relay = p.WatchRelay(p.RestConfig(server=server.url))
            clock = [0.0]
            source = p.RelayWatchSource("http://127.0.0.1:1", direct=direct,
                                        fallback_window_s=30.0, mono=lambda: clock[0])
            try:
                direct.create(p.node("r-0"))
                seen = [[obj.name for _, obj in source.watch(
                    "Node", timeout_seconds=1, resource_version="0")]]
                stats = [dict(source.stats())]
                list(source.watch("Node", timeout_seconds=0))
                stats.append(dict(source.stats()))
                relay.start()
                source._relay_client.close()
                source._relay_client = p.RestClient(p.RestConfig(server=relay.url))
                clock[0] = 31.0
                seen.append([obj.name for _, obj in source.watch(
                    "Node", timeout_seconds=1, resource_version="0")])
                stats.append(dict(source.stats()))
                return seen, stats
            finally:
                relay.stop()
                source.close()
                direct.close()

    seen, stats = on_both(case)
    assert seen == [["r-0"], ["r-0"]]
    assert stats[0]["fallbacks_to_direct"] == stats[1]["fallbacks_to_direct"] == 1
    assert stats[1]["direct_windows"] == 2 and stats[2]["relay_windows"] == 1


def test_expiry_propagates_untouched():
    def case(p):
        with LocalApiServer() as server:
            direct = p.RestClient(p.RestConfig(server=server.url))
            relay = p.WatchRelay(p.RestConfig(server=server.url), journal_window=2).start()
            source = p.RelayWatchSource(relay.url, direct=direct)
            sub = p.RestClient(p.RestConfig(server=relay.url))
            try:
                stale = direct.create(p.node("e-0"))
                consumer = _Consumer(sub, p.ApiError, timeout_seconds=30, resource_version="0")
                assert consumer.wait_events(1)
                for i in range(1, 8):
                    direct.create(p.node(f"e-{i}"))
                assert consumer.wait_events(8)
                with pytest.raises(p.WatchExpiredError):
                    list(source.watch("Node", timeout_seconds=2,
                                      resource_version=stale.resource_version))
                return source.stats()["fallbacks_to_direct"]
            finally:
                relay.stop()
                source.close()
                sub.close()
                direct.close()

    assert on_both(case) == 0


# ----------------------------------------------------------------------
# TestRelayWireMetrics
# ----------------------------------------------------------------------


def test_relay_gauges_render_on_the_wire_family():
    suffixes = ("relay_clients", "relay_streams_total", "relay_streams_compact_total",
                "relay_upstream_bytes_total", "relay_fanout_bytes_total", "relay_scope_streams",
                "relay_windows_total", "relay_fallback_to_direct_total")

    def case(p):
        with LocalApiServer() as server:
            direct = p.RestClient(p.RestConfig(server=server.url))
            relay = p.WatchRelay(p.RestConfig(server=server.url)).start()
            source = p.RelayWatchSource(relay.url, direct=direct)
            try:
                direct.create(p.node("m-0"))
                names = [obj.name for _, obj in source.watch(
                    "Node", timeout_seconds=1, resource_version="0")]
                rendered = p.WireMetrics(relay=relay, relay_source=source).render()
                return (names, [s for s in suffixes if f"tpu_operator_wire_{s}" in rendered],
                        'relay_scope_streams{scope="Node"} 0' in rendered
                        or 'relay_scope_streams{scope="Node"} 1' in rendered,
                        "relay_fallback_to_direct_total 0" in rendered)
            finally:
                relay.stop()
                source.close()
                direct.close()

    assert on_both(case) == (["m-0"], list(suffixes), True, True)


# ----------------------------------------------------------------------
# TestReadReplicas
# ----------------------------------------------------------------------


def test_reads_round_robin_writes_stay_primary():
    def case(p):
        with LocalApiServer() as server:
            rep1 = server.read_replica().start()
            rep2 = server.read_replica().start()
            client = p.RestClient(p.RestConfig(server=server.url,
                                               read_servers=(rep1.url, rep2.url)))
            try:
                for i in range(4):
                    client.create(p.node(f"rr-{i}"))
                counts = [len(client.list("Node")) for _ in range(4)]
                return (counts, rep1.requests_served, rep2.requests_served,
                        server.requests_served, client.transport_stats()["read_requests_sent"])
            finally:
                client.close()
                rep2.stop()
                rep1.stop()

    assert on_both(case) == ([4, 4, 4, 4], 2, 2, 4, 4)


def test_replica_refuses_writes_with_405():
    def case(p):
        with LocalApiServer() as server:
            replica = server.read_replica().start()
            direct = p.RestClient(p.RestConfig(server=replica.url))
            try:
                with pytest.raises(p.ApiError, match="read-only replica"):
                    direct.create(p.node("nope"))
                return direct.list("Node"), list(direct.watch("Node", timeout_seconds=0))
            finally:
                direct.close()
                replica.stop()

    assert on_both(case) == ([], [])


def test_replica_death_fails_over_to_primary():
    def case(p):
        with LocalApiServer() as server:
            replica = server.read_replica().start()
            client = p.RestClient(p.RestConfig(server=server.url, read_servers=(replica.url,)))
            try:
                client.create(p.node("fo-0"))
                counts = [len(client.list("Node"))]
                replica.shutdown()
                counts += [len(client.list("Node")) for _ in range(3)]
                return counts, client.transport_stats()["read_failovers"], client.read_failovers
            finally:
                client.close()
                replica.stop()

    assert on_both(case) == ([1, 1, 1, 1], 1, 1)


def test_watch_windows_ride_replicas():
    def case(p):
        with LocalApiServer() as server:
            replica = server.read_replica().start()
            client = p.RestClient(p.RestConfig(server=server.url, read_servers=(replica.url,)))
            try:
                client.create(p.node("wr-0"))
                events = [(t, obj.name) for t, obj in client.watch(
                    "Node", timeout_seconds=1, resource_version="0")]
                return events, replica.watch_streams, server.watch_streams
            finally:
                client.close()
                replica.stop()

    assert on_both(case) == ([("ADDED", "wr-0")], 1, 0)


def test_replica_never_closes_the_shared_journal():
    def case(p):
        with LocalApiServer() as server:
            replica = server.read_replica().start()
            client = p.RestClient(p.RestConfig(server=server.url))
            try:
                client.create(p.node("shared-0"))
                replica.stop()
                return len(client.list("Node"))
            finally:
                client.close()

    assert on_both(case) == 1


# ----------------------------------------------------------------------
# Across the packages
# ----------------------------------------------------------------------


def _frames(client, rv, n, **kw):
    out = []
    for event_type, obj in client.watch("Node", timeout_seconds=10, resource_version=rv, **kw):
        out.append((event_type, obj.name, obj.resource_version,
                    dict(obj.raw["metadata"].get("labels") or {})))
        if len(out) >= n:
            break
    return out


@pytest.mark.parametrize("encoding", ["json", "compact"])
@pytest.mark.parametrize("relay_pkg, client_pkg", [("port", "jax"), ("jax", "port")],
                         ids=["jax-client-through-port-relay", "port-client-through-jax-relay"])
def test_relays_and_clients_interoperate(relay_pkg, client_pkg, encoding):
    """One server, one package's relay, the other package's client
    through it, beside a direct watch of the client's package: equal
    frames, a replayed window from a cursor included."""
    r, c = PKGS[relay_pkg], PKGS[client_pkg]
    with LocalApiServer() as server:
        server.cluster.create(make_node("x-0", labels={"a": "0"}))
        _, rv = JaxRestClient(JaxRestConfig(server=server.url)).list_with_revision("Node")
        relay = r.WatchRelay(r.RestConfig(server=server.url)).start()
        through = c.RestClient(c.RestConfig(server=relay.url, wire_encoding=encoding))
        direct = c.RestClient(c.RestConfig(server=server.url, wire_encoding=encoding))
        try:
            results = {}

            def watch(name, client):
                results[name] = _frames(client, rv, 4)

            threads = [threading.Thread(target=watch, args=(name, client))
                       for name, client in (("through", through), ("direct", direct))]
            for thread in threads:
                thread.start()
            server.cluster.create(make_node("x-1"))
            server.cluster.patch("Node", "x-0", patch={"metadata": {"labels": {"a": "1"}}})
            server.cluster.patch("Node", "x-1", patch={"metadata": {"labels": {"b": "2"}}})
            server.cluster.delete("Node", "x-1")
            for thread in threads:
                thread.join(timeout=20)
            assert results["through"] == results["direct"]
            assert [(t, name) for t, name, _, _ in results["through"]] == [
                ("ADDED", "x-1"), ("MODIFIED", "x-0"), ("MODIFIED", "x-1"), ("DELETED", "x-1")]
            # A window from the old cursor replays from the relay's journal.
            assert _frames(through, rv, 4) == results["direct"]
            stats = relay.stats()
            assert stats["hub"]["upstream_streams"] == 1
            assert stats["streams_compact"] == (stats["streams_total"] if encoding == "compact"
                                                else 0)
            # A watch alone never proves compact to a client: only a
            # buffered answer does, as in both packages.
            assert through.transport_stats()["watch_frames_received"] == 8
        finally:
            relay.stop()
            through.close()
            direct.close()
