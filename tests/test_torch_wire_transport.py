"""The port's wire path against the JAX package's, over the JAX
``LocalApiServer``.

Each case of ``tests/test_wire_transport.py``'s ``TestConnectionReuse``,
``TestContentNegotiationFallback``, ``TestErrorMapping``,
``TestBookmarkResume``, ``TestLoopStallWatchdog`` and
``TestWatchFrameBuffering`` runs with each package's ``RestClient`` (and
``Informer``, ``LoopStallWatchdog``, ``WireMetrics``), and the client
cases of ``tests/test_pagination.py::TestWirePagination``,
``tests/test_bookmarks.py::TestWireBookmarks`` /
``TestInformerRidesBookmarks`` and
``tests/test_delete_collection.py::TestOverHttp`` the same way; where a
case observes something countable (the server's connections and
requests, the transport's counters, the frames a watch yields) the two
packages must observe the same. One call sequence (writes, lists, a
primed batch, pipelined patches, watch windows) runs through both
clients against twin servers, and their ``transport_stats`` agree on
connections, requests, pipelined batches and watch frames.
``TestTableWatch`` and ``TestNegotiation`` run against the port's server
in ``tests/test_torch_apiserver_transport.py``.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import queue
import socket
import socketserver
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from types import SimpleNamespace

import pytest

from builders import make_node, make_pod
from k8s_operator_libs_tpu.kube import ApiError as JaxApiError
from k8s_operator_libs_tpu.kube import Informer as JaxInformer
from k8s_operator_libs_tpu.kube import LocalApiServer
from k8s_operator_libs_tpu.kube import LoopStallWatchdog as JaxLoopStallWatchdog
from k8s_operator_libs_tpu.kube import NotFoundError as JaxNotFoundError
from k8s_operator_libs_tpu.kube import RestClient as JaxRestClient
from k8s_operator_libs_tpu.kube import RestConfig as JaxRestConfig
from k8s_operator_libs_tpu.kube import install_wire_loop_watchdog as jax_install_watchdog
from k8s_operator_libs_tpu.kube import wire_loop_stall_stats as jax_stall_stats
from k8s_operator_libs_tpu.upgrade.metrics import WireMetrics as JaxWireMetrics
from k8s_operator_libs_tpu_torch.kube import LoopStallWatchdog, install_wire_loop_watchdog
from k8s_operator_libs_tpu_torch.kube import wire_loop_stall_stats
from k8s_operator_libs_tpu_torch.kube.client import ApiError, NotFoundError
from k8s_operator_libs_tpu_torch.kube.informer import Informer
from k8s_operator_libs_tpu_torch.kube.objects import wrap
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.upgrade.metrics import WireMetrics

PKGS = {
    "jax": SimpleNamespace(RestClient=JaxRestClient, RestConfig=JaxRestConfig,
                           Informer=JaxInformer, ApiError=JaxApiError,
                           NotFoundError=JaxNotFoundError, LoopStallWatchdog=JaxLoopStallWatchdog,
                           install_watchdog=jax_install_watchdog, stall_stats=jax_stall_stats,
                           WireMetrics=JaxWireMetrics, node=make_node),
    "port": SimpleNamespace(RestClient=RestClient, RestConfig=RestConfig, Informer=Informer,
                            ApiError=ApiError, NotFoundError=NotFoundError,
                            LoopStallWatchdog=LoopStallWatchdog,
                            install_watchdog=install_wire_loop_watchdog,
                            stall_stats=wire_loop_stall_stats, WireMetrics=WireMetrics,
                            node=lambda *a, **kw: wrap(make_node(*a, **kw).raw)),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


def wait_until(predicate, timeout=10.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def on_both(case):
    """``case(pkg)`` for each package; the two observations must be equal."""
    outcomes = {name: case(PKGS[name]) for name in ("jax", "port")}
    assert outcomes["port"] == outcomes["jax"]
    return outcomes["port"]


# ----------------------------------------------------------------------
# TestConnectionReuse
# ----------------------------------------------------------------------


def test_n_requests_one_connection():
    def case(p):
        with LocalApiServer() as server:
            client = p.RestClient(p.RestConfig(server=server.url))
            try:
                for i in range(10):
                    client.create(p.node(f"reuse-{i}"))
                    assert client.get("Node", f"reuse-{i}") is not None
                assert len(client.list("Node")) == 10
                return (server.connections_opened, server.requests_served,
                        client.transport_stats()["connections_opened"])
            finally:
                client.close()

    assert on_both(case) == (1, 21, 1)


def test_watch_windows_reuse_the_held_connection():
    def case(p):
        with LocalApiServer() as server:
            client = p.RestClient(p.RestConfig(server=server.url))
            try:
                for _ in range(3):
                    assert list(client.watch("Node", timeout_seconds=0)) == []
                client.list("Node")
                return server.connections_opened, client.transport_stats()["requests_sent"]
            finally:
                client.close()

    assert on_both(case) == (1, 4)


def test_pipelined_batch_uses_one_connection_in_order():
    def case(p):
        with LocalApiServer() as server:
            server.cluster.create(make_node("pipe-a"))
            server.cluster.create(make_pod("pipe-p", namespace="ns-1"))
            client = p.RestClient(p.RestConfig(server=server.url))
            try:
                primed = client.prime_list_cache([
                    ("Node", "", None, None),
                    ("Pod", "ns-1", None, None),
                    ("DaemonSet", "ns-1", None, None),
                ])
                opened = server.connections_opened
                batches = client.transport_stats()["pipelined_batches"]
                nodes, rv = client.list_with_revision("Node")
                pods, _ = client.list_with_revision("Pod", "ns-1")
                assert rv
                server.start_request_log()
                again, _ = client.list_with_revision("Node")
                reasked = len(server.stop_request_log())
                return (primed, opened, batches, [n.name for n in nodes],
                        [p_.name for p_ in pods], [n.name for n in again], reasked)
            finally:
                client.close()

    assert on_both(case) == (3, 1, 1, ["pipe-a"], ["pipe-p"], ["pipe-a"], 1)


# ----------------------------------------------------------------------
# TestContentNegotiationFallback
# ----------------------------------------------------------------------


def test_compact_client_gets_compact_responses():
    def case(p):
        with LocalApiServer() as server:
            client = p.RestClient(p.RestConfig(server=server.url, wire_encoding="compact"))
            try:
                client.create(p.node("compact-n", labels={"a": "b"}))
                got = client.get("Node", "compact-n")
                speaks = client.transport_stats()["server_speaks_compact"]
                updated = client.patch("Node", "compact-n",
                                       patch={"metadata": {"labels": {"a": "c"}}})
                return got.labels, speaks, updated.labels["a"]
            finally:
                client.close()

    assert on_both(case) == ({"a": "b"}, True, "c")


def test_json_client_untouched_by_compact_capable_server():
    """The server side of the fallback, seen by a raw client: JSON for a
    JSON-only ``Accept`` and for none; the port's client, asking JSON,
    sends nothing else."""
    with LocalApiServer() as server:
        server.cluster.create(make_node("json-n"))
        conn = http.client.HTTPConnection(*server.server_address)
        try:
            for headers in ({"Accept": "application/json"}, {}):
                conn.request("GET", "/api/v1/nodes", headers=headers)
                resp = conn.getresponse()
                assert resp.status == 200
                assert resp.getheader("Content-Type") == "application/json"
                assert json.loads(resp.read())["kind"] == "NodeList"
        finally:
            conn.close()
        client = RestClient(RestConfig(server=server.url))
        try:
            client.get("Node", "json-n")
            assert client._headers()["Accept"] == "application/json"
            assert client.transport_stats()["server_speaks_compact"] is False
        finally:
            client.close()


class _JsonOnly(BaseHTTPRequestHandler):
    """A server that never heard of the compact type: JSON answers only."""

    protocol_version = "HTTP/1.1"
    seen: list = []

    def _send(self, doc):
        payload = json.dumps(doc).encode()
        self.send_response(201 if self.command == "POST" else 200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        self._send({"apiVersion": "v1", "kind": "NodeList",
                    "metadata": {"resourceVersion": "1"}, "items": []})

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        self.seen.append(self.headers.get("Content-Type", ""))
        self._send(json.loads(body))

    def log_message(self, *args):
        pass


class _Threading(socketserver.ThreadingMixIn, HTTPServer):
    daemon_threads = True


def test_compact_client_against_json_only_server():
    def case(p):
        _JsonOnly.seen = []
        httpd = _Threading(("127.0.0.1", 0), _JsonOnly)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            client = p.RestClient(p.RestConfig(
                server=f"http://127.0.0.1:{httpd.server_address[1]}", wire_encoding="compact"))
            try:
                listed = client.list("Node")
                created = client.create(p.node("fallback-n"))
                return (listed, created.name, list(_JsonOnly.seen),
                        client.transport_stats()["server_speaks_compact"])
            finally:
                client.close()
        finally:
            httpd.shutdown()
            httpd.server_close()

    assert on_both(case) == ([], "fallback-n", ["application/json"], False)


def test_compact_watch_frames_end_to_end():
    def case(p):
        with LocalApiServer() as server:
            client = p.RestClient(p.RestConfig(server=server.url, wire_encoding="compact"))
            try:
                _, rv = client.list_with_revision("Node")
                stream = client.watch("Node", timeout_seconds=10, resource_version=rv)
                server.cluster.create(make_node("compact-w"))
                event_type, obj = next(stream)
                stream.close()
                stats = client.transport_stats()
                return ((event_type, obj.name), stats["watch_frames_received"],
                        stats["server_speaks_compact"])
            finally:
                client.close()

    assert on_both(case) == (("ADDED", "compact-w"), 1, True)


# ----------------------------------------------------------------------
# TestErrorMapping
# ----------------------------------------------------------------------


def _refused_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


@BOTH
def test_unreachable_server_raises_api_error(pkg):
    p = PKGS[pkg]
    client = p.RestClient(p.RestConfig(server=f"http://127.0.0.1:{_refused_port()}"),
                          timeout=2.0)
    try:
        with pytest.raises(p.ApiError):
            client.get("Node", "ghost")
        with pytest.raises(p.ApiError):
            list(client.watch("Node", timeout_seconds=1))
        assert client.prime_list_cache([("Node", "", None, None)]) == 0
    finally:
        client.close()


def test_interim_100_continue_response_is_skipped():
    """The client's side of ``test_expect_100_continue_gets_interim_response``:
    a server that sends the interim ``100 Continue`` before its answer is
    read through to the answer."""
    listener = socket.create_server(("127.0.0.1", 0))

    def serve():
        conn, _ = listener.accept()
        with conn:
            data = b""
            while b"\r\n\r\n" not in data:
                data += conn.recv(65536)
            head, _, body = data.partition(b"\r\n\r\n")
            length = int([line.split(b":")[1] for line in head.split(b"\r\n")
                          if line.lower().startswith(b"content-length")][0])
            while len(body) < length:
                body += conn.recv(65536)
            reply = json.dumps(json.loads(body)).encode()
            conn.sendall(b"HTTP/1.1 100 Continue\r\n\r\nHTTP/1.1 201 Created\r\n"
                         b"Content-Type: application/json\r\n"
                         + b"Content-Length: %d\r\n\r\n" % len(reply) + reply)

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    client = RestClient(RestConfig(server=f"http://127.0.0.1:{listener.getsockname()[1]}"))
    try:
        assert client.create(PKGS["port"].node("expect-n")).name == "expect-n"
    finally:
        client.close()
        thread.join(timeout=5)
        listener.close()


# ----------------------------------------------------------------------
# TestBookmarkResume
# ----------------------------------------------------------------------


def test_informer_resumes_from_bookmark_after_killed_connection():
    def case(p):
        with LocalApiServer(bookmark_interval_s=0.1) as server:
            server.cluster.create(make_node("bm-keep"))
            client = p.RestClient(p.RestConfig(server=server.url))
            informer = p.Informer(client, "Node", watch_timeout_seconds=30)
            try:
                informer.start()
                assert informer.wait_for_sync(timeout=10)
                for i in range(3):
                    server.cluster.create(make_node(f"bm-pre-{i}"))
                assert wait_until(lambda: informer.get("bm-pre-2") is not None)
                server.start_request_log()
                assert server.kill_connections() >= 1
                server.cluster.create(make_node("bm-post"))
                assert wait_until(lambda: informer.get("bm-post") is not None, timeout=15)
                requests = server.stop_request_log()
                lists = [r for r in requests
                         if r[0] == "GET" and r[2].get("watch") not in ("true", "1")]
                watches = [r for r in requests if r[2].get("watch") in ("true", "1")]
                return (lists, bool(watches), all(q.get("resourceVersion") for _, _, q in watches),
                        informer.get("bm-keep") is not None, informer.full_relists)
            finally:
                informer.stop()
                client.close()

    assert on_both(case) == ([], True, True, True, 1)


def test_repeated_failures_degrade_to_relist():
    def case(p):
        with LocalApiServer() as server:
            client = p.RestClient(p.RestConfig(server=server.url))
            informer = p.Informer(client, "Node", watch_timeout_seconds=30)
            try:
                informer.start()
                assert informer.wait_for_sync(timeout=10)
                for i in range(60):
                    server.cluster.create(make_node(f"churn-{i}"))
                while len(server.cluster._history) > 3:
                    server.cluster._history.popleft()
                server.kill_connections()
                assert wait_until(lambda: informer.get("churn-59") is not None, timeout=15)
                return len(informer.list())
            finally:
                informer.stop()
                client.close()

    assert on_both(case) == 60


# ----------------------------------------------------------------------
# TestLoopStallWatchdog
# ----------------------------------------------------------------------


def _running_loop():
    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()
    return loop


@BOTH
def test_detects_seeded_stall(pkg):
    loop = _running_loop()
    try:
        watchdog = PKGS[pkg].LoopStallWatchdog(loop, threshold_s=0.1, interval_s=0.01).start()
        assert wait_until(lambda: watchdog.heartbeats > 0)
        loop.call_soon_threadsafe(lambda: time.sleep(0.3))
        assert wait_until(lambda: watchdog.stalls_over_threshold >= 1, timeout=5)
        assert watchdog.max_stall_s >= 0.2
        stats = watchdog.stats()
        assert stats["threshold_s"] == 0.1 and stats["stalls_over_threshold"] >= 1
        assert sorted(stats) == ["heartbeats", "max_stall_s", "stalls_over_threshold",
                                 "threshold_s"]
        watchdog.stop()
    finally:
        loop.call_soon_threadsafe(loop.stop)


@BOTH
def test_clean_loop_counts_zero_and_reset_zeroes(pkg):
    loop = _running_loop()
    try:
        watchdog = PKGS[pkg].LoopStallWatchdog(loop, threshold_s=1.0, interval_s=0.01).start()
        assert wait_until(lambda: watchdog.heartbeats > 5)
        assert watchdog.stalls_over_threshold == 0
        watchdog.reset()
        assert wait_until(lambda: watchdog.heartbeats > 0)
        assert watchdog.stalls_over_threshold == 0
        watchdog.stop()
    finally:
        loop.call_soon_threadsafe(loop.stop)


@BOTH
def test_wire_loop_install_is_idempotent(pkg):
    p = PKGS[pkg]
    first = p.install_watchdog()
    second = p.install_watchdog(threshold_s=2.5)
    assert first is second and second.threshold_s == 2.5
    p.install_watchdog()
    assert wait_until(lambda: first.heartbeats > 0)
    stats = p.stall_stats()
    assert stats["threshold_s"] == first.threshold_s and "stalls_over_threshold" in stats


def test_the_port_watches_its_own_wire_loop():
    """The port's watchdog sits on the port's wire loop, not the JAX one."""
    from k8s_operator_libs_tpu.kube import rest as jax_rest
    from k8s_operator_libs_tpu_torch.kube import rest as port_rest

    watchdog = install_wire_loop_watchdog()
    assert watchdog._loop is port_rest._get_wire_loop()
    assert watchdog._loop is not jax_rest._get_wire_loop()


@BOTH
def test_clean_roundtrips_do_not_stall_the_wire_loop(pkg):
    p = PKGS[pkg]
    watchdog = p.install_watchdog()
    watchdog.reset()
    with LocalApiServer() as srv:
        client = p.RestClient(p.RestConfig(server=srv.url))
        try:
            for i in range(20):
                srv.cluster.create(make_node(f"wd-{i}"))
            assert len(client.list("Node")) == 20
        finally:
            client.close()
    assert wait_until(lambda: watchdog.heartbeats > 0)
    assert watchdog.stalls_over_threshold == 0


def test_apiserver_stall_watchdog_renders_alike():
    """The server's own watchdog is a ``loop_watchdog`` for each package's
    ``WireMetrics`` (duck-typed on ``loop_stall_stats``): the same text."""
    with LocalApiServer(stall_watchdog_threshold_s=0.5) as srv:
        client = RestClient(RestConfig(server=srv.url))
        try:
            srv.cluster.create(make_node("wd-server"))
            assert client.get("Node", "wd-server").name == "wd-server"
            assert wait_until(lambda: srv.loop_stall_stats().get("heartbeats", 0) > 0)

            class Frozen:
                stats = srv.loop_stall_stats()

                def loop_stall_stats(self):
                    return self.stats

            rendered = WireMetrics(loop_watchdog=Frozen()).render()
            assert rendered == JaxWireMetrics(loop_watchdog=Frozen()).render()
            assert "tpu_operator_wire_loop_stall_total 0" in rendered
        finally:
            client.close()
    with LocalApiServer() as srv2:
        assert WireMetrics(loop_watchdog=srv2).render() == ""


# ----------------------------------------------------------------------
# TestWatchFrameBuffering
# ----------------------------------------------------------------------


def test_frames_buffer_while_consumer_is_busy():
    def case(p):
        with LocalApiServer() as srv:
            client = p.RestClient(p.RestConfig(server=srv.url))
            try:
                _, rv = client.list_with_revision("Node")
                stream = client.watch("Node", timeout_seconds=10, resource_version=rv)
                srv.cluster.create(make_node("slow-0"))
                first = next(stream)
                for i in range(1, 50):
                    srv.cluster.create(make_node(f"slow-{i}"))
                time.sleep(0.5)
                names = [next(stream)[1].name for _ in range(49)]
                stream.close()
                return (first[0], first[1].name), names
            finally:
                client.close()

    first, names = on_both(case)
    assert first == ("ADDED", "slow-0") and names == [f"slow-{i}" for i in range(1, 50)]


# ----------------------------------------------------------------------
# test_pagination.py::TestWirePagination (the client's cases)
# ----------------------------------------------------------------------


def _seed(cluster, n, prefix="pg"):
    for i in range(n):
        cluster.create(make_node(f"{prefix}-{i:03d}"))


def test_listmeta_carries_continue_and_remaining():
    def case(p):
        with LocalApiServer() as server:
            client = p.RestClient(p.RestConfig(server=server.url, list_page_size=0))
            try:
                _seed(server.cluster, 5)
                out = client._request("GET", "/api/v1/nodes", query={"limit": "2"})
                meta = out["metadata"]
                out2 = client._request("GET", "/api/v1/nodes",
                                       query={"limit": "2", "continue": meta["continue"]})
                return (len(out["items"]), bool(meta["continue"]), meta["remainingItemCount"],
                        out2["metadata"]["resourceVersion"] == meta["resourceVersion"])
            finally:
                client.close()

    assert on_both(case) == (2, True, 3, True)


def test_rest_client_paginates_transparently():
    def case(p):
        with LocalApiServer() as server:
            _seed(server.cluster, 23)
            client = p.RestClient(p.RestConfig(server=server.url, list_page_size=5))
            try:
                server.start_request_log()
                items, revision = client.list_with_revision("Node")
                pages = len(server.stop_request_log())
                assert revision == server.cluster.current_resource_version()
                return [o.name for o in items], pages
            finally:
                client.close()

    names, pages = on_both(case)
    assert names == sorted(names) and len(names) == 23 and pages == 5


def test_expired_continue_falls_back_to_full_list():
    def case(p):
        with LocalApiServer() as server:
            _seed(server.cluster, 9)
            client = p.RestClient(p.RestConfig(server=server.url, list_page_size=4))
            calls = []
            original = server.cluster.list_page

            def sabotaged(*args, **kwargs):
                calls.append(kwargs.get("continue_token", ""))
                if kwargs.get("continue_token"):
                    server.cluster.expire_continue_tokens()
                return original(*args, **kwargs)

            server.cluster.list_page = sabotaged
            try:
                items, _ = client.list_with_revision("Node")
                return len(items), [bool(c) for c in calls]
            finally:
                server.cluster.list_page = original
                client.close()

    count, calls = on_both(case)
    assert count == 9 and calls[0] is False and calls[1] is True and calls[-1] is False


def test_informer_initial_sync_rides_pagination():
    def case(p):
        with LocalApiServer() as server:
            _seed(server.cluster, 11)
            client = p.RestClient(p.RestConfig(server=server.url, list_page_size=3))
            informer = p.Informer(client, "Node")
            try:
                informer.start()
                assert informer.wait_for_sync(timeout=30)
                events: queue.Queue = queue.Queue()
                informer.add_event_handler(lambda t, obj, old: events.put((t, obj.name)))
                server.cluster.create(make_node("pg-after-sync"))
                seen = []
                while True:
                    event = events.get(timeout=15)
                    seen.append(event)
                    if event == ("ADDED", "pg-after-sync"):
                        break
                return len(informer.list()), sorted(seen), events.empty()
            finally:
                informer.stop()
                client.close()

    count, seen, empty = on_both(case)
    assert count == 12 and empty
    assert seen == sorted([("ADDED", f"pg-{i:03d}") for i in range(11)]
                          + [("ADDED", "pg-after-sync")])


# ----------------------------------------------------------------------
# test_bookmarks.py::TestWireBookmarks, TestInformerRidesBookmarks
# ----------------------------------------------------------------------


def _collect(watch_iter, deadline_s, want=1, types=("BOOKMARK",)):
    got = []
    deadline = time.monotonic() + deadline_s
    for event_type, obj in watch_iter:
        if event_type in types:
            got.append((event_type, obj))
            if len(got) >= want:
                break
        if time.monotonic() > deadline:
            break
    return got


def test_http_stream_interleaves_bookmarks():
    def case(p):
        with LocalApiServer(bookmark_interval_s=0.15) as server:
            client = p.RestClient(p.RestConfig(server=server.url))
            try:
                server.cluster.create(make_node("bm-wire"))
                got = _collect(client.watch("Node", timeout_seconds=5, allow_bookmarks=True), 5)
                return [(t, obj.raw["kind"]) for t, obj in got]
            finally:
                client.close()

    assert on_both(case) == [("BOOKMARK", "Node")]


def test_plain_watch_never_sees_bookmarks():
    def case(p):
        with LocalApiServer(bookmark_interval_s=0.1) as server:
            client = p.RestClient(p.RestConfig(server=server.url))
            try:
                server.cluster.create(make_node("bm-none"))
                return _collect(client.watch("Node", timeout_seconds=1), 1.5)
            finally:
                client.close()

    assert on_both(case) == []


def test_quiet_scoped_informer_keeps_resume_point_fresh():
    def case(p):
        with LocalApiServer(bookmark_interval_s=0.15) as server:
            client = p.RestClient(p.RestConfig(server=server.url))
            dispatched = []
            informer = p.Informer(client, "Node", label_selector="app=never-matches")
            informer.add_event_handler(lambda t, obj, old: dispatched.append(t))
            try:
                informer.start()
                assert informer.wait_for_sync(timeout=30)
                rv_after_sync = int(informer._resource_version)
                for i in range(40):
                    server.cluster.create(make_node(f"bm-other-{i}"))
                fresh = wait_until(lambda: int(informer._resource_version or 0) > rv_after_sync)
                return fresh, dispatched
            finally:
                informer.stop()
                client.close()

    assert on_both(case) == (True, [])


# ----------------------------------------------------------------------
# test_delete_collection.py::TestOverHttp, and the namespace default
# ----------------------------------------------------------------------


def test_wire_collection_delete():
    def case(p):
        with LocalApiServer() as server:
            client = p.RestClient(p.RestConfig(server=server.url))
            try:
                server.cluster.create(make_node("keep", labels={"team": "gpu"}))
                for i in (1, 2):
                    server.cluster.create(make_node(f"drop-{i}", labels={"team": "tpu"}))
                deleted = sorted(o.name for o in client.delete_collection(
                    "Node", label_selector="team=tpu"))
                kept = client.get("Node", "keep").name
                with pytest.raises(p.NotFoundError):
                    client.get("Node", "drop-1")
                dry = [o.name for o in client.delete_collection(
                    "Node", label_selector="team=gpu", dry_run=True)]
                return deleted, kept, dry, client.get("Node", "keep").name
            finally:
                client.close()

    assert on_both(case) == (["drop-1", "drop-2"], "keep", ["keep"], "keep")


def test_rest_client_defaults_namespace_like_other_verbs():
    def case(p):
        with LocalApiServer() as server:
            client = p.RestClient(p.RestConfig(server=server.url, namespace="one"))
            try:
                server.cluster.create(make_pod("a", namespace="one"))
                server.cluster.create(make_pod("b", namespace="two"))
                deleted = [o.name for o in client.delete_collection("Pod")]
                return deleted, client.get("Pod", "b", "two").name
            finally:
                client.close()

    assert on_both(case) == (["a"], "b")


# ----------------------------------------------------------------------
# One call sequence through both clients
# ----------------------------------------------------------------------

SAME_STATS = ("connections_opened", "requests_sent", "pipelined_batches", "watch_frames_received",
              "server_speaks_compact")


@pytest.mark.parametrize("encoding", ["json", "compact"])
def test_transport_stats_agree_on_one_call_sequence(encoding):
    """Writes, reads, a primed batch, a pipelined patch batch, a delta
    list, watch windows (one cut short by its consumer), an error and a
    delete: the two clients, each against its own twin server, count the
    same connections, requests, pipelined batches and watch frames."""

    def case(p):
        with LocalApiServer() as server:
            client = p.RestClient(p.RestConfig(server=server.url, wire_encoding=encoding))
            try:
                for i in range(4):
                    client.create(p.node(f"seq-{i}", labels={"pool": str(i % 2)}))
                client.create(wrap(make_pod("seq-p", namespace="ns-1").raw)
                              if p is PKGS["port"] else make_pod("seq-p", namespace="ns-1"))
                client.list("Node", label_selector={"pool": "0"})
                client.prime_list_cache([("Node", "", None, None), ("Pod", "ns-1", None, None)])
                client.list_with_revision("Node")
                client.list_with_revision("Pod", "ns-1")
                results = client.patch_many("Node", [
                    (f"seq-{i}", {"metadata": {"labels": {"patched": "yes"}}}, "merge")
                    for i in range(3)
                ] + [("ghost", {"metadata": {"labels": {"x": "y"}}}, "merge")])
                errors = [type(r).__name__ for r in results if isinstance(r, Exception)]
                _, rv = client.list_with_revision("Node")
                stream = client.watch("Node", timeout_seconds=5, resource_version=rv)
                server.cluster.patch("Node", "seq-3", patch={"metadata": {"labels": {"w": "1"}}})
                server.cluster.patch("Node", "seq-3", patch={"metadata": {"labels": {"w": "2"}}})
                frames = [next(stream)[0] for _ in range(2)]
                stream.close()
                assert list(client.watch("Node", timeout_seconds=0, resource_version=rv)) != []
                delta = client.list_delta("Node", rv)
                with pytest.raises(p.NotFoundError):
                    client.get("Node", "ghost")
                client.delete("Node", "seq-0")
                stats = client.transport_stats()
                return ({k: stats[k] for k in SAME_STATS}, errors, frames,
                        sorted(o.name for o in delta.items), delta.full)
            finally:
                client.close()

    stats, errors, frames, delta, full = on_both(case)
    assert errors == ["NotFoundError"] and frames == ["MODIFIED", "MODIFIED"]
    assert stats["pipelined_batches"] == 2 and delta == ["seq-3"] and not full
    assert stats["server_speaks_compact"] is (encoding == "compact")
