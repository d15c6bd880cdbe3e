"""The port's REST client against the JAX package's local API server, over
HTTP: every operation on Node, Pod and NodeHealthReport, the API errors
recognised by reason, a JSON kubeconfig, and the in-cluster service account
read from a directory. The watch: every case of ``tests/test_rest_client.py``'s
``TestWatch``, the port's client beside the JAX client on one server, the
two streams equal event for event; ``list_with_revision``'s revision equal
to the JAX client's; an ``ERROR`` frame inside a 200 stream.
"""

from __future__ import annotations

import json
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from k8s_operator_libs_tpu.kube import LocalApiServer
from k8s_operator_libs_tpu.kube import RestClient as JaxRestClient
from k8s_operator_libs_tpu.kube import RestConfig as JaxRestConfig
from k8s_operator_libs_tpu.kube import WatchExpiredError as JaxWatchExpiredError
from k8s_operator_libs_tpu.kube import rest as jax_rest
from k8s_operator_libs_tpu.kube.objects import Node as JaxNode
from k8s_operator_libs_tpu.upgrade import condition_changed_predicate as jax_condition_changed
from k8s_operator_libs_tpu_torch.api.telemetry_v1alpha1 import make_node_health_report
from k8s_operator_libs_tpu_torch.kube import rest as port_rest
from k8s_operator_libs_tpu_torch.kube.client import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    WatchExpiredError,
    has_reason,
    retry_on_conflict,
)
from k8s_operator_libs_tpu_torch.kube.objects import Node, NodeMaintenance, Pod, wrap
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig, RestConfigError
from k8s_operator_libs_tpu_torch.upgrade import condition_changed_predicate

NS = "kube-system"


@pytest.fixture()
def server():
    with LocalApiServer(token="s3cret") as srv:
        yield srv


@pytest.fixture()
def client(server):
    return RestClient(RestConfig(server=server.url, token="s3cret"))


def _pod(name, node, labels=None):
    pod = Pod.new(name, namespace=NS, labels=labels or {})
    pod.node_name = node
    pod.spec["containers"] = [{"name": "c", "image": "x"}]
    return pod


def test_node_create_get_list_update_status_patch(client, server):
    for name, pool in (("gpu-0", "a"), ("gpu-1", "a"), ("gpu-2", "b")):
        client.create(Node.new(name, labels={"pool": pool}))
    got = client.get("Node", "gpu-0")
    assert isinstance(got, Node) and got.name == "gpu-0" and got.uid
    assert [n.name for n in client.list("Node", label_selector="pool=a")] == ["gpu-0", "gpu-1"]
    assert [n.name for n in client.list("Node", label_selector={"pool": "b"})] == ["gpu-2"]
    got.labels["extra"] = "1"
    client.update(got)
    assert server.cluster.get("Node", "gpu-0").labels["extra"] == "1"
    got = client.get("Node", "gpu-0")
    got.set_ready(False)
    client.update_status(got)
    assert not JaxNode(server.cluster.get("Node", "gpu-0").raw).is_ready()
    patched = client.patch("Node", "gpu-1", patch={"metadata": {"labels": {"pool": None}}})
    assert "pool" not in patched.labels
    client.patch(
        "Node", "gpu-1", patch={"metadata": {"labels": {"s": "t"}}}, patch_type="strategic"
    )
    assert server.cluster.get("Node", "gpu-1").labels["s"] == "t"
    client.delete("Node", "gpu-2")
    assert client.get_or_none("Node", "gpu-2") is None


def test_pods_by_field_selector_across_namespaces(client):
    client.create(_pod("a", "gpu-0", {"app": "x"}))
    client.create(_pod("b", "gpu-1"))
    assert [p.name for p in client.list("Pod", field_selector="spec.nodeName=gpu-0")] == ["a"]
    assert [p.name for p in client.list("Pod", namespace=NS, label_selector="app=x")] == ["a"]
    assert isinstance(client.get("Pod", "a", NS), Pod)


def test_node_health_report_round_trip(client, server):
    doc = make_node_health_report("gpu-0", {"psum": True}, {"mxu_tflops": 240.0}, observed_at=5.0)
    created = client.create(wrap(json.loads(json.dumps(doc))))
    assert created.raw["kind"] == "NodeHealthReport"
    doc["metadata"]["resourceVersion"] = created.resource_version
    client.update_status(wrap(doc))
    stored = server.cluster.get("NodeHealthReport", "gpu-0").raw
    assert stored["status"]["metrics"] == {"mxu_tflops": 240.0}
    assert stored["spec"] == {"nodeName": "gpu-0", "source": "monitor"}
    got = client.get("NodeHealthReport", "gpu-0")
    assert got.raw["status"]["score"] == doc["status"]["score"]
    assert [r.name for r in client.list("NodeHealthReport")] == ["gpu-0"]


def test_errors_carry_the_api_reason(client):
    with pytest.raises(Exception) as missing:
        client.get("Node", "nope")
    assert has_reason(missing.value, NotFoundError)
    client.create(Node.new("gpu-0"))
    with pytest.raises(Exception) as exists:
        client.create(Node.new("gpu-0"))
    assert has_reason(exists.value, AlreadyExistsError)
    stale = client.get("Node", "gpu-0")
    fresh = client.get("Node", "gpu-0")
    fresh.labels["a"] = "1"
    client.update(fresh)
    stale.labels["b"] = "2"
    with pytest.raises(Exception) as conflict:
        client.update(stale)
    assert has_reason(conflict.value, ConflictError)

    def relabel():
        node = client.get("Node", "gpu-0")
        node.labels["c"] = "3"
        return client.update(node)

    assert retry_on_conflict(relabel).labels["c"] == "3"


def test_unauthenticated_is_refused(server):
    with pytest.raises(Exception) as refused:
        RestClient(RestConfig(server=server.url)).list("Node")
    assert getattr(refused.value, "code", None) == 401


def _kubeconfig(server, path):
    doc = {
        "apiVersion": "v1", "kind": "Config", "current-context": "local",
        "clusters": [{"name": "local", "cluster": {"server": server.url}}],
        "users": [{"name": "u", "user": {"token": "s3cret"}}],
        "contexts": [{"name": "local", "context": {"cluster": "local", "user": "u",
                                                   "namespace": NS}}],
    }
    path.write_text(json.dumps(doc))
    return str(path)


def test_json_kubeconfig_from_the_environment(server, tmp_path, monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.setenv("KUBECONFIG", _kubeconfig(server, tmp_path / "config"))
    client = RestClient.from_environment(sa_dir=str(tmp_path / "no-sa"))
    assert client.config.namespace == NS
    client.create(Node.new("gpu-9"))
    assert server.cluster.get("Node", "gpu-9").name == "gpu-9"


def test_no_credentials_says_where_it_looked(tmp_path, monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "missing"))
    with pytest.raises(RestConfigError, match="not running in a cluster.*kubeconfig not found"):
        RestConfig.from_environment(sa_dir=str(tmp_path))


def _self_signed(tmp_path):
    """A certificate and key for 127.0.0.1."""
    cert, key = str(tmp_path / "tls.crt"), str(tmp_path / "tls.key")
    proc = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key, "-out", cert,
         "-days", "1", "-nodes", "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        capture_output=True, timeout=60,
    )
    assert proc.returncode == 0, proc.stderr.decode()[:500]
    return cert, key


def test_in_cluster_service_account_over_tls(tmp_path, monkeypatch):
    cert, key = _self_signed(tmp_path)
    sa = tmp_path / "serviceaccount"
    sa.mkdir()
    (sa / "token").write_text("s3cret\n")
    (sa / "ca.crt").write_text(open(cert).read())
    (sa / "namespace").write_text(NS)
    with LocalApiServer(token="s3cret", certfile=cert, keyfile=key) as srv:
        port = srv.url.rsplit(":", 1)[1]
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
        monkeypatch.setenv("KUBERNETES_SERVICE_PORT", port)
        client = RestClient.from_environment(sa_dir=str(sa))
        assert client.config.server == f"https://127.0.0.1:{port}"
        assert client.config.namespace == NS
        client.create(_pod("probe", "gpu-0"))
        assert [p.name for p in client.list("Pod", namespace=NS)] == ["probe"]


# ----------------------------------------------------------------------
# The watch, beside the JAX client's on one server
# ----------------------------------------------------------------------


@pytest.fixture()
def jax_client(server):
    return JaxRestClient(JaxRestConfig(server=server.url, token="s3cret"))


def _events(stream, n):
    """The first ``n`` events of ``stream`` as (type, name, rv, labels)."""
    got = []
    for event_type, obj in stream:
        got.append((event_type, obj.name, obj.resource_version, dict(obj.raw["metadata"].get("labels") or {})))
        if len(got) >= n:
            break
    return got


def _both_watch(server, client, jax_client, n, writes, **kw):
    """Both clients watch from the current revision (so neither depends on
    when its stream opened) while ``writes`` runs; the events of each."""
    kw.setdefault("resource_version", server.cluster.current_resource_version())
    kw.setdefault("timeout_seconds", 10)
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(lambda c=c: _events(c.watch(**kw), n)) for c in (jax_client, client)]
        writes()
        theirs, ours = (f.result(timeout=20) for f in futures)
    assert ours == theirs
    return ours


def test_watch_streams_adds_and_modifies(server, client, jax_client):
    def writes():
        server.cluster.create(JaxNode.new("w-node"))
        server.cluster.patch("Node", "w-node", patch={"metadata": {"labels": {"x": "1"}}})

    got = _both_watch(server, client, jax_client, 2, writes, kind="Node")
    assert [(t, name) for t, name, _, _ in got] == [("ADDED", "w-node"), ("MODIFIED", "w-node")]


def test_watch_filters_by_label_selector(server, client, jax_client):
    def writes():
        server.cluster.create(JaxNode.new("other-node", labels={"team": "gpu"}))
        server.cluster.create(JaxNode.new("tpu-node", labels={"team": "tpu"}))

    got = _both_watch(server, client, jax_client, 1, writes, kind="Node", label_selector="team=tpu")
    assert [name for _, name, _, _ in got] == ["tpu-node"]


def test_watch_timeout_ends_stream(client, jax_client):
    for c in (jax_client, client):
        start = time.monotonic()
        assert list(c.watch("Node", timeout_seconds=1)) == []
        assert time.monotonic() - start < 6


def test_watch_without_timeout_gets_default_bound(client, jax_client, monkeypatch):
    assert port_rest.DEFAULT_WATCH_TIMEOUT_SECONDS == jax_rest.DEFAULT_WATCH_TIMEOUT_SECONDS == 300
    monkeypatch.setattr(port_rest, "DEFAULT_WATCH_TIMEOUT_SECONDS", 1)
    monkeypatch.setattr(jax_rest, "DEFAULT_WATCH_TIMEOUT_SECONDS", 1)
    for c in (jax_client, client):
        start = time.monotonic()
        assert list(c.watch("Node")) == []
        assert time.monotonic() - start < 6


def test_watch_resume_from_resource_version_replays(server, client, jax_client):
    created = server.cluster.create(JaxNode.new("r-node"))
    for x in ("1", "2"):
        server.cluster.patch("Node", "r-node", patch={"metadata": {"labels": {"x": x}}})
    replays = [
        _events(c.watch("Node", resource_version=created.resource_version, timeout_seconds=2), 2)
        for c in (jax_client, client)
    ]
    assert replays[1] == replays[0]
    assert [(t, labels.get("x")) for t, _, _, labels in replays[1]] == [
        ("MODIFIED", "1"), ("MODIFIED", "2"),
    ]


def test_watch_expired_resource_version_is_410(server, client, jax_client):
    for i in range(40):
        server.cluster.create(JaxNode.new(f"churn-{i}"))
    with server.cluster._lock:
        while server.cluster._history and server.cluster._history[0][0] < 10:
            server.cluster._history.popleft()
    with pytest.raises(JaxWatchExpiredError):
        next(iter(jax_client.watch("Node", resource_version="1", timeout_seconds=2)))
    with pytest.raises(WatchExpiredError) as expired:
        next(iter(client.watch("Node", resource_version="1", timeout_seconds=2)))
    assert has_reason(expired.value, WatchExpiredError) and expired.value.code == 410


def test_leaving_selector_scope_emits_deleted(server, client, jax_client):
    def writes():
        server.cluster.create(JaxNode.new("scope-node", labels={"team": "tpu"}))
        server.cluster.patch("Node", "scope-node", patch={"metadata": {"labels": {"team": "gpu"}}})

    got = _both_watch(server, client, jax_client, 2, writes, kind="Node", label_selector="team=tpu")
    assert [(t, name) for t, name, _, _ in got] == [("ADDED", "scope-node"), ("DELETED", "scope-node")]


def test_watch_feeds_condition_changed_predicate(server, client, jax_client):
    """NodeMaintenance watch deltas through each package's predicate: a
    spec-only change is ignored, the operator's Ready flip reconciles."""
    nm = NodeMaintenance.new("tpu-operator-node-1", namespace="default")
    nm.requestor_id = "tpu.operator.dev"
    nm.node_name = "node-1"
    since = server.cluster.current_resource_version()

    def deltas(c, predicate):
        previous, out = {}, []
        for event_type, obj in c.watch(
            "NodeMaintenance", namespace="default", timeout_seconds=10, resource_version=since
        ):
            old = previous.get(obj.name)
            previous[obj.name] = obj.raw
            if event_type == "MODIFIED" and old is not None:
                out.append(predicate(old, obj.raw))
                if len(out) >= 2:
                    return out
        return out

    with ThreadPoolExecutor(2) as pool:
        futures = [
            pool.submit(deltas, jax_client, jax_condition_changed),
            pool.submit(deltas, client, condition_changed_predicate),
        ]
        server.cluster.create(wrap_jax(nm))
        server.cluster.patch(
            "NodeMaintenance", nm.name, "default",
            patch={"spec": {"additionalRequestors": ["nic.operator.dev"]}},
        )
        server.cluster.patch(
            "NodeMaintenance", nm.name, "default",
            patch={"status": {"conditions": [{"type": "Ready", "status": "True", "reason": "Ready"}]}},
        )
        theirs, ours = (f.result(timeout=20) for f in futures)
    assert ours == theirs == [False, True]


def wrap_jax(obj):
    from k8s_operator_libs_tpu.kube.objects import wrap as jax_wrap

    return jax_wrap(json.loads(json.dumps(obj.raw)))


def test_list_with_revision_equals_jax(server, client, jax_client):
    _, empty_rv = client.list_with_revision("Node")
    assert empty_rv == jax_client.list_with_revision("Node")[1]
    for name, team in (("a", "tpu"), ("b", "gpu"), ("c", "tpu")):
        client.create(Node.new(name, labels={"team": team}))
    server.cluster.delete("Node", "b")
    for kw in ({}, {"label_selector": "team=tpu"}, {"label_selector": {"team": "gpu"}}):
        items, rv = client.list_with_revision("Node", **kw)
        jax_items, jax_rv = jax_client.list_with_revision("Node", **kw)
        assert rv == jax_rv == server.cluster.current_resource_version() != empty_rv
        assert [o.raw for o in items] == [o.raw for o in jax_items]


class _ErrorFrameServer(ThreadingHTTPServer):
    """Answers every watch with a 200 stream of one ADDED frame and then an
    ERROR frame carrying a 410 ``Status``, as an API server reports a
    compaction inside an open stream."""

    daemon_threads = True

    def __init__(self):
        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for frame in (
                    {"type": "ADDED", "object": {"kind": "Node", "apiVersion": "v1",
                                                 "metadata": {"name": "n", "resourceVersion": "7"}}},
                    {"type": "ERROR", "object": {"kind": "Status", "code": 410, "reason": "Expired",
                                                 "message": "too old resource version"}},
                ):
                    data = json.dumps(frame).encode() + b"\n"
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                self.wfile.write(b"0\r\n\r\n")

            def log_message(self, fmt, *args):
                pass

        super().__init__(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.serve_forever, daemon=True).start()


def test_error_frame_inside_the_stream_raises_its_status():
    srv = _ErrorFrameServer()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        results = []
        for c, expired in ((JaxRestClient(JaxRestConfig(server=url)), JaxWatchExpiredError),
                           (RestClient(RestConfig(server=url)), WatchExpiredError)):
            got = []
            with pytest.raises(expired) as raised:
                for event_type, obj in c.watch("Node", timeout_seconds=5):
                    got.append((event_type, obj.name, obj.resource_version))
            results.append((got, raised.value.reason))
        assert results[1] == results[0] == ([("ADDED", "n", "7")], "Expired")
    finally:
        srv.shutdown()
        srv.server_close()


def test_watch_over_tls_streams_and_cancels(tmp_path):
    """The watch's own connection verifies the server's certificate, and a
    cancel from another thread ends a quiet stream at once."""
    from k8s_operator_libs_tpu_torch.kube.rest import WatchHandle

    cert, key = _self_signed(tmp_path)
    with LocalApiServer(token="s3cret", certfile=cert, keyfile=key) as srv:
        client = RestClient(RestConfig(server=srv.url, token="s3cret", ca_file=cert))
        since = client.list_with_revision("Node")[1]
        client.create(Node.new("tls-node"))
        got = _events(client.watch("Node", resource_version=since, timeout_seconds=5), 1)
        assert [(t, name) for t, name, _, _ in got] == [("ADDED", "tls-node")]
        handle = WatchHandle()
        threading.Timer(0.5, handle.cancel).start()
        start = time.monotonic()
        quiet = list(client.watch("Node", resource_version=client.list_with_revision("Node")[1],
                                  timeout_seconds=30, handle=handle))
        assert quiet == [] and time.monotonic() - start < 5
        with pytest.raises(Exception) as untrusted:
            next(iter(RestClient(RestConfig(server=srv.url, token="s3cret")).watch("Node")))
        assert "certificate" in str(untrusted.value).lower()
