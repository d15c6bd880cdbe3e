"""The port's REST client against the JAX package's local API server, over
HTTP: every operation on Node, Pod and NodeHealthReport, the API errors
recognised by reason, a JSON kubeconfig, and the in-cluster service account
read from a directory.
"""

from __future__ import annotations

import json
import subprocess

import pytest

from k8s_operator_libs_tpu.kube import LocalApiServer
from k8s_operator_libs_tpu.kube.objects import Node as JaxNode
from k8s_operator_libs_tpu_torch.api.telemetry_v1alpha1 import make_node_health_report
from k8s_operator_libs_tpu_torch.kube.client import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    has_reason,
    retry_on_conflict,
)
from k8s_operator_libs_tpu_torch.kube.objects import Node, Pod, wrap
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig, RestConfigError

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


def test_in_cluster_service_account_over_tls(tmp_path, monkeypatch):
    cert, key = str(tmp_path / "tls.crt"), str(tmp_path / "tls.key")
    proc = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key, "-out", cert,
         "-days", "1", "-nodes", "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        capture_output=True, timeout=60,
    )
    assert proc.returncode == 0, proc.stderr.decode()[:500]
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
