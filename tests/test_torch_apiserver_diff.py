"""Both API servers behind one client: the JAX package's ``LocalApiServer``
over the JAX ``FakeCluster``, and the port's over the port's, answer one
seeded script of raw HTTP requests alike.

The script covers every route of the dispatcher (discovery, get, list,
watch, post, put, patch as merge, strategic, JSON and apply, delete,
``deletecollection``, the ``eviction`` and ``status`` subresources,
``dryRun``, the Table transform, bearer-token auth) and every status the
servers answer: 200, 201, 400, 401, 404, 405 (a read replica's write and
an unserved method), 409, 410 (an expired continue token, a delta list
and a watch outside the journal), 415 (a strategic patch on a custom
resource), 422 and 429 (a telemetry flow that sheds everything). Lists
come in pages with ``continue`` and ``remainingItemCount``; watches run
with and without bookmarks, in JSON and compact, scoped by a selector,
negotiated as a Table, and with a write landing mid-stream.

Each step's answer is compared: the status, the ``Content-Type``, the
``Retry-After``, the decoded body, and a watch's frames in order (a run
of identical BOOKMARK frames counts once: how many land in a window is
the clock's). The clusters' wall clock is pinned alike, so the Table's
Age cells agree; only ``creationTimestamp``, ``deletionTimestamp`` and
the ``managedFields`` ``time`` are normalized. uids and continue tokens
are equal because both clusters draw them from generators seeded alike.
"""

from __future__ import annotations

import http.client
import json
import pathlib
import random
import threading
import time
import types
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Optional

import pytest
import yaml

import k8s_operator_libs_tpu.kube.apiserver as jax_apiserver
import k8s_operator_libs_tpu.kube.fake as jax_fake
import k8s_operator_libs_tpu.kube.table as jax_table
from k8s_operator_libs_tpu.kube.wire import FrameDecoder, decode_body, encode_compact
import k8s_operator_libs_tpu_torch.kube.apiserver as port_apiserver
import k8s_operator_libs_tpu_torch.kube.fake as port_fake
import k8s_operator_libs_tpu_torch.kube.table as port_table
from torch_cluster_twins import norm

SEED = 20
TOKEN = "diff-token"
#: The clusters' pinned wall clock, and the Table's (an hour and two
#: minutes later: every Age cell reads ``62m``).
CLUSTER_NOW = 1_760_000_000.0
TABLE_NOW = CLUSTER_NOW + 3725.0
CRDS = pathlib.Path(__file__).resolve().parent.parent / "manifests" / "crds"
JSON = "application/json"
COMPACT = "application/vnd.tpu-operator.compact;v=1"
TABLE = "application/json;as=Table;v=v1;g=meta.k8s.io"
NM = "/apis/maintenance.nvidia.com/v1alpha1"
NS = "default"


@dataclass
class Step:
    name: str
    method: str = "GET"
    #: A path, or a function of the run's context (earlier answers).
    path: Any = ""
    body: Any = None
    content_type: str = JSON
    accept: str = ""
    token: Optional[str] = TOKEN
    replica: bool = False
    #: A watch: read the chunked stream to its terminal chunk.
    watch: bool = False
    #: Run on the side's cluster before the request (a compaction, a
    #: journal trim) or, for a watch, on a thread while it streams.
    before: Optional[Callable] = None
    during: Optional[Callable] = None
    #: Stores ``(context key, answer -> value)`` for later steps.
    keep: tuple = ()


def _node(name: str, labels: dict) -> dict:
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels},
            "spec": {"unschedulable": False}}


def _pod(name: str, node: str) -> dict:
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": NS, "labels": {"app": "probe"}},
            "spec": {"nodeName": node, "containers": [{"name": "c", "image": "busybox"}]}}


def _maintenance(name: str, node: str, ready: str = "True") -> dict:
    return {"apiVersion": "maintenance.nvidia.com/v1alpha1", "kind": "NodeMaintenance",
            "metadata": {"name": name, "namespace": NS},
            "spec": {"nodeName": node, "requestorID": "gpu-operator"},
            "status": {"conditions": [{"type": "Ready", "status": ready, "reason": "Ready"}]}}


def _script() -> list[Step]:
    rng = random.Random(SEED)
    nodes = [(f"gpu-{i:02d}", {"pool": rng.choice("ab"), "rack": str(rng.randrange(4))})
             for i in range(9)]
    first = nodes[0][0]
    steps = [
        Step("unauthorized", path="/api/v1/nodes", token=None),
        Step("wrong-token", path="/api/v1/nodes", token="nope"),
        Step("discovery-core", path="/api/v1"),
        Step("discovery-apis-without-group", path="/apis/v1"),
        Step("discovery-group-before-crd", path=NM),
        Step("no-route", path="/api/v1/gadgets"),
        Step("bad-request-line-path", path="/healthz"),
    ]
    for crd in sorted(CRDS.glob("*.yaml")):
        steps.append(Step(f"create-crd-{crd.stem}", "POST",
                          "/apis/apiextensions.k8s.io/v1/customresourcedefinitions",
                          yaml.safe_load(crd.read_text())))
    steps += [Step("discovery-group", path=NM),
              Step("list-empty", path="/api/v1/nodes",
                   keep=(("rv0", lambda a: a["body"]["metadata"]["resourceVersion"]),))]
    steps += [Step(f"create-node-{name}", "POST", "/api/v1/nodes", _node(name, labels))
              for name, labels in nodes]
    steps += [
        Step("create-node-exists", "POST", "/api/v1/nodes", _node(first, {})),
        Step("create-node-dry-run", "POST", "/api/v1/nodes?dryRun=All", _node("ghost", {})),
        Step("get-dry-run-node", path="/api/v1/nodes/ghost"),
        Step("create-node-bad-dry-run", "POST", "/api/v1/nodes?dryRun=Some", _node("x", {})),
        Step("create-node-compact", "POST", "/api/v1/nodes", _node("gpu-compact", {"pool": "c"}),
             content_type=COMPACT, accept=COMPACT),
        Step("get-node-compact", path=f"/api/v1/nodes/{first}", accept=COMPACT),
        Step("get-node", path=f"/api/v1/nodes/{first}",
             keep=(("first_rv", lambda a: a["body"]["metadata"]["resourceVersion"]),)),
        Step("get-node-missing", path="/api/v1/nodes/nobody"),
        Step("list-selector", path="/api/v1/nodes?labelSelector=pool%3Da"),
        Step("list-field-selector", path=f"/api/v1/nodes?fieldSelector=metadata.name%3D{first}"),
        Step("list-bad-limit", path="/api/v1/nodes?limit=abc"),
        Step("list-page-1", path="/api/v1/nodes?limit=4",
             keep=(("cont1", lambda a: a["body"]["metadata"]["continue"]),)),
        Step("list-page-2", path=lambda c: f"/api/v1/nodes?limit=4&continue={c['cont1']}",
             keep=(("cont2", lambda a: a["body"]["metadata"]["continue"]),)),
        Step("list-page-3", path=lambda c: f"/api/v1/nodes?limit=4&continue={c['cont2']}"),
        Step("list-bogus-continue", path="/api/v1/nodes?limit=4&continue=not-a-token"),
        Step("list-page-1-again", path="/api/v1/nodes?limit=4",
             keep=(("cont3", lambda a: a["body"]["metadata"]["continue"]),)),
        Step("list-expired-continue",
             path=lambda c: f"/api/v1/nodes?limit=4&continue={c['cont3']}",
             before=lambda cluster: cluster.expire_continue_tokens()),
        Step("table-list", path="/api/v1/nodes?limit=3", accept=TABLE),
        Step("table-list-object", path="/api/v1/nodes?includeObject=Object", accept=TABLE),
        Step("table-list-none", path="/api/v1/nodes?includeObject=None", accept=TABLE),
        Step("table-get", path=f"/api/v1/nodes/{first}", accept=TABLE),
        Step("table-bad-include", path=f"/api/v1/nodes/{first}?includeObject=Bogus",
             accept=TABLE),
        Step("patch-merge", "PATCH", f"/api/v1/nodes/{first}",
             {"metadata": {"labels": {"patched": "merge"}}},
             content_type="application/merge-patch+json"),
        Step("patch-strategic-node", "PATCH", f"/api/v1/nodes/{first}",
             {"metadata": {"annotations": {"a": "1"}}},
             content_type="application/strategic-merge-patch+json"),
        Step("patch-json", "PATCH", f"/api/v1/nodes/{first}",
             [{"op": "add", "path": "/metadata/labels/jp", "value": "1"}],
             content_type="application/json-patch+json"),
        Step("patch-json-invalid", "PATCH", f"/api/v1/nodes/{first}",
             [{"op": "remove", "path": "/metadata/labels/absent"}],
             content_type="application/json-patch+json"),
        Step("patch-dry-run", "PATCH", f"/api/v1/nodes/{first}?dryRun=All",
             {"metadata": {"labels": {"dry": "1"}}},
             content_type="application/merge-patch+json"),
        Step("patch-missing", "PATCH", "/api/v1/nodes/nobody", {"metadata": {}},
             content_type="application/merge-patch+json"),
        Step("put-stale", "PUT", f"/api/v1/nodes/{first}",
             lambda c: {**_node(first, {}), "metadata": {
                 "name": first, "resourceVersion": c["first_rv"]}}),
        Step("get-node-current", path=f"/api/v1/nodes/{first}",
             keep=(("node_doc", lambda a: a["body"]),)),
        Step("put-update", "PUT", f"/api/v1/nodes/{first}?fieldManager=diff",
             lambda c: {**c["node_doc"], "spec": {"unschedulable": True}}),
        Step("get-node-for-status", path=f"/api/v1/nodes/{first}",
             keep=(("node_doc2", lambda a: a["body"]),)),
        Step("put-status", "PUT", f"/api/v1/nodes/{first}/status",
             lambda c: {**c["node_doc2"], "status": {"conditions": [
                 {"type": "Ready", "status": "False", "reason": "Diff"}]}}),
        Step("apply-create", "PATCH", f"{NM}/namespaces/{NS}/nodemaintenances/nm-a"
             "?fieldManager=alpha", _maintenance("nm-a", first),
             content_type="application/apply-patch+yaml"),
        Step("apply-again", "PATCH", f"{NM}/namespaces/{NS}/nodemaintenances/nm-a"
             "?fieldManager=alpha", _maintenance("nm-a", first),
             content_type="application/apply-patch+yaml"),
        Step("apply-conflict", "PATCH", f"{NM}/namespaces/{NS}/nodemaintenances/nm-a"
             "?fieldManager=beta",
             {**_maintenance("nm-a", first), "spec": {"nodeName": "other",
                                                     "requestorID": "gpu-operator"}},
             content_type="application/apply-patch+yaml"),
        Step("apply-force", "PATCH", f"{NM}/namespaces/{NS}/nodemaintenances/nm-a"
             "?fieldManager=beta&force=true",
             {**_maintenance("nm-a", first), "spec": {"nodeName": "other",
                                                     "requestorID": "gpu-operator"}},
             content_type="application/apply-patch+yaml"),
        Step("apply-name-mismatch", "PATCH", f"{NM}/namespaces/{NS}/nodemaintenances/nm-z"
             "?fieldManager=alpha", _maintenance("nm-a", first),
             content_type="application/apply-patch+yaml"),
        Step("apply-subresource", "PATCH", f"{NM}/namespaces/{NS}/nodemaintenances/nm-a/status"
             "?fieldManager=alpha", _maintenance("nm-a", first),
             content_type="application/apply-patch+yaml"),
        Step("create-cr", "POST", f"{NM}/namespaces/{NS}/nodemaintenances",
             _maintenance("nm-b", nodes[1][0], ready="False")),
        Step("create-cr-invalid", "POST", f"{NM}/namespaces/{NS}/nodemaintenances",
             {**_maintenance("nm-c", first), "spec": {"nodeName": first}}),
        Step("patch-strategic-cr", "PATCH", f"{NM}/namespaces/{NS}/nodemaintenances/nm-b",
             {"spec": {"requestorID": "x"}},
             content_type="application/strategic-merge-patch+json"),
        Step("table-cr-list", path=f"{NM}/namespaces/{NS}/nodemaintenances", accept=TABLE),
        Step("table-cr-object", path=f"{NM}/nodemaintenances?includeObject=Object",
             accept=TABLE),
        Step("list-cr-unserved-version",
             path=f"/apis/maintenance.nvidia.com/v9/namespaces/{NS}/nodemaintenances"),
        Step("deletecollection-cr-all-namespaces", "DELETE", f"{NM}/nodemaintenances"),
        Step("telemetry-shed", "POST",
             "/apis/telemetry.tpu-operator.dev/v1alpha1/nodehealthreports",
             {"apiVersion": "telemetry.tpu-operator.dev/v1alpha1", "kind": "NodeHealthReport",
              "metadata": {"name": first}}),
        Step("replica-list", path="/api/v1/nodes?labelSelector=pool%3Db", replica=True),
        Step("replica-write", "POST", "/api/v1/nodes", _node("replica-node", {}),
             replica=True),
        Step("unserved-method", "OPTIONS", "/api/v1/nodes"),
    ]
    steps += [Step(f"create-pod-{i}", "POST", f"/api/v1/namespaces/{NS}/pods",
                   _pod(f"probe-{i}", nodes[i][0])) for i in range(4)]
    steps += [
        Step("evict", "POST", f"/api/v1/namespaces/{NS}/pods/probe-0/eviction",
             {"apiVersion": "policy/v1", "kind": "Eviction",
              "metadata": {"name": "probe-0", "namespace": NS}}),
        Step("evict-dry-run-body", "POST", f"/api/v1/namespaces/{NS}/pods/probe-1/eviction",
             {"apiVersion": "policy/v1", "kind": "Eviction",
              "metadata": {"name": "probe-1", "namespace": NS},
              "deleteOptions": {"dryRun": ["All"]}}),
        Step("evict-bad-dry-run", "POST", f"/api/v1/namespaces/{NS}/pods/probe-1/eviction",
             {"deleteOptions": {"dryRun": ["Maybe"]}}),
        Step("evict-missing", "POST", f"/api/v1/namespaces/{NS}/pods/nobody/eviction", {}),
        Step("list-pods", path=f"/api/v1/namespaces/{NS}/pods"),
        Step("delete-pod", "DELETE", f"/api/v1/namespaces/{NS}/pods/probe-2"),
        Step("delete-pod-dry-run", "DELETE", f"/api/v1/namespaces/{NS}/pods/probe-3?dryRun=All"),
        Step("delete-pod-precondition", "DELETE", f"/api/v1/namespaces/{NS}/pods/probe-3",
             {"preconditions": {"uid": "not-the-uid"}}),
        Step("delete-missing", "DELETE", "/api/v1/nodes/nobody"),
        Step("deletecollection-dry-run", "DELETE", "/api/v1/nodes?labelSelector=pool%3Db"
             "&dryRun=All"),
        Step("deletecollection-pods", "DELETE", f"/api/v1/namespaces/{NS}/pods"
             "?labelSelector=app%3Dprobe"),
        Step("delta-list", path=lambda c: f"/api/v1/nodes?sinceResourceVersion={c['rv0']}"),
        Step("delta-list-selector",
             path=lambda c: f"/api/v1/nodes?sinceResourceVersion={c['rv0']}"
                            "&labelSelector=pool%3Da"),
        Step("watch-replay-json", path=lambda c: "/api/v1/nodes?watch=true&timeoutSeconds=1"
             f"&resourceVersion={c['rv0']}", watch=True),
        Step("watch-replay-compact", path=lambda c: "/api/v1/nodes?watch=true&timeoutSeconds=1"
             f"&resourceVersion={c['rv0']}&labelSelector=pool%3Da", accept=COMPACT, watch=True),
        Step("watch-bookmarks", path=lambda c: "/api/v1/nodes?watch=true&timeoutSeconds=1"
             f"&allowWatchBookmarks=true&resourceVersion={c['rv0']}&labelSelector=rack%3D0",
             watch=True),
        Step("watch-bookmarks-compact", path="/api/v1/nodes?watch=true&timeoutSeconds=1"
             "&allowWatchBookmarks=true&labelSelector=pool%3Dc", accept=COMPACT, watch=True),
        Step("watch-live", path="/api/v1/nodes?watch=true&timeoutSeconds=1"
             "&labelSelector=pool%3Da", watch=True,
             during=lambda cluster: (
                 cluster.patch("Node", nodes[2][0],
                               patch={"metadata": {"labels": {"pool": "a", "live": "1"}}}),
                 cluster.patch("Node", nodes[2][0],
                               patch={"metadata": {"labels": {"pool": "b"}}}))),
        Step("watch-table", path=lambda c: "/api/v1/nodes?watch=true&timeoutSeconds=1"
             f"&resourceVersion={c['rv0']}&labelSelector=pool%3Da", accept=TABLE, watch=True),
        Step("watch-cr", path=f"{NM}/namespaces/{NS}/nodemaintenances?watch=true"
             "&timeoutSeconds=1&resourceVersion=0", watch=True),
        Step("delta-list-expired", path=lambda c: f"/api/v1/nodes?sinceResourceVersion={c['rv0']}",
             before=lambda cluster: cluster._history.clear()),
        Step("watch-expired", path=lambda c: "/api/v1/nodes?watch=true&timeoutSeconds=1"
             f"&resourceVersion={c['rv0']}", watch=True),
        Step("list-final", path="/api/v1/nodes"),
    ]
    return steps


STEPS = _script()


def _request(url: str, step: Step, context: dict) -> dict:
    host, port = url.split("//", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        path = step.path(context) if callable(step.path) else step.path
        body = step.body(context) if callable(step.body) else step.body
        headers = {}
        if step.token:
            headers["Authorization"] = f"Bearer {step.token}"
        if step.accept:
            headers["Accept"] = step.accept
        data = None
        if body is not None:
            headers["Content-Type"] = step.content_type
            data = (encode_compact(body) if step.content_type == COMPACT
                    else json.dumps(body).encode())
        conn.request(step.method, path, body=data, headers=headers)
        resp = conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type")
        answer = {"status": resp.status, "content_type": ctype,
                  "retry_after": resp.getheader("Retry-After"),
                  "chunked": resp.getheader("Transfer-Encoding")}
        if step.watch and resp.status == 200:
            frames = list(FrameDecoder(ctype).feed(raw))
            collapsed = []
            for frame in frames:
                if not (collapsed and frame["type"] == "BOOKMARK" and collapsed[-1] == frame):
                    collapsed.append(frame)
            answer["frames"] = collapsed
        else:
            answer["body"] = decode_body(raw, ctype) if raw else None
        return answer
    finally:
        conn.close()


def _run(side: str, monkeypatch) -> dict[str, Any]:
    """The whole script against one package's server; each step's answer
    by name."""
    fake, apiserver, table = ((jax_fake, jax_apiserver, jax_table) if side == "jax"
                              else (port_fake, port_apiserver, port_table))
    monkeypatch.setattr(fake, "_UID_RNG", random.Random(SEED))
    token_rng = random.Random(SEED + 1)
    monkeypatch.setattr(fake, "uuid", types.SimpleNamespace(
        UUID=uuid.UUID,
        uuid4=lambda: uuid.UUID(int=token_rng.getrandbits(128), version=4)))
    clock = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                     if not k.startswith("_")})
    clock.time = lambda: CLUSTER_NOW
    monkeypatch.setattr(fake, "time", clock)
    monkeypatch.setattr(table, "time", types.SimpleNamespace(time=lambda: TABLE_NOW))
    apf = apiserver.ApfConfig(retry_after_s=0.25, flows={
        "telemetry": apiserver.FlowConfig(queue_depth=0)})
    cluster = fake.FakeCluster()
    server = apiserver.LocalApiServer(cluster=cluster, token=TOKEN, bookmark_interval_s=0.2,
                                      apf=apf).start()
    replica = server.read_replica().start()
    answers: dict[str, Any] = {}
    context: dict[str, Any] = {}
    try:
        for step in STEPS:
            if step.before is not None:
                step.before(cluster)
            writer = None
            if step.during is not None:
                writer = threading.Timer(0.3, step.during, args=(cluster,))
                writer.start()
            answer = _request((replica if step.replica else server).url, step, context)
            if writer is not None:
                writer.join()
            for key, pick in step.keep:
                context[key] = pick(answer)
            answers[step.name] = answer
        answers["_stats"] = {"apf": server.apf_stats(), "watch_streams": server.watch_streams,
                             "requests": server.requests_served + replica.requests_served}
    finally:
        replica.stop()
        server.stop()
    return answers


@pytest.fixture(scope="module")
def answers():
    with pytest.MonkeyPatch.context() as mp:
        jax = _run("jax", mp)
    with pytest.MonkeyPatch.context() as mp:
        port = _run("port", mp)
    return {"jax": jax, "port": port}


@pytest.mark.parametrize("step", [s.name for s in STEPS])
def test_step_answers_alike(answers, step):
    assert norm(answers["port"][step]) == norm(answers["jax"][step])


def test_script_reaches_every_status_and_route(answers):
    port = answers["port"]
    statuses = {port[s.name]["status"] for s in STEPS}
    assert statuses == {200, 201, 400, 401, 404, 405, 409, 410, 415, 422, 429}
    assert port["telemetry-shed"]["retry_after"] == "0.25"
    assert port["list-page-1"]["body"]["metadata"]["remainingItemCount"] == 6
    assert port["list-expired-continue"]["status"] == 410
    assert port["watch-expired"]["status"] == 410
    assert port["delta-list"]["body"]["metadata"]["deltaSince"]
    assert port["get-node-compact"]["content_type"].startswith(
        "application/vnd.tpu-operator.compact")
    frames = port["watch-live"]["frames"]
    assert [f["type"] for f in frames] == ["MODIFIED", "DELETED"]
    assert any(f["type"] == "BOOKMARK" for f in port["watch-bookmarks"]["frames"])
    assert all(f["object"]["kind"] == "Table" for f in port["watch-table"]["frames"])
    table = port["table-cr-list"]["body"]
    assert [c["name"] for c in table["columnDefinitions"]] == [
        "Name", "Node", "Requestor", "Ready", "Phase"]
    assert [c["name"] for c in port["table-list"]["body"]["columnDefinitions"]] == [
        "Name", "Age"]
    assert port["table-list"]["body"]["rows"][0]["cells"][1] == "62m"
    methods = {s.method for s in STEPS}
    assert methods == {"GET", "POST", "PUT", "PATCH", "DELETE", "OPTIONS"}
    assert answers["port"]["_stats"] == answers["jax"]["_stats"]
