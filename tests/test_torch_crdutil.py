"""The port's CRD utility, held case by case against the JAX package's.

Every case of ``tests/test_crdutil.py`` runs twice on the same inputs: the
JAX ``crdutil`` over an in-memory ``FakeCluster``, and the port's over its
``RestClient`` against a ``LocalApiServer`` serving a twin ``FakeCluster``
(made with the same ``crd_establish_delay``, ``crd_discovery_delay`` and
``auto_establish_crds``). What the two return is compared exactly: the
count, or the error's type and message; then the CRDs each cluster stores
(name, labels, spec, Established, served versions) and the discovery
documents of each group/version the case touches. These are control-plane
objects: there is no tolerance. The file also holds
``TestCrdutilOverRest`` and the two discovery cases of
``tests/test_rest_client.py`` (the JAX ``RestClient`` and the port's on
servers alike), and the port's command line (``python -m
k8s_operator_libs_tpu_torch.crdutil``) beside the JAX example's: run with
``KUBECONFIG`` at a server, and ``--demo`` refused naming ROADMAP A19.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import pytest

from k8s_operator_libs_tpu import crdutil as jax_crdutil
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube.rest import RestClient as JaxRestClient
from k8s_operator_libs_tpu.kube.rest import RestConfig as JaxRestConfig
from k8s_operator_libs_tpu_torch import crdutil
from k8s_operator_libs_tpu_torch.crdutil import __main__ as port_cli
from k8s_operator_libs_tpu_torch.kube.objects import CustomResourceDefinition
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig

HERE = os.path.dirname(__file__)
FIXTURES = os.path.join(HERE, "crd_fixtures")
CRDS = os.path.join(FIXTURES, "crds")
UPDATED = os.path.join(FIXTURES, "updated")
NESTED = os.path.join(FIXTURES, "nested")
REPO_CRDS = os.path.join(HERE, "..", "manifests", "crds")
CRD = "CustomResourceDefinition"

#: The group/versions the fixtures serve, and the core group.
GROUP_VERSIONS = (("", "v1"), ("example.dev", "v1"), ("example.dev", "v1alpha1"),
                  ("example.dev", "v2"))


def outcome(fn):
    """What ``fn()`` returned, or the error's type name and message."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared, not handled
        return ("raised", type(e).__name__, str(e))


class Twins:
    """A JAX cluster and a port client on a served twin."""

    def __init__(self, stack: contextlib.ExitStack, **cluster_kwargs) -> None:
        self.jax = FakeCluster(**cluster_kwargs)
        self.twin = FakeCluster(**cluster_kwargs)
        server = stack.enter_context(LocalApiServer(cluster=self.twin))
        self.url = server.url
        self.port = RestClient(RestConfig(server=server.url))

    def both(self, jax_fn, port_fn):
        """Run the JAX side on its cluster and the port's on its client;
        their outcomes must be equal, and so must the clusters after."""
        theirs = outcome(lambda: jax_fn(self.jax))
        ours = outcome(lambda: port_fn(self.port))
        assert ours == theirs
        self.same()
        return theirs

    def process(self, paths, operation, **kw):
        return self.both(
            lambda c: jax_crdutil.process_crds(c, paths, operation, **kw),
            lambda c: crdutil.process_crds(c, paths, operation, **kw),
        )

    @staticmethod
    def stored(cluster: FakeCluster) -> list:
        out = []
        for obj in cluster.list(CRD):
            crd = CustomResourceDefinition(obj.raw)
            out.append((crd.name, dict(crd.raw["metadata"].get("labels") or {}),
                        crd.raw.get("spec"), crd.is_established(), crd.served_versions))
        return sorted(out, key=lambda row: row[0])

    def discovery(self) -> dict:
        """Each group/version's discovery on both sides: the resources,
        or NotFound."""
        docs = {}
        for group, version in GROUP_VERSIONS:
            theirs = outcome(lambda: self.jax.discover(group, version))
            ours = outcome(lambda: self.port.discover(group, version))
            docs[(group, version)] = (theirs, ours)
        return docs

    def same(self) -> None:
        assert self.stored(self.twin) == self.stored(self.jax)
        for gv, (theirs, ours) in self.discovery().items():
            if theirs[0] == "raised":
                assert ours[0] == "raised" and ours[1] == "NotFoundError", (gv, ours)
                assert theirs[1] == "NotFoundError", (gv, theirs)
            else:
                assert ours == theirs, gv


@pytest.fixture
def twins():
    with contextlib.ExitStack() as stack:
        yield lambda **kw: Twins(stack, **kw)


@pytest.fixture
def timeout(monkeypatch):
    def set_timeout(seconds: float) -> None:
        monkeypatch.setattr(jax_crdutil.crdutil, "ESTABLISH_TIMEOUT_SECONDS", seconds)
        monkeypatch.setattr(crdutil.crdutil, "ESTABLISH_TIMEOUT_SECONDS", seconds)

    return set_timeout


# ----------------------------------------------------------------------
# TestWalkAndParse
# ----------------------------------------------------------------------

def parsed(module, path):
    return [(c.name, c.raw) for c in module.parse_crds_from_file(path)]


def test_walk_recursive_and_filtered():
    assert crdutil.walk_crd_paths([NESTED]) == jax_crdutil.walk_crd_paths([NESTED])
    assert [os.path.basename(f) for f in crdutil.walk_crd_paths([NESTED])] == ["deep.yml"]


def test_walk_missing_path_errors():
    ghost = [os.path.join(FIXTURES, "ghost")]
    theirs = outcome(lambda: jax_crdutil.walk_crd_paths(ghost))
    assert outcome(lambda: crdutil.walk_crd_paths(ghost)) == theirs
    assert theirs[1] == "CRDProcessingError"


def test_walk_single_file():
    f = os.path.join(CRDS, "widgets.yaml")
    assert crdutil.walk_crd_paths([f]) == jax_crdutil.walk_crd_paths([f]) == [f]


def test_parse_multi_doc_skips_non_crds():
    f = os.path.join(CRDS, "widgets.yaml")
    assert parsed(crdutil, f) == parsed(jax_crdutil, f)
    assert [name for name, _ in parsed(crdutil, f)] == [
        "widgets.example.dev", "gadgets.example.dev",
    ]


def test_parse_bad_yaml(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("kind: CustomResourceDefinition\n  broken: [indent")
    theirs = outcome(lambda: jax_crdutil.parse_crds_from_file(str(bad)))
    assert outcome(lambda: crdutil.parse_crds_from_file(str(bad))) == theirs
    assert theirs[1] == "CRDProcessingError"


def test_parse_the_repo_manifests():
    """The repo's own CRDs, which the card's phase applies."""
    theirs = jax_crdutil.parse_crds_from_paths([REPO_CRDS])
    ours = crdutil.parse_crds_from_paths([REPO_CRDS])
    assert [(c.name, c.group, c.plural, c.served_versions) for c in ours] == [
        (c.name, c.group, c.plural, c.served_versions) for c in theirs
    ]
    assert sorted(c.name for c in ours) == [
        "nodemaintenances.maintenance.nvidia.com", "tpuupgradepolicies.tpu-operator.dev",
    ]


# ----------------------------------------------------------------------
# TestApply
# ----------------------------------------------------------------------

def test_apply_creates_and_establishes(twins):
    t = twins()
    assert t.process([CRDS], crdutil.CRDOperation.APPLY) == ("ok", 2)
    assert CustomResourceDefinition(
        t.port.get(CRD, "widgets.example.dev").raw
    ).is_established()


def test_apply_is_idempotent(twins):
    t = twins()
    t.process([CRDS], "apply")
    rv = t.port.get(CRD, "widgets.example.dev").resource_version
    assert t.process([CRDS], "apply") == ("ok", 2)
    assert len(t.port.list(CRD)) == 2
    # The second apply took the update path.
    assert t.port.get(CRD, "widgets.example.dev").resource_version != rv


def test_apply_updates_existing(twins):
    t = twins()
    t.process([CRDS], "apply")
    t.process([UPDATED], "apply")
    crd = t.port.get(CRD, "widgets.example.dev")
    assert crd.labels.get("rev") == "2"
    assert crd.raw["spec"]["versions"][1]["name"] == "v2"


def test_apply_multiple_paths(twins):
    assert twins().process([CRDS, NESTED], "apply") == ("ok", 3)


def test_wait_for_established_with_delay(twins):
    t = twins(crd_establish_delay=0.2)
    assert t.process([NESTED], "apply") == ("ok", 1)
    assert CustomResourceDefinition(t.port.get(CRD, "deeps.example.dev").raw).is_established()


def test_wait_times_out_when_never_established(twins, timeout):
    timeout(0.3)
    result = twins(auto_establish_crds=False).process([NESTED], "apply")
    assert result[:2] == ("raised", "CRDProcessingError")
    assert "timed out" in result[2]


def test_update_waits_for_new_served_version(twins):
    t = twins()
    t.process([CRDS], "apply")
    path = os.path.join(UPDATED, "widgets.yaml")
    t.process([UPDATED], "apply")
    t.both(
        lambda c: jax_crdutil.wait_for_crds(
            c, jax_crdutil.parse_crds_from_file(path), timeout_seconds=1),
        lambda c: crdutil.wait_for_crds(c, crdutil.parse_crds_from_file(path), timeout_seconds=1),
    )


# ----------------------------------------------------------------------
# TestDiscoveryWait
# ----------------------------------------------------------------------

def test_established_but_undiscoverable_blocks_the_wait(twins):
    t = twins(crd_discovery_delay=0.4)
    start = time.monotonic()
    outcome(lambda: crdutil.process_crds(t.port, [NESTED], "apply"))
    elapsed = time.monotonic() - start
    jax_crdutil.process_crds(t.jax, [NESTED], "apply")
    t.same()
    assert CustomResourceDefinition(t.port.get(CRD, "deeps.example.dev").raw).is_established()
    # A wait on the status would have returned at once.
    assert elapsed >= 0.4, elapsed


def test_wait_times_out_when_never_discoverable(twins, timeout):
    timeout(0.3)
    t = twins(crd_discovery_delay=60.0)
    result = t.process([NESTED], "apply")
    assert result[:2] == ("raised", "CRDProcessingError")
    assert "discoverable" in result[2]
    assert CustomResourceDefinition(t.port.get(CRD, "deeps.example.dev").raw).is_established()


def test_discover_lists_builtin_and_crd_resources(twins):
    t = twins()
    t.process([CRDS], "apply")
    assert any(r["name"] == "pods" for r in t.port.discover("", "v1"))
    assert any(r["name"] == "widgets" for r in t.port.discover("example.dev", "v1"))


def test_discover_unknown_group_is_not_found(twins):
    t = twins()
    theirs = outcome(lambda: t.jax.discover("ghosts.example.dev", "v1"))
    ours = outcome(lambda: t.port.discover("ghosts.example.dev", "v1"))
    assert theirs[1] == ours[1] == "NotFoundError"


def test_manual_establishment_reaches_discovery(twins):
    """The case plays the CRD controller itself: it writes the Established
    condition, and the wait must then pass on both sides."""
    t = twins(auto_establish_crds=False)
    path = os.path.join(NESTED, "subdir", "deep.yml")
    (theirs,) = jax_crdutil.parse_crds_from_file(path)
    (ours,) = crdutil.parse_crds_from_file(path)
    t.jax.create(theirs.deep_copy())
    t.port.create(ours.deep_copy())
    t.same()
    assert outcome(lambda: t.port.discover("example.dev", "v1"))[0] == "raised"
    status = {"status": {"conditions": [{"type": "Established", "status": "True"}]}}
    t.jax.patch(CRD, theirs.name, "", patch=status)
    assert t.port.patch(CRD, ours.name, patch=status) is not None
    t.both(
        lambda c: jax_crdutil.wait_for_crds(
            c, jax_crdutil.parse_crds_from_file(path), timeout_seconds=1),
        lambda c: crdutil.wait_for_crds(c, crdutil.parse_crds_from_file(path), timeout_seconds=1),
    )


def test_spec_patch_adding_version_becomes_discoverable(twins):
    t = twins()
    t.process([NESTED], "apply")
    versions = list(t.port.get(CRD, "deeps.example.dev").raw["spec"]["versions"])
    versions.append({"name": "v2", "served": True, "storage": False,
                     "schema": {"openAPIV3Schema": {"type": "object"}}})
    t.jax.patch(CRD, "deeps.example.dev", "", patch={"spec": {"versions": versions}})
    t.port.patch(CRD, "deeps.example.dev", patch={"spec": {"versions": versions}})
    t.same()
    assert any(r["name"] == "deeps" for r in t.port.discover("example.dev", "v2"))


def test_deleted_crd_leaves_discovery(twins):
    t = twins()
    t.process([CRDS], "apply")
    t.process([CRDS], "delete")
    assert outcome(lambda: t.port.discover("example.dev", "v1"))[1] == "NotFoundError"


# ----------------------------------------------------------------------
# TestDelete
# ----------------------------------------------------------------------

def test_delete(twins):
    t = twins()
    t.process([CRDS], "apply")
    assert t.process([CRDS], crdutil.CRDOperation.DELETE) == ("ok", 2)
    assert t.port.list(CRD) == []


def test_delete_tolerates_absent(twins):
    assert twins().process([CRDS], "delete") == ("ok", 2)


def test_invalid_operation(twins):
    result = twins().process([CRDS], "explode")
    assert result[:2] == ("raised", "ValueError")


# ----------------------------------------------------------------------
# TestCrdutilOverRest, and tests/test_rest_client.py's discovery cases
# ----------------------------------------------------------------------

def test_apply_update_delete_over_the_wire(twins, tmp_path):
    crd = tmp_path / "crd.yaml"
    crd.write_text(
        """apiVersion: apiextensions.k8s.io/v1
kind: CustomResourceDefinition
metadata:
  name: widgets.example.dev
spec:
  group: example.dev
  names: {plural: widgets, kind: Widget}
  scope: Namespaced
  versions:
  - name: v1
    served: true
    storage: true
"""
    )
    t = twins()
    assert t.process([str(tmp_path)], "apply") == ("ok", 1)
    assert t.port.get(CRD, "widgets.example.dev") is not None
    # Applied again: the update path, under retry_on_conflict.
    assert t.process([str(tmp_path)], "apply") == ("ok", 1)
    assert t.process([str(tmp_path)], "delete") == ("ok", 1)
    assert t.port.get_or_none(CRD, "widgets.example.dev") is None


@pytest.fixture
def servers():
    """Two servers alike: one for the JAX client, one for the port's."""
    with LocalApiServer() as theirs, LocalApiServer() as ours:
        yield (JaxRestClient(JaxRestConfig(server=theirs.url)),
               RestClient(RestConfig(server=ours.url)))


def test_core_group_discovery_over_the_wire(servers):
    theirs, ours = servers
    assert ours.discover("", "v1") == theirs.discover("", "v1")
    assert any(r["name"] == "nodes" for r in ours.discover("", "v1"))


def test_crd_becomes_discoverable_over_the_wire(servers):
    theirs, ours = servers
    assert crdutil.process_crds(ours, [CRDS], "apply") == jax_crdutil.process_crds(
        theirs, [CRDS], "apply"
    )
    for group, version in GROUP_VERSIONS:
        their_doc = outcome(lambda: theirs.discover(group, version))
        assert outcome(lambda: ours.discover(group, version))[:2] == their_doc[:2]
    v1 = ours.discover("example.dev", "v1")
    assert any(r["name"] == "widgets" for r in v1)
    assert not any(r["name"] == "gadgets" for r in v1)
    assert any(r["name"] == "gadgets" for r in ours.discover("example.dev", "v1alpha1"))


# ----------------------------------------------------------------------
# TestExampleCli: the port's command line beside the JAX example
# ----------------------------------------------------------------------

def jax_example():
    sys.path.insert(0, os.path.join(HERE, "..", "examples"))
    import apply_crds

    return apply_crds


@pytest.fixture
def kubeconfig(tmp_path, monkeypatch):
    """``KUBECONFIG`` at a served cluster; the cluster."""
    cluster = FakeCluster(crd_establish_delay=0.05)
    with LocalApiServer(cluster=cluster) as server:
        path = tmp_path / "kubeconfig"
        path.write_text(json.dumps({
            "current-context": "c",
            "clusters": [{"name": "c", "cluster": {"server": server.url}}],
            "users": [{"name": "u", "user": {}}],
            "contexts": [{"name": "c", "context": {"cluster": "c", "user": "u"}}],
        }))
        monkeypatch.setenv("KUBECONFIG", str(path))
        monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
        yield cluster


def test_demo_apply(kubeconfig, capsys):
    """The JAX example's ``--demo`` and the port's command line at a
    server print the same line, and the port's CRDs are stored."""
    assert jax_example().main(["--crds-path", CRDS, "--operation", "apply", "--demo"]) == 0
    theirs = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_cli.main(["--crds-path", CRDS, "--operation", "apply"]) == 0
    ours = capsys.readouterr().out.strip().splitlines()[-1]
    assert ours == theirs == "apply: processed 2 CRD(s)"
    assert sorted(o.name for o in kubeconfig.list(CRD)) == [
        "gadgets.example.dev", "widgets.example.dev",
    ]
    assert port_cli.main(["--crds-path", CRDS, "--operation", "delete"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "delete: processed 2 CRD(s)"
    assert kubeconfig.list(CRD) == []


def test_demo_missing_path_clean_error(kubeconfig, capsys):
    assert jax_example().main(["--crds-path", "/nope", "--demo"]) == 1
    theirs = capsys.readouterr().err.strip().splitlines()[-1]
    assert port_cli.main(["--crds-path", "/nope"]) == 1
    ours = capsys.readouterr().err.strip().splitlines()[-1]
    assert ours == theirs
    assert "does not exist" in ours


@pytest.mark.parametrize("operation", ["apply", "delete"])
def test_port_demo_prints_what_the_jax_demo_prints(operation, capsys):
    """``--demo`` on both commands: each over its own package's in-memory
    cluster (a fresh one a process, so a delete finds nothing to delete
    and still counts the documents it processed)."""
    args = ["--crds-path", CRDS, "--operation", operation, "--demo"]
    assert jax_example().main(args) == 0
    theirs = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_cli.main(args) == 0
    ours = capsys.readouterr().out.strip().splitlines()[-1]
    assert ours == theirs == f"{operation}: processed 2 CRD(s)"


def test_port_demo_waits_for_its_cluster_to_establish_the_crds(monkeypatch):
    """The demo's cluster is the port's ``FakeCluster`` with the JAX
    example's establishment delay; the wait sees both CRDs established
    and discoverable, and the command closes the cluster."""
    from k8s_operator_libs_tpu_torch.kube.fake import FakeCluster

    made = []

    def build(args):
        made.append(FakeCluster(crd_establish_delay=0.05))
        return made[-1]

    monkeypatch.setattr(port_cli, "build_client", build)
    assert port_cli.main(["--crds-path", CRDS, "--demo"]) == 0
    (cluster,) = made
    crds = cluster.list(CRD)
    assert sorted(o.name for o in crds) == ["gadgets.example.dev", "widgets.example.dev"]
    assert all(o.is_established() for o in crds)
    assert cluster._pending_timers == []  # closed: close() cancels and clears them


def test_port_demo_client_is_the_ports_in_memory_cluster():
    from k8s_operator_libs_tpu_torch.kube.fake import FakeCluster

    client = port_cli.build_client(port_cli.argparse.Namespace(demo=True))
    try:
        assert type(client) is FakeCluster and client._crd_establish_delay == 0.05
    finally:
        client.close()


def test_port_demo_missing_path_clean_error(capsys):
    assert jax_example().main(["--crds-path", "/nope", "--demo"]) == 1
    theirs = capsys.readouterr().err.strip().splitlines()[-1]
    assert port_cli.main(["--crds-path", "/nope", "--demo"]) == 1
    ours = capsys.readouterr().err.strip().splitlines()[-1]
    assert ours == theirs
    assert "does not exist" in ours
