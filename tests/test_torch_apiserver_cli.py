"""The port's API server as a deployment artifact: ``python -m
k8s_operator_libs_tpu_torch.kube.apiserver --port 0 --token T
--kubeconfig K`` serves a scratch cluster in a process of its own, and
the port's crdutil command and ``RestClient.from_environment()`` reach it
through the kubeconfig it writes: the CRDs applied, listed, then deleted.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from k8s_operator_libs_tpu_torch.kube.rest import RestClient

REPO = Path(__file__).resolve().parent.parent
CRDS = REPO / "manifests" / "crds"
TOKEN = "cli-token"


def _env(kubeconfig: Path) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["KUBECONFIG"] = str(kubeconfig)
    return env


@pytest.fixture
def served(tmp_path):
    """The server's process, once its kubeconfig is written; its URL."""
    kubeconfig = tmp_path / "kubeconfig"
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.kube.apiserver", "--port", "0",
         "--token", TOKEN, "--kubeconfig", str(kubeconfig)],
        cwd=str(tmp_path), env=_env(kubeconfig), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving in-memory cluster at "):
                break
        assert lines and lines[-1].startswith("serving in-memory cluster at "), "".join(lines)
        yield kubeconfig, lines[-1].split(" at ", 1)[1].strip()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()


def _crdutil(kubeconfig: Path, operation: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.crdutil", "--crds-path", str(CRDS),
         "--operation", operation],
        cwd=str(REPO), env=_env(kubeconfig), capture_output=True, text=True, timeout=120)


def _crd_names(monkeypatch, kubeconfig: Path) -> list[str]:
    monkeypatch.setenv("KUBECONFIG", str(kubeconfig))
    client = RestClient.from_environment(sa_dir=str(kubeconfig.parent / "no-service-account"))
    try:
        return sorted(o.name for o in client.list("CustomResourceDefinition"))
    finally:
        client.close()


def test_crdutil_applies_and_deletes_through_the_servers_kubeconfig(served, monkeypatch):
    kubeconfig, url = served
    doc = json.loads(kubeconfig.read_text())
    assert doc["clusters"][0]["cluster"]["server"] == url
    assert doc["users"][0]["user"]["token"] == TOKEN
    assert not url.endswith(":0")
    applied = _crdutil(kubeconfig, "apply")
    assert applied.returncode == 0, applied.stdout + applied.stderr
    assert "processed 2 CRD(s)" in applied.stdout + applied.stderr
    assert _crd_names(monkeypatch, kubeconfig) == [
        "nodemaintenances.maintenance.nvidia.com", "tpuupgradepolicies.tpu-operator.dev"]
    deleted = _crdutil(kubeconfig, "delete")
    assert deleted.returncode == 0, deleted.stdout + deleted.stderr
    assert _crd_names(monkeypatch, kubeconfig) == []


def test_the_server_refuses_a_client_without_its_token(served, tmp_path, monkeypatch):
    kubeconfig, url = served
    anonymous = tmp_path / "anonymous"
    doc = json.loads(kubeconfig.read_text())
    doc["users"][0]["user"] = {}
    anonymous.write_text(json.dumps(doc))
    refused = _crdutil(anonymous, "apply")
    assert refused.returncode != 0
    assert "bearer token" in refused.stdout + refused.stderr
    assert _crd_names(monkeypatch, kubeconfig) == []
