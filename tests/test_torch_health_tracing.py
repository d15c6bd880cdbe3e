"""The health gate's spans in the port's tracer, on CPU ranks.

A battery is a ``gate.run`` span (category ``probe``); each probe the gate
calls is a ``gate.<probe>`` span below it, and the probes' host steps are
spans below those. With no tracer installed nothing is recorded and the
verdict is the same.
"""

import pytest
import torch

from k8s_operator_libs_tpu_torch.kube import FakeCluster
from k8s_operator_libs_tpu_torch.kube.objects import Node
from k8s_operator_libs_tpu_torch.tpu import health
from k8s_operator_libs_tpu_torch.upgrade import DeviceClass, UpgradeKeys, ValidationManager
from k8s_operator_libs_tpu_torch.upgrade.state_provider import NodeUpgradeStateProvider
from k8s_operator_libs_tpu_torch.utils import tracing

#: The probe spans below ``gate.run``, in the order the gate calls them.
GATE_PROBES = ["gate.collectives", "gate.mxu", "gate.burnin", "gate.flash"]
#: The host steps below each probe span, in their order.
PROBE_STEPS = {
    "gate.collectives": [],
    "gate.mxu": ["mxu.check"],
    "gate.burnin": [],
    "gate.flash": ["flash.inputs", "flash.oracle", "flash.check"],
}


@pytest.fixture(scope="module")
def gate():
    """One CPU rank's gate with every probe of one card on, its world
    formed by a first battery."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gate = health.IciHealthGate(
        devices=["cpu"], payload_mb=0.1, matmul_size=128, run_flash_attention=True
    )
    first = gate.run()
    assert first.ok, first.failures
    yield gate
    gate.close()
    torch.set_num_threads(threads)


@pytest.fixture
def traced(gate):
    """A tracer installed in this process, cleared after the test."""
    tracer = tracing.Tracer()
    tracing.install_tracer(tracer)
    try:
        yield tracer
    finally:
        tracing.clear_tracer()


def _children(records: list, parent: dict) -> list:
    return sorted((r for r in records if r["parent"] == parent["span"]),
                  key=lambda r: r["start"])


def test_a_traced_battery_emits_the_probe_tree(gate, traced):
    report = gate.run()
    records = traced.records()
    assert report.ok, report.failures
    assert {r["category"] for r in records} == {"probe"}
    (root,) = [r for r in records if r["name"] == "gate.run"]
    assert root["parent"] == ""
    assert root["attrs"] == {"ok": True, "world_size": 1}
    probes = _children(records, root)
    assert [r["name"] for r in probes] == GATE_PROBES
    for probe in probes:
        assert root["start"] <= probe["start"] <= probe["end"] <= root["end"]
        steps = _children(records, probe)
        assert [r["name"] for r in steps] == PROBE_STEPS[probe["name"]]
        for step in steps:
            assert probe["start"] <= step["start"] <= step["end"] <= probe["end"]
            assert _children(records, step) == []
    assert len(records) == 1 + len(GATE_PROBES) + sum(map(len, PROBE_STEPS.values()))


def test_an_untraced_battery_records_nothing_and_gives_the_same_verdict(
    gate, traced, monkeypatch
):
    traced_report = gate.run()
    tracing.clear_tracer()
    opened = []

    class Recorded(tracing._SpanScope):
        def __init__(self, *args):
            opened.append(args[1])
            super().__init__(*args)

    monkeypatch.setattr(tracing, "_SpanScope", Recorded)
    report = gate.run()
    assert tracing.tracer() is None and opened == []
    assert report.ok is traced_report.ok is True
    assert report.failures == traced_report.failures == []
    assert report.observation()[0] == traced_report.observation()[0]


def test_validation_hook_runs_the_battery_inside_validate_node(gate, traced):
    keys = UpgradeKeys(DeviceClass.nvidia("nvidia-driver"))
    cluster = FakeCluster()
    cluster.create(Node.new("gpu-0"))
    node = Node(cluster.get("Node", "gpu-0").raw)
    manager = ValidationManager(
        cluster, NodeUpgradeStateProvider(cluster, keys), keys,
        validation_hook=gate.validation_hook(),
    )
    assert manager.validate(node) is True
    records = traced.records()
    (validate,) = [r for r in records if r["name"] == "validate.node"]
    (root,) = [r for r in records if r["name"] == "gate.run"]
    assert validate["attrs"] == {"node": "gpu-0", "passed": True}
    assert root["parent"] == validate["span"] and root["trace"] == validate["trace"]
    assert root["attrs"]["ok"] is True
    assert [r["name"] for r in _children(records, root)] == GATE_PROBES
