"""The port's health gate against the JAX package's, on the CPU.

The report shape, the telemetry keys and the CLI flags are the contract
the control plane reads, so each is held against the JAX package's. The
tests import the JAX control plane; the port itself must not, which the
guard at the end checks.
"""

import ast
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from builders import make_node
from k8s_operator_libs_tpu.api import DriverUpgradePolicySpec
from k8s_operator_libs_tpu.kube import FakeCluster
from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator
from k8s_operator_libs_tpu.ops.collectives import (
    CollectiveReport as JaxCollectiveReport,
)
from k8s_operator_libs_tpu.ops.collectives import LinkProbeReport as JaxLinkProbeReport
from k8s_operator_libs_tpu.ops.matmul import MxuReport as JaxMxuReport
from k8s_operator_libs_tpu.ops.probe_harness import ProbeReport as JaxProbeReport
from k8s_operator_libs_tpu.tpu import health as jax_health
from k8s_operator_libs_tpu.upgrade import (
    ClusterUpgradeStateManager,
    DeviceClass,
    TaskRunner,
    UpgradeKeys,
)
from k8s_operator_libs_tpu_torch.tpu import health as port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from a thread per core, and the suite runs
    several workers side by side with timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]
PORT_DIR = REPO / "k8s_operator_libs_tpu_torch"

#: Small CPU gate: every tier of the one-device battery, quick.
SMALL_GATE = dict(device="cpu", matmul_size=128)
#: The collective battery's ops, in the JAX gate's order.
BATTERY_OPS = ["psum", "all_gather", "reduce_scatter", "ppermute_ring"]
#: Knobs both gates run on the CPU (no Pallas kernel, which has no CPU
#: lowering outside interpret mode).
PARITY_KNOBS = dict(payload_mb=0.1, matmul_size=128, run_seq_parallel_probes=True)


@pytest.fixture(scope="module")
def port_report():
    gate = port.IciHealthGate.tpu_defaults(**SMALL_GATE)
    report = gate.run()
    gate.close()
    assert report.ok, report.failures
    return report


@pytest.fixture(scope="module")
def gate_reports():
    """n -> (the port's report on n CPU ranks, the JAX gate's on n CPU
    devices), at ``PARITY_KNOBS``; each made once."""
    made = {}

    def get(n):
        if n not in made:
            gate = port.IciHealthGate(devices=["cpu"] * n, **PARITY_KNOBS)
            ours = gate.run()
            gate.close()
            theirs = jax_health.IciHealthGate(
                devices=jax.devices("cpu")[:n], **PARITY_KNOBS
            ).run()
            made[n] = (ours, theirs)
        return made[n]

    return get


def test_gate_runs_ok_on_cpu(port_report):
    assert port_report.mxu.ok and port_report.mxu.tflops > 0
    assert port_report.burnin_ok is True
    assert port_report.flash.ok and port_report.flash.tokens_per_s > 0
    assert [c.op for c in port_report.collectives] == BATTERY_OPS
    assert port_report.links == []
    assert port_report.process_count == 1 and port_report.failures == []


def test_one_device_gate_runs_the_collective_battery_as_jax_does(gate_reports):
    ours, theirs = gate_reports(1)
    assert [(c.op, c.ok, c.error) for c in ours.collectives] == [
        (c.op, c.ok, c.error) for c in theirs.collectives
    ]
    assert [c.op for c in ours.collectives] == BATTERY_OPS
    assert all(c.ok for c in ours.collectives)
    assert ours.collectives[-1].error == "single device"


def test_tpu_defaults_turn_kernels_on_and_leave_floors_at_zero():
    gate = port.IciHealthGate.tpu_defaults()
    assert gate.use_pallas_matmul and gate.run_flash_attention
    assert gate.min_mxu_tflops == 0.0 and gate.min_ring_gbytes_per_s == 0.0
    assert port.IciHealthGate.tpu_defaults(min_mxu_tflops=5.0).min_mxu_tflops == 5.0


def test_port_report_parses_into_jax_report(port_report):
    line = json.dumps(dataclasses.asdict(port_report))
    theirs = jax_health.HealthReport.from_dict(json.loads(line))
    assert dataclasses.asdict(theirs) == json.loads(line)
    assert theirs.ok and isinstance(theirs.mxu, JaxMxuReport)
    assert isinstance(theirs.flash, JaxProbeReport)
    assert theirs.observation() == port_report.observation()
    assert theirs.summary() == port_report.summary()


def test_jax_report_parses_into_port_report():
    theirs = jax_health.HealthReport(
        ok=False,
        collectives=[
            JaxCollectiveReport(op="psum_ring_allreduce", ok=True, gbytes_per_s=12.5),
            JaxCollectiveReport(op="ppermute_ring", ok=False, error="timeout"),
        ],
        mxu=JaxMxuReport(ok=True, tflops=3.5, max_abs_err=0.01),
        burnin_ok=True,
        ring_attention=JaxProbeReport(ok=True, tokens_per_s=10.0),
        ulysses=JaxProbeReport(ok=True, tokens_per_s=20.0),
        flash=JaxProbeReport(ok=False, error="numerics"),
        elapsed_s=1.5,
        failures=["ppermute_ring: timeout"],
        links=[JaxLinkProbeReport(src=0, dst=1, peer="node-b", ok=True,
                                  latency_s=0.002, gbytes_per_s=4.0)],
        process_count=2,
        slice_devices_passed=3,
        slice_devices_total=4,
    )
    payload = json.loads(json.dumps(dataclasses.asdict(theirs)))
    payload["field_from_a_newer_payload"] = 1
    ours = port.HealthReport.from_dict(payload)
    del payload["field_from_a_newer_payload"]
    assert dataclasses.asdict(ours) == payload
    assert ours.observation() == theirs.observation()
    assert ours.ring_bandwidth() == theirs.ring_bandwidth() == 12.5
    assert ours.summary() == theirs.summary()


@pytest.mark.parametrize("n", [1, 2])
def test_observation_keys_match_jax_for_the_tiers_both_ran(gate_reports, n):
    ours, theirs = gate_reports(n)
    assert ours.ok and theirs.ok, (ours.failures, theirs.failures)
    our_checks, our_metrics = ours.observation()
    their_checks, their_metrics = theirs.observation()
    assert our_checks == their_checks
    assert set(our_metrics) == set(their_metrics)


KNOBS = [
    {},
    dict(use_pallas_matmul=True, run_flash_attention=True, run_seq_parallel_probes=True),
    dict(
        min_ring_gbytes_per_s=2.0, min_mxu_tflops=3.0, payload_mb=0.5,
        matmul_size=512, run_burnin=False, run_link_probes=False,
        link_peer_names=["node-a", "node-b"],
    ),
]


@pytest.mark.parametrize("knobs", KNOBS)
def test_to_cli_args_equals_jax(knobs):
    assert port.IciHealthGate(**knobs).to_cli_args() == (
        jax_health.IciHealthGate(**knobs).to_cli_args()
    )


@pytest.mark.parametrize("knobs", KNOBS)
def test_parser_accepts_jax_gate_arguments(knobs):
    args = port.build_parser().parse_args(jax_health.IciHealthGate(**knobs).to_cli_args())
    assert args.matmul_size == knobs.get("matmul_size", 1024)
    assert args.device == "cuda"


def test_main_prints_a_report_and_writes_the_ready_file(tmp_path, capsys):
    ready = tmp_path / "ready"
    rc = port.main([
        "--device", "cpu", "--matmul-size", "128", "--no-flash-attention",
        "--ready-file", str(ready),
    ])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    ours = port.HealthReport.from_dict(json.loads(line))
    theirs = jax_health.HealthReport.from_dict(json.loads(line))
    assert ours.ok and theirs.ok and ours.flash is None
    assert ready.read_text().startswith("ok=True")


def test_main_on_cpu_leaves_the_kernels_off_unless_asked(capsys):
    assert port.main(["--device", "cpu", "--matmul-size", "64", "--no-burnin"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["flash"] is None and report["mxu"]["ok"]


def test_main_failure_exits_nonzero_without_ready_file(tmp_path, capsys):
    ready = tmp_path / "ready"
    rc = port.main([
        "--device", "cpu", "--matmul-size", "64", "--no-burnin",
        "--min-mxu-tflops", "1e9", "--ready-file", str(ready),
    ])
    assert rc == 1 and not ready.exists()
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not report["ok"] and "below floor" in report["failures"][0]


def test_main_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["--matmul-size", "64"])


def test_gate_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.IciHealthGate(matmul_size=64).run()


def test_more_than_one_device_names_the_roadmap_item(gate_reports):
    """More than one device: an ok report with the JAX gate's collectives,
    links and sequence-parallel fields."""
    ours, theirs = gate_reports(2)
    assert ours.ok, ours.failures
    assert [(c.op, c.ok, c.error) for c in ours.collectives] == [
        (c.op, c.ok, c.error) for c in theirs.collectives
    ]
    assert [(h.src, h.dst, h.peer, h.ok) for h in ours.links] == [
        (h.src, h.dst, h.peer, h.ok) for h in theirs.links
    ] == [(0, 1, "device-1", True), (1, 0, "device-0", True)]
    for probe in ("ring_attention", "ulysses"):
        mine, ref = getattr(ours, probe), getattr(theirs, probe)
        assert mine.ok and ref.ok and mine.tokens_per_s > 0
    assert ours.burnin_ok is theirs.burnin_ok is True


def test_burnin_crash_is_a_failed_report(monkeypatch):
    from k8s_operator_libs_tpu_torch.models import burnin

    # A config its ranks cannot build: the burn-in raises in every rank.
    monkeypatch.setattr(
        burnin, "BurninConfig", functools.partial(burnin.BurninConfig, n_experts=2)
    )
    gate = port.IciHealthGate(device="cpu", matmul_size=64)
    report = gate.run()
    assert not report.ok and report.burnin_ok is False
    assert "burn-in train step failed" in report.failures
    assert all(c.ok for c in report.collectives)
    # The world a rank failed in is dropped; the next run forms a new one.
    monkeypatch.undo()
    report = gate.run()
    gate.close()
    assert report.ok and report.burnin_ok is True, report.failures


NS = "gpu-driver"
LABELS = {"app": "nvidia-driver"}


def _roll(hook, max_passes=30):
    keys = UpgradeKeys(DeviceClass.nvidia("nvidia-driver"))
    cluster = FakeCluster()
    for i in range(2):
        cluster.create(make_node(f"gpu-{i}"))
    sim = DaemonSetSimulator(cluster, name="nvidia-driver", namespace=NS, match_labels=LABELS)
    sim.settle()
    mgr = ClusterUpgradeStateManager(
        cluster, DeviceClass.nvidia("nvidia-driver"), runner=TaskRunner(inline=True)
    )
    mgr.with_validation_enabled(validation_hook=hook)
    sim.set_template_hash("v2")
    policy = DriverUpgradePolicySpec(auto_upgrade=True)
    for _ in range(max_passes):
        sim.step()
        mgr.apply_state(mgr.build_state(NS, LABELS), policy)
        sim.step()
    return {n.name: n.labels.get(keys.state_label, "") for n in cluster.list("Node")}


def test_validation_hook_gates_a_fake_cluster_roll():
    gate = port.IciHealthGate(device="cpu", matmul_size=64, run_flash_attention=False)
    seen = []
    inner = gate.validation_hook()

    def hook(node):
        seen.append(node.name)
        return inner(node)

    states = _roll(hook)
    assert states == {"gpu-0": "upgrade-done", "gpu-1": "upgrade-done"}
    assert set(seen) == {"gpu-0", "gpu-1"}


def test_failing_gate_keeps_nodes_out_of_service():
    gate = port.IciHealthGate(
        device="cpu", matmul_size=64, run_burnin=False, min_mxu_tflops=1e9
    )
    states = _roll(gate.validation_hook(), max_passes=8)
    assert "upgrade-done" not in states.values()
    assert "validation-required" in states.values()


def test_cache_warmup_hook_runs_the_gate_and_always_reports_done():
    gate = port.IciHealthGate(
        device="cpu", matmul_size=64, run_burnin=False, min_mxu_tflops=1e9
    )
    hook = port.cache_warmup_hook(gate)
    try:
        assert hook(make_node("gpu-0")) is True
        # The warm-up formed the gate's world; the gate's own run reuses it.
        world = gate._world
        assert world is not None and world.error is None
        assert not gate.run().ok and gate._world is world
    finally:
        gate.close()


def test_subprocess_gate_runs_the_port_payload():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    gate = port.SubprocessHealthGate(
        cli_args=["--device", "cpu", "--matmul-size", "64", "--no-burnin",
                  "--no-flash-attention"],
        timeout_seconds=120, env=env, cwd=str(REPO),
    )
    report = gate.run()
    assert report.ok, report.failures
    assert report.mxu is not None and report.mxu.ok


# ----------------------------------------------------------------------
# Guard: the port imports neither jax nor the JAX package.
# ----------------------------------------------------------------------

def _imported_modules(path: Path) -> list[tuple[str, int]]:
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(alias.name, 0) for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            found.append((node.module or "", node.level))
    return found


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax") or top == "k8s_operator_libs_tpu"


@pytest.mark.parametrize(
    "path",
    sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [name for name, level in _imported_modules(path) if level == 0 and _forbidden(name)]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['k8s_operator_libs_tpu'] = None\n"
        "import k8s_operator_libs_tpu_torch.tpu.health as h\n"
        "import k8s_operator_libs_tpu_torch.models.burnin\n"
        "r = h.IciHealthGate(device='cpu', matmul_size=32, run_burnin=False).run()\n"
        "assert r.ok, r.failures\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
