"""The port's ``upgrade_controller --demo`` under the other flag sets of
``tests/test_example_cli.py``, each run as a process with the gate on the
CPU (``--gate-device cpu``): the requestor combinations, leader election,
one fleet shard, the fleet rollout with its orchestrator, and probe pods
(``--validation-pod``, the pods' kubelet simulated). Each roll must
complete. The plain, ``--slice-aware`` and ``--requestor`` sets, held to
the JAX example's passes, are in ``tests/test_torch_demo.py``. The last
case rehearses ``chip_smoke.py``'s in-memory phase on the CPU.
"""

from __future__ import annotations

import pytest

from torch_demo import DEMO_NODES, finish, gate_verdicts, passes, port_demo


@pytest.mark.parametrize(
    "flags",
    [
        ("--requestor", "--slice-aware"),
        ("--requestor", "--post-maintenance"),
        ("--requestor", "--slice-aware", "--post-maintenance"),
    ],
    ids=["requestor+slice-aware", "requestor+post-maintenance",
         "requestor+slice-aware+post-maint"],
)
def test_demo_roll_completes(flags):
    rc, out, err = finish(port_demo(*flags))
    assert rc == 0, out[-2000:] + err[-1000:]
    assert "rolling upgrade complete" in out
    assert gate_verdicts(out) == {name: True for name in DEMO_NODES}


def test_demo_with_leader_election():
    rc, out, err = finish(port_demo("--leader-elect", "--leader-elect-id", "demo-replica"))
    assert rc == 0, out[-2000:] + err[-1000:]
    assert "campaigning as 'demo-replica'" in out
    assert "leading; starting reconciles" in out
    assert "rolling upgrade complete" in out


def test_demo_fleet_mode_single_shard():
    rc, out, err = finish(port_demo("--shards", "1", "--shard-index", "0"))
    assert rc == 0, out[-2000:] + err[-1000:]
    assert "rolling upgrade complete" in out
    # A tick may find the shard's Lease not yet held; the passes that ran
    # a reconcile ran it over the shard.
    reconciled = [line for line in passes(out) if "no shards owned" not in line]
    assert reconciled and all(line.endswith(" | shards=shard-00") for line in reconciled)


def test_demo_fleet_orchestrate():
    rc, out, err = finish(port_demo("--shards", "1", "--shard-index", "0",
                                    "--fleet-rollout", "demo-roll", "--orchestrate"))
    assert rc == 0, out[-2000:] + err[-1000:]
    assert "fleet orchestrator: campaigning" in out
    assert "rolling upgrade complete" in out


def test_demo_with_validation_pods():
    rc, out, err = finish(port_demo("--validation-pod"))
    assert rc == 0, out[-2000:] + err[-1000:]
    assert "rolling upgrade complete" in out
    # The simulated kubelet runs the probe pods; no gate runs in process.
    assert gate_verdicts(out) == {}


def test_chip_smoke_in_memory_phase_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``chip_smoke.py``'s in-memory phase whole on the CPU: the demo
    children with ``--gate-device cpu``, the crdutil demo children, and
    ``fake_roll`` with each probe pod's payload a stub; every pod is
    counted as launching the gate's kernels, the controller none, and the
    provider's read-back waited on the port's ``CachedClient``."""
    import json

    from k8s_operator_libs_tpu_torch.parallel import topology
    from test_torch_cuda import chip_smoke_module

    smoke = chip_smoke_module()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the demo children's CPU gate: one thread
    monkeypatch.setattr(topology, "local_gpu_labels", lambda: {
        "nvidia.com/gpu.present": "true", "nvidia.com/gpu.count": "1",
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
    })
    launches = {"matmul": 4657, "flash_attention": 4}
    caches = []

    def stub_pod(container, host_paths, workdir, label):
        caches.append(sorted(host_paths.values()))
        return {"seconds_to_ready": 0.0, "elapsed_s": 0.0, "launches": dict(launches)}

    monkeypatch.setattr(smoke, "run_probe_pod", stub_pod)
    demo_child = smoke.demo_child
    monkeypatch.setattr(smoke, "demo_child",
                        lambda label, *args: demo_child(label, *args, "--gate-device", "cpu"))
    result = smoke.in_memory_phase("cpu", launches, str(tmp_path))
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    printed = {key: line[key] for line in out for key in line if key != "card"}
    assert printed.pop("in_memory")["seconds"] > 0
    assert printed == result
    assert result["demo"]["plain"]["passes"] == 33
    assert result["demo"]["requestor"]["passes"] == 41
    assert [r["last_line"] for r in result["crdutil_demo"].values()] == [
        "apply: processed 2 CRD(s)", "delete: processed 2 CRD(s)"]
    fake = result["fake_roll"]
    assert fake["nodes"] == list(smoke.FAKE_ROLL_NODES)
    assert fake["cluster_nodes"] == smoke.WATCH_POOL_NODES + len(smoke.FAKE_ROLL_NODES)
    assert fake["launches"] == {k: len(smoke.FAKE_ROLL_NODES) * v for k, v in launches.items()}
    assert (fake["controller_launches"]["matmul"], fake["controller_launches"]["flash_attention"]) \
        == (0, 0)
    assert fake["read_back_waits"] > 0 and fake["read_back_timeouts"] == 0
    # Each pod ran on the kernel cache the roll phase keeps for its node.
    assert sorted(caches) == [[str(tmp_path / n)]
                              for n in smoke.ROLL_NODES[:len(smoke.FAKE_ROLL_NODES)]]
