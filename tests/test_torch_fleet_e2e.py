"""The fleet's daemon lifecycle end to end, the port against the JAX
package: ``tests/test_daemon_e2e.py``'s ``TestShutdownUnderLoad`` and
``TestOrchestrateMultiProcess``, each run once a package over a
``LocalApiServer`` of its own, seeded the same; the two packages'
observations must be equal.

* **Shutdown under load**: SIGTERM one shard worker and the elected
  orchestrator mid 64-pool roll. The supervised drain joins every thread
  it owns within its deadline, releases every held Lease at once (a
  successor orchestrator takes over within a retry period), the roll
  converges under the survivors with no global-budget violation, and once
  everything stopped the wire stays quiet.
* **N worker processes and one orchestrator**: two processes of the
  command with ``--shards 2`` and ``--orchestrate`` on the first roll a
  fleet of four pools grant wave by grant wave; SIGTERM ends both with
  code 0 and every Lease empty. The port's processes run
  ``python -m k8s_operator_libs_tpu_torch.upgrade_controller`` where
  neither ``jax`` nor the JAX package can be imported.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

from k8s_operator_libs_tpu import fleet as jax_fleet
from k8s_operator_libs_tpu import runtime as jax_runtime
from k8s_operator_libs_tpu.api import DriverUpgradePolicySpec as JaxPolicy
from k8s_operator_libs_tpu.api import make_fleet_rollout, pools_in_phase, rollout_spec
from k8s_operator_libs_tpu.kube import LocalApiServer, Node
from k8s_operator_libs_tpu.kube import RestClient as JaxRestClient
from k8s_operator_libs_tpu.kube import RestConfig as JaxRestConfig
from k8s_operator_libs_tpu.kube.objects import KubeObject
from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator
from k8s_operator_libs_tpu.parallel.topology import (
    GKE_NODEPOOL_LABEL,
    GKE_TPU_ACCELERATOR_LABEL,
    GKE_TPU_TOPOLOGY_LABEL,
)
from k8s_operator_libs_tpu.utils.jaxenv import hermetic_cpu_env
from k8s_operator_libs_tpu_torch import fleet as port_fleet
from k8s_operator_libs_tpu_torch import runtime as port_runtime
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig

NS = "kube-system"
DS_LABELS = {"app": "libtpu-installer"}
ROLLOUT = "fleet-roll"
REPO = Path(__file__).resolve().parents[1]
POLICY = {"autoUpgrade": True, "maxParallelUpgrades": 0, "maxUnavailable": "100%"}

PKGS = {
    "jax": SimpleNamespace(fleet=jax_fleet, runtime=jax_runtime, policy=JaxPolicy.from_dict(POLICY),
                           client=lambda url: JaxRestClient(JaxRestConfig(server=url))),
    "port": SimpleNamespace(fleet=port_fleet, runtime=port_runtime,
                            policy=DriverUpgradePolicySpec.from_dict(POLICY),
                            client=lambda url: RestClient(RestConfig(server=url))),
}


def on_both(case, *args):
    outcomes = {name: case(pkg, *args) for name, pkg in PKGS.items()}
    assert outcomes["port"] == outcomes["jax"]
    return outcomes["port"]


def pool_of(node_name: str) -> str:
    return node_name.split("-")[0]


def tpu_node(name: str, pool: str) -> Node:
    node = Node.new(name, labels={GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
                                  GKE_TPU_TOPOLOGY_LABEL: "4x4", GKE_NODEPOOL_LABEL: pool})
    node.set_ready(True)
    return node


def seed_fleet(cluster, pools: int, budget: str):
    """``pools`` one-host pools, the driver DaemonSet and the FleetRollout."""
    pool_names = [f"s{i}" for i in range(pools)]
    for pool in pool_names:
        cluster.create(tpu_node(f"{pool}-h0", pool))
    sim = DaemonSetSimulator(cluster, name="libtpu-installer", namespace=NS,
                             match_labels=DS_LABELS, initial_hash="libtpu-v1")
    sim.settle()
    rollout = make_fleet_rollout(ROLLOUT, pool_names, budget)
    cluster.create(KubeObject(rollout))
    return pool_names, sim, rollout_spec(rollout).resolved_budget()


def disrupted_pools(cluster) -> set:
    out = set()
    for name in cluster.object_names("Node"):
        raw = cluster.peek("Node", name) or {}
        if (raw.get("spec") or {}).get("unschedulable"):
            out.add(pool_of(name))
    return out


def lease_holder(cluster, name: str) -> str:
    raw = cluster.peek("Lease", name, NS) or {}
    return (raw.get("spec") or {}).get("holderIdentity") or ""


class TestShutdownUnderLoad:
    POOLS = 64
    SHARDS = 4

    def _worker(self, pkg, srv, clients, index: int):
        client = pkg.client(srv.url)
        clients.append(client)
        fleet = pkg.fleet
        return fleet.ShardWorker(client, fleet.FleetWorkerConfig(
            identity=f"worker-{index}", shards=self.SHARDS, namespace=NS,
            driver_labels=DS_LABELS, pool_of=pool_of, rollout_name=ROLLOUT,
            preferred_shards=[fleet.shard_id(j) for j in range(self.SHARDS) if j % 2 == index],
            lease_duration_s=5.0, renew_deadline_s=3.0, retry_period_s=0.5,
            failover_probe_s=0.5,
        ))

    def test_sigterm_mid_roll(self):
        def case(pkg):
            rt = pkg.runtime
            with LocalApiServer() as srv:
                _, sim, budget = seed_fleet(srv.cluster, self.POOLS, "25%")
                clients = []
                stop_survivor = threading.Event()
                survivor_thread = successor = None
                drained = False
                w0 = self._worker(pkg, srv, clients, 0)
                w1 = self._worker(pkg, srv, clients, 1)
                sup = rt.Supervisor(drain_timeout_s=20.0, component_timeout_s=10.0)
                sup.install_signal_handlers()
                try:
                    w0.start(sync_timeout=60)
                    w1.start(sync_timeout=60)
                    deadline = time.time() + 60
                    while True:
                        w0.tick(pkg.policy)
                        w1.tick(pkg.policy)
                        if len(w0.owned_shards() | w1.owned_shards()) == self.SHARDS:
                            break
                        assert time.time() < deadline, "shards never settled"
                        time.sleep(0.02)
                    victim_shards = set(w0.owned_shards())
                    sup.adopt(rt.FuncComponent("worker0", stop=w0.stop))

                    def run_victim(stop_event):
                        while not stop_event.is_set():
                            try:
                                w0.tick(pkg.policy)
                            except Exception:  # noqa: BLE001 - retried
                                pass
                            stop_event.wait(0.005)

                    sup.add(rt.ThreadComponent("worker0-loop", run_victim, join_timeout_s=10.0),
                            depends_on=["worker0"])
                    orch_client = pkg.client(srv.url)
                    clients.append(orch_client)
                    orch = rt.OrchestratorDaemon(
                        orch_client, ROLLOUT, namespace=NS, identity="orch-victim",
                        interval_s=0.05, lease_duration_s=5.0, renew_deadline_s=3.0,
                        retry_period_s=0.1, use_wakeups=False, join_timeout_s=10.0,
                    )
                    orch.start()
                    sup.adopt(orch)
                    sup.start()

                    def run_survivor():
                        while not stop_survivor.is_set():
                            try:
                                w1.tick(pkg.policy)
                            except Exception:  # noqa: BLE001 - retried
                                pass
                            stop_survivor.wait(0.005)

                    survivor_thread = threading.Thread(target=run_survivor, daemon=True,
                                                       name="survivor-loop")
                    survivor_thread.start()
                    deadline = time.time() + 30
                    while not orch.is_leader():
                        assert time.time() < deadline, "orchestrator never led"
                        time.sleep(0.02)
                    sim.set_template_hash("libtpu-v2")
                    deadline = time.time() + 120
                    while (orch.orchestrator.grants_issued < budget // 2
                           or not disrupted_pools(srv.cluster)):
                        sim.step()
                        assert time.time() < deadline, "roll never got underway"
                        time.sleep(0.01)

                    os.kill(os.getpid(), signal.SIGTERM)
                    assert sup.wait(timeout=10), "SIGTERM never set the event"
                    began = time.monotonic()
                    reports = sup.stop()
                    elapsed = time.monotonic() - began
                    drained = True
                    assert elapsed < 20.0, f"drain took {elapsed:.1f}s"
                    names = [r.name for r in reports]
                    assert names == ["worker0-loop", "fleet-orchestrator", "worker0"]
                    assert all(r.ok for r in reports), reports
                    leftover = [t.name for t in threading.enumerate()
                                if t.name in ("worker0-loop", "fleet-orchestrator")]
                    assert not leftover, f"threads survived the drain: {leftover}"
                    released = {
                        "fleet-orchestrator": lease_holder(srv.cluster, "fleet-orchestrator"),
                        **{f"fleet-{s}": lease_holder(srv.cluster, f"fleet-{s}")
                           for s in sorted(victim_shards)},
                    }
                    assert set(released.values()) == {""}, released

                    succ_client = pkg.client(srv.url)
                    clients.append(succ_client)
                    successor = rt.OrchestratorDaemon(
                        succ_client, ROLLOUT, namespace=NS, identity="orch-successor",
                        interval_s=0.02, lease_duration_s=5.0, renew_deadline_s=3.0,
                        retry_period_s=0.05, use_wakeups=False, join_timeout_s=10.0,
                    )
                    began = time.monotonic()
                    successor.start()
                    deadline = time.time() + 10
                    while not successor.is_leader():
                        assert time.time() < deadline, "successor never led"
                        time.sleep(0.01)
                    takeover = time.monotonic() - began
                    assert takeover < 3.0, f"takeover took {takeover:.2f}s"

                    violations = 0
                    deadline = time.time() + 240
                    while True:
                        sim.step()
                        if len(disrupted_pools(srv.cluster)) > budget:
                            violations += 1
                        ledger = srv.cluster.peek("FleetRollout", ROLLOUT)
                        done = len(pools_in_phase(ledger or {}, "done"))
                        if done == self.POOLS:
                            break
                        assert time.time() < deadline, (
                            f"roll did not converge under survivors ({done}/{self.POOLS})")
                        time.sleep(0.005)
                    assert violations == 0
                    assert sim.all_pods_ready_and_current()
                finally:
                    sup.restore_signal_handlers()
                    stop_survivor.set()
                    if survivor_thread is not None:
                        survivor_thread.join(timeout=10)
                    if successor is not None:
                        successor.stop()
                    w1.stop()
                    if not drained:
                        sup.stop()
                    for client in clients:
                        client.close()
                request_log = srv.start_request_log()
                time.sleep(0.4)
                srv.stop_request_log()
                assert request_log == [], f"traffic after stop returned: {request_log[:10]}"
                return {"reports": names, "released": sorted(released),
                        "violations": violations, "done": done}

        on_both(case)


def blocked_path(root: Path) -> str:
    """A directory whose ``jax`` and ``k8s_operator_libs_tpu`` packages
    raise on import, first on the child's path."""
    for name in ("jax", "k8s_operator_libs_tpu"):
        pkg = root / name
        pkg.mkdir(parents=True, exist_ok=True)
        (pkg / "__init__.py").write_text(f"raise ImportError('{name} is not importable here')\n")
    return str(root)


class TestOrchestrateMultiProcess:
    def _command(self, name: str, tmp_path: Path, kubeconfig: str):
        if name == "jax":
            env = hermetic_cpu_env(4)
            return [sys.executable, str(REPO / "examples" / "upgrade_controller.py")], env, None
        env = dict(os.environ)
        env["PYTHONPATH"] = blocked_path(tmp_path / "blocked") + os.pathsep + str(REPO)
        return ([sys.executable, "-m", "k8s_operator_libs_tpu_torch.upgrade_controller",
                 "--selector", "app=libtpu-installer"], env, str(tmp_path))

    def test_two_workers_one_orchestrator_roll_and_sigterm(self, tmp_path):
        def case(pkg):
            name = "port" if pkg is PKGS["port"] else "jax"
            with LocalApiServer() as srv:
                kubeconfig = srv.write_kubeconfig(str(tmp_path / f"{name}.kubeconfig"))
                node_names = []
                for i in range(4):
                    srv.cluster.create(tpu_node(f"fleet-node-{i}", "fleet-pool"))
                    node_names.append(f"fleet-node-{i}")
                sim = DaemonSetSimulator(srv.cluster, name="libtpu-installer", namespace=NS,
                                         match_labels=DS_LABELS, initial_hash="libtpu-v1")
                sim.settle()
                srv.cluster.create(KubeObject(make_fleet_rollout(ROLLOUT, node_names, "50%")))
                sim.set_template_hash("libtpu-v2")
                argv, env, cwd = self._command(name, tmp_path, kubeconfig)
                env["KUBECONFIG"] = kubeconfig
                procs = []
                try:
                    for i in range(2):
                        flags = ["--shards", "2", "--shard-index", str(i),
                                 "--fleet-rollout", ROLLOUT, "--interval", "0.2",
                                 "--leader-elect-id", f"proc-{i}"]
                        if i == 0:
                            flags.append("--orchestrate")
                        procs.append(subprocess.Popen(
                            [*argv, *flags], env=env, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True))
                    deadline = time.time() + 150
                    while True:
                        sim.step()
                        for proc in procs:
                            if proc.poll() is not None:
                                out, _ = proc.communicate(timeout=10)
                                raise AssertionError(
                                    f"{name}: worker exited early (rc={proc.returncode}): "
                                    f"{out[-1500:]}")
                        ledger = srv.cluster.peek("FleetRollout", ROLLOUT)
                        if len(pools_in_phase(ledger or {}, "done")) == 4:
                            break
                        assert time.time() < deadline, (
                            f"{name}: fleet roll did not converge; "
                            f"ledger={(ledger or {}).get('status')}")
                        time.sleep(0.05)
                    assert sim.all_pods_ready_and_current()
                    leader = lease_holder(srv.cluster, "fleet-orchestrator")
                    assert leader == "proc-0"
                    for proc in procs:
                        proc.send_signal(signal.SIGTERM)
                    outs = [proc.communicate(timeout=60)[0] for proc in procs]
                    for proc, out in zip(procs, outs):
                        assert proc.returncode == 0, out[-1500:]
                        assert "shutdown requested; draining" in out
                    assert "fleet orchestrator: campaigning as 'proc-0'" in outs[0]
                    leases = {lease: lease_holder(srv.cluster, lease) for lease in
                              ("fleet-orchestrator", "fleet-shard-00", "fleet-shard-01")}
                    assert set(leases.values()) == {""}, leases
                    completed_by = {p: (entry or {}).get("completedBy") for p, entry in
                                    ((ledger or {}).get("status") or {}).get("pools", {}).items()}
                    if name == "port":
                        assert not any("Traceback" in out for out in outs), outs
                finally:
                    for proc in procs:
                        if proc.poll() is None:
                            proc.kill()
                return {"leader": leader, "leases": leases,
                        "return_codes": [p.returncode for p in procs],
                        "completed_by": completed_by}

        on_both(case)


def test_chip_smoke_fleet_roll_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``chip_smoke.py``'s fleet_roll phase whole on the CPU, each probe
    pod's payload a stub that writes its ready file and parks: two fleet
    workers over ``ApiStub`` roll both pools one at a time under the
    orchestrator's grants, both exit 0 on SIGTERM and every Lease is
    empty."""
    from k8s_operator_libs_tpu_torch.parallel import topology
    from test_torch_cuda import chip_smoke_module

    smoke = chip_smoke_module()
    monkeypatch.setattr(topology, "local_gpu_labels", lambda: {
        "nvidia.com/gpu.present": "true", "nvidia.com/gpu.count": "1",
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
    })
    launches = {"matmul": 4657, "flash_attention": 4}
    stub = ("import sys, time\n"
            "open(sys.argv[sys.argv.index('--ready-file') + 1], 'w').write('ok=True')\n"
            "time.sleep(600)\n")
    monkeypatch.setattr(smoke, "controller_pod_argv", lambda workdir: (
        lambda pod, argv: [sys.executable, "-c", stub, "--ready-file", "unset"]))
    monkeypatch.setattr(smoke, "read_pod_run", lambda workdir, name, label: {
        "launches": dict(launches), "elapsed_s": 0.0,
        "build_s": {"matmul": 0.0, "flash_attention": 0.0}})
    result = smoke.fleet_roll_phase("cpu", launches, str(tmp_path))
    out = capsys.readouterr().out.splitlines()
    (printed,) = [json.loads(line)["fleet_roll"] for line in out
                  if line.startswith('{"fleet_roll"')]
    assert printed == result
    assert result["most_pools_out_at_once"] == 1
    assert set(result["done_s"]) == set(smoke.FLEET_POOLS)
    first, second = result["grant_order"]
    assert result["granted_s"][second] >= result["done_s"][first]
    assert result["orchestrator"]["grants_issued"] == 2
    assert result["orchestrator"]["budget_denials"] > 0
    assert result["return_codes"] == {w: 0 for w in smoke.FLEET_IDS}
    assert set(result["leases_after"].values()) == {""}
    assert result["pod_launches"] == {k: 2 * v for k, v in launches.items()}
    assert result["parent_launches"] == {"matmul": 0, "flash_attention": 0}
