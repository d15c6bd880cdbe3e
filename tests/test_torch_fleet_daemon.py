"""The port's fleet orchestrator daemon and the command's fleet mode.

* The four cases of ``tests/test_runtime.py::TestOrchestratorDaemon``
  run once with each package's ``OrchestratorDaemon``: the JAX daemon on
  a ``FakeCluster``, the port's over its ``RestClient`` at a
  ``LocalApiServer`` serving another one seeded the same; the two
  packages' observations (who led, whether a standby ticked, the Lease
  after each stop, the stop reports) must be equal.
* The port's daemon releases its Lease only after its tick thread ended:
  a thread still in a grant round when the stop's budget runs out leaves
  the Lease to expire.
* SIGTERM while a drain is in flight, in fleet mode (``--shards 1
  --fleet-rollout``): the drain's state write lands while the shard Lease
  is still held, and the Lease is released only after it; where the drain
  outlives the stop budget, the shard Lease is left to expire and the
  drain's write never lands.
* ``--watch-relay`` and ``--demo`` still exit non-zero naming their
  ROADMAP items, and ``--orchestrate`` without ``--fleet-rollout`` is
  refused.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from builders import make_node, make_pod
from k8s_operator_libs_tpu import runtime as jax_runtime
from k8s_operator_libs_tpu.api.fleet_v1alpha1 import make_fleet_rollout, set_pool_phase
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer, Node
from k8s_operator_libs_tpu.kube.objects import KubeObject
from k8s_operator_libs_tpu_torch import runtime as port_runtime
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.kube.sim import DaemonSetSimulator
from k8s_operator_libs_tpu_torch.upgrade import DeviceClass, UpgradeKeys

REPO = Path(__file__).resolve().parents[1]
NS = "default"
RUNTIMES = {"jax": jax_runtime, "port": port_runtime}


def wait_until(pred, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def lease_holder(cluster, name: str, namespace: str = NS) -> str:
    raw = cluster.peek("Lease", name, namespace) or {}
    return (raw.get("spec") or {}).get("holderIdentity") or ""


class TestOrchestratorDaemon:
    @staticmethod
    def _seed(cluster, pools=("p0", "p1")):
        for pool in pools:
            node = Node.new(f"{pool}-h0")
            node.set_ready(True)
            cluster.create(node)
        cluster.create(KubeObject(make_fleet_rollout("roll", list(pools), "50%")))

    @staticmethod
    def _daemon(rt, client, identity="orch-a", **overrides):
        kwargs = dict(namespace=NS, identity=identity, interval_s=0.02, lease_duration_s=1.0,
                      renew_deadline_s=0.6, retry_period_s=0.05, use_wakeups=False,
                      join_timeout_s=5.0)
        kwargs.update(overrides)
        return rt.OrchestratorDaemon(client, "roll", **kwargs)

    def on_both(self, case):
        outcomes = {}
        for name, rt in RUNTIMES.items():
            with contextlib.ExitStack() as stack:
                cluster = FakeCluster()
                self._seed(cluster)
                client = cluster
                if name == "port":
                    server = stack.enter_context(LocalApiServer(cluster=cluster))
                    client = RestClient(RestConfig(server=server.url))
                    stack.callback(client.close)
                outcomes[name] = case(rt, cluster, client)
        assert outcomes["port"] == outcomes["jax"]
        return outcomes["port"]

    def test_leader_ticks_and_stop_joins_and_releases(self):
        def case(rt, cluster, client):
            daemon = self._daemon(rt, client)
            daemon.start()
            try:
                assert wait_until(daemon.is_leader)
                assert wait_until(lambda: daemon.led_ticks > 0)
                assert daemon.healthy()
            finally:
                daemon.stop()
            assert daemon._thread is None and not daemon.healthy()
            holder = lease_holder(cluster, "fleet-orchestrator")
            assert holder == ""
            ledger = cluster.get("FleetRollout", "roll").raw["status"]
            return {"holder": holder, "grants": daemon.orchestrator.grant_order,
                    "ledger": ledger}

        self.on_both(case)

    def test_standby_does_not_tick(self):
        def case(rt, cluster, client):
            leader = self._daemon(rt, client, identity="leader")
            leader.start()
            try:
                assert wait_until(leader.is_leader)
                standby = self._daemon(rt, client, identity="standby")
                standby.start()
                try:
                    time.sleep(0.3)
                    assert not standby.is_leader()
                    assert standby.led_ticks == 0
                    assert standby.healthy()
                    holder = lease_holder(cluster, "fleet-orchestrator")
                finally:
                    standby.stop()
            finally:
                leader.stop()
            return {"holder": holder, "standby_ticks": standby.led_ticks}

        self.on_both(case)

    def test_failover_to_standby_after_graceful_stop(self):
        def case(rt, cluster, client):
            leader = self._daemon(rt, client, identity="leader")
            standby = self._daemon(rt, client, identity="standby")
            leader.start()
            standby.start()
            try:
                assert wait_until(leader.is_leader)
                leader.stop()
                began = time.monotonic()
                assert wait_until(standby.is_leader, timeout=5.0)
                takeover = time.monotonic() - began
                assert takeover < 0.9, f"takeover took {takeover:.2f}s: waited out the TTL?"
                assert wait_until(lambda: standby.led_ticks > 0)
                holder = lease_holder(cluster, "fleet-orchestrator")
            finally:
                standby.stop()
                leader.stop()
            return {"holder": holder, "after": lease_holder(cluster, "fleet-orchestrator")}

        self.on_both(case)

    def test_stop_reports_cover_the_daemon(self):
        def case(rt, cluster, client):
            sup = rt.Supervisor()
            daemon = self._daemon(rt, client)
            sup.add(daemon)
            sup.start()
            assert wait_until(lambda: daemon.led_ticks > 0)
            reports = sup.stop()
            assert all(isinstance(r, rt.StopReport) and r.ok for r in reports)
            return {"reports": [r.name for r in reports],
                    "holder": lease_holder(cluster, "fleet-orchestrator")}

        assert self.on_both(case) == {"reports": ["fleet-orchestrator"], "holder": ""}


def test_daemon_releases_the_lease_only_after_its_tick_thread_ended():
    """A tick thread still in its grant round when the stop's budget runs
    out leaves the Lease held (to expire); once it ends, a stop releases."""
    with LocalApiServer() as server:
        TestOrchestratorDaemon._seed(server.cluster)
        client = RestClient(RestConfig(server=server.url))
        daemon = TestOrchestratorDaemon._daemon(port_runtime, client, lease_duration_s=30.0,
                                                join_timeout_s=0.3)
        in_round, release_round = threading.Event(), threading.Event()
        tick = daemon.orchestrator.tick

        def held_tick(wake_traces=None):
            in_round.set()
            release_round.wait(30)
            return tick(wake_traces=wake_traces)

        daemon.orchestrator.tick = held_tick
        thread = None
        try:
            daemon.start()
            thread = daemon._thread
            assert in_round.wait(10), "the daemon never ticked"
            daemon.stop()
            assert daemon.released is False
            assert thread.is_alive()
            assert lease_holder(server.cluster, "fleet-orchestrator") == "orch-a"
            # The round ends and writes its grants under the Lease it still holds.
            release_round.set()
            thread.join(10)
            assert not thread.is_alive()
            assert server.cluster.get("FleetRollout", "roll").raw["status"]["grantsIssued"] == 1
            # A daemon whose thread ends in its budget releases at once.
            daemon = TestOrchestratorDaemon._daemon(port_runtime, client, identity="orch-b",
                                                    lease_duration_s=30.0)
            daemon.orchestrator.tick = lambda wake_traces=None: {}
            server.cluster.delete("Lease", "fleet-orchestrator", NS)  # orch-a's, expired
            daemon.start()
            assert wait_until(daemon.is_leader)
            daemon.stop()
            assert daemon.released is True
            assert lease_holder(server.cluster, "fleet-orchestrator") == ""
        finally:
            release_round.set()
            if thread is not None:
                thread.join(10)
            client.close()


# ---------------------------------------------------------------------------
# The command in fleet mode
# ---------------------------------------------------------------------------

CMD_NS = "kube-system"
CMD_LABELS = {"app": "gpu-installer"}
KEYS = UpgradeKeys(DeviceClass.nvidia("gpu"))
SHARD_LEASE = "fleet-shard-00"


def child(*args: str) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.upgrade_controller", *args],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


@pytest.mark.parametrize("drain_timeout_s, handed_over", [(3, True), (14, False)],
                         ids=["drain-ends-in-budget", "drain-outlives-budget"])
def test_sigterm_during_a_fleet_drain_writes_only_under_the_shard_lease(
        tmp_path, monkeypatch, drain_timeout_s, handed_over):
    with LocalApiServer() as server:
        cluster = server.cluster
        for i in range(2):
            cluster.create(make_node(f"wd-{i}"))
            pod = make_pod(f"train-wd-{i}", namespace="default", node_name=f"wd-{i}")
            pod.metadata["finalizers"] = ["test.example/hold"]  # the eviction never completes
            cluster.create(pod)
        sim = DaemonSetSimulator(cluster, name="gpu-installer", namespace=CMD_NS,
                                 match_labels=CMD_LABELS, initial_hash="v1")
        sim.settle()
        # Each node its own pool; wd-0's pool granted, so one drain runs.
        cluster.create(KubeObject(make_fleet_rollout("roll", ["wd-0", "wd-1"], 1)))
        ledger = cluster.get("FleetRollout", "roll")
        set_pool_phase(ledger.raw, "wd-0", "granted", grantedSeq=1)
        cluster.update_status(ledger)
        kubeconfig = server.write_kubeconfig(str(tmp_path / "kubeconfig"))
        monkeypatch.setenv("KUBECONFIG", kubeconfig)
        policy = tmp_path / "policy.json"
        policy.write_text(json.dumps({
            "autoUpgrade": True, "maxParallelUpgrades": 0, "maxUnavailable": "100%",
            "drain": {"enable": True, "force": True, "timeoutSeconds": drain_timeout_s},
        }))
        stats = tmp_path / "stats.json"
        writes: list[tuple[float, str, str]] = []

        def record(verb, kind, payload):
            if verb not in ("get", "list", "watch"):
                writes.append((time.monotonic(), verb, lease_holder(cluster, SHARD_LEASE,
                                                                     CMD_NS)))

        proc = child("--shards", "1", "--shard-index", "0", "--fleet-rollout", "roll",
                     "--interval", "0.5", "--leader-elect-id", "wd-a", "--policy", str(policy),
                     "--stats-json", str(stats))
        output: list[str] = []
        drainer = threading.Thread(target=lambda: output.extend(proc.stdout), daemon=True)
        drainer.start()
        stop = threading.Event()

        def kubelet():
            while not stop.is_set():
                sim.step()
                time.sleep(0.1)

        ticker = threading.Thread(target=kubelet, daemon=True)
        ticker.start()
        try:
            assert wait_until(lambda: any("pass 1:" in line for line in output), 60), (
                "no first pass:\n" + "".join(output[-40:]))
            cluster.add_reactor("*", "Node", record)
            sim.set_template_hash("v2")
            held = wait_until(lambda: any(p.metadata.get("deletionTimestamp")
                                          for p in cluster.list("Pod", namespace="default")),
                              60)
            assert held, "no drain evicted its pod:\n" + "".join(output[-40:])
            signalled = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            ended = time.monotonic()
            if not handed_over:
                time.sleep(drain_timeout_s - (ended - signalled) + 1)
        finally:
            stop.set()
            ticker.join(timeout=5)
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            drainer.join(timeout=5)
        text = "".join(output)
        assert rc == 0, text[-3000:]
        assert "shutdown requested; draining" in text
        holders = {holder for _, _, holder in writes}
        assert holders == {"wd-a"}, f"a Node write landed outside the shard Lease: {writes}"
        states = {n.name: n.labels.get(KEYS.state_label) for n in cluster.list("Node")}
        assert states["wd-1"] == "upgrade-required", states  # never granted
        if handed_over:
            assert states["wd-0"] == "upgrade-failed"  # the drain's timeout, after the signal
            assert any(at > signalled for at, _, _ in writes)
            assert lease_holder(cluster, SHARD_LEASE, CMD_NS) == ""
            assert "leaving the shard Leases to expire" not in text
        else:
            assert states["wd-0"] == "drain-required"
            assert ended - signalled < drain_timeout_s
            assert lease_holder(cluster, SHARD_LEASE, CMD_NS) == "wd-a"
            assert "leaving the shard Leases to expire" in text
        recorded = json.loads(stats.read_text())
        assert recorded["shards"] == ["shard-00"] and recorded["idle_ticks"] == 0


@pytest.mark.parametrize("flag, item", [
    (["--watch-relay", "http://127.0.0.1:1"], "A18"),
    (["--demo"], "A19"),
], ids=["watch-relay", "demo"])
def test_kept_refusals_still_exit_nonzero_naming_their_items(tmp_path, flag, item):
    proc = child("--shards", "2", "--shard-index", "0", "--fleet-rollout", "roll", *flag)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 2, out
    assert flag[0] in out and f"(ROADMAP {item})" in out


def test_orchestrate_requires_a_fleet_rollout():
    proc = child("--shards", "2", "--orchestrate")
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 2, out
    assert "--orchestrate requires --fleet-rollout" in out
