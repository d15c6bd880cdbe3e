"""The port's ``upgrade_controller`` command against a ``LocalApiServer``.

``python -m k8s_operator_libs_tpu_torch.upgrade_controller`` is the JAX
package's ``examples/upgrade_controller.py`` over the port. Here it runs
against the JAX ``LocalApiServer`` through a kubeconfig, the cluster's
kubelets played by the port's ``DaemonSetSimulator``:

* the watch-only roll of ``tests/test_informer.py``'s
  ``TestWatchDrivenController::test_roll_progresses_on_watch_triggers_alone``
  (``--watch --interval 600``: only watch-triggered passes can drive it),
  here also under ``--leader-elect`` and ended by SIGTERM, which must
  return 0, print ``shutdown requested; draining`` and leave the Lease
  released; ``--stats-json`` must count the passes printed;
* SIGTERM while a drain is in flight (its pod held by a finalizer): the
  drain's state write lands while the Lease is still held, and the Lease
  is handed over only after it; where the drain outlives the stop
  budget, the Lease is left to expire and the process ends at once, so
  the drain's write never lands;
* a stolen Lease: the deposed leader exits 3, printing no pass after the
  elector reports the loss, within the renew deadline and a wake slice;
* ``--once`` prints exactly one pass (``--demo``, which the command no
  longer refuses, has its own files: ``tests/test_torch_demo*.py``);
* ``--watch --watch-relay`` on twin clusters: the JAX command through the
  JAX ``WatchRelay`` on one, the port's through the port's on the other,
  each roll driven by watch events alone; every node takes the JAX
  command's state-label sequence, and each relay carried one upstream
  stream a scope;
* each fleet flag runs one tick of a shard worker under ``--once``
  and leaves every Lease released;
* ``--ici-gate`` with no card: the gate raises in the validation hook, so
  the node stays in ``validation-required`` instead of passing.

The roll, the drain and the Lease cases are child processes, each with its
own deadline and a pipe drained continuously; the others run ``main`` in
this process.
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

import pytest

from builders import make_node, make_pod
from k8s_operator_libs_tpu.kube import LocalApiServer
from k8s_operator_libs_tpu_torch.kube.leader import LeaderElectionConfig
from k8s_operator_libs_tpu_torch import upgrade_controller
from k8s_operator_libs_tpu_torch.kube.sim import DaemonSetSimulator
from k8s_operator_libs_tpu_torch.upgrade import DeviceClass, UpgradeKeys

REPO = Path(__file__).resolve().parents[1]
NS = "kube-system"
KEYS = UpgradeKeys(DeviceClass.nvidia("gpu"))
LABELS = {"app": "gpu-installer"}
LEASE = "upgrade-controller-nvidia"


def wait_until(predicate, timeout: float, interval: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


@pytest.fixture()
def pool(tmp_path, monkeypatch):
    """A server with two nodes and the driver DaemonSet settled at v1; the
    kubeconfig at it in ``$KUBECONFIG``."""
    with LocalApiServer() as server:
        for i in range(2):
            server.cluster.create(make_node(f"wd-{i}"))
        sim = DaemonSetSimulator(server.cluster, name="gpu-installer", namespace=NS,
                                 match_labels=LABELS, initial_hash="v1")
        sim.settle()
        kubeconfig = server.write_kubeconfig(str(tmp_path / "kubeconfig"))
        monkeypatch.setenv("KUBECONFIG", kubeconfig)
        yield server, sim


def _states(cluster) -> dict:
    return {n.name: n.labels.get(KEYS.state_label) for n in cluster.list("Node")}


class Child:
    """The command as a child process, its merged output drained
    continuously into ``output``."""

    def __init__(self, *args: str) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "k8s_operator_libs_tpu_torch.upgrade_controller", *args],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        self.output: list[str] = []
        self.drainer = threading.Thread(target=lambda: self.output.extend(self.proc.stdout),
                                        daemon=True)
        self.drainer.start()

    def printed(self, text: str) -> bool:
        return any(text in line for line in list(self.output))

    def wait_printed(self, text: str, timeout: float) -> None:
        assert wait_until(lambda: self.printed(text) or self.proc.poll() is not None,
                          timeout) and self.printed(text), (
            f"the controller never printed {text!r}:\n" + self.tail())

    def tail(self, n: int = 60) -> str:
        return "".join(self.output[-n:])

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self.drainer.join(timeout=5)


class Kubelet:
    """The DaemonSet simulator ticking every 0.1 s in a thread."""

    def __init__(self, sim) -> None:
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(sim,), daemon=True)
        self.thread.start()

    def _run(self, sim) -> None:
        while not self.stop.is_set():
            sim.step()
            time.sleep(0.1)

    def close(self) -> None:
        self.stop.set()
        self.thread.join(timeout=5)


def test_watch_roll_progresses_on_watch_triggers_alone_and_sigterm_releases(pool, tmp_path):
    server, sim = pool
    cluster = server.cluster
    stats = tmp_path / "stats.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.upgrade_controller",
         "--watch", "--interval", "600", "--leader-elect", "--leader-elect-id", "wd-a",
         "--stats-json", str(stats)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    # Drained continuously: a full pipe would block the controller's writes.
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
            "the controller never completed its first pass:\n" + "".join(output[-40:])
        )
        sim.set_template_hash("v2")  # the update lands: watch events
        converged = wait_until(
            lambda: set(_states(cluster).values()) == {"upgrade-done"}
            and sim.all_pods_ready_and_current()
            and not any(n.unschedulable for n in cluster.list("Node")),
            120,
        )
        assert converged, "the watch-driven roll did not converge:\n" + "".join(output[-60:])
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
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
    assert cluster.get("Lease", LEASE, NS).holder_identity == ""  # released, not expired
    printed = sum(1 for line in output if line.startswith("pass "))
    assert json.loads(stats.read_text())["passes"] == printed


@pytest.mark.parametrize("drain_timeout_s, handed_over", [(3, True), (14, False)],
                         ids=["drain-ends-in-budget", "drain-outlives-budget"])
def test_sigterm_during_a_drain_writes_only_under_the_lease(pool, tmp_path, drain_timeout_s,
                                                             handed_over):
    server, sim = pool
    cluster = server.cluster
    for i in range(2):
        pod = make_pod(f"train-wd-{i}", namespace="default", node_name=f"wd-{i}")
        pod.metadata["finalizers"] = ["test.example/hold"]  # the eviction never completes
        cluster.create(pod)
    policy = tmp_path / "policy.json"
    policy.write_text(json.dumps({
        "autoUpgrade": True, "maxParallelUpgrades": 1,
        "drain": {"enable": True, "force": True, "timeoutSeconds": drain_timeout_s},
    }))
    # Every Node write, with the Lease's holder at that moment (the
    # reactor runs under the cluster's lock, before the write).
    writes: list[tuple[float, str, str]] = []

    def record(verb, kind, payload):
        if verb not in ("get", "list", "watch"):
            lease = cluster.get("Lease", LEASE, NS)
            writes.append((time.monotonic(), verb, lease.holder_identity))

    child = Child("--watch", "--interval", "600", "--leader-elect", "--leader-elect-id",
                  "wd-a", "--policy", str(policy))
    kubelet = Kubelet(sim)
    try:
        child.wait_printed("pass 1:", 60)
        cluster.add_reactor("*", "Node", record)
        sim.set_template_hash("v2")
        held = wait_until(lambda: any(p.metadata.get("deletionTimestamp")
                                      for p in cluster.list("Pod", namespace="default")), 60)
        assert held, "no drain evicted its pod:\n" + child.tail()
        signalled = time.monotonic()
        child.proc.send_signal(signal.SIGTERM)
        rc = child.proc.wait(timeout=60)
        ended = time.monotonic()
        time.sleep(drain_timeout_s - (ended - signalled) + 1 if not handed_over else 0)
    finally:
        kubelet.close()
        child.close()
    text = child.tail(200)
    assert rc == 0, text
    holders = {holder for _, _, holder in writes}
    assert holders == {"wd-a"}, f"a Node write landed outside the Lease: {writes}"
    lease = cluster.get("Lease", LEASE, NS)
    drained = [n for n, state in _states(cluster).items() if state != "upgrade-required"]
    assert len(drained) == 1, _states(cluster)
    if handed_over:
        # The drain's own write (its timeout) landed after the signal.
        assert _states(cluster)[drained[0]] == "upgrade-failed"
        assert any(at > signalled for at, _, _ in writes)
        assert lease.holder_identity == ""
        assert "leaving the Lease to expire" not in text
    else:
        # Ended after the budget, the drain's write never came.
        assert _states(cluster)[drained[0]] == "drain-required"
        assert ended - signalled < drain_timeout_s
        assert lease.holder_identity == "wd-a"
        assert "leaving the Lease to expire" in text


def test_deposed_leader_exits_3_with_no_pass_after_the_loss(pool):
    server, _ = pool
    cluster = server.cluster
    cfg = LeaderElectionConfig(name=LEASE, namespace=NS, identity="wd-a")
    child = Child("--watch", "--interval", "600", "--leader-elect", "--leader-elect-id", "wd-a")
    stop = threading.Event()

    def touch():
        # A node event every 0.2 s: a key always waits, so only the loop's
        # look at the Lease keeps a deposed leader from another pass.
        n = 0
        while not stop.is_set():
            node = cluster.get("Node", "wd-1")
            node.labels["test.example/tick"] = str(n)
            cluster.update(node)
            n += 1
            time.sleep(0.2)

    toucher = threading.Thread(target=touch, daemon=True)
    try:
        child.wait_printed("pass 1:", 60)
        toucher.start()
        lease = cluster.get("Lease", LEASE, NS)
        lease.spec["holderIdentity"] = "thief"
        lease.spec["leaseDurationSeconds"] = 300
        lease.spec["renewTime"] = time.strftime("%Y-%m-%dT%H:%M:%S.000000Z", time.gmtime())
        cluster.update(lease)
        stolen = time.monotonic()
        rc = child.proc.wait(timeout=60)
        exited = time.monotonic() - stolen
    finally:
        stop.set()
        if toucher.is_alive():
            toucher.join(timeout=5)
        child.close()
    lines = child.output
    text = "".join(lines)
    assert rc == 3, text[-3000:]
    lost = next(i for i, line in enumerate(lines) if "LOST" in line)
    assert not [line for line in lines[lost:] if line.startswith("pass ")], text[-3000:]
    assert "leader election: lease lost; exiting" in text
    limit = cfg.renew_deadline_s + cfg.retry_period_s + upgrade_controller.WAKE_S + 3.0
    assert exited < limit, f"exited {exited:.1f} s after the steal"
    assert cluster.get("Lease", LEASE, NS).holder_identity == "thief"  # never taken back


def test_once_prints_exactly_one_pass(pool, capsys):
    server, _ = pool
    assert upgrade_controller.main(["--once"]) == 0
    passes = [line for line in capsys.readouterr().out.splitlines() if line.startswith("pass ")]
    assert len(passes) == 1 and passes[0].startswith("pass 1: unknown=2 ")
    assert set(_states(server.cluster).values()) == {"upgrade-done"}


@pytest.mark.parametrize("flags, shards, states", [
    (["--shards", "2"], "shard-00", {"wd-0": None, "wd-1": None}),
    (["--shards", "2", "--shard-index", "1"], "shard-01",
     {"wd-0": "upgrade-done", "wd-1": "upgrade-done"}),
    (["--shards", "2", "--pool-prefix-sep=-"], "shard-00",
     {"wd-0": "upgrade-done", "wd-1": "upgrade-done"}),
    (["--shards", "1", "--fleet-rollout", "roll"], "shard-00",
     {"wd-0": "upgrade-done", "wd-1": "upgrade-done"}),
    (["--shards", "1", "--fleet-rollout", "roll", "--orchestrate"], "shard-00",
     {"wd-0": "upgrade-done", "wd-1": "upgrade-done"}),
], ids=["shards", "shard-index", "pool-prefix-sep", "fleet-rollout", "orchestrate"])
def test_fleet_flags_run_one_tick_over_the_shards_held(pool, capsys, flags, shards, states):
    """Each flag the fleet slice lifted: ``--once`` ticks the shard worker
    once, and at its first tick a worker holds only its preferred shard.
    Of two shards, each node its own pool, shard-01 holds both nodes; with
    ``--pool-prefix-sep=-`` their pool ``wd`` is shard-00's. On the way out
    the shard Leases and the orchestrator's are released."""
    server, _ = pool
    assert upgrade_controller.main([*flags, "--once", "--leader-elect-id", "w"]) == 0
    out = capsys.readouterr().out
    passes = [line for line in out.splitlines() if line.startswith("pass ")]
    assert len(passes) == 1 and passes[0].endswith(f" | shards={shards}"), out
    assert _states(server.cluster) == states
    assert ("fleet orchestrator: campaigning as 'w'" in out) == ("--orchestrate" in flags)
    holders = {lease.name: lease.holder_identity for lease in server.cluster.list("Lease")}
    assert holders.get(f"fleet-{shards}") == "" and set(holders.values()) == {""}


def test_ici_gate_without_a_card_raises_instead_of_passing(pool, caplog):
    server, sim = pool
    cluster = server.cluster
    node = cluster.get("Node", "wd-0")
    node.labels[KEYS.state_label] = "validation-required"
    node.unschedulable = True
    cluster.update(node)
    caplog.set_level("ERROR")
    assert upgrade_controller.main(["--once", "--ici-gate"]) == 0
    assert _states(cluster)["wd-0"] == "validation-required"
    assert cluster.get("Node", "wd-0").unschedulable
    failures = [
        r.getMessage() for r in caplog.records if "validation hook failed" in r.getMessage()
    ]
    assert failures and "no CUDA device" in failures[0]


def test_chip_smoke_controller_roll_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``chip_smoke.py``'s controller_roll phase whole on the CPU, each probe
    pod's payload a stub that writes its ready file and parks: two
    replicas over ``ApiStub``, the roll by watch alone, the scrape, the
    takeover after SIGTERM, both exits and the Lease released."""
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
    monkeypatch.setattr(smoke, "read_pod_run", lambda workdir, name, label="": {
        "launches": dict(launches), "build_s": {"matmul": 0.0, "flash_attention": 0.0}})
    result = smoke.controller_roll_phase("cpu", launches, str(tmp_path))
    out = capsys.readouterr().out.splitlines()
    (printed,) = [json.loads(line)["controller_roll"] for line in out
                  if line.startswith('{"controller_roll"')]
    assert printed == result
    assert result["return_codes"] == {"ctl-a": 0, "ctl-b": 0}
    assert result["lease_holder_after"]["ctl-b"] == ""
    assert result["takeover_s"] < smoke.LEASE_DURATION_S
    assert result["standby_passes_while_leader_ran"] == 0
    assert result["reconcile_passes_total"] == result["leader_passes_at_scrape"]
    woken = result["stats_json"]["ctl-a"]["woken_by"]
    assert woken["interval"] == 0 and woken["nodes"] > woken["resync"]
    assert all(spans["lease.round"] for spans in result["spans_by_name"].values())
    assert result["pod_launches"] == {k: 2 * v for k, v in launches.items()}
    for node in smoke.CONTROLLER_NODES:
        states = [state for state, _ in result["trajectories"][node]]
        assert states[-1] == "upgrade-done" and "validation-required" in states


def test_chip_smoke_server_roll_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``chip_smoke.py``'s server_roll phase whole on the CPU, each probe
    pod's payload a stub that writes its ready file and parks: the port's
    command over the port's ``LocalApiServer`` among 1024 more nodes, the
    Node list paged, every connection killed once mid-roll and the
    informers resuming by watch, the flows admitted and none shed, no loop
    stall, a two-row Table, server spans joined to the command's trace,
    exit 0 and the Lease released."""
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
    monkeypatch.setattr(smoke, "read_pod_run", lambda workdir, name, label="": {
        "launches": dict(launches), "build_s": {"matmul": 0.0, "flash_attention": 0.0}})
    result = smoke.controller_roll_phase("cpu", launches, str(tmp_path), server=True)
    out = capsys.readouterr().out.splitlines()
    (printed,) = [json.loads(line)["server_roll"] for line in out
                  if line.startswith('{"server_roll"')]
    assert printed == result
    assert result["return_code"] == 0 and result["lease_holder_after"] == "", (
        result["return_code"], result["lease_holder_after"], result["exit_s"])
    server = result["server"]
    assert server["continue_tokens"] >= 2
    assert server["full_node_lists_after_kill"] == 0 and server["node_watches_after_kill"] >= 1, (
        server["requests_after_kill"])
    assert all(flow["shed_429_total"] == 0 for flow in server["apf"].values()), server["apf"]
    assert server["loop_stall"]["stalls_over_threshold"] == 0, server["loop_stall"]
    assert result["table"]["rows"] == 2
    assert server["server_requests_joined_to_command"] >= 1
    assert result["pod_launches"] == {k: 2 * v for k, v in launches.items()}
    for node in smoke.SERVER_NODES:
        states = [state for state, _ in result["trajectories"][node]]
        assert states[-1] == "upgrade-done" and "validation-required" in states


RELAY_SIDES = {
    "jax": dict(ds="libtpu-installer", keys="jax",
                argv=[sys.executable, str(REPO / "examples" / "upgrade_controller.py")]),
    "port": dict(ds="gpu-installer", keys="port",
                 argv=[sys.executable, "-m", "k8s_operator_libs_tpu_torch.upgrade_controller"]),
}


def _relay_roll(name: str, tmp_path) -> dict:
    """One watch-driven roll of two nodes by ``name``'s command through
    ``name``'s relay; what the roll showed."""
    from k8s_operator_libs_tpu.kube import RestConfig as JaxRestConfig
    from k8s_operator_libs_tpu.kube import WatchRelay as JaxWatchRelay
    from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator as JaxDaemonSetSimulator
    from k8s_operator_libs_tpu.upgrade import DeviceClass as JaxDeviceClass
    from k8s_operator_libs_tpu.upgrade import UpgradeKeys as JaxUpgradeKeys
    from k8s_operator_libs_tpu.utils.jaxenv import hermetic_cpu_env
    from k8s_operator_libs_tpu_torch.kube.relay import WatchRelay
    from k8s_operator_libs_tpu_torch.kube.rest import RestConfig

    side = RELAY_SIDES[name]
    if name == "jax":
        state_label = JaxUpgradeKeys(JaxDeviceClass.tpu()).state_label
        env = hermetic_cpu_env(4)
    else:
        state_label = KEYS.state_label
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    sim_cls = JaxDaemonSetSimulator if name == "jax" else DaemonSetSimulator
    with LocalApiServer() as server:
        cluster = server.cluster
        for i in range(2):
            cluster.create(make_node(f"wd-{i}"))
        sim = sim_cls(cluster, name=side["ds"], namespace=NS,
                      match_labels={"app": side["ds"]}, initial_hash="v1")
        sim.settle()
        sequences: dict = {}
        lock = threading.Lock()

        def record(event, obj, old):
            if obj.get("kind") != "Node":
                return
            label = (obj["metadata"].get("labels") or {}).get(state_label)
            old_label = (((old or {}).get("metadata") or {}).get("labels") or {}).get(
                state_label)
            if label != old_label:
                with lock:
                    sequences.setdefault(obj["metadata"]["name"], []).append(label)

        cluster.subscribe(record)
        if name == "jax":
            relay = JaxWatchRelay(JaxRestConfig(server=server.url)).start()
        else:
            relay = WatchRelay(RestConfig(server=server.url)).start()
        env["KUBECONFIG"] = server.write_kubeconfig(str(tmp_path / f"{name}.kubeconfig"))
        stats = tmp_path / f"{name}-stats.json"
        proc = subprocess.Popen(
            [*side["argv"], "--watch", "--interval", "600", "--selector", f"app={side['ds']}",
             "--watch-relay", relay.url, "--stats-json", str(stats)],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        output: list[str] = []
        drainer = threading.Thread(target=lambda: output.extend(proc.stdout), daemon=True)
        drainer.start()
        kubelet = Kubelet(sim)

        def states():
            return {n.name: n.labels.get(state_label) for n in cluster.list("Node")}

        try:
            assert wait_until(lambda: set(states().values()) == {"upgrade-done"}, 60), (
                f"{name}: the first pass never classified the pool:\n" + "".join(output[-40:]))
            sim.set_template_hash("v2")
            converged = wait_until(
                lambda: set(states().values()) == {"upgrade-done"}
                and sim.all_pods_ready_and_current()
                and not any(n.unschedulable for n in cluster.list("Node")), 120)
            assert converged, f"{name}: the relay-fed roll did not converge:\n" + "".join(
                output[-60:])
            relay_stats = relay.stats()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            kubelet.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            drainer.join(timeout=5)
            relay.stop()
        recorded = json.loads(stats.read_text())
        scopes = relay_stats["hub"]["scopes"]
        return {
            "rc": rc,
            "sequences": sequences,
            "relay_kinds": sorted(scope["kind"] for scope in scopes.values()),
            "one_upstream_a_scope": all(
                scope["upstream_watches_opened"] == 1 for scope in scopes.values()),
            "frames_via_relay": recorded["relay"]["frames_via_relay"] > 0,
            "fallbacks_to_direct": recorded["relay"]["fallbacks_to_direct"],
        }


def test_watch_roll_through_a_relay_matches_the_jax_command(tmp_path):
    outcomes = {name: _relay_roll(name, tmp_path) for name in RELAY_SIDES}
    assert outcomes["port"] == outcomes["jax"]
    got = outcomes["port"]
    assert got["rc"] == 0 and got["one_upstream_a_scope"] and got["frames_via_relay"]
    assert got["relay_kinds"] == ["ControllerRevision", "DaemonSet", "Node", "Pod"]
    assert got["fallbacks_to_direct"] == 0
    assert all(seq[-1] == "upgrade-done" for seq in got["sequences"].values())
