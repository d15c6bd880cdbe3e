"""The port's chaos harness against the JAX package's: the fault points,
the registry and the scheduled hub lag.

Each case of ``tests/test_chaos.py``'s ``TestFaultPoints`` and
``TestRegistry``, and the three cases of ``tests/test_watchhub.py``'s
``TestHubUnderScheduledLag`` (seeds 101 to 103), runs with the JAX
package's harness and then with the port's (``testing/chaos.py``), never
both at once: each package has its own ``utils.faultpoints`` registry.
The JAX case's checks hold on both sides. A case that runs a schedule
holds the port's run to the JAX run of the same schedule: the schedule's
JSON byte for byte, the step trace, the fires, the violations (all zero),
convergence, the completeness aborts, the asynchronous points engaged and
the final digest. A case that drives one site by hand compares what each
side observed. The determinism, corpus and policy-matrix cases and the
port's command are in ``tests/test_torch_chaos_corpus.py``.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import pytest

from k8s_operator_libs_tpu import api as jax_api
from k8s_operator_libs_tpu import fleet as jax_fleet
from k8s_operator_libs_tpu import kube as jax_kube
from k8s_operator_libs_tpu.kube import client as jax_client
from k8s_operator_libs_tpu.kube import objects as jax_objects
from k8s_operator_libs_tpu.testing import chaos as jax_chaos
from k8s_operator_libs_tpu.utils import faultpoints as jax_faultpoints
from k8s_operator_libs_tpu_torch import api as port_api
from k8s_operator_libs_tpu_torch import fleet as port_fleet
from k8s_operator_libs_tpu_torch import kube as port_kube
from k8s_operator_libs_tpu_torch.kube import client as port_client
from k8s_operator_libs_tpu_torch.kube import objects as port_objects
from k8s_operator_libs_tpu_torch.testing import chaos as port_chaos
from k8s_operator_libs_tpu_torch.utils import faultpoints as port_faultpoints


def _pkg(chaos, faultpoints, kube, objects, client, api, fleet):
    return SimpleNamespace(
        chaos=chaos, faultpoints=faultpoints, FakeCluster=kube.FakeCluster,
        Informer=kube.Informer, LeaderElector=kube.LeaderElector,
        LeaderElectionConfig=kube.LeaderElectionConfig, WatchHub=kube.WatchHub,
        Node=objects.Node, KubeObject=objects.KubeObject, ApiError=client.ApiError,
        make_fleet_rollout=api.make_fleet_rollout, pools_in_phase=api.pools_in_phase,
        FleetOrchestrator=fleet.FleetOrchestrator,
    )


PKGS = {
    "jax": _pkg(jax_chaos, jax_faultpoints, jax_kube, jax_objects, jax_client, jax_api,
                jax_fleet),
    "port": _pkg(port_chaos, port_faultpoints, port_kube, port_objects, port_client, port_api,
                 port_fleet),
}

#: What a run must show alike in both packages, besides the schedule bytes.
RUN_FIELDS = ("converged", "steps", "violations", "trace", "fired", "async_engaged",
              "completeness_aborts", "final_digest")


@pytest.fixture(autouse=True)
def _clean_registries():
    """A failed check must not leave a plan or clock in either registry:
    each refuses to stack."""
    yield
    for pkg in PKGS.values():
        pkg.faultpoints.clear_plan()
        pkg.faultpoints.clear_clock()


def schedule_for(pkg, config: dict, faults=None, seed: int = 0):
    """``faults`` None: the schedule the seed draws; else the given specs."""
    c = pkg.chaos
    cfg = c.ChaosConfig(**config)
    if faults is None:
        return c.generate_schedule(seed, cfg)
    return c.FaultSchedule(seed=seed, config=cfg, faults=[c.FaultSpec(**f) for f in faults])


def assert_same_run(jax_result, port_result) -> None:
    assert port_result.schedule_json == jax_result.schedule_json
    for name in RUN_FIELDS:
        assert getattr(port_result, name) == getattr(jax_result, name), name


def held_to_jax(config: dict, faults=None, seed: int = 0):
    """Run one schedule with the JAX harness, then with the port's; the
    port's run equals the JAX run. Returns both results."""
    jax_result = jax_chaos.run_schedule(schedule_for(PKGS["jax"], config, faults, seed))
    port_result = port_chaos.run_schedule(schedule_for(PKGS["port"], config, faults, seed))
    assert_same_run(jax_result, port_result)
    return jax_result, port_result


def install(pkg, config: dict, faults, step: int):
    plan = pkg.chaos.FaultPlan(schedule_for(pkg, config, faults))
    plan.begin_step(step)
    pkg.faultpoints.install_plan(plan)
    return plan


def on_both(case):
    """Run ``case(pkg)`` with the JAX package, then the port; the two
    observations must be equal. Returns the port's."""
    seen = {}
    for name, pkg in PKGS.items():
        try:
            seen[name] = case(pkg)
        finally:
            pkg.faultpoints.clear_plan()
            pkg.faultpoints.clear_clock()
    assert seen["port"] == seen["jax"]
    return seen["port"]


def wait_for(predicate, what: str, timeout: float = 5.0) -> None:
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# TestFaultPoints: the sites driven by hand
# ---------------------------------------------------------------------------


def test_lease_fault_denies_the_protocol_round():
    """``lease.round``: an armed schedule fails the round with no Lease
    write; another shard's Lease acquires; disarmed, the elector
    acquires."""
    def case(p):
        cluster = p.FakeCluster()

        def elector(name):
            return p.LeaderElector(cluster, p.LeaderElectionConfig(
                name=name, namespace="kube-system", identity="w0"))

        held = elector("fleet-shard-00")
        plan = install(p, {}, [dict(step=5, point="lease", duration=3,
                                    target="fleet-shard-00")], step=5)
        denied = held.try_acquire_or_renew()
        assert denied is False
        assert plan.fired["lease"] == 1
        assert cluster.get_or_none("Lease", "fleet-shard-00", "kube-system") is None
        other = elector("fleet-shard-01").try_acquire_or_renew()
        assert other is True
        plan.begin_step(8)
        healed = held.try_acquire_or_renew()
        assert healed is True
        return denied, dict(plan.fired), other, healed

    on_both(case)


def test_grant_write_fault_fires_in_the_orchestrator():
    """``fleet.grant_write``: with a conflict armed the round is lost and
    the ledger stays put; healed, it grants."""
    def case(p):
        cluster = p.FakeCluster()
        cluster.create(p.KubeObject(p.make_fleet_rollout("roll", ["p0", "p1"], 1)))
        plan = install(p, {}, [dict(step=0, point="grant_write", duration=1,
                                    error="conflict")], step=0)
        orch = p.FleetOrchestrator(cluster, "roll")
        lost = orch.tick()
        assert lost == {"error": "conflict"}
        assert plan.fired["grant_write"] >= 1
        raw = cluster.get("FleetRollout", "roll").raw
        assert p.pools_in_phase(raw, "granted") == []
        plan.begin_step(1)
        granted = orch.tick()["granted"]
        assert granted == 1
        return lost, dict(plan.fired), granted

    on_both(case)


def test_watch_hold_lags_exactly_the_targeted_informer():
    """``watch.deliver`` holds one tagged informer: its store lags while a
    peer of the same kind stays current, and the heal releases the
    event."""
    def case(p):
        cluster = p.FakeCluster()
        held = p.Informer(cluster, "Node")
        held.chaos_tag = "w0"
        peer = p.Informer(cluster, "Node")
        peer.chaos_tag = "w1"
        plan = install(p, {}, [dict(step=1, point="watch", duration=1, target="w0",
                                    param="Node")], step=1)
        with held, peer:
            held.wait_for_sync(5)
            peer.wait_for_sync(5)
            cluster.create(p.Node.new("n0"))
            wait_for(lambda: peer.get("n0") is not None, "peer never caught up")
            lagged = held.get("n0") is None
            assert lagged, "the held informer saw the event through the hold"
            plan.begin_step(2)
            wait_for(lambda: held.get("n0") is not None, "the heal never released the hold")
        return lagged, plan.fired.get("watch", 0) >= 1

    on_both(case)


def test_hub_overflow_forces_the_stale_resume_path():
    """``watchhub.deliver`` overflow: the subscriber's buffer is dropped
    mid-stream and it resumes from the hub's journal with no event lost."""
    def case(p):
        cluster = p.FakeCluster()
        for i in range(3):
            cluster.create(p.Node.new(f"seed-{i}"))
        hub = p.WatchHub(cluster, idle_linger_s=0.0)
        plan = install(p, {}, [dict(step=2, point="hub_replay", duration=1, param="Node",
                                    count=1)], step=0)
        got: list[str] = []
        done = threading.Event()

        def consume():
            rv = cluster.current_resource_version()
            for event_type, obj in hub.watch("Node", resource_version=rv, timeout_seconds=30):
                if event_type == "BOOKMARK":
                    continue
                got.append(obj.name)
                if len(got) >= 6:
                    done.set()
                    return

        thread = threading.Thread(target=consume, daemon=True)
        thread.start()
        with hub:
            for i in range(3):
                cluster.create(p.Node.new(f"pre-{i}"))
            wait_for(lambda: len(got) >= 3, f"subscriber never saw {got}")
            plan.begin_step(2)
            for i in range(3):
                cluster.create(p.Node.new(f"post-{i}"))
            assert done.wait(10), f"subscriber stalled after {got}"
        thread.join(5)
        assert got == [f"pre-{i}" for i in range(3)] + [f"post-{i}" for i in range(3)]
        assert plan.fired.get("hub_replay", 0) >= 1
        return list(got)

    on_both(case)


def test_partition_blackholes_one_identity():
    """``wire.partition`` blackholes exactly the targeted client, the
    verbs the base client does not declare (``update_status``) too; heal
    restores it."""
    def case(p):
        cluster = p.FakeCluster()
        cluster.create(p.Node.new("n0"))
        cut = p.chaos.PartitionedClient(cluster, "w0")
        ok = p.chaos.PartitionedClient(cluster, "w1")
        plan = install(p, {}, [dict(step=3, point="partition", duration=2, target="w0")],
                       step=3)
        errors = []
        for call in (lambda: cut.get("Node", "n0"),
                     lambda: cut.update_status(cluster.get("Node", "n0"))):
            with pytest.raises(p.ApiError, match="partition") as info:
                call()
            errors.append(str(info.value))
        assert ok.get("Node", "n0").name == "n0"
        assert plan.fired["partition"] == 2
        plan.begin_step(5)
        assert cut.get("Node", "n0").name == "n0"
        return errors, dict(plan.fired), sorted(p.chaos.PartitionedClient._INTERCEPTED)

    on_both(case)


# ---------------------------------------------------------------------------
# TestFaultPoints: the sites under a schedule, each run held to the JAX run
# ---------------------------------------------------------------------------


def _alive_sets(result) -> list[tuple]:
    return [tuple(t["alive"]) for t in result.trace]


def test_status_write_fault_fires_in_the_done_report():
    for result in held_to_jax(
        dict(pools=4, workers=2, shards=2, fault_window=20),
        [dict(step=4, point="status_write", duration=6, error="server_timeout")],
    ):
        assert result.fired.get("status_write", 0) >= 1, "dead schedule"
        assert result.converged and result.total_violations == 0


@pytest.mark.parametrize("point", ["worker_kill", "sigterm"])
def test_permanent_exit_fails_over_and_converges(point):
    """``worker_kill`` (the crash: ``test_worker_kill_fails_over_and_converges``)
    and ``sigterm`` (the graceful stop:
    ``test_sigterm_graceful_handoff_converges``), neither restarted: the
    survivor takes w0's shards and the roll converges within budget."""
    for result in held_to_jax(
        dict(pools=6, workers=2, shards=2, fault_window=30),
        [dict(step=6, point=point, duration=1, target="w0", param="perma")],
    ):
        assert result.fired.get(point) == 1
        assert result.converged, result.summary()
        for kind in ("budget", "grant_retired_unrolled", "node_lost_or_cordoned"):
            assert result.violations[kind] == 0
        assert result.total_violations == 0, result.summary()
        assert [t for t in result.trace if t["alive"] == ["w1"]], "w0 was never down"


@pytest.mark.parametrize("point", ["worker_kill", "sigterm"])
def test_restarted_worker_rejoins_the_fleet(point):
    """``test_worker_restart_resumes_the_same_identity`` and
    ``test_sigterm_restart_rejoins_the_fleet``: w1 leaves at step 5 and
    is back at step 13."""
    for result in held_to_jax(
        dict(pools=4, workers=2, shards=2, fault_window=30),
        [dict(step=5, point=point, duration=8, target="w1", param="restart")],
    ):
        assert result.converged and result.total_violations == 0
        alive = _alive_sets(result)
        assert ("w0",) in alive, "w1 was never down"
        assert alive[-1] == ("w0", "w1"), "w1 never came back"


def test_sigterm_schedule_is_deterministic():
    """The graceful exit's run, twice on the port, once on JAX: the same
    trace, fires and digest each time."""
    config = dict(pools=4, workers=2, shards=2, fault_window=30)
    faults = [dict(step=4, point="sigterm", duration=6, target="w0", param="restart")]
    jax_result, first = held_to_jax(config, faults)
    second = port_chaos.run_schedule(schedule_for(PKGS["port"], config, faults))
    assert first.converged and second.converged and jax_result.converged
    assert first.trace == second.trace
    assert first.final_digest == second.final_digest
    assert first.fired == second.fired


@pytest.mark.parametrize("point,config,faults", [
    ("wire_kill", dict(wire=True),
     [dict(step=5, point="wire_kill", duration=1)]),
    ("relay_kill", dict(relay=True),
     [dict(step=5, point="relay_kill", duration=1)]),
    ("replica_failover", dict(wire=True, replicas=2),
     [dict(step=5, point="replica_failover", duration=4, target="1")]),
], ids=["wire_kill", "relay_kill", "replica_failover"])
def test_wire_points_fire_and_converge(point, config, faults):
    """``test_wire_kill_fires_against_a_real_server``,
    ``test_relay_kill_degrades_to_direct_and_converges`` and
    ``test_replica_failover_mid_roll_converges``: each driver point fires
    against the port's own server, relay or replica, and the roll
    converges with no violation."""
    for result in held_to_jax(dict(pools=4, workers=2, shards=2, fault_window=20, **config),
                              faults):
        if point == "replica_failover":
            assert result.fired.get(point, 0) == 1
        else:
            assert result.fired.get(point, 0) >= 1, "dead fault"
        assert result.converged and result.total_violations == 0


def test_generate_schedule_draws_sigterm():
    cfg = dict(pools=4, workers=2, shards=2)
    drawn = []
    for seed in range(80):
        texts = {n: schedule_for(p, cfg, seed=seed) for n, p in PKGS.items()}
        assert texts["port"].to_json() == texts["jax"].to_json()
        drawn += [s for s in texts["port"].faults if s.point == "sigterm"]
    assert drawn, "no seed in 0..79 drew a sigterm fault"
    for spec in drawn:
        assert spec.target in ("w0", "w1")
        assert spec.param in ("perma", "restart")


def test_generate_schedule_draws_the_relay_and_replica_points():
    relay_cfg = dict(pools=4, relay=True)
    wire_cfg = dict(pools=4, wire=True, replicas=2)
    drew_relay = drew_failover = False
    for seed in range(40):
        for cfg in (relay_cfg, wire_cfg):
            text = schedule_for(PKGS["jax"], cfg, seed=seed).to_json()
            sched = schedule_for(PKGS["port"], cfg, seed=seed)
            assert sched.to_json() == text
            assert port_chaos.FaultSchedule.from_json(text).to_json() == text
            drew_relay = drew_relay or any(f.point == "relay_kill" for f in sched.faults)
            drew_failover = drew_failover or any(
                f.point == "replica_failover" for f in sched.faults)
    assert drew_relay and drew_failover
    for seed in range(40):
        base = schedule_for(PKGS["port"], dict(pools=4), seed=seed)
        assert base.to_json() == schedule_for(PKGS["jax"], dict(pools=4), seed=seed).to_json()
        assert not any(f.point in ("relay_kill", "replica_failover") for f in base.faults)


# ---------------------------------------------------------------------------
# TestHubUnderScheduledLag (tests/test_watchhub.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,overflow_step,duration", [
    (101, 3, 2),    # the first grant burst
    (102, 12, 3),   # mid-roll churn
    (103, 22, 2),   # completion-report window
])
def test_hub_overflow_during_grant_write_converges(seed, overflow_step, duration):
    for result in held_to_jax(
        dict(pools=6, workers=2, shards=2, hub=True, fault_window=40),
        [dict(step=overflow_step, point="hub_replay", duration=duration, count=2),
         dict(step=overflow_step, point="grant_write", duration=1, error="conflict",
              count=1)],
        seed=seed,
    ):
        assert result.converged, f"seed {seed} never converged"
        assert result.total_violations == 0, result.violations
        assert result.async_engaged["hub_replay"], "dead schedule"


# ---------------------------------------------------------------------------
# TestRegistry
# ---------------------------------------------------------------------------


def test_plans_do_not_stack():
    def case(p):
        plan = install(p, {}, [dict(step=0, point="lease")], step=0)
        with pytest.raises(RuntimeError, match="already installed"):
            p.faultpoints.install_plan(object())
        p.faultpoints.clear_plan()
        p.faultpoints.install_plan(plan)
        return p.faultpoints.fault_point("lease.round", name="x").kind

    assert on_both(case) == "deny"


def test_no_plan_means_no_behavior_change():
    def case(p):
        p.faultpoints.clear_plan()
        assert p.faultpoints.fault_point("lease.round", name="x") is None
        before = time.time()
        assert abs(p.faultpoints.wall_now() - before) < 5.0
        return True

    on_both(case)


def test_clock_drives_wall_now():
    """The port's ``ChaosClock`` reads as the JAX one: its start times,
    ``advance``, and ``wall_now``/``mono_now`` while installed."""
    def case(p):
        default = p.faultpoints.ChaosClock()
        clock = p.faultpoints.ChaosClock(wall_start=123.0)
        p.faultpoints.install_clock(clock)
        readings = [default.now(), default.wall(), p.faultpoints.wall_now()]
        clock.advance(7.0)
        readings += [p.faultpoints.wall_now(), clock.now()]
        assert readings[2:4] == [123.0, 130.0]
        p.faultpoints.clear_clock()
        return readings

    assert on_both(case) == [100.0, 1_700_000_000.0, 123.0, 130.0, 107.0]
    clock = port_faultpoints.ChaosClock()
    port_faultpoints.install_clock(clock)
    clock.advance(2.5)
    assert port_faultpoints.mono_now() == 102.5


def test_harness_rolls_back_only_its_own_installs():
    """A run refused by the no-stacking rule leaves the owner's clock and
    rolls back its own plan; the other package's registry is untouched
    throughout."""
    def case(p):
        mine = p.faultpoints.ChaosClock(wall_start=55.0)
        p.faultpoints.install_clock(mine)
        with pytest.raises(RuntimeError, match="already installed"):
            p.chaos.run_schedule(schedule_for(p, dict(pools=2, workers=1, shards=1)))
        assert p.faultpoints.wall_now() == 55.0
        assert p.faultpoints.fault_point("lease.round", name="x") is None
        other = PKGS["jax" if p is PKGS["port"] else "port"].faultpoints
        assert other.fault_point("lease.round", name="x") is None
        assert abs(other.wall_now() - time.time()) < 5.0
        p.faultpoints.clear_clock()
        return True

    on_both(case)


#: Threads a run may leave behind: each package's wire client loop is one
#: daemon thread a process, shared by every ``RestClient``. The JAX relay's
#: ``stop`` closes its listener without waking the thread blocked in its
#: ``accept()`` (ROADMAP queue C, C19); the port's shuts the listener down
#: first, so its accept thread ends.
LEFT_BY_DESIGN = {
    "jax": {"kube-wire-client", "watch-relay-accept"},
    "port": {"kube-wire-client"},
}


def test_each_harness_tears_down_its_own_threads_and_installs():
    """A JAX run, then a port run, in one process: after each, neither
    registry holds a plan or a clock, and the threads the run started (its
    informers, hub, relay, server and replicas) have ended."""
    config = dict(pools=4, workers=2, shards=2, fault_window=10, hub=True, wire=True,
                  relay=True, replicas=1)
    for name, pkg in PKGS.items():
        before = set(threading.enumerate())
        result = pkg.chaos.run_schedule(schedule_for(pkg, config, seed=3))
        assert result.converged and result.total_violations == 0, (name, result.summary())
        for each in PKGS.values():
            assert each.faultpoints.fault_point("lease.round", name="x") is None
            assert abs(each.faultpoints.wall_now() - time.time()) < 5.0

        def left():
            return {t.name for t in threading.enumerate()
                    if t not in before and t.is_alive()} - LEFT_BY_DESIGN[name]

        wait_for(lambda: not left(), f"{name} left threads running", timeout=10.0)
