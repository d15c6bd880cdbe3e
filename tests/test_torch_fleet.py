"""The port's fleet tier against the JAX package's, case by case.

Every case of ``tests/test_fleet.py`` (the hash ring, the shard scope, the
health fold, the orchestrator, the fleet roll and the done report's
safety), of ``tests/test_api_types.py::TestFleetRollout`` and of
``tests/test_link_health.py``'s ``TestFleetLinkFold`` and
``TestFleetMetricsFamily`` runs once with each package on twin clusters:
the JAX fleet on a ``FakeCluster``, the port's over its ``RestClient`` at a
``LocalApiServer`` serving another ``FakeCluster`` seeded the same (the
JAX ``DaemonSetSimulator`` plays the kubelets of both). Each run makes the
JAX case's checks and returns what it observed: the grants in order, the
budget in use, each node's state and cordon bit, the Lease holders and the
ledger's status; the two packages' observations must be equal. The
workers run on one virtual clock a side, advanced 0.6 s an iteration, as
in the JAX file; the informers deliver in real time, so the number of
iterations a roll takes is not compared.
"""

from __future__ import annotations

import contextlib
import itertools
import time
import urllib.request
from types import SimpleNamespace

import pytest

from builders import make_node
from k8s_operator_libs_tpu import api as jax_api
from k8s_operator_libs_tpu import fleet as jax_fleet
from k8s_operator_libs_tpu import upgrade as jax_upgrade
from k8s_operator_libs_tpu.api import telemetry_v1alpha1 as jax_telemetry
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer, Node
from k8s_operator_libs_tpu.kube.client import ApiError as JaxApiError
from k8s_operator_libs_tpu.kube.client import ConflictError as JaxConflictError
from k8s_operator_libs_tpu.kube.objects import KubeObject
from k8s_operator_libs_tpu.kube.resources import resource_for_kind as jax_resource_for_kind
from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator
from k8s_operator_libs_tpu.upgrade.health_source import HealthSource as JaxHealthSource
from k8s_operator_libs_tpu.upgrade.requestor import RequestorOptions as JaxRequestorOptions
from k8s_operator_libs_tpu.upgrade.requestor import enable_requestor_mode as jax_requestor
from k8s_operator_libs_tpu.utils import IntOrString as JaxIntOrString
from k8s_operator_libs_tpu_torch import api as port_api
from k8s_operator_libs_tpu_torch import fleet as port_fleet
from k8s_operator_libs_tpu_torch import upgrade as port_upgrade
from k8s_operator_libs_tpu_torch.api import fleet_v1alpha1 as port_fleet_v1
from k8s_operator_libs_tpu_torch.api import telemetry_v1alpha1 as port_telemetry
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from k8s_operator_libs_tpu_torch.kube.client import ApiError
from k8s_operator_libs_tpu_torch.kube.resources import resource_for_kind
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.upgrade.health_source import HealthSource
from k8s_operator_libs_tpu_torch.upgrade.requestor import RequestorOptions
from k8s_operator_libs_tpu_torch.upgrade.requestor import enable_requestor_mode
from k8s_operator_libs_tpu_torch.utils.intstr import IntOrString

NS = "driver-ns"
LABELS = {"app": "driver"}
ROLLOUT = "fleet-roll"
#: The JAX file's policy: the grant is the budget.
POLICY = {"autoUpgrade": True, "maxParallelUpgrades": 0, "maxUnavailable": "100%"}
SICK = {"ok": True, "latency_s": 5.0, "gbytes_per_s": 1.0}

PKGS = {
    "jax": SimpleNamespace(
        fleet=jax_fleet, api=jax_api, upgrade=jax_upgrade, telemetry=jax_telemetry,
        HealthSource=JaxHealthSource, policy=jax_api.DriverUpgradePolicySpec.from_dict(POLICY),
        errors=(JaxApiError, jax_upgrade.BuildStateError), IntOrString=JaxIntOrString,
        RequestorOptions=JaxRequestorOptions, enable_requestor_mode=jax_requestor,
        device=jax_upgrade.DeviceClass.nvidia("gpu"),
    ),
    "port": SimpleNamespace(
        fleet=port_fleet, api=port_api, upgrade=port_upgrade, telemetry=port_telemetry,
        HealthSource=HealthSource, policy=DriverUpgradePolicySpec.from_dict(POLICY),
        errors=(ApiError, port_upgrade.BuildStateError), IntOrString=IntOrString,
        RequestorOptions=RequestorOptions, enable_requestor_mode=enable_requestor_mode,
        device=port_upgrade.DeviceClass.nvidia("gpu"),
    ),
}
KEYS = port_upgrade.UpgradeKeys(PKGS["port"].device)
assert KEYS.state_label == jax_upgrade.UpgradeKeys(PKGS["jax"].device).state_label


def pool_of(node_name: str) -> str:
    return node_name.split("-")[0]


class Clock:
    def __init__(self, start: float = 100.0) -> None:
        self.t = start

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class ServerTimeoutError(JaxApiError):
    """A 504-shaped transient failure of the API server."""


class Flaky:
    """A reactor failing the next ``times`` matching calls, then passing."""

    def __init__(self, exc_type, times=3):
        self.exc_type = exc_type
        self.remaining = times
        self.fired = 0

    def __call__(self, verb, kind, payload):
        if self.remaining > 0:
            self.remaining -= 1
            self.fired += 1
            raise self.exc_type(f"injected {self.exc_type.__name__}")


class Side:
    """One package's side: a ``FakeCluster`` and the client its fleet runs
    over (the cluster itself for ``jax``, a ``RestClient`` at a server of
    it for ``port``)."""

    def __init__(self, name: str, stack: contextlib.ExitStack,
                 cluster: FakeCluster | None = None) -> None:
        self.name = name
        self.pkg = PKGS[name]
        self.cluster = cluster if cluster is not None else FakeCluster()
        if name == "port":
            server = stack.enter_context(LocalApiServer(cluster=self.cluster))
            self.client = RestClient(RestConfig(server=server.url))
            stack.callback(self.client.close)
        else:
            self.client = self.cluster
        self.stack = stack


def on_both(case, **kwargs):
    """``case(side)`` on each package's side; equal observations."""
    outcomes = {}
    for name in PKGS:
        with contextlib.ExitStack() as stack:
            outcomes[name] = case(Side(name, stack, **kwargs))
    assert outcomes["port"] == outcomes["jax"]
    return outcomes["port"]


def build_fleet(side, pools=8, hosts=2, budget="25%"):
    cluster = side.cluster
    pool_names = [f"p{i}" for i in range(pools)]
    for pool in pool_names:
        for h in range(hosts):
            node = Node.new(f"{pool}-h{h}")
            node.set_ready(True)
            cluster.create(node)
    sim = DaemonSetSimulator(cluster, name="driver", namespace=NS, match_labels=LABELS)
    sim.settle()
    cluster.create(KubeObject(side.pkg.api.make_fleet_rollout(ROLLOUT, pool_names, budget)))
    return sim, pool_names


def make_worker(side, clock, identity, workers, shards=2, **overrides):
    kwargs = dict(
        identity=identity, shards=shards, namespace=NS, driver_labels=LABELS, pool_of=pool_of,
        rollout_name=ROLLOUT, workers=tuple(workers), lease_duration_s=3.0,
        renew_deadline_s=2.0, retry_period_s=0.5, device=side.pkg.device,
    )
    kwargs.update(overrides)
    fleet = side.pkg.fleet
    worker = fleet.ShardWorker(side.client, fleet.FleetWorkerConfig(**kwargs),
                               now_fn=clock.now, wall_fn=clock.now)
    worker.start(sync_timeout=10)
    side.stack.callback(worker.stop)
    return worker


def node_state(cluster, name: str):
    raw = cluster.peek("Node", name) or {}
    return ((raw.get("metadata") or {}).get("labels") or {}).get(KEYS.state_label)


def disrupted_pools(cluster) -> set[str]:
    out = set()
    for obj in cluster.list("Node"):
        node = Node(obj.raw)
        if node.unschedulable or not node.is_ready():
            out.add(pool_of(node.name))
    return out


def ledger(cluster) -> dict:
    """Each spec pool's status entry, and the grants issued."""
    raw = cluster.peek("FleetRollout", ROLLOUT) or {}
    status = raw.get("status") or {}
    return {"pools": status.get("pools") or {}, "grantsIssued": status.get("grantsIssued")}


def nodes_view(cluster) -> dict:
    return {o.name: (node_state(cluster, o.name), bool(Node(o.raw).unschedulable))
            for o in cluster.list("Node")}


def lease_holders(cluster) -> dict:
    return {o.name: (o.raw.get("spec") or {}).get("holderIdentity") or ""
            for o in cluster.list("Lease")}


def drive_fleet(side, sim, orch, workers, clock, pool_names, budget, max_iters=400,
                mid_roll_hook=None):
    """Tick the simulator, the orchestrator and the workers until the
    ledger says every pool is done, sampling the global budget every
    iteration; (iterations, violations)."""
    cluster = side.cluster
    violations = 0
    raw = {}
    for i in range(max_iters):
        if mid_roll_hook is not None:
            workers = mid_roll_hook(i, workers) or workers
        sim.step()
        orch.tick()
        for worker in workers:
            try:
                worker.tick(side.pkg.policy)
            except side.pkg.errors:
                pass  # a pass aborts; the next resumes from the labels
        sim.step()
        if len(disrupted_pools(cluster)) > budget:
            violations += 1
        clock.advance(0.6)
        try:
            raw = cluster.peek("FleetRollout", ROLLOUT) or {}
        except JaxApiError:
            continue
        if len(jax_api.pools_in_phase(raw, "done")) == len(pool_names):
            return i + 1, violations
    raise AssertionError(f"{side.name}: fleet roll did not converge in {max_iters} iterations "
                         f"(done={len(jax_api.pools_in_phase(raw, 'done'))}/{len(pool_names)})")


def assert_fleet_converged(side, sim):
    assert sim.all_pods_ready_and_current()
    for obj in side.cluster.list("Node"):
        assert node_state(side.cluster, obj.name) == "upgrade-done"
        assert not Node(obj.raw).unschedulable


def roll_outcome(side, workers, violations) -> dict:
    return {
        "violations": violations,
        "ledger": ledger(side.cluster),
        "nodes": nodes_view(side.cluster),
        "owned": [sorted(w.owned_shards()) for w in workers],
        "reported": [w.pools_reported_done for w in workers],
        "leases": lease_holders(side.cluster),
    }


# ---------------------------------------------------------------------------
# The FleetRollout contract
# ---------------------------------------------------------------------------


class TestFleetRollout:
    @staticmethod
    def run(case):
        outcomes = {name: case(PKGS[name]) for name in PKGS}
        assert outcomes["port"] == outcomes["jax"]

    def test_round_trip(self):
        def case(pkg):
            Spec = pkg.api.FleetRolloutSpec
            spec = Spec(pools=["p0", "p1", "p2"], max_unavailable_pools=pkg.IntOrString("50%"))
            assert Spec.from_dict(spec.to_dict()) == spec
            unlimited = Spec.from_dict({"pools": ["a", "b"], "maxUnavailablePools": None})
            assert unlimited.max_unavailable_pools is None
            assert unlimited.resolved_budget() == 2
            assert Spec.from_dict(unlimited.to_dict()) == unlimited
            defaulted = Spec.from_dict({"pools": ["a"]})
            assert defaulted.max_unavailable_pools == pkg.IntOrString("25%")
            with_policy = Spec.from_dict({"pools": ["a", {"name": "b", "policy": ["cost-tier"]}]})
            return [spec.to_dict(), unlimited.to_dict(), defaulted.to_dict(),
                    with_policy.to_dict(), with_policy.policy_for("b")]

        self.run(case)

    def test_resolved_budget(self):
        def case(pkg):
            Spec = pkg.api.FleetRolloutSpec
            spec = Spec.from_dict({"pools": [f"p{i}" for i in range(64)]})
            assert spec.resolved_budget() == 16
            tiny = Spec.from_dict({"pools": ["a", "b"], "maxUnavailablePools": "10%"})
            assert tiny.resolved_budget() == 1
            absolute = Spec.from_dict({"pools": ["a", "b"], "maxUnavailablePools": 50})
            assert absolute.resolved_budget() == 2
            return [spec.resolved_budget(), tiny.resolved_budget(), absolute.resolved_budget()]

        self.run(case)

    def test_validation(self):
        def case(pkg):
            Spec = pkg.api.FleetRolloutSpec
            errors = []
            for pools in ([], ["a", "a"], ["a", ""]):
                with pytest.raises(ValueError) as exc:
                    Spec(pools=pools)
                errors.append(str(exc.value))
            with pytest.raises(ValueError) as exc:
                Spec(pools=["a"], pool_policies={"b": ("cost-tier",)})
            errors.append(str(exc.value))
            return errors

        self.run(case)

    def test_ledger_phases(self):
        def case(pkg):
            api = pkg.api
            raw = api.make_fleet_rollout("roll", ["a", "b"], "25%")
            assert api.pool_phase(raw, "a") == "pending"
            assert api.set_pool_phase(raw, "a", "granted", grantedSeq=1)
            assert not api.set_pool_phase(raw, "a", "granted"), "no-op re-set"
            assert api.pools_in_phase(raw, "granted") == ["a"]
            api.set_pool_phase(raw, "ghost", "granted")
            assert api.pools_in_phase(raw, "granted") == ["a"]
            with pytest.raises(ValueError):
                api.set_pool_phase(raw, "a", "nonsense")
            return raw

        self.run(case)

    def test_registry_matches_contract(self):
        info = jax_resource_for_kind(port_fleet_v1.FLEET_ROLLOUT_KIND)
        port = resource_for_kind(port_fleet_v1.FLEET_ROLLOUT_KIND)
        assert (port.api_version, port.plural, port.namespaced) == (
            info.api_version, info.plural, info.namespaced
        ) == (port_fleet_v1.FLEET_ROLLOUT_API_VERSION, port_fleet_v1.FLEET_ROLLOUT_PLURAL, False)
        # The JAX and the port's objects round-trip the same dict.
        policies = {"p1": ["cost-tier"]}
        jax_raw = jax_api.make_fleet_rollout("roll", ["p0", "p1"], 1, policies)
        port_raw = port_api.make_fleet_rollout("roll", ["p0", "p1"], 1, policies)
        assert port_raw == jax_raw
        assert port_api.rollout_spec(jax_raw).to_dict() == jax_api.rollout_spec(port_raw).to_dict()


# ---------------------------------------------------------------------------
# The hash ring
# ---------------------------------------------------------------------------


class TestHashRing:
    KEYS = [f"pool-{i}" for i in range(96)]

    @staticmethod
    def run(case):
        outcomes = {name: case(PKGS[name].fleet.HashRing) for name in PKGS}
        assert outcomes["port"] == outcomes["jax"]

    def test_deterministic_across_instances(self):
        def case(HashRing):
            a = HashRing(["w1", "w2", "w3"])
            b = HashRing(["w3", "w1", "w2"])
            owners = [a.owner(k) for k in self.KEYS]
            assert owners == [b.owner(k) for k in self.KEYS]
            return owners

        self.run(case)

    def test_every_member_owns_keys(self):
        def case(HashRing):
            assignment = HashRing(["w1", "w2", "w3", "w4"]).assignment(self.KEYS)
            assert set(assignment) == {"w1", "w2", "w3", "w4"}
            assert all(owned for owned in assignment.values())
            return dict(assignment)

        self.run(case)

    def test_add_moves_only_keys_to_the_new_member(self):
        def case(HashRing):
            ring = HashRing(["w1", "w2", "w3"])
            before = {k: ring.owner(k) for k in self.KEYS}
            ring.add("w4")
            moved = {k: (before[k], ring.owner(k)) for k in self.KEYS
                     if ring.owner(k) != before[k]}
            assert moved and all(new == "w4" for _, new in moved.values())
            assert len(moved) < len(self.KEYS) / 2
            return moved

        self.run(case)

    def test_remove_moves_only_the_removed_members_keys(self):
        def case(HashRing):
            ring = HashRing(["w1", "w2", "w3", "w4"])
            before = {k: ring.owner(k) for k in self.KEYS}
            ring.remove("w4")
            for k in self.KEYS:
                if before[k] != "w4":
                    assert ring.owner(k) == before[k]
                else:
                    assert ring.owner(k) != "w4"
            return {k: ring.owner(k) for k in self.KEYS}

        self.run(case)

    def test_empty_ring_raises(self):
        def case(HashRing):
            with pytest.raises(ValueError) as exc:
                HashRing().owner("anything")
            return str(exc.value)

        self.run(case)

    def test_validation(self):
        def case(HashRing):
            with pytest.raises(ValueError) as a:
                HashRing(replicas=0)
            with pytest.raises(ValueError) as b:
                HashRing().add("")
            return [str(a.value), str(b.value)]

        self.run(case)


# ---------------------------------------------------------------------------
# Shard-scoped snapshots
# ---------------------------------------------------------------------------


def _one_worker(side, clock, shards=2, preferred=None):
    return make_worker(side, clock, "w-a", workers=("w-a",), shards=shards,
                       preferred_shards=preferred, rollout_name="")


def _wait_dirty(source, node_name, timeout=5.0):
    """Until the watch thread delivered the node's delta."""
    deadline = time.monotonic() + timeout
    while node_name not in source.dirty().nodes:
        if time.monotonic() > deadline:
            raise AssertionError(f"delta for {node_name} never delivered")
        time.sleep(0.01)


class TestShardScope:
    def test_scoped_worker_touches_only_its_shards(self):
        def case(side):
            sim, pool_names = build_fleet(side)
            cluster = side.cluster
            clock = Clock()
            worker = _one_worker(side, clock)
            first = side.pkg.fleet.shard_id(0)
            worker.config.preferred_shards = None
            second = worker._claims[side.pkg.fleet.shard_id(1)]
            second.preferred = False
            second._probe = 10_000.0
            in_scope = {p for p in pool_names if worker.pool_ring.owner(p) == first}
            assert in_scope and in_scope != set(pool_names)
            sim.set_template_hash("v2")
            for _ in range(120):
                sim.step()
                try:
                    worker.tick(side.pkg.policy)
                except side.pkg.errors:
                    pass  # the caller's loop owns the retry
                sim.step()
                clock.advance(0.6)
                if all(node_state(cluster, f"{p}-h{h}") == "upgrade-done"
                       and cluster.peek("Pod", sim.pod_name(f"{p}-h{h}"), NS)
                       ["metadata"]["labels"]["controller-revision-hash"] == "v2"
                       for p in in_scope for h in range(2)):
                    break
            else:
                raise AssertionError("owned shard never converged")
            for p in set(pool_names) - in_scope:
                for h in range(2):
                    assert node_state(cluster, f"{p}-h{h}") is None
                    raw = cluster.peek("Node", f"{p}-h{h}")
                    assert not (raw.get("spec") or {}).get("unschedulable")
            return {"in_scope": sorted(in_scope), "nodes": nodes_view(cluster),
                    "leases": lease_holders(cluster)}

        on_both(case)

    def test_completeness_invariant_is_shard_scoped(self):
        def case(side):
            sim, pool_names = build_fleet(side)
            cluster = side.cluster
            clock = Clock()
            worker = _one_worker(side, clock)
            second = worker._claims[side.pkg.fleet.shard_id(1)]
            second.preferred = False
            second._probe = 10_000.0
            worker.tick(side.pkg.policy)
            first = side.pkg.fleet.shard_id(0)
            in_scope = next(p for p in pool_names if worker.pool_ring.owner(p) == first)
            out_of_scope = next(p for p in pool_names if worker.pool_ring.owner(p) != first)
            cluster.delete("Pod", sim.pod_name(f"{out_of_scope}-h0"), NS)
            _wait_dirty(worker.source, f"{out_of_scope}-h0")
            worker.mgr.build_state(NS, LABELS)  # no BuildStateError
            cluster.delete("Pod", sim.pod_name(f"{in_scope}-h0"), NS)
            _wait_dirty(worker.source, f"{in_scope}-h0")
            aborts_before = worker.mgr.completeness_aborts_total
            with pytest.raises(side.pkg.upgrade.BuildStateError):
                worker.mgr.build_state(NS, LABELS)
            assert worker.mgr.completeness_aborts_total == aborts_before + 1
            assert (worker.mgr.last_pass_stats.aborted_completeness_races
                    == worker.mgr.completeness_aborts_total)
            return {"in_scope": in_scope, "out_of_scope": out_of_scope,
                    "aborts": worker.mgr.completeness_aborts_total,
                    "scoped_nodes": worker.source.scoped_node_count()}

        on_both(case)

    def test_scope_change_invalidates_baseline(self):
        def case(side):
            build_fleet(side)
            worker = _one_worker(side, Clock())
            worker.tick(side.pkg.policy)
            source = worker.source
            assert not source.dirty().full
            assert source.set_owned_shards(frozenset([side.pkg.fleet.shard_id(0)]))
            assert source.dirty().full, "an ownership change must force a full rebuild"
            assert not source.set_owned_shards(frozenset([side.pkg.fleet.shard_id(0)]))
            return sorted(source.owned_shards())

        on_both(case)


# ---------------------------------------------------------------------------
# The health fold
# ---------------------------------------------------------------------------


def _publish(side, node_name, checks, metrics, **kw):
    side.cluster.create(KubeObject(
        side.pkg.telemetry.make_node_health_report(node_name, checks, metrics, **kw)
    ))


class TestHealthAggregation:
    def test_scoped_source_filters_and_refolds(self):
        def case(side):
            for name in ("p0-h0", "p1-h0", "p2-h0"):
                _publish(side, name, {"ring": True}, {})
            scope = {"p0-h0"}
            source = side.pkg.HealthSource(side.client, node_filter=lambda n: n in scope)
            seen = []
            with source:
                seen.append(sorted(source.snapshot()))
                scope.add("p1-h0")
                source.refold()
                seen.append(sorted(source.snapshot()))
                scope.remove("p0-h0")
                source.refold()
                seen.append(sorted(source.snapshot()))
            assert seen == [["p0-h0"], ["p0-h0", "p1-h0"], ["p1-h0"]]
            return seen

        on_both(case)

    def test_aggregator_folds_worst_member_per_pool(self):
        def case(side):
            _publish(side, "p0-h0", {"ring": True}, {})
            _publish(side, "p0-h1", {"ring": False}, {"probe_latency_s": 300.0})
            _publish(side, "p1-h0", {"ring": True}, {})
            source = side.pkg.HealthSource(side.client)
            with source:
                agg = side.pkg.fleet.FleetHealthAggregator(pool_of)
                agg.add_source(source)
                health = agg.pool_health()
                assert health["p0"][0] < health["p1"][0]
                order = agg.ordered(["p9", "p1", "p0"])
                assert order == ["p0", "p1", "p9"]
            return {"health": health, "order": order}

        on_both(case)


class StubSource:
    def __init__(self, snap):
        self._snap = snap

    def snapshot(self):
        return self._snap


class TestFleetLinkFold:
    @staticmethod
    def run(case):
        outcomes = {name: case(PKGS[name]) for name in PKGS}
        assert outcomes["port"] == outcomes["jax"]

    def test_cross_shard_link_pairs_in_the_merged_fold(self):
        def case(pkg):
            t = pkg.telemetry
            a = t.parse_node_health(t.make_node_health_report(
                "pool-1-n0", {}, {}, links={"pool-2-n0": dict(SICK)}))
            b = t.parse_node_health(t.make_node_health_report("pool-2-n0", {}, {}))
            agg = pkg.fleet.FleetHealthAggregator(pool_of=lambda n: n.rsplit("-n", 1)[0])
            agg.add_source(StubSource({"pool-1-n0": a}))
            agg.add_source(StubSource({"pool-2-n0": b}))
            health = agg.pool_health()
            assert health["pool-1"][0] == 40.0 and health["pool-2"][0] == 40.0
            order = agg.ordered(["pool-3", "pool-2", "pool-1"])
            assert order[-1] == "pool-3"
            return {"health": health, "order": order}

        self.run(case)

    def test_duplicate_node_merges_sicker_links_across_copies(self):
        def case(pkg):
            t = pkg.telemetry
            stale = t.NodeHealth("p1-n0", score=95.0)
            fresh = t.parse_node_health(t.make_node_health_report(
                "p1-n0", {}, {},
                links={"p2-n0": {"ok": False, "latency_s": 0.0, "gbytes_per_s": 0.0}}))
            agg = pkg.fleet.FleetHealthAggregator(pool_of=lambda n: n.rsplit("-n", 1)[0])
            agg.add_source(StubSource({"p1-n0": stale}))
            agg.add_source(StubSource({"p1-n0": fresh}))
            health = agg.pool_health()
            assert health["p1"][0] == 0.0 and health["p2"][0] == 0.0
            return health

        self.run(case)

    def test_strict_pool_mapper_tolerates_device_tag_peers(self):
        def case(pkg):
            t = pkg.telemetry
            report = t.parse_node_health(t.make_node_health_report(
                "n0", {}, {}, links={"device-3": dict(SICK)}))

            def strict_pool_of(name):
                if name.startswith("device-"):
                    raise KeyError(name)
                return "pool-1"

            agg = pkg.fleet.FleetHealthAggregator(pool_of=strict_pool_of)
            agg.add_source(StubSource({"n0": report}))
            assert agg.pool_health() == {"pool-1": (40.0, 0)}
            return agg.pool_health()

        self.run(case)

    def test_mapper_failure_for_a_reported_node_stays_loud(self):
        def case(pkg):
            def broken_pool_of(name):
                raise KeyError(name)

            agg = pkg.fleet.FleetHealthAggregator(pool_of=broken_pool_of)
            agg.add_source(StubSource({"n0": pkg.telemetry.NodeHealth("n0", score=10.0)}))
            with pytest.raises(KeyError) as exc:
                agg.pool_health()
            return str(exc.value)

        self.run(case)


# ---------------------------------------------------------------------------
# The orchestrator
# ---------------------------------------------------------------------------


class TestOrchestrator:
    def test_grants_respect_global_budget(self):
        def case(side):
            build_fleet(side, pools=8, budget="25%")
            orch = side.pkg.fleet.FleetOrchestrator(side.client, ROLLOUT)
            summary = orch.tick()
            assert summary["budget"] == 2 and summary["granted"] == 2
            raw = side.cluster.get("FleetRollout", ROLLOUT).raw
            assert len(jax_api.pools_in_phase(raw, "granted")) == 2
            assert len(jax_api.pools_in_phase(raw, "pending")) == 6
            denials = orch.budget_denials
            second = orch.tick()
            assert orch.grants_issued == 2 and orch.budget_denials > denials
            return {"summaries": [summary, second], "ledger": ledger(side.cluster),
                    "denials": orch.budget_denials, "last": orch.last_summary}

        on_both(case)

    def test_completion_frees_budget(self):
        def case(side):
            build_fleet(side, pools=4, budget=1)
            orch = side.pkg.fleet.FleetOrchestrator(side.client, ROLLOUT)
            orch.tick()
            granted = jax_api.pools_in_phase(side.cluster.get("FleetRollout", ROLLOUT).raw,
                                             "granted")
            assert len(granted) == 1
            obj = side.cluster.get("FleetRollout", ROLLOUT)
            jax_api.set_pool_phase(obj.raw, granted[0], "done")
            side.cluster.update_status(obj)
            orch.tick()
            raw = side.cluster.get("FleetRollout", ROLLOUT).raw
            assert len(jax_api.pools_in_phase(raw, "granted")) == 1
            assert jax_api.pool_phase(raw, granted[0]) == "done"
            return {"grant_order": orch.grant_order, "ledger": ledger(side.cluster)}

        on_both(case)

    def test_degraded_pools_granted_first(self):
        def case(side):
            build_fleet(side, pools=8, budget=2)
            for host in ("p5-h0", "p3-h1"):
                _publish(side, host, {"ring_allreduce": False},
                         {"ring_gbytes_per_s": 1.0, "probe_latency_s": 200.0})
            source = side.pkg.HealthSource(side.client)
            with source:
                agg = side.pkg.fleet.FleetHealthAggregator(pool_of)
                agg.add_source(source)
                orch = side.pkg.fleet.FleetOrchestrator(side.client, ROLLOUT, aggregator=agg)
                orch.tick()
            assert set(orch.grant_order) == {"p3", "p5"}
            return {"grant_order": orch.grant_order, "ledger": ledger(side.cluster)}

        on_both(case)

    def test_stateless_resume(self):
        def case(side):
            build_fleet(side, pools=6, budget=2)
            side.pkg.fleet.FleetOrchestrator(side.client, ROLLOUT).tick()
            first = set(jax_api.pools_in_phase(side.cluster.get("FleetRollout", ROLLOUT).raw,
                                               "granted"))
            second = side.pkg.fleet.FleetOrchestrator(side.client, ROLLOUT)
            summary = second.tick()
            assert summary["granted"] == 2 and not summary["new_grants"]
            raw = side.cluster.get("FleetRollout", ROLLOUT).raw
            assert set(jax_api.pools_in_phase(raw, "granted")) == first
            return {"summary": summary, "ledger": ledger(side.cluster)}

        on_both(case)

    def test_missing_rollout_is_a_noop(self):
        def case(side):
            orch = side.pkg.fleet.FleetOrchestrator(side.client, "nope")
            assert orch.tick() == {"missing": True}
            assert orch.grants_issued == 0
            return [orch.ticks, orch.last_summary]

        on_both(case)


# ---------------------------------------------------------------------------
# The fleet roll
# ---------------------------------------------------------------------------


class TestFleetRoll:
    def test_two_workers_roll_the_fleet_within_budget(self):
        def case(side):
            sim, pool_names = build_fleet(side, pools=8, budget="25%")
            clock = Clock()
            idents = ("w-a", "w-b")
            workers = [make_worker(side, clock, ident, idents) for ident in idents]
            orch = side.pkg.fleet.FleetOrchestrator(side.client, ROLLOUT)
            sim.set_template_hash("v2")
            _, violations = drive_fleet(side, sim, orch, workers, clock, pool_names, budget=2)
            assert violations == 0
            assert_fleet_converged(side, sim)
            assert all(w.passes > 0 for w in workers)
            assert sum(w.pools_reported_done for w in workers) == len(pool_names)
            assert all(w.pools_reported_done > 0 for w in workers)
            owned = [sorted(w.owned_shards()) for w in workers]
            assert sorted(itertools.chain(*owned)) == [side.pkg.fleet.shard_id(i)
                                                        for i in range(2)]
            return dict(roll_outcome(side, workers, violations), grants=orch.grant_order)

        on_both(case)

    def test_worker_crash_mid_roll_fails_over_and_converges(self):
        def case(side):
            sim, pool_names = build_fleet(side, pools=8, budget="25%")
            clock = Clock()
            idents = ("w-a", "w-b")
            workers = [make_worker(side, clock, ident, idents) for ident in idents]
            victim, survivor = workers
            orch = side.pkg.fleet.FleetOrchestrator(side.client, ROLLOUT)
            state = {"killed_at": None}

            def kill_mid_roll(i, active):
                if state["killed_at"] is None and disrupted_pools(side.cluster):
                    victim_pools = {p for p in pool_names
                                    if victim.pool_ring.owner(p) in victim.owned_shards()}
                    if disrupted_pools(side.cluster) & victim_pools:
                        state["killed_at"] = i
                        state["victim_shards"] = victim.owned_shards()
                        return [survivor]
                return active

            sim.set_template_hash("v2")
            _, violations = drive_fleet(side, sim, orch, workers, clock, pool_names, budget=2,
                                        mid_roll_hook=kill_mid_roll)
            assert state["killed_at"] is not None and state["victim_shards"]
            assert violations == 0
            assert_fleet_converged(side, sim)
            shard = side.pkg.fleet.shard_id
            assert survivor.owned_shards() == frozenset([shard(0), shard(1)])
            out = roll_outcome(side, [survivor], violations)
            # The victim's claims still say held (it never ticked again);
            # its Leases passed to the survivor.
            out.update(grants=orch.grant_order, victim_shards=sorted(state["victim_shards"]),
                       victim_reported=victim.pools_reported_done)
            return out

        on_both(case)

    @pytest.mark.parametrize(
        "verb,kind,exc_type",
        [
            (v, k, e)
            for (v, k), e in itertools.product(
                [("update", "Lease"), ("create", "Lease"),
                 ("update_status", "FleetRollout"), ("get", "FleetRollout")],
                [JaxConflictError, ServerTimeoutError],
            )
        ],
        ids=lambda p: getattr(p, "__name__", str(p)),
    )
    def test_fleet_path_survives_transient_faults(self, verb, kind, exc_type):
        def case(side):
            sim, pool_names = build_fleet(side, pools=4, budget=2)
            clock = Clock()
            idents = ("w-a", "w-b")
            workers = [make_worker(side, clock, ident, idents) for ident in idents]
            orch = side.pkg.fleet.FleetOrchestrator(side.client, ROLLOUT)
            fault = Flaky(exc_type, times=4)
            armed = {"at": 0 if verb == "create" else 2, "done": False}

            def arm(i, active):
                if i == armed["at"] and not armed["done"]:
                    armed["done"] = True
                    side.cluster.add_reactor(verb, kind, fault)
                return active

            sim.set_template_hash("v2")
            _, violations = drive_fleet(side, sim, orch, workers, clock, pool_names, budget=2,
                                        mid_roll_hook=arm)
            assert fault.fired > 0, "fault point never exercised"
            assert violations == 0
            assert_fleet_converged(side, sim)
            out = roll_outcome(side, workers, violations)
            out.pop("reported")  # who reports first depends on the faults' timing
            return dict(out, grants=orch.grant_order)

        on_both(case)

    def test_single_worker_owns_everything_without_peers(self):
        def case(side):
            sim, pool_names = build_fleet(side, pools=4, budget="100%")
            clock = Clock()
            worker = make_worker(side, clock, "solo", workers=("solo",), shards=3)
            orch = side.pkg.fleet.FleetOrchestrator(side.client, ROLLOUT)
            sim.set_template_hash("v2")
            _, violations = drive_fleet(side, sim, orch, [worker], clock, pool_names, budget=4)
            shard = side.pkg.fleet.shard_id
            assert worker.owned_shards() == frozenset(shard(i) for i in range(3))
            assert_fleet_converged(side, sim)
            return dict(roll_outcome(side, [worker], violations), grants=orch.grant_order)

        on_both(case)


class TestDoneReportSafety:
    def test_requestor_mode_refuses_grant_gating(self):
        def case(side):
            up = side.pkg.upgrade
            mgr = up.ClusterUpgradeStateManager(side.client, side.pkg.device,
                                                runner=up.TaskRunner(inline=True))
            side.pkg.enable_requestor_mode(mgr, side.pkg.RequestorOptions(
                use_maintenance_operator=True))
            fleet = side.pkg.fleet
            with pytest.raises(ValueError, match="grant gating") as exc:
                fleet.ShardWorker(side.client, fleet.FleetWorkerConfig(
                    identity="x", shards=1, namespace=NS, driver_labels=LABELS,
                    rollout_name=ROLLOUT), manager=mgr)
            return str(exc.value)

        on_both(case)

    def test_stale_revision_view_cannot_retire_a_grant(self):
        def case(side):
            sim, _ = build_fleet(side, pools=4, budget="100%")
            clock = Clock()
            worker = make_worker(side, clock, "solo", workers=("solo",))
            orch = side.pkg.fleet.FleetOrchestrator(side.client, ROLLOUT)
            worker.tick(side.pkg.policy)
            stale = list(worker.source.controller_revisions(NS, LABELS))
            worker.source.controller_revisions = lambda namespace, labels: list(stale)
            sim.set_template_hash("v2")
            orch.tick()
            for _ in range(6):
                clock.advance(0.6)
                worker.tick(side.pkg.policy)
            raw = side.cluster.get("FleetRollout", ROLLOUT).raw
            assert jax_api.pools_in_phase(raw, "done") == []
            assert worker.pools_reported_done == 0
            return {"ledger": ledger(side.cluster), "nodes": nodes_view(side.cluster)}

        on_both(case)

    def test_ghost_pool_grant_is_retired_not_leaked(self):
        def case(side):
            sim, pool_names = build_fleet(side, pools=3, budget=1)
            obj = side.cluster.get("FleetRollout", ROLLOUT)
            obj.raw["spec"]["pools"] = ["a-ghost"] + list(pool_names)
            side.cluster.update(obj)
            clock = Clock()
            worker = make_worker(side, clock, "solo", workers=("solo",))
            orch = side.pkg.fleet.FleetOrchestrator(side.client, ROLLOUT)
            sim.set_template_hash("v2")
            _, violations = drive_fleet(side, sim, orch, [worker], clock,
                                        ["a-ghost"] + list(pool_names), budget=1)
            assert violations == 0
            assert_fleet_converged(side, sim)
            raw = side.cluster.get("FleetRollout", ROLLOUT).raw
            assert jax_api.pool_phase(raw, "a-ghost") == "done"
            return dict(roll_outcome(side, [worker], violations), grants=orch.grant_order)

        on_both(case)


# ---------------------------------------------------------------------------
# The tpu_operator_fleet_* family
# ---------------------------------------------------------------------------


class StubOrchestrator:
    grants_issued = 7
    budget_denials = 3
    ticks = 11
    api_errors = 1
    last_summary = {"budget": 4, "granted": 3, "done": 2, "pending": 5}


class StubWorker:
    config = SimpleNamespace(identity="worker-a")
    passes = 42
    shard_passes = {"shard-00": 40, "shard-01": 2}

    def owned_shards(self):
        return frozenset({"shard-00", "shard-01"})

    def lease_stats(self):
        return {"acquisitions": 5, "failover_acquisitions": 2, "losses": 1}


class TestFleetMetricsFamily:
    def test_renders_orchestrator_and_worker_counters(self):
        texts = {}
        for name, pkg in PKGS.items():
            metrics = pkg.fleet.FleetMetrics(orchestrator=StubOrchestrator())
            metrics.add_worker(StubWorker())
            texts[name] = metrics.render()
        text = texts["port"]
        assert text == texts["jax"]  # byte for byte
        assert "tpu_operator_fleet_grants_total 7" in text
        assert "tpu_operator_fleet_budget_denials_total 3" in text
        assert "tpu_operator_fleet_budget_headroom 3" in text
        assert 'tpu_operator_fleet_worker_owned_shards{worker="worker-a"} 2' in text
        assert 'tpu_operator_fleet_lease_failovers_total{worker="worker-a"} 2' in text
        assert ('tpu_operator_fleet_shard_passes_total'
                '{worker="worker-a",shard="shard-00"} 40') in text

    def test_served_by_the_shared_metrics_server(self):
        bodies = {}
        for name, pkg in PKGS.items():
            with pkg.upgrade.MetricsServer(pkg.fleet.FleetMetrics()) as server:
                bodies[name] = urllib.request.urlopen(server.url).read().decode()
        assert bodies["port"] == bodies["jax"] == ""

    def test_worker_lease_and_pass_counters_move(self):
        def case(side):
            for i in range(4):
                side.cluster.create(make_node(f"n{i}"))
            sim = DaemonSetSimulator(side.cluster, name="driver", namespace=NS,
                                     match_labels=LABELS)
            sim.settle()
            clock = {"t": 1000.0}
            fleet = side.pkg.fleet
            worker = fleet.ShardWorker(
                side.client,
                fleet.FleetWorkerConfig(identity="w1", shards=2, namespace=NS,
                                        driver_labels=LABELS, pool_of=lambda name: "pool-0",
                                        device=side.pkg.device),
                now_fn=lambda: clock["t"], wall_fn=lambda: clock["t"],
            )
            with worker:
                for _ in range(3):
                    worker.tick(side.pkg.policy)
                    clock["t"] += 3.0
                stats = worker.lease_stats()
                assert stats == {"acquisitions": 2, "failover_acquisitions": 0, "losses": 0}
                assert worker.passes >= 2
                owned = {s: c for s, c in worker.shard_passes.items() if c}
                assert owned
                metrics = fleet.FleetMetrics()
                metrics.add_worker(worker)
                return {"stats": stats, "passes": worker.passes, "shard_passes": owned,
                        "text": metrics.render()}

        on_both(case)
