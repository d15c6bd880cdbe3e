"""The port's write path, held case by case against the JAX package's.

Each case of ``tests/test_write_batching.py`` runs on twin clusters
(``torch_twins.Side``): the JAX provider, batcher and machine over one
``FakeCluster``, the port's over its ``RestClient`` and a ``LocalApiServer``
serving the other. The JAX case's assertions hold on both sides, and the
sides are compared exactly: the PATCH bodies and types sent, the write
counters and the batcher's ``stats()``, each slot's result or error, the
per-node state-label sequences of a roll as each cluster's journal saw
them, and every node's upgrade labels, annotations and cordon bit.

The JAX file's ``RecordingClient``, ``_GateClient`` and spy wrap the JAX
``FakeCluster``; on the port's side the same wrappers (they forward any
other call) wrap the port's ``RestClient``, which has no ``patch_many`` of
its own: a wrapper's ``patch_many`` sends through ``kube.client.patch_many``,
one PATCH a slot. The fault plan is installed in each package's
``utils.faultpoints``.
"""

from __future__ import annotations

import contextlib
import threading

import pytest

from builders import make_node
from k8s_operator_libs_tpu_torch.kube.client import patch_many
from torch_twins import KEYS, LABELS, NS, PKGS, Side, node_view

ANN = "example.com/upgrade-requested"


@pytest.fixture
def sides():
    with contextlib.ExitStack() as stack:
        yield lambda **kw: {name: Side(name, stack, **kw) for name in ("jax", "port")}


@pytest.fixture(autouse=True)
def _clean_fault_registry():
    yield
    for pkg in PKGS.values():
        pkg.faultpoints.clear_plan()


def bare(sides, *names):
    """Twin clusters of the named nodes, no driver."""
    s = sides(nodes=0, driver=False)
    for side in s.values():
        for name in names:
            side.cluster.create(make_node(name))
    return s


def forward_patch_many(inner, kind, patches, namespace, **kw):
    """The inner client's own ``patch_many`` (the JAX ``FakeCluster``'s),
    else the port's serial loop over its ``patch``."""
    if hasattr(inner, "patch_many"):
        return inner.patch_many(kind, patches, namespace=namespace, **kw)
    return patch_many(inner, kind, patches, namespace=namespace)


class RecordingClient:
    """Forwards every call; records PATCH bodies and patch_many batches."""

    def __init__(self, inner):
        self._inner = inner
        self.patches = []
        self.patch_many_calls = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def patch(self, kind, name, namespace="", patch=None, patch_type="merge", **kw):
        self.patches.append((name, patch, patch_type))
        return self._inner.patch(kind, name, namespace=namespace, patch=patch,
                                 patch_type=patch_type, **kw)

    def patch_many(self, kind, patches, namespace="", **kw):
        self.patch_many_calls.append(list(patches))
        return forward_patch_many(self._inner, kind, patches, namespace, **kw)


# ----------------------------------------------------------------------
# TestCoalescedPatchBody
# ----------------------------------------------------------------------

def test_label_and_annotation_is_one_merge_patch(sides):
    s = sides(nodes=0, driver=False)
    seen = {}
    for name, side in s.items():
        side.cluster.create(make_node("n1", annotations={"doomed": "x"}))
        client = RecordingClient(side.client)
        p = side.pkg.Provider(client, KEYS)
        p.change_node_state_and_annotations(
            p.get_node("n1"), side.pkg.upgrade.UpgradeState.CORDON_REQUIRED,
            {ANN: "true", "doomed": side.pkg.NULL},
        )
        assert client.patches == [("n1", {"metadata": {
            "labels": {KEYS.state_label: "cordon-required"},
            "annotations": {ANN: "true", "doomed": None},
        }}, "merge")]
        stored = side.cluster.get("Node", "n1")
        assert stored.labels[KEYS.state_label] == "cordon-required"
        assert stored.annotations[ANN] == "true" and "doomed" not in stored.annotations
        stats = p.write_stats()
        assert stats["issued"] == 1 and stats["coalesced"] == 2
        seen[name] = (client.patches, stats)
    assert seen["port"] == seen["jax"]
    assert node_view(s["port"].cluster) == node_view(s["jax"].cluster)


def test_label_only_write_stays_strategic(sides):
    seen = {}
    for name, side in bare(sides, "n1").items():
        client = RecordingClient(side.client)
        p = side.pkg.Provider(client, KEYS)
        p.change_node_upgrade_state(p.get_node("n1"),
                                    side.pkg.upgrade.UpgradeState.UPGRADE_REQUIRED)
        assert client.patches == [(
            "n1", {"metadata": {"labels": {KEYS.state_label: "upgrade-required"}}},
            "strategic",
        )]
        seen[name] = client.patches
    assert seen["port"] == seen["jax"]


def test_settled_keys_filtered_from_coalesced_body(sides):
    s = sides(nodes=0, driver=False)
    seen = {}
    for name, side in s.items():
        side.cluster.create(make_node("n1", labels={KEYS.state_label: "cordon-required"}))
        client = RecordingClient(side.client)
        p = side.pkg.Provider(client, KEYS)
        node = p.get_node("n1")
        cordon = side.pkg.upgrade.UpgradeState.CORDON_REQUIRED
        p.change_node_state_and_annotations(node, cordon, {ANN: "true"})
        assert client.patches == [("n1", {"metadata": {"annotations": {ANN: "true"}}}, "merge")]
        p.change_node_state_and_annotations(node, cordon, {ANN: "true"})
        assert len(client.patches) == 1
        assert p.write_stats()["skipped"] == 1
        seen[name] = (client.patches, p.write_stats())
    assert seen["port"] == seen["jax"]


# ----------------------------------------------------------------------
# TestNoOpSkipsBeforeBatching
# ----------------------------------------------------------------------

def test_settled_write_never_wakes_the_batcher(sides):
    seen = {}
    for name, side in bare(sides, "n1").items():
        batcher = side.pkg.WriteBatcher(side.client)
        p = side.pkg.Provider(side.client, KEYS)
        p.set_batcher(batcher)
        node = p.get_node("n1")
        cordon = side.pkg.upgrade.UpgradeState.CORDON_REQUIRED
        p.change_node_upgrade_state(node, cordon)
        assert batcher.stats()["writes_flushed"] == 1
        p.change_node_upgrade_state(node, cordon)
        assert batcher.stats() == {"batches_flushed": 1, "writes_flushed": 1, "max_batch": 1}
        assert p.write_stats() == {"issued": 1, "skipped": 1, "coalesced": 0, "batched": 1}
        seen[name] = (batcher.stats(), p.write_stats())
    assert seen["port"] == seen["jax"]


# ----------------------------------------------------------------------
# TestDeadWatchNoReadBack
# ----------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_write_issues_zero_reads_with_informers_stopped(sides, batched):
    """With the write-through wired and every informer stopped, a write
    reads nothing back (the PATCH response proves it) and the next
    snapshot sees it."""
    s = sides(nodes=2)
    logs = {}
    for name, side in s.items():
        mgr = side.manager(options=side.pkg.upgrade.StateOptions(batch_writes=batched))
        source = mgr.with_snapshot_from_informers(NS, LABELS, resync_period_s=0.0)
        source.stop()
        node = side.node("node-0")
        log = side.cluster.start_call_log()
        try:
            mgr.provider.change_node_upgrade_state(
                node, side.pkg.upgrade.UpgradeState.CORDON_REQUIRED
            )
        finally:
            side.cluster.stop_call_log()
        assert [c for c in log if c[0] in ("get", "list")] == []
        assert [c[0] for c in log] == ["patch"]
        assert source.nodes()["node-0"].labels[KEYS.state_label] == "cordon-required"
        logs[name] = list(log)
    assert logs["port"] == logs["jax"]
    assert node_view(s["port"].cluster) == node_view(s["jax"].cluster)


# ----------------------------------------------------------------------
# TestTerminalSequencesWithBatching
# ----------------------------------------------------------------------

def transitions_of(cluster) -> dict:
    """Each node's state-label sequence, as the cluster's journal has it."""
    transitions: dict = {}
    lock = threading.Lock()

    def record(event, obj, old):
        if obj.get("kind") != "Node":
            return
        label = (obj["metadata"].get("labels") or {}).get(KEYS.state_label)
        old_label = (((old or {}).get("metadata") or {}).get("labels") or {}).get(
            KEYS.state_label
        )
        if label != old_label:
            with lock:
                transitions.setdefault(obj["metadata"]["name"], []).append(label)

    cluster.subscribe(record)
    return transitions


def roll(side, width, batched, node_count=6) -> dict:
    """One full v2 roll; each node's state-label sequence."""
    up = side.pkg.upgrade
    runner = up.TaskRunner(max_workers=width) if width > 1 else up.TaskRunner(inline=True)
    mgr = side.manager(runner=runner,
                       options=up.StateOptions(apply_width=width, batch_writes=batched))
    transitions = transitions_of(side.cluster)
    side.sim.set_template_hash("v2")
    for _ in range(80):
        side.sim.step()
        mgr.apply_state(mgr.build_state(NS, LABELS), side.pkg.policy)
        side.sim.step()
        done = all(side.state(f"node-{i}") == "upgrade-done" for i in range(node_count))
        if done and side.sim.all_pods_ready_and_current():
            break
    else:
        raise AssertionError(f"{side.name} width={width} batched={batched}: no convergence")
    if width > 1:
        assert runner.wait_idle(timeout=10)
        runner.shutdown()
    if batched:
        assert mgr.enable_write_batching().stats()["writes_flushed"] > 0
    return transitions


@pytest.mark.parametrize("width", [1, 8], ids=["identical_at_width_1", "identical_at_width_8"])
def test_terminal_sequences_with_batching(sides, width):
    """Batching changes how writes travel, never what they do: each
    node's sequence of a batched roll, on either side, is the JAX serial
    roll's."""
    serial = roll(sides(nodes=6)["jax"], width=1, batched=False)
    s = sides(nodes=6)
    for side in s.values():
        batched = roll(side, width=width, batched=True)
        assert batched == serial, side.name
    assert node_view(s["port"].cluster) == node_view(s["jax"].cluster)


# ----------------------------------------------------------------------
# TestWriteBatcherUnit
# ----------------------------------------------------------------------

class TargetedPartialPlan:
    """Fails the named node's slot at ``upgrade.write_batch_partial``."""

    def __init__(self, pkg, node):
        self.pkg = pkg
        self.node = node
        self.fired = 0

    def consult(self, point, ctx):
        if point == "upgrade.write_batch_partial" and ctx.get("node") == self.node:
            self.fired += 1
            return self.pkg.faultpoints.FaultAction(
                kind="raise", exc=self.pkg.ConflictError(f"injected conflict on {self.node}")
            )
        return None


class GateClient:
    """``patch_many`` waits until released, then optionally raises."""

    def __init__(self, inner, explode=False):
        self._inner = inner
        self.explode = explode
        self.entered = threading.Event()
        self.release = threading.Event()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def patch_many(self, kind, patches, namespace="", **kw):
        self.entered.set()
        assert self.release.wait(10), "gate never released"
        if self.explode:
            raise RuntimeError("leader flush exploded")
        return forward_patch_many(self._inner, kind, patches, namespace, **kw)


def result_of(value):
    if isinstance(value, BaseException):
        return (type(value).__name__, str(value))
    return dict(value.labels)


def wait_pending(batcher, n: int) -> None:
    for _ in range(1000):
        with batcher._lock:
            if len(batcher._pending) == n:
                return
        threading.Event().wait(0.002)


def test_single_threaded_degenerates_to_batches_of_one(sides):
    seen = {}
    for name, side in bare(sides, "n0", "n1", "n2").items():
        batcher = side.pkg.WriteBatcher(side.client)
        for i in range(3):
            out = batcher.stage("Node", f"n{i}", {"metadata": {"labels": {"k": f"v{i}"}}})
            assert out.labels["k"] == f"v{i}"
        assert batcher.stats() == {"batches_flushed": 3, "writes_flushed": 3, "max_batch": 1}
        seen[name] = batcher.stats()
    assert seen["port"] == seen["jax"]


def test_partial_batch_fault_isolates_to_one_slot(sides):
    seen = {}
    for name, side in bare(sides, "good-0", "bad", "good-1", "decoy").items():
        plan = TargetedPartialPlan(side.pkg, "bad")
        side.pkg.faultpoints.install_plan(plan)
        try:
            gate = GateClient(side.client)
            batcher = side.pkg.WriteBatcher(gate)
            results = {}

            def stage(node, batcher=batcher, results=results):
                try:
                    results[node] = batcher.stage(
                        "Node", node, {"metadata": {"labels": {"k": "v"}}}
                    )
                except BaseException as e:  # noqa: BLE001 - compared
                    results[node] = e

            leader = threading.Thread(target=stage, args=("decoy",))
            leader.start()
            assert gate.entered.wait(5)
            threads = [threading.Thread(target=stage, args=(n,))
                       for n in ("good-0", "bad", "good-1")]
            for t in threads:
                t.start()
            wait_pending(batcher, 3)
            gate.release.set()
            leader.join(10)
            for t in threads:
                t.join(10)
        finally:
            side.pkg.faultpoints.clear_plan()
        assert isinstance(results["bad"], side.pkg.ConflictError)
        assert plan.fired == 1
        assert "k" not in side.cluster.get("Node", "bad").labels
        stats = batcher.stats()
        assert stats["max_batch"] == 3 and stats["writes_flushed"] == 3
        seen[name] = ({n: result_of(r) for n, r in results.items()}, stats)
    assert seen["port"] == seen["jax"]


def test_leader_death_resolves_followers_loudly(sides):
    seen = {}
    for name, side in bare(sides, "a", "b").items():
        gate = GateClient(side.client, explode=True)
        batcher = side.pkg.WriteBatcher(gate)
        results = {}

        def stage(node, batcher=batcher, results=results):
            try:
                results[node] = batcher.stage("Node", node, {"metadata": {"labels": {"k": "v"}}})
            except BaseException as e:  # noqa: BLE001 - compared
                results[node] = e

        leader = threading.Thread(target=stage, args=("a",))
        leader.start()
        assert gate.entered.wait(5)
        follower = threading.Thread(target=stage, args=("b",))
        follower.start()
        wait_pending(batcher, 1)
        gate.release.set()
        leader.join(10)
        follower.join(10)
        assert isinstance(results["a"], RuntimeError)
        assert isinstance(results["b"], side.pkg.WriteBatchError)
        gate.explode = False
        out = batcher.stage("Node", "b", {"metadata": {"labels": {"k": "v"}}})
        assert out.labels["k"] == "v"
        seen[name] = ({n: result_of(r) for n, r in results.items()}, batcher.stats())
    assert seen["port"] == seen["jax"]


def test_fifo_order_across_batches(sides):
    seen = {}
    for name, side in bare(sides, "n1").items():
        applied = []
        inner = side.client

        class Spy:
            def __getattr__(self, attr):
                return getattr(inner, attr)

            def patch_many(self, kind, patches, namespace="", **kw):
                applied.extend(n for n, _, _ in patches)
                return forward_patch_many(inner, kind, patches, namespace, **kw)

        batcher = side.pkg.WriteBatcher(Spy(), max_batch=2)
        for i in range(5):
            batcher.stage("Node", "n1", {"metadata": {"labels": {"seq": str(i)}}})
        assert applied == ["n1"] * 5
        assert side.cluster.get("Node", "n1").labels["seq"] == "4"
        seen[name] = (applied, batcher.stats())
    assert seen["port"] == seen["jax"]


def test_provider_rolls_back_in_memory_on_flush_failure(sides):
    s = bare(sides, "n1")
    seen = {}
    for name, side in s.items():
        cordon = side.pkg.upgrade.UpgradeState.CORDON_REQUIRED
        side.pkg.faultpoints.install_plan(TargetedPartialPlan(side.pkg, "n1"))
        p = side.pkg.Provider(side.client, KEYS)
        p.set_batcher(side.pkg.WriteBatcher(side.client))
        node = p.get_node("n1")
        try:
            with pytest.raises(side.pkg.ConflictError):
                p.change_node_upgrade_state(node, cordon)
        finally:
            side.pkg.faultpoints.clear_plan()
        assert KEYS.state_label not in node.labels
        assert KEYS.state_label not in side.cluster.get("Node", "n1").labels
        p.change_node_upgrade_state(node, cordon)
        assert side.state("n1") == "cordon-required"
        seen[name] = p.write_stats()
    assert seen["port"] == seen["jax"]
    assert node_view(s["port"].cluster) == node_view(s["jax"].cluster)


def test_many_stagers_every_write_lands_once():
    """A stress of the port's batcher: 32 threads (more than the cores),
    eight writes each to a node of their own, a short switch interval.
    Every write returns its own node's patched object, the batcher
    counts each write once, and every node ends at its last write."""
    import sys

    from k8s_operator_libs_tpu.kube import FakeCluster
    from k8s_operator_libs_tpu_torch.upgrade import WriteBatcher

    cluster = FakeCluster()
    threads_n, writes_n = 32, 8
    for t in range(threads_n):
        cluster.create(make_node(f"n{t}"))
    batcher = WriteBatcher(cluster, max_batch=16)
    errors: list = []

    def worker(t: int) -> None:
        for i in range(writes_n):
            out = batcher.stage("Node", f"n{t}", {"metadata": {"labels": {"seq": str(i)}}})
            if out.name != f"n{t}" or out.labels["seq"] != str(i):
                errors.append((t, i, out.name, out.labels.get("seq")))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(threads_n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    stats = batcher.stats()
    assert stats["writes_flushed"] == threads_n * writes_n
    assert 1 <= stats["max_batch"] <= 16
    assert stats["batches_flushed"] <= threads_n * writes_n
    assert all(cluster.get("Node", f"n{t}").labels["seq"] == str(writes_n - 1)
               for t in range(threads_n))
