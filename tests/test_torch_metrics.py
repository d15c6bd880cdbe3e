"""The port's ``UpgradeMetrics`` (``upgrade/metrics.py``), held against the
JAX collector.

Twin clusters of ``tests/test_torch_state_manager.py`` and
``tests/test_torch_checkpoint.py`` (the JAX machine over a
``FakeCluster``, the port's over ``RestClient`` and a ``LocalApiServer``
serving its twin, one virtual clock in both packages' ``faultpoints``)
roll alike; after every pass each side's collector observes its
snapshot, and the port's ``render()`` must equal the JAX one's byte for
byte, under the same device label. The pass's wall timings
(``snapshot_s``, ``apply_s``, ``bucket_seconds``) are each machine's own
``time.perf_counter`` differences, so each package's ``state_manager``
and ``common_manager`` read a ``perf_counter`` of their own here that
moves one fixed step a read: a timing renders the reads its timer
brackets, and equal renders show that each port timer starts and stops
where the JAX one does. Then the
cases of ``tests/test_metrics.py``'s ``TestRender``, ``TestEndpoint`` and
``TestObserveLockDiscipline`` on the port's collector.
"""

from __future__ import annotations

import contextlib
import threading
import time
import urllib.error
import urllib.request

import pytest

from builders import make_node
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube.sim import DaemonSetSimulator
from k8s_operator_libs_tpu.upgrade import UpgradeMetrics as JaxUpgradeMetrics
from k8s_operator_libs_tpu.upgrade import common_manager as jax_common_manager
from k8s_operator_libs_tpu.upgrade import metrics as jax_metrics
from k8s_operator_libs_tpu.upgrade import state_manager as jax_state_manager
from k8s_operator_libs_tpu.utils import faultpoints as jax_faultpoints
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.upgrade import (
    ClusterUpgradeStateManager,
    DeviceClass,
    MetricsServer,
    TaskRunner,
    UpgradeKeys,
    UpgradeMetrics,
    common_manager,
    metrics,
    state_manager,
)
from k8s_operator_libs_tpu_torch.utils import faultpoints
from test_torch_state_manager import LABELS as SM_LABELS
from test_torch_state_manager import NS as SM_NS

KEYS = UpgradeKeys(DeviceClass.nvidia("gpu"))
NS = "driver-ns"
LABELS = {"app": "driver"}
POLICY = DriverUpgradePolicySpec.from_dict(
    {"autoUpgrade": True, "maxParallelUpgrades": 0, "maxUnavailable": "100%"}
)


class Clock:
    def __init__(self, start: float = 1_760_000_000.0) -> None:
        self.now = start

    def wall(self) -> float:
        return self.now


#: The seconds a ``SteppedTime.perf_counter`` read moves: a power of two,
#: so every sum and difference of reads is exact.
STEP = 0.25


class SteppedTime:
    """The ``time`` module with a ``perf_counter`` that moves ``STEP`` on
    each read."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._now = 0.0

    def __getattr__(self, name):
        return getattr(time, name)

    def perf_counter(self) -> float:
        with self._lock:
            self._now += STEP
            return self._now


@pytest.fixture
def frozen(monkeypatch):
    """One virtual wall clock in both packages, and a stepped
    ``perf_counter`` for each package's phase timers."""
    for modules in ((jax_state_manager, jax_common_manager), (state_manager, common_manager)):
        stepped = SteppedTime()
        for module in modules:
            monkeypatch.setattr(module, "time", stepped)
    c = Clock()
    jax_faultpoints.install_clock(c)
    faultpoints.install_clock(c)
    try:
        yield c
    finally:
        jax_faultpoints.clear_clock()
        faultpoints.clear_clock()


def test_the_families_are_the_jax_collectors():
    assert metrics._GAUGES == jax_metrics._GAUGES
    assert metrics._PASS_GAUGES == jax_metrics._PASS_GAUGES
    assert metrics._CHECKPOINT_GAUGES == jax_metrics._CHECKPOINT_GAUGES
    assert metrics._PREFIX == jax_metrics._PREFIX


@pytest.mark.parametrize("name", ["validation-passes", "drain-pod-selector"])
def test_render_equals_jax_after_every_pass(name, frozen):
    from test_torch_state_manager import SCENARIOS
    from test_torch_state_manager import Side as SmSide

    sc = SCENARIOS[name]
    health: dict = {}
    with contextlib.ExitStack() as stack:
        a, b = SmSide(sc, health, stack), SmSide(sc, health, stack)
        collectors = {"jax": JaxUpgradeMetrics(a.machines["jax"]),
                      "port": UpgradeMetrics(b.machines["port"])}
        assert collectors["port"].render() == collectors["jax"].render()
        texts = []
        for p in range(sc.max_passes):
            frozen.now += sc.tick_s
            for side, machine in ((a, "jax"), (b, "port")):
                side.sim.step()
                if side.vsim is not None:
                    side.vsim.step()
                mgr = side.machines[machine]
                state = mgr.build_state(SM_NS, SM_LABELS)
                mgr.apply_state(state, side.policies[machine])
                side.sim.step()
                collectors[machine].observe(state)
            port, jax = collectors["port"].render(), collectors["jax"].render()
            assert port == jax, f"{name}: pass {p}"
            texts.append(port)
            if a.settled() and b.settled():
                break
        else:
            raise AssertionError(f"{name}: no convergence")
    cordon = f'tpu_operator_upgrade_pass_bucket_seconds{{device="gpu",bucket="cordon"}} {STEP}'
    assert any(cordon in text for text in texts)
    for family in ("pass_snapshot_seconds", "pass_apply_seconds"):
        prefix = f'tpu_operator_upgrade_{family}{{device="gpu"}} '
        seconds = [float(line[len(prefix):]) for text in texts
                   for line in text.splitlines() if line.startswith(prefix)]
        assert len(seconds) == len(texts) and min(seconds) >= STEP, (family, seconds)
    assert f'tpu_operator_upgrade_reconcile_passes_total{{device="gpu"}} {p + 1}' in port


def test_render_equals_jax_through_the_checkpoint_arc(frozen):
    """The ``tpu_operator_upgrade_checkpoint_*`` family too, pass by pass."""
    from test_torch_checkpoint import NEW, Scenario, Twin, checkpoint_policy

    with contextlib.ExitStack() as stack:
        twin = Twin(Scenario(), frozen, stack)
        sides = {"jax": twin.a, "port": twin.b}
        collectors = {"jax": JaxUpgradeMetrics(twin.a.machines["jax"]),
                      "port": UpgradeMetrics(twin.b.machines["port"])}
        built: dict = {}
        for machine, side in sides.items():
            mgr = side.machines[machine]

            def build_state(ns, labels, build=mgr.build_state, machine=machine):
                built[machine] = build(ns, labels)
                return built[machine]

            mgr.build_state = build_state  # the pass's own snapshot, kept to observe
        texts = []

        def after(p, side):
            if side is twin.a:
                return
            for machine in sides:
                collectors[machine].observe(built[machine])
            texts.append((collectors["port"].render(), collectors["jax"].render()))

        twin.a.sim.set_template_hash(NEW)
        twin.b.sim.set_template_hash(NEW)
        twin.roll(checkpoint_policy(), after=after)
    assert texts and all(port == jax for port, jax in texts)
    final = texts[-1][0]
    assert 'tpu_operator_upgrade_checkpoint_completed_total{device="gpu"} 1' in final
    assert 'tpu_operator_upgrade_checkpoint_escalations_total{device="gpu"} 0' in final


# ----------------------------------------------------------------------
# TestRender, TestEndpoint, TestObserveLockDiscipline on the port
# ----------------------------------------------------------------------

def make_harness(stack: contextlib.ExitStack, nodes: int = 3):
    cluster = FakeCluster()
    for i in range(nodes):
        cluster.create(make_node(f"node-{i}"))
    sim = DaemonSetSimulator(cluster, name="driver", namespace=NS, match_labels=LABELS)
    sim.settle()
    server = stack.enter_context(LocalApiServer(cluster=cluster))
    mgr = ClusterUpgradeStateManager(
        RestClient(RestConfig(server=server.url)), DeviceClass.nvidia("gpu"),
        runner=TaskRunner(inline=True),
    )
    return cluster, sim, mgr


def test_gauges_track_a_roll():
    with contextlib.ExitStack() as stack:
        cluster, sim, mgr = make_harness(stack)
        collector = UpgradeMetrics(mgr)
        sim.set_template_hash("v2")
        for _ in range(40):
            sim.step()
            state = mgr.build_state(NS, LABELS)
            mgr.apply_state(state, POLICY)
            collector.observe(state)
            sim.step()
            if all(n.labels.get(KEYS.state_label) == "upgrade-done"
                   for n in cluster.list("Node")):
                break
        state = mgr.build_state(NS, LABELS)
        collector.observe(state)
    text = collector.render()
    assert 'tpu_operator_upgrade_done{device="gpu"} 3' in text
    assert 'tpu_operator_upgrade_in_progress{device="gpu"} 0' in text
    assert 'tpu_operator_upgrade_failed{device="gpu"} 0' in text
    assert "tpu_operator_upgrade_reconcile_passes_total" in text


def test_render_is_valid_exposition_format():
    with contextlib.ExitStack() as stack:
        _, _, mgr = make_harness(stack, nodes=1)
        text = UpgradeMetrics(mgr).render()
    for line in text.strip().splitlines():
        assert line.startswith("#") or " " in line
    names = [line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")]
    assert len(names) == 6
    assert len(set(names)) == 6


def test_pass_bucket_seconds_exposition_byte_exact():
    with contextlib.ExitStack() as stack:
        _, _, mgr = make_harness(stack, nodes=1)
        collector = UpgradeMetrics(mgr)
        state = mgr.build_state(NS, LABELS)
        mgr.last_pass_stats.bucket_seconds = {"cordon": 0.25, "classify[unknown]": 0.0125}
        collector.observe(state)
        lines = collector.render().splitlines()
        start = lines.index(
            "# HELP tpu_operator_upgrade_pass_bucket_seconds Per-bucket "
            "apply wall seconds of the most recent pass that ran any "
            "bucket (the gauge twin of the pass span's bucket children; "
            "docs/tracing.md)"
        )
        assert lines[start + 1] == "# TYPE tpu_operator_upgrade_pass_bucket_seconds gauge"
        assert lines[start + 2] == (
            'tpu_operator_upgrade_pass_bucket_seconds{device="gpu",bucket="classify[unknown]"}'
            " 0.0125"
        )
        assert lines[start + 3] == (
            'tpu_operator_upgrade_pass_bucket_seconds{device="gpu",bucket="cordon"} 0.25'
        )
        # A settled pass (an empty dict) keeps the last timings exported.
        mgr.last_pass_stats.bucket_seconds = {}
        collector.observe(state)
        assert ('tpu_operator_upgrade_pass_bucket_seconds{device="gpu",bucket="cordon"} 0.25'
                in collector.render())


def test_label_values_are_escaped():
    from k8s_operator_libs_tpu_torch.tpu.monitor import MonitorMetrics

    assert metrics.prom_label("node", 'a"b\\c\nd') == '{node="a\\"b\\\\c\\nd"}'
    collector = MonitorMetrics('evil"node\\')
    collector.record(None)
    for line in collector.render().strip().splitlines():
        if line.startswith("#"):
            continue
        assert 'node="evil\\"node\\\\"' in line


def test_metrics_served_over_http():
    with contextlib.ExitStack() as stack:
        _, _, mgr = make_harness(stack, nodes=2)
        collector = UpgradeMetrics(mgr)
        collector.observe(mgr.build_state(NS, LABELS))
        with MetricsServer(collector) as server:
            body = urllib.request.urlopen(server.url, timeout=5).read().decode()
            assert 'tpu_operator_upgrade_managed_nodes{device="gpu"} 2' in body
            assert body == collector.render()
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(server.url.replace("/metrics", "/nope"), timeout=5)
            assert err.value.code == 404


class SlowManager:
    def __init__(self, entered: threading.Event, release: threading.Event) -> None:
        self.entered, self.release = entered, release

    def get_total_managed_nodes(self, state):
        self.entered.set()
        self.release.wait(5)
        return 3

    def get_upgrades_in_progress(self, state):
        return 0

    def get_upgrades_done(self, state):
        return 0

    def get_upgrades_failed(self, state):
        return 0

    def get_upgrades_pending(self, state):
        return 0


def test_render_not_blocked_by_slow_observe():
    """observe() computes the manager's accessors outside the collector's
    lock: a slow pass never stalls a scrape."""
    entered, release = threading.Event(), threading.Event()
    collector = UpgradeMetrics(SlowManager(entered, release), device_label="gpu")
    observer = threading.Thread(target=collector.observe, args=(None,))
    observer.start()
    try:
        assert entered.wait(5)
        rendered = {"text": None}
        done = threading.Event()

        def scrape():
            rendered["text"] = collector.render()
            done.set()

        threading.Thread(target=scrape).start()
        assert done.wait(2), "render() blocked behind observe()"
        assert 'tpu_operator_upgrade_managed_nodes{device="gpu"} 0' in rendered["text"]
    finally:
        release.set()
        observer.join(timeout=10)
    assert 'managed_nodes{device="gpu"} 3' in collector.render()


def test_bare_manager_renders_as_jax():
    """A manager without ``PassStats``: the five gauges and the count, as the
    JAX collector renders them, before and after an observe."""
    ready = threading.Event()
    ready.set()
    ours = UpgradeMetrics(SlowManager(threading.Event(), ready), device_label="gpu")
    theirs = JaxUpgradeMetrics(SlowManager(threading.Event(), ready), device_label="gpu")
    assert ours.render() == theirs.render()
    ours.observe(None)
    theirs.observe(None)
    assert ours.render() == theirs.render()


def test_observe_commits_in_entry_order():
    """The ticket: an observe that entered first but committed last is
    dropped, so the values are the later-entering observe's."""
    first_in, release = threading.Event(), threading.Event()

    class Gated(SlowManager):
        def __init__(self):
            super().__init__(first_in, release)
            self.calls = 0

        def get_total_managed_nodes(self, state):
            self.calls += 1
            if self.calls == 1:
                first_in.set()
                release.wait(5)
                return 1
            return 2

    collector = UpgradeMetrics(Gated(), device_label="gpu")
    slow = threading.Thread(target=collector.observe, args=(None,))
    slow.start()
    assert first_in.wait(5)
    collector.observe(None)  # enters second, commits first
    release.set()
    slow.join(timeout=10)
    text = collector.render()
    assert 'managed_nodes{device="gpu"} 2' in text
    assert 'reconcile_passes_total{device="gpu"} 2' in text
