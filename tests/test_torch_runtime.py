"""The port's supervised runtime against the JAX package's, case by case.

Every case of ``tests/test_runtime.py`` but those of the fleet orchestrator
runs once with each package's ``runtime`` (and, for the eager release,
``kube/leader.py``) on the same inputs; each run makes the JAX case's
checks and returns what it observed (start and stop journals, stop
reports, Lease holders), and the two packages' observations must be
equal. The lease case puts the JAX elector on a ``FakeCluster`` and the
port's on the port's ``RestClient`` at a ``LocalApiServer`` serving
another one.

The cases of ``TestOrchestratorDaemon`` (``runtime/daemon.py``) run in
``tests/test_torch_fleet_daemon.py``, with the rest of the fleet tier.
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time

import pytest

from k8s_operator_libs_tpu import runtime as jax_runtime
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube import leader as jax_leader
from k8s_operator_libs_tpu_torch import runtime as port_runtime
from k8s_operator_libs_tpu_torch.kube import leader as port_leader
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig

NS = "default"
PKGS = {"jax": (jax_runtime, jax_leader), "port": (port_runtime, port_leader)}


def on_both(case):
    """``case(runtime, leader)`` for each package; equal outcomes."""
    outcomes = {name: case(*mods) for name, mods in PKGS.items()}
    assert outcomes["port"] == outcomes["jax"]
    return outcomes["port"]


def recorder_component(rt, name, journal, fail_start=False):
    """A FuncComponent that journals its start and stop."""

    def _start():
        if fail_start:
            raise RuntimeError(f"{name} refused to start")
        journal.append(f"+{name}")

    return rt.FuncComponent(name, start=_start, stop=lambda: journal.append(f"-{name}"))


def wire(rt, sup, journal, *specs):
    for name, deps in specs:
        sup.add(recorder_component(rt, name, journal), depends_on=deps)


def wait_until(pred, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def reports_shape(reports):
    return [(r.name, r.ok, r.timed_out, r.error) for r in reports]


class TestSupervisorOrdering:
    def test_start_producers_first_stop_consumers_first(self):
        def case(rt, _):
            journal = []
            sup = rt.Supervisor()
            wire(rt, sup, journal, ("sink", ("source", "queue")), ("queue", ("source",)),
                 ("source", ()))
            sup.start()
            assert journal == ["+source", "+queue", "+sink"]
            sup.stop()
            assert journal[3:] == ["-sink", "-queue", "-source"]
            return journal

        on_both(case)

    def test_registration_order_breaks_ties(self):
        def case(rt, _):
            journal = []
            sup = rt.Supervisor()
            wire(rt, sup, journal, ("b", ()), ("a", ()), ("c", ("b",)))
            sup.start()
            assert journal == ["+b", "+a", "+c"]  # roots in registration order
            sup.stop()
            assert journal[3:] == ["-c", "-a", "-b"]
            return journal

        on_both(case)

    def test_adopted_components_drain_without_start(self):
        def case(rt, _):
            journal = []
            sup = rt.Supervisor()
            sup.adopt(recorder_component(rt, "producer", journal))
            sup.adopt(recorder_component(rt, "consumer", journal), depends_on=["producer"])
            sup.stop()
            assert journal == ["-consumer", "-producer"]
            return journal

        on_both(case)

    def test_start_skips_adopted_but_stop_covers_both(self):
        def case(rt, _):
            journal = []
            sup = rt.Supervisor()
            sup.adopt(recorder_component(rt, "adopted", journal))
            sup.add(recorder_component(rt, "added", journal), depends_on=["adopted"])
            sup.start()
            assert journal == ["+added"], "adopted must not be started twice"
            sup.stop()
            assert journal[1:] == ["-added", "-adopted"]
            return journal

        on_both(case)

    def test_stop_only_drains_started_components(self):
        def case(rt, _):
            journal = []
            sup = rt.Supervisor()
            sup.add(recorder_component(rt, "never-started", journal))
            sup.stop()
            assert journal == [] and sup.stop_reports == []
            return journal, reports_shape(sup.stop_reports)

        on_both(case)


class TestSupervisorWiring:
    def test_duplicate_name_rejected(self):
        def case(rt, _):
            sup = rt.Supervisor()
            sup.add(rt.FuncComponent("x"))
            with pytest.raises(rt.SupervisorError, match="duplicate") as exc:
                sup.add(rt.FuncComponent("x"))
            return str(exc.value)

        on_both(case)

    def test_unknown_dependency_rejected_at_start(self):
        def case(rt, _):
            sup = rt.Supervisor()
            sup.add(rt.FuncComponent("consumer"), depends_on=["ghost"])
            with pytest.raises(rt.SupervisorError, match="unknown") as exc:
                sup.start()
            return str(exc.value)

        on_both(case)

    def test_cycle_rejected_at_start(self):
        def case(rt, _):
            sup = rt.Supervisor()
            sup.add(rt.FuncComponent("a"), depends_on=["b"])
            sup.add(rt.FuncComponent("b"), depends_on=["a"])
            with pytest.raises(rt.SupervisorError, match="cycle") as exc:
                sup.start()
            return str(exc.value)

        on_both(case)

    def test_double_start_rejected(self):
        def case(rt, _):
            sup = rt.Supervisor()
            sup.add(rt.FuncComponent("x"))
            sup.start()
            with pytest.raises(RuntimeError, match="already started") as exc:
                sup.start()
            sup.stop()
            return str(exc.value)

        on_both(case)

    def test_stop_is_tolerant_of_bad_wiring(self):
        def case(rt, _):
            journal = []
            sup = rt.Supervisor()
            sup.adopt(recorder_component(rt, "orphan", journal),
                      depends_on=["never-registered"])
            reports = sup.stop()
            assert journal == ["-orphan"] and [r.name for r in reports] == ["orphan"]
            return journal, [r.name for r in reports]

        on_both(case)


class TestSupervisorFailure:
    def test_failed_start_drains_started_subset_and_reraises(self):
        def case(rt, _):
            journal = []
            sup = rt.Supervisor()
            sup.add(recorder_component(rt, "ok", journal))
            sup.add(recorder_component(rt, "bad", journal, fail_start=True), depends_on=["ok"])
            sup.add(recorder_component(rt, "never", journal), depends_on=["bad"])
            with pytest.raises(RuntimeError, match="refused to start"):
                sup.start()
            # ok started and was drained; bad and never did not start.
            assert journal == ["+ok", "-ok"]
            assert sup.stop_reports and sup.stop_reports[0].name == "ok"
            return journal, [r.name for r in sup.stop_reports]

        on_both(case)

    def test_wedged_stop_costs_its_budget_not_the_drain(self):
        def case(rt, _):
            journal = []
            release = threading.Event()
            sup = rt.Supervisor(drain_timeout_s=5.0, component_timeout_s=0.2)
            sup.adopt(recorder_component(rt, "tail", journal))
            sup.adopt(rt.FuncComponent("wedged", stop=release.wait), depends_on=["tail"])
            began = time.monotonic()
            reports = sup.stop()
            elapsed = time.monotonic() - began
            release.set()  # unwedge the helper thread
            by_name = {r.name: r for r in reports}
            assert by_name["wedged"].timed_out and not by_name["wedged"].ok
            assert by_name["tail"].ok
            assert journal == ["-tail"], "the drain must go on past the wedge"
            assert elapsed < 4.0, "a wedge costs its budget, not the deadline"
            return journal, reports_shape(reports)

        on_both(case)

    def test_raising_stop_is_recorded_not_propagated(self):
        def case(rt, _):
            journal = []
            sup = rt.Supervisor()

            def _explode():
                raise ValueError("release failed")

            sup.adopt(recorder_component(rt, "tail", journal))
            sup.adopt(rt.FuncComponent("bomb", stop=_explode), depends_on=["tail"])
            reports = sup.stop()  # must not raise
            by_name = {r.name: r for r in reports}
            assert not by_name["bomb"].ok and "release failed" in by_name["bomb"].error
            assert journal == ["-tail"]
            return journal, reports_shape(reports)

        on_both(case)

    def test_overall_deadline_caps_late_budgets(self):
        def case(rt, _):
            blocker = threading.Event()
            sup = rt.Supervisor(drain_timeout_s=0.3, component_timeout_s=10.0)
            sup.adopt(rt.FuncComponent("slow2", stop=blocker.wait))
            sup.adopt(rt.FuncComponent("slow1", stop=blocker.wait), depends_on=["slow2"])
            began = time.monotonic()
            reports = sup.stop()
            elapsed = time.monotonic() - began
            blocker.set()
            assert all(r.timed_out for r in reports)
            assert elapsed < 2.0, "the overall deadline bounds the whole drain"
            return reports_shape(reports)

        on_both(case)


class TestSupervisorSignals:
    def test_sigterm_only_sets_the_event(self):
        def case(rt, _):
            journal = []
            sup = rt.Supervisor()
            sup.adopt(recorder_component(rt, "worker", journal))
            sup.install_signal_handlers()
            try:
                before = sup.stop_requested
                os.kill(os.getpid(), signal.SIGTERM)
                woke = sup.wait(timeout=5.0)
                during = list(journal)  # the handler must not drain
                sup.stop()
            finally:
                sup.restore_signal_handlers()
            assert (before, woke, during, journal) == (False, True, [], ["-worker"])
            return before, woke, during, journal

        on_both(case)

    def test_restore_signal_handlers_puts_back_previous(self):
        def case(rt, _):
            seen = []
            prev = signal.signal(signal.SIGTERM, lambda *_: seen.append("prev"))
            try:
                sup = rt.Supervisor()
                sup.install_signal_handlers()
                sup.restore_signal_handlers()
                restored = signal.getsignal(signal.SIGTERM) is not sup._on_signal
                os.kill(os.getpid(), signal.SIGTERM)
                assert restored and wait_until(lambda: seen == ["prev"])
                assert not sup.stop_requested
            finally:
                signal.signal(signal.SIGTERM, prev)
            return restored, seen, sup.stop_requested

        on_both(case)

    def test_request_stop_and_wait(self):
        def case(rt, _):
            sup = rt.Supervisor()
            early = sup.wait(timeout=0.01)
            sup.request_stop()
            assert not early and sup.stop_requested and sup.wait(timeout=0)
            return early, sup.stop_requested

        on_both(case)

    def test_context_manager_starts_and_drains(self):
        def case(rt, _):
            journal = []
            sup = rt.Supervisor()
            sup.add(recorder_component(rt, "x", journal))
            with sup:
                inside = (list(journal), sup.healthy())
            assert inside == (["+x"], True) and journal == ["+x", "-x"]
            assert not sup.healthy(), "nothing running: not healthy"
            return inside, journal

        on_both(case)


class TestComponents:
    def test_thread_component_owns_one_nondaemon_thread(self):
        def case(rt, _):
            entered = threading.Event()

            def run(stop_event):
                entered.set()
                stop_event.wait(30)

            comp = rt.ThreadComponent("loop", run, join_timeout_s=5.0)
            before = comp.healthy()
            comp.start()
            assert entered.wait(5)
            thread = comp._thread
            shape = (thread is not None, thread.daemon, comp.healthy())
            comp.stop()
            after = (thread.is_alive(), comp.healthy())
            assert (before, shape, after) == (False, (True, False, True), (False, False))
            return before, shape, after

        on_both(case)

    def test_thread_component_double_start_rejected(self):
        def case(rt, _):
            comp = rt.ThreadComponent("loop", lambda ev: ev.wait(30))
            comp.start()
            try:
                with pytest.raises(RuntimeError, match="already started") as exc:
                    comp.start()
            finally:
                comp.stop()
            return str(exc.value)

        on_both(case)

    def test_thread_component_stop_is_idempotent(self):
        def case(rt, _):
            comp = rt.ThreadComponent("loop", lambda ev: ev.wait(30))
            comp.start()
            comp.stop()
            comp.stop()  # a second stop is a no-op
            assert not comp.healthy()
            return comp.healthy()

        on_both(case)

    def test_func_component_defaults(self):
        def case(rt, _):
            comp = rt.FuncComponent("noop")
            comp.start()
            comp.stop()
            shape = (comp.healthy(), isinstance(comp, rt.Component))
            assert shape == (True, True)
            return shape

        on_both(case)

    def test_supervisor_healthy_reflects_running_components(self):
        def case(rt, _):
            sup = rt.Supervisor()
            sup.add(rt.FuncComponent("well"))
            seen = [sup.healthy()]
            sup.start()
            seen.append(sup.healthy())
            sup.add(rt.FuncComponent("sick", healthy=lambda: False))
            seen.append(sup.healthy())  # a component not started does not count
            sup.stop()
            seen.append(sup.healthy())
            assert seen == [False, True, True, False]
            return seen

        on_both(case)


class Clock:
    def __init__(self, start: float = 100.0) -> None:
        self.t = start

    def now(self) -> float:
        return self.t


class TestEagerLeaseRelease:
    """Supervised stop releases a held Lease at once: the successor takes
    it with no clock advance."""

    def test_successor_acquires_with_zero_ttl_wait(self):
        def case(rt, le):
            with contextlib.ExitStack() as stack:
                cluster = FakeCluster()
                client = cluster
                if rt is port_runtime:
                    server = stack.enter_context(LocalApiServer(cluster=cluster))
                    client = RestClient(RestConfig(server=server.url))
                clock = Clock()

                def elector(identity):
                    return le.LeaderElector(
                        client,
                        le.LeaderElectionConfig(name="fleet-orchestrator", namespace=NS,
                                                identity=identity),
                        now_fn=clock.now,
                    )

                a = elector("a")
                assert a.try_acquire_or_renew()
                first = cluster.get("Lease", "fleet-orchestrator", NS).holder_identity
                sup = rt.Supervisor()
                sup.adopt(rt.FuncComponent("leader-elector", stop=a.stop))
                sup.stop()
                b = elector("b")
                taken = b.try_acquire_or_renew()  # no clock advance
                lease = cluster.get("Lease", "fleet-orchestrator", NS)
                assert first == "a" and taken, "the lease was not released at once"
                assert lease.holder_identity == "b" and lease.lease_transitions == 1
                return first, taken, lease.holder_identity, lease.lease_transitions

        on_both(case)
