"""The port's leader election against the JAX package's, case by case.

Every case of ``tests/test_leader_election.py`` runs once with each
package's ``kube/leader.py`` on the same inputs and the same fake
monotonic clock: the JAX electors over a ``FakeCluster``, the port's over
the port's ``RestClient`` at a ``LocalApiServer`` serving another one
(faults injected as the JAX case does, by the cluster's reactors, which
reach the port's elector as HTTP errors). Each run makes the JAX case's
checks and returns what it observed (each round's verdict, the Lease's
holder, transitions and record fields), and the two packages'
observations must be equal. The failover case runs real elector threads
over HTTP for both packages. ``TestControllerGracefulShutdown`` runs the
port's command, ``python -m k8s_operator_libs_tpu_torch.upgrade_controller``.
"""

from __future__ import annotations

import contextlib
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from k8s_operator_libs_tpu.kube import ConflictError, FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube import RestClient as JaxRestClient
from k8s_operator_libs_tpu.kube import RestConfig as JaxRestConfig
from k8s_operator_libs_tpu.kube import leader as jax_leader
from k8s_operator_libs_tpu_torch.kube import leader as port_leader
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig

REPO = Path(__file__).resolve().parents[1]
NS = "kube-system"
NAME = "upgrade-controller-tpu"


class Clock:
    def __init__(self, start: float = 100.0) -> None:
        self.t = start

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class Side:
    """One package's elector module, a cluster, and the client its
    electors use: the cluster itself (``jax``) or a ``RestClient`` at a
    server of it (``port``)."""

    def __init__(self, name: str, stack: contextlib.ExitStack) -> None:
        self.le = jax_leader if name == "jax" else port_leader
        self.cluster = FakeCluster()
        self.client = self.cluster
        if name == "port":
            server = stack.enter_context(LocalApiServer(cluster=self.cluster))
            self.client = RestClient(RestConfig(server=server.url))
        self.clock = Clock()

    def elector(self, identity: str, **overrides):
        cfg = self.le.LeaderElectionConfig(name=NAME, namespace=NS, identity=identity,
                                           **overrides)
        return self.le.LeaderElector(self.client, cfg, now_fn=self.clock.now)

    def lease(self):
        return self.cluster.get("Lease", NAME, NS)


def on_both(case):
    """``case(side)`` for each package's side; equal outcomes."""
    outcomes = {}
    for name in ("jax", "port"):
        with contextlib.ExitStack() as stack:
            outcomes[name] = case(Side(name, stack))
    assert outcomes["port"] == outcomes["jax"]
    return outcomes["port"]


def _conflict(verb, kind, payload):
    raise ConflictError("simulated write race")


class TestProtocol:
    def test_acquire_creates_lease(self):
        def case(s):
            a = s.elector("a")
            held = a.try_acquire_or_renew()
            lease = s.lease()
            assert held and lease.holder_identity == "a"
            assert lease.lease_duration_seconds == 15 and lease.lease_transitions == 0
            assert lease.renew_time
            return held, lease.holder_identity, lease.lease_duration_seconds, \
                lease.lease_transitions

        on_both(case)

    def test_renew_updates_renew_time(self):
        def case(s):
            a = s.elector("a")
            assert a.try_acquire_or_renew()
            first = s.lease().renew_time
            time.sleep(0.001)  # the wall stamps must differ
            s.clock.advance(2)
            renewed = a.try_acquire_or_renew()
            lease = s.lease()
            assert renewed and lease.renew_time != first
            assert lease.lease_transitions == 0  # a renewal is no transition
            return renewed, lease.renew_time != first, lease.lease_transitions

        on_both(case)

    def test_follower_stands_by_while_leader_fresh(self):
        def case(s):
            a, b = s.elector("a"), s.elector("b")
            rounds = [a.try_acquire_or_renew(), b.try_acquire_or_renew()]
            s.clock.advance(10)  # < lease_duration_s since b observed the record
            rounds.append(b.try_acquire_or_renew())
            assert rounds == [True, False, False] and s.lease().holder_identity == "a"
            return rounds, s.lease().holder_identity

        on_both(case)

    def test_follower_steals_stale_lease_and_bumps_transitions(self):
        def case(s):
            a, b = s.elector("a"), s.elector("b")
            rounds = [a.try_acquire_or_renew(), b.try_acquire_or_renew()]
            s.clock.advance(16)  # a never renews: the observed age passes the lease
            rounds.append(b.try_acquire_or_renew())
            lease = s.lease()
            assert rounds == [True, False, True]
            assert lease.holder_identity == "b" and lease.lease_transitions == 1
            return rounds, lease.holder_identity, lease.lease_transitions

        on_both(case)

    def test_leader_renewal_resets_follower_steal_clock(self):
        def case(s):
            a, b = s.elector("a"), s.elector("b")
            rounds = [a.try_acquire_or_renew()]
            for _ in range(5):
                rounds.append(b.try_acquire_or_renew())
                s.clock.advance(10)
                time.sleep(0.001)
                rounds.append(a.try_acquire_or_renew())  # renews: the record changes
            rounds.append(b.try_acquire_or_renew())
            assert rounds == [True] + [False, True] * 5 + [False]
            assert s.lease().holder_identity == "a"
            return rounds, s.lease().holder_identity

        on_both(case)

    def test_release_hands_over_immediately(self):
        def case(s):
            a, b = s.elector("a"), s.elector("b")
            rounds = [a.try_acquire_or_renew(), b.try_acquire_or_renew()]
            a.release()
            rounds.append(b.try_acquire_or_renew())  # no clock advance at all
            lease = s.lease()
            assert rounds == [True, False, True]
            assert lease.holder_identity == "b" and lease.lease_transitions == 1
            return rounds, lease.holder_identity, lease.lease_transitions

        on_both(case)

    def test_release_by_non_holder_is_noop(self):
        def case(s):
            a, b = s.elector("a"), s.elector("b")
            assert a.try_acquire_or_renew()
            b.release()
            assert s.lease().holder_identity == "a"
            return s.lease().holder_identity

        on_both(case)

    def test_update_conflict_is_a_lost_round_not_a_crash(self):
        def case(s):
            a = s.elector("a")
            first = a.try_acquire_or_renew()
            s.cluster.add_reactor("update", "Lease", _conflict)
            s.clock.advance(2)
            second = a.try_acquire_or_renew()
            assert (first, second) == (True, False)
            return first, second

        on_both(case)

    def test_create_race_lost_is_a_lost_round(self):
        def case(s):
            a = s.elector("a")
            s.cluster.add_reactor("create", "Lease", _conflict)
            held = a.try_acquire_or_renew()
            assert not held
            return held

        on_both(case)

    def test_on_new_leader_callback(self):
        def case(s):
            seen = []
            a = s.elector("a")
            b = s.elector("b", on_new_leader=seen.append)
            rounds = [a.try_acquire_or_renew(), b.try_acquire_or_renew()]
            assert rounds == [True, False] and seen == ["a"]
            return rounds, seen

        on_both(case)

    @pytest.mark.parametrize("kwargs", [
        dict(identity=""),
        dict(identity="a", lease_duration_s=5, renew_deadline_s=5),
        dict(identity="a", retry_period_s=9, renew_deadline_s=9, lease_duration_s=15),
    ], ids=["no-identity", "deadline-not-below-duration", "retry-not-below-deadline"])
    def test_config_validation(self, kwargs):
        def case(s):
            with pytest.raises(ValueError) as exc:
                s.le.LeaderElectionConfig(name="x", namespace=NS, **kwargs)
            return str(exc.value)

        on_both(case)


FAST = dict(lease_duration_s=1.2, renew_deadline_s=0.8, retry_period_s=0.15)


def _wait_until(predicate, deadline_s, what):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


class TestFailoverE2E:
    """Real elector threads over real HTTP."""

    @pytest.mark.parametrize("pkg", ["jax", "port"])
    def test_graceful_and_crash_failover(self, pkg):
        le = jax_leader if pkg == "jax" else port_leader
        rest, config = (JaxRestClient, JaxRestConfig) if pkg == "jax" else (RestClient, RestConfig)
        with LocalApiServer() as server:
            clients = [rest(config(server=server.url)) for _ in range(3)]
            try:
                a, b, c = (
                    le.LeaderElector(clients[i], le.LeaderElectionConfig(
                        name=NAME, namespace=NS, identity=f"replica-{i}", **FAST))
                    for i in range(3)
                )
                a.start()
                assert a.wait_for_leadership(timeout=10)
                b.start()
                time.sleep(0.5)
                assert not b.is_leader()  # a standby while a renews
                # Graceful: stop() releases; b takes over well within the
                # lease it would otherwise wait out.
                a.stop()
                assert b.wait_for_leadership(timeout=10)
                # A crash: b stops without releasing; c steals only once the
                # lease is stale.
                b.stop(release=False)
                c.start()
                time.sleep(0.3)
                assert not c.is_leader()
                assert c.wait_for_leadership(timeout=10)
                lease = server.cluster.get("Lease", NAME, NS)
                assert lease.holder_identity == "replica-2"
                assert lease.lease_transitions >= 2
                c.stop()
            finally:
                for cl in clients:
                    cl.close()

    def test_lost_leadership_fires_callback(self):
        def case(s):
            stopped = []
            elector = s.le.LeaderElector(s.client, s.le.LeaderElectionConfig(
                name=NAME, namespace=NS, identity="flaky",
                on_stopped_leading=lambda: stopped.append(True), **FAST))
            elector.start()
            led = elector.wait_for_leadership(timeout=10)
            s.cluster.add_reactor("update", "Lease", _conflict)
            s.cluster.add_reactor("get", "Lease", _conflict)
            _wait_until(lambda: stopped and not elector.is_leader(), 10,
                        "on_stopped_leading after the renewals fail")
            elector.stop(release=False)
            assert led
            return led, stopped[:1], elector.is_leader()

        on_both(case)


class TestLeaseRecordFidelity:
    """The acquisition record survives renewals; the transition count
    survives a whole A -> B -> A cycle."""

    def test_renewal_preserves_acquire_time_and_transitions(self):
        def case(s):
            a = s.elector("a")
            assert a.try_acquire_or_renew()
            acquired_at = s.lease().spec["acquireTime"]
            s.clock.advance(2)
            time.sleep(0.001)
            assert a.try_acquire_or_renew()
            lease = s.lease()
            kept = lease.spec["acquireTime"] == acquired_at
            assert acquired_at and kept and "leaseTransitions" in lease.spec
            assert lease.renew_time != acquired_at
            return kept, "leaseTransitions" in lease.spec

        on_both(case)

    def test_transitions_accumulate_across_handovers(self):
        def case(s):
            a, b = s.elector("a"), s.elector("b")
            rounds = [a.try_acquire_or_renew(), b.try_acquire_or_renew()]
            s.clock.advance(2)
            rounds.append(a.try_acquire_or_renew())  # a renewal keeps the count
            a.release()
            rounds.append(b.try_acquire_or_renew())  # transition 1
            b.release()
            rounds.append(a.try_acquire_or_renew())  # transition 2
            assert rounds == [True, False, True, True, True]
            assert s.lease().lease_transitions == 2
            return rounds, s.lease().lease_transitions

        on_both(case)


class TestControllerGracefulShutdown:
    """The kubelet sends SIGTERM to a terminating controller pod: the port's
    command must exit 0 and release its Lease, so that a standby takes
    over at once."""

    def test_sigterm_releases_lease(self, tmp_path):
        lease_name = "upgrade-controller-nvidia"
        with LocalApiServer() as server:
            env = dict(os.environ)
            env["KUBECONFIG"] = server.write_kubeconfig(str(tmp_path / "kc"))
            env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
            proc = subprocess.Popen(
                [sys.executable, "-m", "k8s_operator_libs_tpu_torch.upgrade_controller",
                 "--leader-elect", "--leader-elect-id", "term-me", "--interval", "0.2"],
                cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            output: list[str] = []
            drainer = threading.Thread(target=lambda: output.extend(proc.stdout), daemon=True)
            drainer.start()
            client = RestClient(RestConfig(server=server.url))
            try:
                def holder():
                    lease = client.get_or_none("Lease", lease_name, NS)
                    return lease.holder_identity if lease else ""

                _wait_until(lambda: holder() == "term-me", 30,
                            "the controller to acquire the lease")
                proc.send_signal(signal.SIGTERM)
                proc.wait(timeout=30)
                drainer.join(timeout=5)
                out = "".join(output)
                assert proc.returncode == 0, out[-1500:]
                assert "shutdown requested; draining" in out
                assert client.get("Lease", lease_name, NS).holder_identity == ""
            finally:
                if proc.poll() is None:
                    proc.kill()
                client.close()
