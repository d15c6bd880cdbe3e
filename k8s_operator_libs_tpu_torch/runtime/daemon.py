"""The fleet orchestrator as a supervised daemon.

The JAX package's ``runtime/daemon.py``. :class:`OrchestratorDaemon`
puts a :class:`~..fleet.orchestrator.FleetOrchestrator` behind the
Component protocol: a ``fleet-orchestrator`` leader election of its own
(one grant issuer a fleet, any number of standbys), wakeups on the
FleetRollout's watch (``fleet/wakeup.py``) and one non-daemon tick
thread. Shard workers (``upgrade_controller --shards N --shard-index i``)
and orchestrator replicas (``--orchestrate``) run against one API server;
only the Lease's holder ticks, so an orchestrator's crash fails over as a
worker's does: the successor resumes from the ledger.

:meth:`OrchestratorDaemon.stop` drains consumers first: the tick loop,
then the wakeup streams that feed it, then the Lease, released at once so
that a standby takes over without waiting out the lease. Unlike the JAX
package's, the Lease is released only if the tick thread ended within the
stop's budget: a thread still in a grant round could write the ledger
after a successor leads, so it is left to expire then.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence

from ..fleet.orchestrator import FleetHealthAggregator, FleetOrchestrator
from ..fleet.wakeup import WATCH_WINDOW_SECONDS, WatchWake
from ..kube.client import Client
from ..kube.leader import LeaderElectionConfig, LeaderElector
from ..utils.log import get_logger
from .component import lifecycle_resource

log = get_logger("runtime.daemon")

__all__ = ["OrchestratorDaemon"]


@lifecycle_resource(acquire="start", release="stop")
class OrchestratorDaemon:
    """A supervised, leader-elected FleetOrchestrator tick loop."""

    def __init__(
        self,
        client: Client,
        rollout_name: str,
        namespace: str = "default",
        identity: str = "",
        interval_s: float = 2.0,
        aggregator: Optional[FleetHealthAggregator] = None,
        policy: Sequence[str] = (),
        lease_name: str = "fleet-orchestrator",
        lease_duration_s: float = 15.0,
        renew_deadline_s: float = 10.0,
        retry_period_s: float = 2.0,
        use_wakeups: bool = True,
        wake_window_s: int = WATCH_WINDOW_SECONDS,
        join_timeout_s: float = 10.0,
    ) -> None:
        self.name = "fleet-orchestrator"
        self._client = client
        self._namespace = namespace
        self._interval_s = interval_s
        self._use_wakeups = use_wakeups
        self._wake_window_s = wake_window_s
        self._join_timeout_s = join_timeout_s
        self.orchestrator = FleetOrchestrator(
            client, rollout_name, aggregator=aggregator, policy=policy
        )
        self.elector = LeaderElector(
            client,
            LeaderElectionConfig(
                name=lease_name,
                namespace=namespace,
                identity=identity or f"orchestrator-{os.getpid()}",
                lease_duration_s=lease_duration_s,
                renew_deadline_s=renew_deadline_s,
                retry_period_s=retry_period_s,
            ),
        )
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._wake: Optional[WatchWake] = None
        #: Ticks issued while holding the Lease.
        self.led_ticks = 0
        #: Whether the last stop released the Lease (False: the tick thread
        #: outlived the budget and the Lease is left to expire).
        self.released = False

    # -- Component ---------------------------------------------------------------------
    def start(self) -> "OrchestratorDaemon":
        if self._thread is not None:
            raise RuntimeError("orchestrator daemon already started")
        self.elector.start()
        if self._use_wakeups:
            self._wake = WatchWake(self._client, ("FleetRollout",), namespace=self._namespace,
                                   window_seconds=self._wake_window_s)
        self._stop_event.clear()
        self._thread = threading.Thread(target=self._loop, name="fleet-orchestrator",
                                        daemon=False)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """The tick loop, then the wakeup streams, then the Lease: released
        at once where the loop ended, left to expire where it did not."""
        budget = self._join_timeout_s if timeout is None else timeout
        self._stop_event.set()
        wake = self._wake
        if wake is not None:
            wake.poke()  # release a wait in progress at once
        thread = self._thread
        ended = True
        if thread is not None:
            thread.join(timeout=budget)
            ended = not thread.is_alive()
        self._thread = None
        if wake is not None:
            wake.stop()
        self._wake = None
        if not ended:
            log.warning("fleet orchestrator: the tick thread outlived the stop; "
                        "leaving the Lease to expire")
        self.elector.stop(release=ended)
        self.released = ended

    def healthy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- the loop --------------------------------------------------------------------------
    def is_leader(self) -> bool:
        return self.elector.is_leader()

    def _loop(self) -> None:
        while not self._stop_event.is_set():
            if self.elector.is_leader():
                traces = self._wake.consume_traces() if self._wake is not None else []
                self.orchestrator.tick(wake_traces=traces or None)
                self.led_ticks += 1
            if self._stop_event.is_set():
                return
            if self._wake is not None:
                # A ledger delivery, or a stop's poke, ends the wait early;
                # the interval is the safety net.
                self._wake.wait(self._interval_s)
            else:
                self._stop_event.wait(self._interval_s)
