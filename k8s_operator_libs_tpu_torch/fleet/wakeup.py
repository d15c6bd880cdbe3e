"""Tick wakeups on watch delivery for the fleet's loops.

The JAX package's ``fleet/wakeup.py``. A tick loop that polls pays one
interval a hop: a worker reports a completion, the orchestrator sees it
at its next tick and grants, and each worker sees the grant at its next.
:class:`WatchWake` follows the watch streams instead, one thread a kind,
and releases the waiting loop when a frame lands, so a tick starts one
delivery after its cause.

Each delivery's ``resourceVersion`` is looked up in the tracer's book of
write origins, and the originating traces are handed to the woken tick:
``FleetOrchestrator.tick(wake_traces=...)`` links its grant span to them,
and a worker hands them to ``IncrementalSnapshotSource.note_wake_trace``,
so its pass span links back to the grant.

A shared watch hub as the streams' source waits for ROADMAP A18 (b); the
threads watch through the client. Unlike the JAX package's, :meth:`stop`
cancels each open window (``kube/rest.py``'s ``WatchHandle``) rather than
letting it run out.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from ..kube.client import Client, WatchExpiredError, has_reason
from ..kube.rest import WatchHandle
from ..utils import tracing
from ..utils.lifecycle import lifecycle_resource
from ..utils.log import get_logger

log = get_logger("fleet.wakeup")

#: Bounded watch windows; a window resumed from the last revision seen
#: misses nothing (the journal replays).
WATCH_WINDOW_SECONDS = 5


@lifecycle_resource(acquire="__init__", release="stop")
class WatchWake:
    """Wake a tick loop on the watch delivery of any of ``kinds``. One a
    loop: the loop calls :meth:`wait`, the rest is internal.

    The wake is level-triggered (an Event, not a queue): N deliveries
    between two waits are one wake, which is the reconcile contract: a
    tick derives everything from the current state, so it needs to know
    *that* something changed, never *what*.
    """

    def __init__(
        self,
        client: Client,
        kinds: Sequence[str],
        namespace: str = "",
        window_seconds: int = WATCH_WINDOW_SECONDS,
    ) -> None:
        self._client = client
        self._namespace = namespace
        self._window = window_seconds
        self._event = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._traces: list[str] = []
        self._handles: dict[str, WatchHandle] = {}
        #: Deliveries seen and wakes granted (a wake may carry many).
        self.deliveries = 0
        self.wakes = 0
        self._threads = [
            threading.Thread(target=self._follow, args=(kind,),
                             name=f"watch-wake-{kind.lower()}", daemon=True)
            for kind in kinds
        ]
        for t in self._threads:
            t.start()

    # -- the loop's side -----------------------------------------------------------
    def wait(self, timeout: Optional[float]) -> bool:
        """Block until a delivery lands or ``timeout`` (the loop's interval,
        the safety net) passes; True where a delivery woke it."""
        fired = self._event.wait(timeout)
        if fired:
            self._event.clear()
            self.wakes += 1
        return fired

    def consume_traces(self) -> list[str]:
        """The traces of the writes whose deliveries woke the loop since the
        last call (empty with no tracer installed)."""
        with self._lock:
            if not self._traces:
                return []
            out, self._traces = self._traces, []
            return out

    def poke(self) -> None:
        """Release the current :meth:`wait` at once, with no delivery: a
        stop does so, so that a loop parked on its interval sees it now."""
        self._event.set()

    def stop(self, join_timeout: Optional[float] = None) -> None:
        self._stop.set()
        with self._lock:
            handles = list(self._handles.values())
        for handle in handles:
            handle.cancel()
        if join_timeout is not None:
            # Joined, so that no window opens after stop returns.
            deadline = time.monotonic() + join_timeout
            for t in self._threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))

    # -- the followers ---------------------------------------------------------------
    def _follow(self, kind: str) -> None:
        resource_version: Optional[str] = None
        while not self._stop.is_set():
            handle = WatchHandle()
            with self._lock:
                self._handles[kind] = handle
            if self._stop.is_set():
                return
            try:
                for event_type, obj in self._client.watch(
                    kind, namespace=self._namespace, timeout_seconds=self._window,
                    resource_version=resource_version, handle=handle, allow_bookmarks=True,
                ):
                    rv = obj.resource_version
                    if rv:
                        resource_version = rv
                    if event_type == "BOOKMARK":
                        continue  # a resume point only: nothing changed
                    self.deliveries += 1
                    self._note_origin(rv)
                    self._event.set()
                    if self._stop.is_set():
                        return
            except Exception as e:  # noqa: BLE001 - the client's own classes
                if self._stop.is_set():
                    return
                resource_version = None
                if has_reason(e, WatchExpiredError):
                    # Out of the journal's window: resume from now. The
                    # missed deltas still wake the loop: the state moved.
                    self._event.set()
                    continue
                log.warning("watch-wake %s: stream failed: %s", kind, e)
                # One window's pause, so that a server that is down is not spun on.
                self._stop.wait(self._window)

    def _note_origin(self, rv: str) -> None:
        tracer = tracing.tracer()
        if tracer is None or not rv:
            return
        origin = tracer.write_origin(rv)
        if origin is None:
            return
        trace_id = origin[0]
        with self._lock:
            if len(self._traces) < 64 and trace_id not in self._traces:
                self._traces.append(trace_id)
