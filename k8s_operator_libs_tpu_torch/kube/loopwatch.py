"""The event-loop stall watchdog of the client's wire loop.

The JAX package's ``kube/loopwatch.py``. A coroutine on the watched loop
sleeps ``interval_s`` and measures how late each wakeup arrives on the
loop itself: a callback that holds the loop for S seconds delays the
heartbeat by about S, so the observed lateness is the worst stall every
other task on the loop saw. It catches what a static proof cannot see
(an unresolved dispatch, a C extension, a CPU-bound callback) at about 50
no-op wakeups a second.

Exported as the ``tpu_operator_wire_loop_stall_*`` counter and
max-seconds pair through :class:`~..upgrade.metrics.WireMetrics`.

Caveats: the resolution is ``interval_s`` (a shorter stall reads as 0);
descheduling of the whole process also delays the heartbeat, so the
default threshold sits well above scheduler jitter and well below any
real blocking call (socket timeouts, sleeps and subprocess waits are
hundreds of milliseconds or more).
"""

from __future__ import annotations

import asyncio
import threading
from typing import Optional

from ..utils.lifecycle import lifecycle_resource

#: Default stall threshold: far above GIL/scheduler jitter (tens of ms
#: even on loaded CI runners), far below any genuine blocking call on
#: the wire path (transport timeouts are seconds).
DEFAULT_STALL_THRESHOLD_S = 0.5

#: Heartbeat cadence — the measurement resolution.
DEFAULT_HEARTBEAT_INTERVAL_S = 0.02


@lifecycle_resource(acquire="start", release="stop")
class LoopStallWatchdog:
    """Heartbeat-gap stall detector for one event loop.

    Counters are written on the loop thread and read from any thread
    (single-field int/float reads are GIL-atomic — the wire-counter
    convention of ``kube/rest.py``/``kube/apiserver.py``).
    """

    def __init__(
        self,
        loop: asyncio.AbstractEventLoop,
        threshold_s: float = DEFAULT_STALL_THRESHOLD_S,
        interval_s: float = DEFAULT_HEARTBEAT_INTERVAL_S,
    ) -> None:
        self._loop = loop
        self.threshold_s = float(threshold_s)
        self.interval_s = float(interval_s)
        #: Heartbeat wakeups that arrived >= threshold late — each one
        #: is a distinct window in which the loop could not run.
        self.stalls_over_threshold = 0
        #: Worst observed lateness (seconds) since start()/reset().
        self.max_stall_s = 0.0
        self.heartbeats = 0
        self.stopped = False
        self._task: Optional[asyncio.Task] = None
        #: Last heartbeat wakeup (loop clock); loop-thread only, and
        #: refreshed by reset()'s dispatched zeroing so a stall in
        #: flight when reset() lands is not billed to the new window.
        self._last_beat = 0.0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "LoopStallWatchdog":
        """Install the heartbeat task; safe from any thread, before or
        after the loop starts running."""

        def _install() -> None:
            """Runs on the watched loop."""
            if not self.stopped:
                self._task = self._loop.create_task(self._beat())

        self._loop.call_soon_threadsafe(_install)
        return self

    def stop(self) -> None:
        self.stopped = True
        task = self._task
        if task is not None:
            try:
                self._loop.call_soon_threadsafe(task.cancel)
            except RuntimeError:
                pass  # loop already closed; the task died with it

    def reset(self, wait_s: float = 5.0) -> None:
        """Zero the counters (benchmark windows measure from here).
        Callable from any thread: the write is dispatched to the
        watched loop — the counters are loop-bound state, so the zeroing
        serializes with the heartbeat instead of racing it (the ASY604
        discipline, applied to the watchdog itself) — and the caller
        blocks until it lands (bounded by ``wait_s``), so counters read
        after ``reset()`` returns never show the previous window."""
        done = threading.Event()

        def _zero() -> None:
            """Runs on the watched loop."""
            self.stalls_over_threshold = 0
            self.max_stall_s = 0.0
            self.heartbeats = 0
            # A stall in flight while reset() was called belongs to the
            # PREVIOUS window: restart the lateness clock from now so
            # the next heartbeat does not bill it to the fresh one.
            self._last_beat = self._loop.time()
            done.set()

        try:
            self._loop.call_soon_threadsafe(_zero)
        except RuntimeError:
            _zero()  # loop already closed: no heartbeat left to race
            return
        done.wait(wait_s)

    async def _beat(self) -> None:
        """Runs on the watched loop."""
        loop = asyncio.get_running_loop()
        self._last_beat = loop.time()
        try:
            while not self.stopped:
                await asyncio.sleep(self.interval_s)
                now = loop.time()
                stall = now - self._last_beat - self.interval_s
                self._last_beat = now
                self.heartbeats += 1
                if stall > self.max_stall_s:
                    self.max_stall_s = stall
                if stall >= self.threshold_s:
                    self.stalls_over_threshold += 1
        except asyncio.CancelledError:
            raise

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        """The ``tpu_operator_wire_loop_stall_*`` feed."""
        return {
            "stalls_over_threshold": self.stalls_over_threshold,
            "max_stall_s": round(self.max_stall_s, 4),
            "threshold_s": self.threshold_s,
            "heartbeats": self.heartbeats,
        }


# -- the shared client wire loop ------------------------------------------

_wire_watchdog: Optional[LoopStallWatchdog] = None
_wire_watchdog_lock = threading.Lock()


def install_wire_loop_watchdog(
    threshold_s: float = DEFAULT_STALL_THRESHOLD_S,
    interval_s: float = DEFAULT_HEARTBEAT_INTERVAL_S,
) -> LoopStallWatchdog:
    """Start (or return) the process-wide watchdog on the shared client
    wire loop (``kube/rest.py``). Idempotent per loop: a second install
    returns the live watchdog with the REQUESTED threshold/interval
    applied (both are live-tunable — the heartbeat reads them per
    wakeup), so the advertised tuning knob works regardless of who
    installed first; callers that need a fresh measurement window use
    :meth:`LoopStallWatchdog.reset`."""
    from .rest import _get_wire_loop

    global _wire_watchdog
    with _wire_watchdog_lock:
        loop = _get_wire_loop()
        watchdog = _wire_watchdog
        if (watchdog is not None and watchdog._loop is loop
                and not watchdog.stopped):
            watchdog.threshold_s = float(threshold_s)
            watchdog.interval_s = float(interval_s)
            return watchdog
        _wire_watchdog = LoopStallWatchdog(
            loop, threshold_s=threshold_s, interval_s=interval_s
        ).start()
        return _wire_watchdog


def wire_loop_stall_stats() -> dict:
    """Stats of the shared wire-loop watchdog; ``{}`` when none is
    installed (WireMetrics renders nothing then)."""
    watchdog = _wire_watchdog
    return watchdog.stats() if watchdog is not None else {}
