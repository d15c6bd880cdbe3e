"""The wall clock behind the state machine's durable clocks, and the
named fault points.

A copy of the JAX package's ``utils/faultpoints.py``. :func:`wall_now` is
``time.time`` unless a clock is installed, and the annotation-backed
deadlines (the validation timeout, the wait for workload pods, the
checkpoint escalation) and the slice planner's budget view read it.
:func:`mono_now` is ``time.monotonic`` unless the installed clock has a
``now()``. A test installs a virtual clock, an object with a ``wall()``
method, so a deadline passes when the test says time passed; the same
clock object may be installed here and in the JAX package to drive both
machines alike. :class:`ChaosClock` is the chaos harness's clock
(``testing/chaos.py``): virtual monotonic and wall time, advanced only by
the schedule's driver.

A fault plan (an object with ``consult(point, ctx) -> FaultAction or
None``) answers :func:`fault_point` at the named points the port
consults:

* ``lease.round`` in ``kube/leader.py`` (``DENY`` fails the round before
  any Lease write);
* ``fleet.grant_write`` in ``fleet/orchestrator.py`` and
  ``fleet.status_write`` in ``fleet/worker.py`` (``RAISE``);
* ``upgrade.write_batch_partial`` in ``upgrade/write_batch.py``, one
  consult per batch entry (``RAISE``);
* ``watch.deliver`` in ``kube/informer.py``, where :func:`chaos_hold`
  blocks a watch stream while the plan answers ``HOLD`` (a lagging
  stream: the consumer's view goes stale until the plan lets go);
* ``watchhub.deliver`` in ``kube/watchhub.py``, where ``OVERFLOW`` forces
  every live subscriber's buffer over its bound;
* ``wire.partition`` in the chaos harness's ``PartitionedClient``
  (``RAISE``: the participant is cut from the apiserver).

With no plan installed a consult is one global read, and
:func:`plan_active` lets a site skip the work of building its consult's
context.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Protocol

#: The kinds a plan may answer with, as the JAX module names them:
#: ``deny`` fails a protocol round benignly, ``raise`` raises
#: ``FaultAction.exc`` at the site, ``hold`` blocks a delivery while the
#: plan keeps answering it, ``overflow`` forces a watch hub's buffers over
#: their bound.
DENY = "deny"
RAISE = "raise"
HOLD = "hold"
OVERFLOW = "overflow"


@dataclass
class FaultAction:
    """One consult's verdict (``kind`` as the JAX module names them); the
    port's point raises ``exc``, which the plan builds."""

    kind: str
    exc: Optional[BaseException] = None


class WallClock(Protocol):
    def wall(self) -> float: ...


class ChaosClock:
    """Virtual monotonic and wall time, advanced only by the schedule's
    driver: Lease expiry, failover probes and the durable-clock deadlines
    move when the schedule says time passed, never because the host was
    slow. Thread-safe: watch and pump threads read it while the driver
    advances it."""

    def __init__(self, start: float = 100.0, wall_start: float = 1_700_000_000.0) -> None:
        self._lock = threading.Lock()
        self._mono = float(start)
        self._wall = float(wall_start)

    def now(self) -> float:
        """The monotonic reading (a ``LeaderElector``'s or
        ``ShardWorker``'s ``now_fn``)."""
        with self._lock:
            return self._mono

    def wall(self) -> float:
        """The wall reading (``wall_fn`` and :func:`wall_now`)."""
        with self._lock:
            return self._wall

    def advance(self, dt: float) -> None:
        with self._lock:
            self._mono += dt
            self._wall += dt


_clock: Optional[WallClock] = None
_plan: Optional[Any] = None


def install_plan(plan: Any) -> None:
    """Install the fault plan; one at a time."""
    global _plan
    if _plan is not None and plan is not None:
        raise RuntimeError("a fault plan is already installed")
    _plan = plan


def clear_plan() -> None:
    global _plan
    _plan = None


def plan_active() -> bool:
    """True while a fault plan is installed: the cheap check before a
    site builds a costly context (the hub's scan of its subscribers)."""
    return _plan is not None


def fault_point(point: str, **ctx: Any) -> Optional[FaultAction]:
    """The installed plan's answer at ``point`` (``ctx`` names the site:
    the node, the kind); None without a plan."""
    plan = _plan
    if plan is None:
        return None
    return plan.consult(point, ctx)


def install_clock(clock: Optional[WallClock]) -> None:
    """Install the clock behind :func:`wall_now` and :func:`mono_now` (a
    :class:`ChaosClock`, or any object with a ``wall()``); one at a time."""
    global _clock
    if _clock is not None and clock is not None:
        raise RuntimeError("a clock is already installed")
    _clock = clock


def clear_clock() -> None:
    global _clock
    _clock = None


def wall_now() -> float:
    """``time.time()``, or the installed clock's ``wall()``."""
    clock = _clock
    return time.time() if clock is None else clock.wall()


def mono_now() -> float:
    """``time.monotonic()``, or the installed clock's ``now()`` where it
    has one (a clock of ``wall()`` alone leaves the monotonic time real)."""
    now = getattr(_clock, "now", None)
    return time.monotonic() if now is None else now()


def chaos_hold(
    point: str,
    should_abort: Callable[[], bool],
    poll_s: float = 0.002,
    **ctx: Any,
) -> None:
    """Block while the plan answers ``HOLD`` at ``point`` (a held watch
    stream). Returns at once with no plan installed; ``should_abort``
    (the caller's stop signal) always wins, so a held thread can still
    shut down."""
    while not should_abort():
        act = fault_point(point, **ctx)
        if act is None or act.kind != HOLD:
            return
        time.sleep(poll_s)
