"""The supervision tree: ordered start, reverse-ordered bounded drain.

The JAX package's ``runtime/supervisor.py``. One :class:`Supervisor` owns
every background component of a process behind the
:class:`~.component.Component` protocol. Components register with
``add(component, depends_on=...)`` naming their producers; the start
order is a deterministic topological sort of that graph (producers
first), the stop order its exact reverse, so a consumer never outlives
what feeds it.

Signals are events, not control flow: ``install_signal_handlers``
registers a handler that only sets a ``threading.Event`` (no lock, no
I/O). The main loop reads ``stop_requested`` or ``wait`` and runs the
drain from ordinary code.

The drain is bounded twice: one deadline for the whole tree and a budget
for each component within it. Each ``stop`` runs on a daemon helper
thread joined with a timeout, so a wedged component costs its budget and
no more; the :class:`StopReport` records who overran.
"""

from __future__ import annotations

import signal
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

from ..utils.log import get_logger
from .component import Component, lifecycle_resource

log = get_logger("runtime.supervisor")

__all__ = ["Supervisor", "SupervisorError", "StopReport"]


class SupervisorError(RuntimeError):
    """Bad supervision wiring: duplicate name, unknown or cyclic deps."""


@dataclass
class StopReport:
    """How one component's drain went — the shutdown audit record."""

    name: str
    seconds: float
    ok: bool = True
    timed_out: bool = False
    error: str = ""


@dataclass
class _Entry:
    component: Component
    depends_on: tuple[str, ...] = ()
    started: bool = False


@lifecycle_resource(acquire="start", release="stop")
class Supervisor:
    """Own, order, and drain a daemon's background components."""

    def __init__(
        self,
        drain_timeout_s: float = 30.0,
        component_timeout_s: float = 10.0,
        mono=time.monotonic,
    ) -> None:
        self._drain_timeout_s = drain_timeout_s
        self._component_timeout_s = component_timeout_s
        self._mono = mono
        self._entries: dict[str, _Entry] = {}
        self._add_order: list[str] = []
        self._started = False
        self._stop_event = threading.Event()
        self._prev_handlers: dict[int, object] = {}
        #: Per-component drain records from the most recent stop().
        self.stop_reports: list[StopReport] = []

    # -- wiring -------------------------------------------------------------
    def add(
        self, component: Component, depends_on: Iterable[str] = ()
    ) -> Component:
        """Register ``component``; ``depends_on`` names its producers
        (components it consumes), which start before it and stop after
        it. Forward references are fine — the DAG is validated when
        :meth:`start` sorts it."""
        name = component.name
        if name in self._entries:
            raise SupervisorError(f"duplicate component name {name!r}")
        self._entries[name] = _Entry(component, tuple(depends_on))
        self._add_order.append(name)
        return component

    def adopt(
        self, component: Component, depends_on: Iterable[str] = ()
    ) -> Component:
        """Register a component that is ALREADY running (the command's
        shape: acquisition interleaves with sync waits, so the setup
        code starts components itself and hands the supervisor
        ownership of the drain). The component joins the stop order
        immediately — :meth:`stop` drains it in reverse dependency
        order even if :meth:`start` is never called, so a signal
        landing mid-setup still drains everything adopted so far."""
        self.add(component, depends_on)
        self._entries[component.name].started = True
        return component

    def component(self, name: str) -> Component:
        return self._entries[name].component

    def names(self) -> tuple[str, ...]:
        return tuple(self._add_order)

    def _toposort(self) -> list[str]:
        """Deterministic Kahn's sort: producers first, ties broken by
        registration order."""
        for name in self._add_order:
            for dep in self._entries[name].depends_on:
                if dep not in self._entries:
                    raise SupervisorError(
                        f"component {name!r} depends on unknown {dep!r}"
                    )
        indeg = {
            name: len(set(self._entries[name].depends_on))
            for name in self._add_order
        }
        consumers: dict[str, list[str]] = {n: [] for n in self._add_order}
        for name in self._add_order:
            for dep in set(self._entries[name].depends_on):
                consumers[dep].append(name)
        ready = [n for n in self._add_order if indeg[n] == 0]
        order: list[str] = []
        while ready:
            name = ready.pop(0)
            order.append(name)
            for consumer in consumers[name]:
                indeg[consumer] -= 1
                if indeg[consumer] == 0:
                    ready.append(consumer)
        if len(order) != len(self._add_order):
            cyclic = sorted(n for n in self._add_order if indeg[n] > 0)
            raise SupervisorError(f"dependency cycle through {cyclic}")
        return order

    def _drain_order(self) -> list[str]:
        """Reverse-dependency drain order over the STARTED entries:
        consumers before producers. Tolerant where :meth:`_toposort` is
        strict — unknown deps are ignored and a cycle degrades to
        registration order — because stop() must drain everything it
        owns no matter how the wiring ended up."""
        indeg: dict[str, int] = {}
        consumers: dict[str, list[str]] = {n: [] for n in self._add_order}
        for name in self._add_order:
            deps = {
                d for d in self._entries[name].depends_on
                if d in self._entries
            }
            indeg[name] = len(deps)
            for dep in deps:
                consumers[dep].append(name)
        ready = [n for n in self._add_order if indeg[n] == 0]
        order: list[str] = []
        while ready:
            name = ready.pop(0)
            order.append(name)
            for consumer in consumers[name]:
                indeg[consumer] -= 1
                if indeg[consumer] == 0:
                    ready.append(consumer)
        placed = set(order)
        order.extend(n for n in self._add_order if n not in placed)
        return [n for n in reversed(order) if self._entries[n].started]

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Supervisor":
        """Start every not-yet-running component, producers first
        (adopted components are skipped — they are already running). A
        failed start drains whatever is running (in reverse) and
        re-raises."""
        if self._started:
            raise RuntimeError("supervisor already started")
        self._stop_event.clear()
        order = self._toposort()
        self._started = True
        for name in order:
            entry = self._entries[name]
            if entry.started:
                continue
            try:
                entry.component.start()
            except BaseException:
                log.error("supervisor: start of %r failed; draining", name)
                self.stop()
                raise
            entry.started = True
        return self

    def stop(self, timeout: Optional[float] = None) -> list[StopReport]:
        """Drain every running component, consumers before producers,
        under one overall deadline with per-component budgets. Never
        raises: failures and overruns are recorded in the returned
        :class:`StopReport` list (also kept on ``self.stop_reports``)."""
        overall = self._drain_timeout_s if timeout is None else timeout
        deadline = self._mono() + overall
        reports: list[StopReport] = []
        for name in self._drain_order():
            entry = self._entries[name]
            remaining = max(0.0, deadline - self._mono())
            budget = min(self._component_timeout_s, remaining)
            reports.append(self._stop_one(entry, budget))
            entry.started = False
        self._started = False
        self._stop_event.set()
        self.stop_reports = reports
        return reports

    def _stop_one(self, entry: _Entry, budget: float) -> StopReport:
        """Run one component's stop on a daemon helper joined with the
        budget — a wedged release costs its budget, not the drain."""
        component = entry.component
        failure: list[BaseException] = []

        def _invoke() -> None:
            try:
                component.stop(budget)
            except BaseException as e:  # noqa: BLE001 - recorded, drain goes on
                failure.append(e)

        began = self._mono()
        helper = threading.Thread(
            target=_invoke, name=f"stop-{component.name}", daemon=True
        )
        helper.start()
        helper.join(timeout=budget)
        seconds = self._mono() - began
        if helper.is_alive():
            log.warning(
                "supervisor: component %r overran its %.1fs stop budget",
                component.name, budget,
            )
            return StopReport(component.name, seconds, ok=False,
                              timed_out=True)
        if failure:
            log.warning(
                "supervisor: component %r stop raised: %s",
                component.name, failure[0],
            )
            return StopReport(component.name, seconds, ok=False,
                              error=str(failure[0]))
        return StopReport(component.name, seconds)

    def __enter__(self) -> "Supervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- health -------------------------------------------------------------
    def healthy(self) -> bool:
        """True when at least one component is running and every
        running component reports healthy — the daemon's single
        liveness answer."""
        running = [e for e in self._entries.values() if e.started]
        if not running:
            return False
        return all(e.component.healthy() for e in running)

    # -- signals (LIF805-clean by construction) ------------------------------
    def _on_signal(self, signum, frame) -> None:
        # ONLY set the event: no locks, no I/O, no loop touches — the
        # main loop observes stop_requested and runs the actual drain.
        self._stop_event.set()

    def install_signal_handlers(
        self, signals: Sequence[int] = (signal.SIGTERM, signal.SIGINT)
    ) -> None:
        """Route ``signals`` to the stop event. Main thread only (a
        CPython restriction); previous handlers are kept for
        :meth:`restore_signal_handlers`."""
        for signum in signals:
            self._prev_handlers[signum] = signal.signal(
                signum, self._on_signal
            )

    def restore_signal_handlers(self) -> None:
        while self._prev_handlers:
            signum, prev = self._prev_handlers.popitem()
            signal.signal(signum, prev)

    def request_stop(self) -> None:
        self._stop_event.set()

    @property
    def stop_requested(self) -> bool:
        return self._stop_event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until stop is requested (or ``timeout``); True when
        the stop event fired — the daemon main loop's sleep."""
        return self._stop_event.wait(timeout)
