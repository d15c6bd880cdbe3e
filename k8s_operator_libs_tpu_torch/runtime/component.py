"""The Component protocol and the lifecycle-resource registry.

The JAX package's ``runtime/component.py``. Everything that owns a
background footprint (a thread, a watch stream, a listening socket, a
held Lease) joins the supervision tree behind three methods: ``start``
acquires, ``stop`` releases within a budget, ``healthy`` answers the
liveness probe. The :class:`~.supervisor.Supervisor` owns the order;
each component manages only its own footprint.

:func:`lifecycle_resource` (``utils/lifecycle.py``) declares, with literal
method names, which call pair bounds a class's footprint; the repo's
analyzer (``tools/analyze.py``, its LIF8xx rules) reads the decorators.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Protocol, runtime_checkable

from ..utils.lifecycle import lifecycle_resource, registered_resources

__all__ = [
    "Component",
    "FuncComponent",
    "ThreadComponent",
    "lifecycle_resource",
    "registered_resources",
]


@runtime_checkable
class Component(Protocol):
    """One supervised background component.

    ``stop`` takes the remaining drain budget in seconds (None = use
    the component's own default); it must be idempotent and must never
    raise — a failed release is logged and reported, never allowed to
    abort the rest of the drain.
    """

    name: str

    def start(self) -> None: ...

    def stop(self, timeout: Optional[float] = None) -> None: ...

    def healthy(self) -> bool: ...


class FuncComponent:
    """Adapt plain callables to the :class:`Component` protocol.

    ``stop`` is a thunk — bind any arguments (release flags, budgets)
    at construction. The supervisor's per-component timeout is enforced
    OUTSIDE the thunk (supervisor drain helper), so a thunk that blocks
    cannot stall the rest of the drain.
    """

    def __init__(
        self,
        name: str,
        start: Optional[Callable[[], object]] = None,
        stop: Optional[Callable[[], object]] = None,
        healthy: Optional[Callable[[], bool]] = None,
    ) -> None:
        self.name = name
        self._start = start
        self._stop_fn = stop
        self._healthy = healthy

    def start(self) -> None:
        if self._start is not None:
            self._start()

    def stop(self, timeout: Optional[float] = None) -> None:
        if self._stop_fn is not None:
            self._stop_fn()

    def healthy(self) -> bool:
        if self._healthy is None:
            return True
        return bool(self._healthy())


@lifecycle_resource(acquire="start", release="stop")
class ThreadComponent:
    """Own ONE non-daemon thread running ``run(stop_event)``.

    The canonical worker-loop shape: ``run`` must poll (or wait on) the
    event and return promptly once it is set; ``stop`` sets the event
    and joins within the budget — always with a timeout, so shutdown
    stays bounded (LIF803).
    """

    def __init__(
        self,
        name: str,
        run: Callable[[threading.Event], object],
        join_timeout_s: float = 10.0,
    ) -> None:
        self.name = name
        self._run = run
        self._join_timeout_s = join_timeout_s
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError(f"component {self.name!r} already started")
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop_event,),
            name=self.name, daemon=False,
        )
        self._thread.start()

    def stop(self, timeout: Optional[float] = None) -> None:
        self._stop_event.set()
        thread = self._thread
        if thread is not None:
            budget = self._join_timeout_s if timeout is None else timeout
            thread.join(timeout=budget)
        self._thread = None

    def healthy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()
