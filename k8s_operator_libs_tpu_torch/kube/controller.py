"""The controller runtime: informers feed a rate-limited workqueue that
feeds reconcile workers.

The JAX package's ``kube/controller.py``. The upgrade library's contract is
"call ``build_state``/``apply_state`` from your ``Reconcile`` loop"; this is
that loop, in controller-runtime's shape:

* ``Request``: the (namespace, name) reconcile key, hashable, so the queue
  collapses many events of one object into one pass;
* ``Result``: ``requeue``/``requeue_after`` with controller-runtime's
  outcome contract. An exception queues the key again with a per-item
  exponential backoff; ``requeue_after`` schedules a timed revisit and
  resets the backoff; a plain success resets it too;
* ``Controller.watch(informer, ...)``: a source with an optional predicate
  (the requestor mode's predicates plug in unchanged) and an optional
  mapper (the default enqueues the event's own object).

The workqueue's dirty/processing invariant keeps a key from being
reconciled concurrently with itself even with ``max_concurrent > 1``: the
one-writer-a-node rule the state machine depends on.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Iterable, NamedTuple, Optional

from .informer import Informer
from .objects import KubeObject
from .workqueue import RateLimitingQueue
from ..utils.log import get_logger

log = get_logger("kube.controller")


class Request(NamedTuple):
    """The reconcile key: controller-runtime's ``reconcile.Request``
    (a NamespacedName). Hashable so the workqueue can dedup it."""

    namespace: str
    name: str


@dataclass(frozen=True)
class Result:
    """controller-runtime ``reconcile.Result``. ``requeue_after > 0``
    wins over ``requeue`` (same precedence as upstream)."""

    requeue: bool = False
    requeue_after: float = 0.0


#: predicate signature: (event_type, obj, old) -> bool — the same plain
#: functions the requestor-mode predicates already use.
Predicate = Callable[[str, KubeObject, Optional[KubeObject]], bool]
#: mapper signature: (event_type, obj, old) -> iterable of Requests.
Mapper = Callable[[str, KubeObject, Optional[KubeObject]], Iterable[Request]]
#: reconciler: Request -> Result | None (None means plain success).
Reconciler = Callable[[Request], Optional[Result]]


class Controller:
    """N workers over a rate-limited queue, fed by informer watches.

    Lifecycle: construct with the reconciler, ``watch()`` sources, then
    ``start()`` (starts any informer not already running, waits for
    their initial sync so the first reconciles see a warm cache) and
    eventually ``stop()`` (drains nothing — in-flight reconciles finish,
    queued keys are dropped, informers this controller started are
    stopped)."""

    def __init__(
        self,
        reconciler: Reconciler,
        *,
        max_concurrent_reconciles: int = 1,
        rate_limiter=None,
        name: str = "controller",
    ) -> None:
        if max_concurrent_reconciles < 1:
            raise ValueError("max_concurrent_reconciles must be >= 1")
        self._reconciler = reconciler
        self.name = name
        self.max_concurrent_reconciles = max_concurrent_reconciles
        self.queue = RateLimitingQueue(rate_limiter)
        self._watches: list[Informer] = []
        # Informers THIS controller started (decided at start() time, not
        # watch() time): only these are stopped on stop(), so an informer
        # shared with other components is never torn down from here.
        self._owned: list[Informer] = []
        self._workers: list[threading.Thread] = []
        self._started = False
        self._lock = threading.Lock()

    # -- wiring ------------------------------------------------------------
    def watch(
        self,
        informer: Informer,
        *,
        predicate: Optional[Predicate] = None,
        mapper: Optional[Mapper] = None,
    ) -> "Controller":
        """Register a source. The default mapping is
        EnqueueRequestForObject — one ``Request`` per event object
        (DELETED included: controllers reconcile absence). A ``mapper``
        overrides it (EnqueueRequestsFromMapFunc), e.g. mapping a Pod
        event to its node's Request. Predicates run first and see
        ``(event_type, obj, old)``."""

        def handler(event: str, obj: KubeObject, old: Optional[KubeObject]):
            if predicate is not None:
                try:
                    if not predicate(event, obj, old):
                        return
                except Exception:  # noqa: BLE001 - predicate owns its errors
                    log.exception("%s: predicate failed; enqueueing anyway",
                                  self.name)
            if mapper is not None:
                try:
                    requests = list(mapper(event, obj, old))
                except Exception:  # noqa: BLE001 - mapper owns its errors
                    log.exception("%s: mapper failed; event dropped",
                                  self.name)
                    return
            else:
                requests = [Request(obj.namespace or "", obj.name)]
            for request in requests:
                self.queue.add(request)

        informer.add_event_handler(handler)
        self._watches.append(informer)
        return self

    def enqueue(self, request: Request) -> None:
        """Manual trigger (the GenericEvent channel analog)."""
        self.queue.add(request)

    def enqueue_after(self, request: Request, delay: float) -> None:
        self.queue.add_after(request, delay)

    # -- lifecycle ---------------------------------------------------------
    def start(self, sync_timeout: Optional[float] = 30.0) -> "Controller":
        with self._lock:
            if self._started:
                raise RuntimeError(f"{self.name} already started")
            self._started = True
        for informer in self._watches:
            if not informer.started:
                informer.start()
                self._owned.append(informer)
        for informer in self._watches:
            if not informer.wait_for_sync(sync_timeout):
                # Unwind cleanly: stop the informers THIS call started
                # (not shared ones) and allow a retry — a half-started
                # controller must not leak watch threads or wedge on
                # "already started".
                for owned in self._owned:
                    owned.stop()
                self._owned = []
                with self._lock:
                    self._started = False
                raise TimeoutError(
                    f"{self.name}: informer for {informer.kind} did not "
                    f"sync within {sync_timeout}s"
                )
        for i in range(self.max_concurrent_reconciles):
            worker = threading.Thread(
                target=self._worker, name=f"{self.name}-worker-{i}",
                daemon=True,
            )
            worker.start()
            self._workers.append(worker)
        return self

    def stop(self, drain_timeout: float = 0.0) -> None:
        """Shut down workers; ``drain_timeout > 0`` lets queued work
        finish first (ShutDownWithDrain)."""
        if drain_timeout > 0:
            self.queue.shutdown_with_drain(drain_timeout)
        self.queue.shutdown()
        for worker in self._workers:
            worker.join(timeout=10)
        for informer in self._owned:
            informer.stop()
        self._owned = []

    def __enter__(self) -> "Controller":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the worker loop ---------------------------------------------------
    def _worker(self) -> None:
        while True:
            item = self.queue.get()
            if item is None:
                return
            try:
                try:
                    result = self._reconciler(item) or Result()
                except Exception:  # noqa: BLE001 - the retry contract
                    log.exception(
                        "%s: reconcile of %s failed (requeue #%d)",
                        self.name, item, self.queue.num_requeues(item) + 1,
                    )
                    self.queue.add_rate_limited(item)
                else:
                    if result.requeue_after > 0:
                        # A timed revisit is not a failure: reset backoff
                        # so the NEXT failure starts from the base delay.
                        self.queue.forget(item)
                        self.queue.add_after(item, result.requeue_after)
                    elif result.requeue:
                        self.queue.add_rate_limited(item)
                    else:
                        self.queue.forget(item)
            finally:
                self.queue.done(item)
