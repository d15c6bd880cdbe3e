"""Rate-limited work queues with client-go's ``util/workqueue`` semantics.

The JAX package's ``kube/workqueue.py``. A controller-runtime controller
is, underneath, such a queue: watch events enqueue keys, workers dequeue
them, and a failed reconcile is queued again with a per-item exponential
backoff under an overall rate cap. ``kube/controller.py`` and the
``upgrade_controller`` command stand on it.

Three layers, as client-go's interfaces:

* ``WorkQueue``: the base queue with the *dirty/processing* invariant. An
  item is handed to one worker at a time; adding an item while it is
  processed marks it dirty, and it is handed out again after ``done``
  (never concurrently); adding an item already queued does nothing.
* ``DelayingQueue``: ``add_after(item, delay)``; a timer thread moves
  matured items into the base queue.
* ``RateLimitingQueue``: ``add_rate_limited``, ``forget`` and
  ``num_requeues`` over a rate limiter.

The default rate limiter is client-go's ``DefaultControllerRateLimiter``:
the longer of a per-item exponential backoff (5 ms doubling to 1000 s)
and a shared token bucket (10 qps, burst 100), so one key that keeps
failing backs off while a flood of distinct keys is smoothed.
"""

from __future__ import annotations

import collections
import heapq
import itertools
import threading
import time
from typing import Callable, Hashable, Optional

from ..utils.log import get_logger

log = get_logger("kube.workqueue")


# ---------------------------------------------------------------------------
# Rate limiters
# ---------------------------------------------------------------------------


class ItemExponentialFailureRateLimiter:
    """Per-item exponential backoff: ``base * 2^failures`` capped at
    ``max_delay``; ``forget`` resets the item's failure count."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 1000.0):
        if base_delay <= 0 or max_delay <= 0:
            raise ValueError("delays must be positive")
        self.base_delay = base_delay
        self.max_delay = max_delay
        self._failures: dict[Hashable, int] = {}
        self._lock = threading.Lock()

    def when(self, item: Hashable) -> float:
        with self._lock:
            failures = self._failures.get(item, 0)
            self._failures[item] = failures + 1
        # Cap the exponent before shifting so a long-failing item cannot
        # overflow into a huge float; the min() below clamps anyway.
        exp = min(failures, 64)
        return min(self.base_delay * (2.0 ** exp), self.max_delay)

    def forget(self, item: Hashable) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def num_requeues(self, item: Hashable) -> int:
        with self._lock:
            return self._failures.get(item, 0)


class BucketRateLimiter:
    """Shared token bucket (golang.org/x/time/rate shape): ``when``
    reserves the next token and returns how long until it matures.
    Item-agnostic — ``forget`` is a no-op, like client-go's."""

    def __init__(
        self,
        qps: float = 10.0,
        burst: int = 100,
        clock: Callable[[], float] = time.monotonic,
    ):
        if qps <= 0 or burst < 1:
            raise ValueError("qps must be > 0 and burst >= 1")
        self.qps = qps
        self.burst = burst
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()
        self._lock = threading.Lock()

    def when(self, item: Hashable) -> float:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.qps
            )
            self._last = now
            self._tokens -= 1.0
            if self._tokens >= 0:
                return 0.0
            # The reservation is committed (tokens may go negative, the
            # deficit is repaid over time) — exactly rate.Reserve().
            return -self._tokens / self.qps

    def forget(self, item: Hashable) -> None:
        return None

    def num_requeues(self, item: Hashable) -> int:
        return 0


class MaxOfRateLimiter:
    """The worst (longest) verdict of several limiters; every limiter
    still sees every call so their internal state advances together."""

    def __init__(self, *limiters) -> None:
        if not limiters:
            raise ValueError("need at least one limiter")
        self.limiters = limiters

    def when(self, item: Hashable) -> float:
        return max(limiter.when(item) for limiter in self.limiters)

    def forget(self, item: Hashable) -> None:
        for limiter in self.limiters:
            limiter.forget(item)

    def num_requeues(self, item: Hashable) -> int:
        return max(limiter.num_requeues(item) for limiter in self.limiters)


def default_controller_rate_limiter() -> MaxOfRateLimiter:
    """client-go's ``DefaultControllerRateLimiter``: per-item 5 ms
    doubling to 1000 s, overall 10 qps / burst 100."""
    return MaxOfRateLimiter(
        ItemExponentialFailureRateLimiter(0.005, 1000.0),
        BucketRateLimiter(10.0, 100),
    )


# ---------------------------------------------------------------------------
# Base queue: the dirty/processing invariant
# ---------------------------------------------------------------------------


class WorkQueue:
    """client-go ``workqueue.Type``: FIFO with dedup and in-flight
    exclusion.

    Invariants (the ones controllers rely on):

    * an item is delivered to at most one ``get`` at a time;
    * ``add`` of an item already waiting is a no-op (dedup);
    * ``add`` of an item currently being processed defers it: the item
      re-enters the queue when its ``done`` is called, so no update is
      lost and no key is reconciled concurrently with itself.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._queue: collections.deque[Hashable] = collections.deque()
        self._dirty: set[Hashable] = set()
        self._processing: set[Hashable] = set()
        self._shutting_down = False

    def add(self, item: Hashable) -> None:
        with self._cond:
            if self._shutting_down or item in self._dirty:
                return
            self._dirty.add(item)
            if item in self._processing:
                return  # re-queued by done()
            self._queue.append(item)
            self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[Hashable]:
        """Block for the next item; ``None`` means shut down (or timed
        out). The caller MUST call ``done(item)`` when finished."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._queue and not self._shutting_down:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                self._cond.wait(remaining)
            if not self._queue:
                return None  # shutting down
            item = self._queue.popleft()
            self._processing.add(item)
            self._dirty.discard(item)
            return item

    def get_batch(
        self,
        timeout: Optional[float] = None,
        max_items: Optional[int] = None,
    ) -> list[Hashable]:
        """Block up to ``timeout`` for the first item, then greedily drain
        whatever else is immediately available (no further waiting), up to
        ``max_items``. Empty list means shut down or timed out.

        The shape a whole-world reconciler wants: one pass covers every
        key that accumulated while the previous pass ran, instead of one
        pass per key. Every returned item is in-flight — the caller MUST
        call ``done`` on each (and ``forget`` on success when rate
        limiting), exactly as with ``get``."""
        first = self.get(timeout)
        if first is None:
            return []
        items = [first]
        while max_items is None or len(items) < max_items:
            item = self.get(timeout=0)
            if item is None:
                break
            items.append(item)
        return items

    def done(self, item: Hashable) -> None:
        with self._cond:
            self._processing.discard(item)
            # A dirty item cannot already be queued: add() skips the
            # queue for items in _processing, and get() cleared the
            # dirty bit when it handed this item out.
            if item in self._dirty:
                self._queue.append(item)
                self._cond.notify()
            elif not self._processing:
                self._cond.notify_all()  # wake drain waiters

    def shutdown(self) -> None:
        """Stop accepting adds and wake blocked getters; queued items
        are discarded once drained getters see None."""
        with self._cond:
            self._shutting_down = True
            self._queue.clear()
            self._dirty.clear()
            self._cond.notify_all()

    def shutdown_with_drain(self, timeout: Optional[float] = None) -> bool:
        """client-go ShutDownWithDrain: stop accepting adds but let
        already-queued and in-flight items finish; returns False if the
        drain timed out with work still in flight."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._shutting_down = True
            self._cond.notify_all()
            while self._queue or self._processing:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cond.wait(remaining)
            return True

    @property
    def shutting_down(self) -> bool:
        with self._cond:
            return self._shutting_down

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)


# ---------------------------------------------------------------------------
# Delaying queue
# ---------------------------------------------------------------------------


class DelayingQueue(WorkQueue):
    """``add_after(item, delay)`` — a timer thread matures delayed items
    into the base queue. Duplicate pending timers keep only the SOONER
    deadline, like client-go's waitingLoop."""

    def __init__(self) -> None:
        super().__init__()
        self._timer_cond = threading.Condition()
        self._heap: list[tuple[float, int, Hashable]] = []
        self._deadlines: dict[Hashable, float] = {}
        self._seq = itertools.count()
        self._timer_stop = False
        self._timer = threading.Thread(
            target=self._timer_loop, name="workqueue-delay", daemon=True
        )
        self._timer.start()

    def add_after(self, item: Hashable, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        if self.shutting_down:
            return
        deadline = time.monotonic() + delay
        with self._timer_cond:
            current = self._deadlines.get(item)
            if current is not None and current <= deadline:
                return  # an equal-or-sooner timer already pends
            self._deadlines[item] = deadline
            heapq.heappush(self._heap, (deadline, next(self._seq), item))
            self._timer_cond.notify()

    def _timer_loop(self) -> None:
        while True:
            with self._timer_cond:
                while not self._timer_stop:
                    if not self._heap:
                        self._timer_cond.wait()
                        continue
                    now = time.monotonic()
                    deadline, _, item = self._heap[0]
                    if deadline <= now:
                        heapq.heappop(self._heap)
                        # Only the entry that owns the item's recorded
                        # deadline fires; leftovers superseded by a sooner
                        # timer (which already fired and cleared the slot)
                        # are stale and skipped.
                        if self._deadlines.get(item) == deadline:
                            del self._deadlines[item]
                            break
                        continue
                    self._timer_cond.wait(deadline - now)
                if self._timer_stop:
                    return
            self.add(item)

    def shutdown(self) -> None:
        self._stop_timer()
        super().shutdown()

    def shutdown_with_drain(self, timeout: Optional[float] = None) -> bool:
        # Pending timers do not hold the drain open (client-go drains
        # only in-flight work; delayed re-adds after shutdown are dropped
        # by add()'s shutting_down check).
        self._stop_timer()
        return super().shutdown_with_drain(timeout)

    def _stop_timer(self) -> None:
        with self._timer_cond:
            self._timer_stop = True
            self._timer_cond.notify_all()
        if self._timer is not threading.current_thread():
            self._timer.join(timeout=5)


# ---------------------------------------------------------------------------
# Rate-limiting queue
# ---------------------------------------------------------------------------


class RateLimitingQueue(DelayingQueue):
    """``add_rate_limited`` defers by the limiter's verdict; ``forget``
    resets an item's backoff after a successful reconcile."""

    def __init__(self, rate_limiter=None) -> None:
        super().__init__()
        self.rate_limiter = rate_limiter or default_controller_rate_limiter()

    def add_rate_limited(self, item: Hashable) -> None:
        self.add_after(item, self.rate_limiter.when(item))

    def forget(self, item: Hashable) -> None:
        self.rate_limiter.forget(item)

    def num_requeues(self, item: Hashable) -> int:
        return self.rate_limiter.num_requeues(item)
