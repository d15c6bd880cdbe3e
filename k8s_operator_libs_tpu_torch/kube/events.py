"""Kubernetes Event recording with client-go correlation semantics.

The JAX package's ``kube/events.py``: the recorder, and ``FakeRecorder``,
the in-memory one of the tests and demos. The port's state machine passes its recorder to every
manager (cordon, drain, pod, validation, safe load, the state provider),
and the monitor records each condition transition, so a hot reconcile
loop records through here. client-go's EventCorrelator sits in front of
the API writes, and this recorder carries the same three behaviors, so
such a loop cannot spam the apiserver:

* **dedup** — an identical event (same object/type/reason/message)
  PATCHes the existing Event, bumping ``count`` and ``lastTimestamp``,
  instead of creating a new object; an Event the server garbage-collected
  (the patch answers ``NotFound``, recognised by its reason) is created
  again;
* **aggregation** — more than ``aggregate_threshold`` SIMILAR events
  (same object/type/reason, differing messages) inside
  ``aggregate_window_s`` collapse into one aggregate Event whose message
  is prefixed ``(combined from similar events)``, counted like a dedup;
* **spam filter** — a per-object token bucket (burst
  ``spam_burst``, one token refilled every ``spam_refill_s``) drops
  events beyond the budget entirely.

Each cache is an LRU of 4096 keys; ``now_fn`` is the clock the window and
the bucket read.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Callable, Deque

from .client import Client, NotFoundError, has_reason
from .objects import Event, KubeObject, rfc3339_now

EVENT_TYPE_NORMAL = "Normal"
EVENT_TYPE_WARNING = "Warning"

#: client-go correlator defaults (tools/record): LRU cache size,
#: aggregation threshold/window, spam-filter burst and refill.
_CACHE_SIZE = 4096
AGGREGATE_THRESHOLD = 10
AGGREGATE_WINDOW_S = 600.0
SPAM_BURST = 25
SPAM_REFILL_S = 300.0


class _LRU(OrderedDict):
    def __init__(self, cap: int) -> None:
        super().__init__()
        self._cap = cap

    def touch(self, key, default):
        if key in self:
            self.move_to_end(key)
            return self[key]
        self[key] = default
        while len(self) > self._cap:
            self.popitem(last=False)
        return default


class EventRecorder:
    """Records events as real Event objects in a cluster, correlated."""

    def __init__(
        self,
        client: Client,
        namespace: str = "default",
        now_fn: Callable[[], float] = time.monotonic,
        aggregate_threshold: int = AGGREGATE_THRESHOLD,
        aggregate_window_s: float = AGGREGATE_WINDOW_S,
        spam_burst: int = SPAM_BURST,
        spam_refill_s: float = SPAM_REFILL_S,
    ) -> None:
        self._client = client
        self._namespace = namespace
        self._now = now_fn
        self._aggregate_threshold = aggregate_threshold
        self._aggregate_window_s = aggregate_window_s
        self._spam_burst = spam_burst
        self._spam_refill_s = spam_refill_s
        self._lock = threading.Lock()
        #: spam key -> [tokens, last refill time]
        self._buckets: _LRU = _LRU(_CACHE_SIZE)
        #: similarity key -> deque of observation times (window pruned)
        self._similar: _LRU = _LRU(_CACHE_SIZE)
        #: dedup key -> [event name, namespace, count]
        self._seen: _LRU = _LRU(_CACHE_SIZE)

    def _spam_ok(self, spam_key) -> bool:
        bucket = self._buckets.touch(
            spam_key, [float(self._spam_burst), self._now()]
        )
        now = self._now()
        refilled = (now - bucket[1]) / self._spam_refill_s
        bucket[0] = min(float(self._spam_burst), bucket[0] + refilled)
        bucket[1] = now
        if bucket[0] < 1.0:
            return False
        bucket[0] -= 1.0
        return True

    def event(
        self,
        obj: KubeObject,
        event_type: str,
        reason: str,
        message: str,
    ) -> None:
        namespace = obj.namespace or self._namespace
        # uid is part of every key, as in client-go: a deleted-and-
        # recreated object must not correlate onto (or inherit the spam
        # budget of) its dead incarnation's events.
        spam_key = (obj.raw.get("kind", ""), namespace, obj.name, obj.uid)
        agg_key = spam_key + (event_type, reason)
        # Two phases: correlation bookkeeping under the lock (in-memory
        # only — the lock is NEVER held across an API write, so a slow
        # apiserver cannot serialize every recording thread and no
        # lock-order cycle with the client's own locks can form), then
        # the write outside it. The dedup entry — including the chosen
        # Event name on first occurrence — is committed under the lock,
        # so racing recorders can never create duplicate objects; their
        # count increments are exact in the cache, and a patch landing
        # out of order is corrected by the next one (the same anomaly any
        # concurrent patcher has).
        with self._lock:
            if not self._spam_ok(spam_key):
                return
            # Aggregation counts DISTINCT messages (client-go's
            # localKeys), never raw occurrences: identical events stay on
            # the dedup path no matter how many arrive.
            similar = self._similar.touch(agg_key, {})
            now = self._now()
            similar[message] = now
            for m, t0 in list(similar.items()):
                if now - t0 > self._aggregate_window_s:
                    del similar[m]
            if len(similar) > self._aggregate_threshold:
                message = f"(combined from similar events): {message}"
                dedup_key = agg_key + ("<aggregate>",)
            else:
                dedup_key = agg_key + (message,)
            seen = self._seen.get(dedup_key)
            if seen is not None:
                seen[2] += 1
                count = seen[2]
            else:
                name = f"{obj.name}.{uuid.uuid4().hex[:10]}"
                self._seen.touch(dedup_key, [name, namespace, 1])
        if seen is not None:
            try:
                self._client.patch(
                    "Event",
                    seen[0],
                    seen[1],
                    patch={
                        "count": count,
                        "message": message,
                        "lastTimestamp": rfc3339_now(),
                    },
                )
                return
            except Exception as e:  # noqa: BLE001 - the client's own classes
                if not has_reason(e, NotFoundError):
                    raise
                # The deduped Event was garbage-collected server-side;
                # recreate under the same cache entry.
                with self._lock:
                    current = self._seen.get(dedup_key)
                    if current is not seen:
                        return  # someone else already recreated it
                    name = f"{obj.name}.{uuid.uuid4().hex[:10]}"
                    seen[0], seen[2] = name, 1
        ev = Event.new(name, namespace=namespace)
        stamp = rfc3339_now()
        ev.raw.update(
            {
                "type": event_type,
                "reason": reason,
                "message": message,
                "count": 1,
                "involvedObject": {
                    "kind": obj.raw.get("kind", ""),
                    "name": obj.name,
                    "namespace": obj.namespace,
                    "uid": obj.uid,
                },
                "firstTimestamp": stamp,
                "lastTimestamp": stamp,
            }
        )
        try:
            self._client.create(ev)
        except Exception:
            # A failed create must not strand a phantom dedup entry that
            # would absorb future occurrences into a nonexistent object.
            with self._lock:
                current = self._seen.get(dedup_key)
                if current is not None and current[0] == name:
                    self._seen.pop(dedup_key, None)
            raise

    def eventf(
        self, obj: KubeObject, event_type: str, reason: str, fmt: str, *args
    ) -> None:
        self.event(obj, event_type, reason, fmt % args if args else fmt)


class FakeRecorder:
    """In-memory recorder with a bounded buffer, mirroring
    record.FakeRecorder(100) in the reference suites."""

    def __init__(self, capacity: int = 100) -> None:
        self._lock = threading.Lock()
        self.capacity = capacity
        self.messages: Deque[str] = deque(maxlen=capacity)

    def event(
        self, obj: KubeObject, event_type: str, reason: str, message: str
    ) -> None:
        with self._lock:
            self.messages.append(f"{event_type} {reason} {message}")

    def eventf(
        self, obj: KubeObject, event_type: str, reason: str, fmt: str, *args
    ) -> None:
        self.event(obj, event_type, reason, fmt % args if args else fmt)

    def drain(self) -> list[str]:
        with self._lock:
            out = list(self.messages)
            self.messages.clear()
            return out
