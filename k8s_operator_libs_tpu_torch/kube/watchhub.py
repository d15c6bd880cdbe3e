"""WatchHub: one upstream watch a (kind, scope), multiplexed to N
subscribers in one process.

The JAX package's ``kube/watchhub.py``. Co-hosted consumers (the fleet's
shard workers, a relay's subscribers) would each open a copy of every
watch and carry the same deltas N times. The hub brings the API server's
watch cache to the client side:

* it opens **one upstream watch a scope**, the scope being (kind,
  namespace, label selector, field selector), and fans every frame out to
  all the scope's subscribers, so the count of consumers no longer
  multiplies the upstream load;
* each subscriber has its **own resume cursor** and a **bounded
  buffer**: a slow subscriber is marked stale (its buffer is dropped,
  never the upstream stream) and resumes itself from its cursor over the
  hub's journal, the **replay window**, with no upstream re-LIST and no
  other subscriber touched;
* a dead upstream **connection** is resumed once for everyone, from the
  hub's last delivered or bookmarked revision; only a 410 (the revision
  fell out of the server's journal) or repeated failures broadcast
  ``WatchExpiredError`` to the subscribers, whose informers then re-list,
  cheaply, through the delta list.

``watch()`` has :meth:`Client.watch`'s signature, frames, windows,
timeouts, bookmarks and cancel, which is what lets
:class:`~.informer.Informer` ride the hub through its ``stream_source``
hook unchanged. A frame keeps its ``metadata.resourceVersion``, so a
delivery of a resumed or replayed frame still finds its write's origin in
the tracer's book (``utils/tracing.py``).

Threading: ``WatchHub._lock`` guards the scope registry only; each
``_Upstream`` owns one Condition over its journal and subscribers. The
lock order is ``WatchHub._lock`` then ``_Upstream.cond`` (a join and an
unsubscribe), and the pump thread only takes its upstream's condition.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Mapping, Optional

from .client import Client, WatchExpiredError, has_reason
from .objects import wrap
from ..utils.faultpoints import OVERFLOW, fault_point, plan_active
from ..utils.log import get_logger
from ..utils.lifecycle import lifecycle_resource

log = get_logger("kube.watchhub")

#: Default per-scope replay window (journal entries) — the same order of
#: magnitude as the fake apiserver's own watch journal: a subscriber
#: further behind than this must re-list anyway.
DEFAULT_JOURNAL_WINDOW = 4096

#: Default per-subscriber buffer bound. A subscriber this far behind the
#: fan-out loses its BUFFER (stale → self-resume from its cursor), never
#: the upstream stream.
DEFAULT_BUFFER_LIMIT = 1024


def _scope_key(
    kind: str,
    namespace: str,
    label_selector: Optional[str | Mapping[str, str]],
    field_selector: Optional[str],
) -> tuple[str, str, str, str]:
    if isinstance(label_selector, Mapping):
        label_selector = ",".join(
            f"{k}={v}" for k, v in sorted(label_selector.items())
        )
    return (kind, namespace, label_selector or "", field_selector or "")


class _Subscriber:
    """One consumer's hub-side state: bounded buffer + stale/expired
    flags. The resume CURSOR lives in the consumer generator — the hub
    only ever needs it at (re)subscription time."""

    __slots__ = ("buffer", "stale", "expired", "allow_bookmarks",
                 "stale_resumes")

    def __init__(self, allow_bookmarks: bool) -> None:
        #: (rv:int, event_type:str, raw:dict|None) — raw None = BOOKMARK.
        self.buffer: deque = deque()
        self.stale = False
        self.expired = False
        self.allow_bookmarks = allow_bookmarks
        self.stale_resumes = 0


class _Upstream:
    """One scope's upstream stream: pump thread + journal + subscribers."""

    def __init__(self, hub: "WatchHub", key: tuple[str, str, str, str]) -> None:
        self.hub = hub
        self.key = key
        self.cond = threading.Condition(threading.Lock())
        #: Replay window: (rv:int, event_type:str, raw:dict), rv-ordered.
        self.journal: deque = deque()
        self.subscribers: list[_Subscriber] = []
        #: Highest revision delivered or bookmarked upstream — the shared
        #: resume point after a dead connection.
        self.last_rv = 0
        #: Events with rv strictly greater than this are fully covered by
        #: the journal; None = coverage unknown (live-only upstream, or
        #: after an expiry reset).
        self.covered_from: Optional[int] = None
        #: The rv the NEXT upstream window watches from ("" = live-only).
        self.resume_rv: Optional[str] = None
        #: Bumped when a joiner REWINDS the stream (the live-only
        #: coverage restart): frames still arriving from the cancelled
        #: stream carry the old epoch and are discarded — otherwise an
        #: in-flight frame would clobber the rewound ``resume_rv`` back
        #: to ``last_rv`` and the restarted window would never replay
        #: the joiner's gap while ``covered_from`` falsely vouched for
        #: it.
        self.stream_epoch = 0
        #: When the subscriber count last hit zero (None while anyone is
        #: subscribed). The upstream LINGERS for ``hub.idle_linger_s``
        #: past this before retiring — a subscriber whose WINDOW ended
        #: (informer re-subscribing within microseconds) must find the
        #: same upstream and journal, or every synchronized window end
        #: would tear the stream down, lose the replay window, and make
        #: laggard-cursor rejoins spuriously expire.
        self.idle_since: Optional[float] = None
        self.closing = False
        self.thread: Optional[threading.Thread] = None
        self.handle: Any = None
        # -- counters (written under cond; read for stats) --
        self.frames_upstream = 0
        self.frames_delivered = 0
        self.stale_resumes = 0
        self.expiries = 0
        self.upstream_watches_opened = 0
        self.upstream_resumes = 0

    # -- pump (upstream thread) -------------------------------------------
    def _deliver_locked(self, rv: int, event_type: str,
                        raw: Optional[dict]) -> None:
        """Fan one frame out to every live subscriber; caller holds cond.
        A full buffer marks the subscriber stale and DROPS its buffer —
        the journal already holds everything past its cursor, so the
        self-resume replays exactly what the drop lost."""
        # Consulted only for real frames with an ELIGIBLE (non-stale,
        # non-expired) subscriber: a bookmark (raw None) can never
        # overflow a buffer, an already-stale subscriber cannot
        # overflow again before its self-resume, and a count-bounded
        # fault must not have its fires eaten by frames the overflow
        # cannot apply to. plan_active() first: the eligibility scan
        # must cost production fan-out (no plan ever installed) one
        # global read per frame, nothing more.
        act = None
        if plan_active() and raw is not None and any(
            not s.stale and not s.expired for s in self.subscribers
        ):
            act = fault_point("watchhub.deliver", kind=self.key[0])
        forced_overflow = act is not None and act.kind == OVERFLOW
        for sub in self.subscribers:
            if sub.stale or sub.expired:
                continue
            if raw is None and not sub.allow_bookmarks:
                continue
            if forced_overflow:
                # The chaos fault point: treat this
                # frame as the one that overflowed every live buffer —
                # the subscriber takes the SAME stale -> journal
                # self-resume path a genuinely slow consumer takes, at
                # a schedule-chosen moment (e.g. mid-grant-write).
                sub.stale = True
                sub.buffer.clear()
                continue
            if len(sub.buffer) >= self.hub.buffer_limit:
                sub.stale = True
                sub.buffer.clear()
                continue
            sub.buffer.append((rv, event_type, raw))
            if raw is not None:
                self.frames_delivered += 1
        self.cond.notify_all()

    def _broadcast_expired_locked(self) -> None:
        """The upstream revision fell out of the SERVER's journal (or
        resumes kept failing): every subscriber must re-list. The hub's
        own journal can no longer vouch for continuity, so it resets."""
        self.expiries += 1
        self.journal.clear()
        self.covered_from = None
        self.resume_rv = None
        for sub in self.subscribers:
            sub.expired = True
            sub.buffer.clear()
        self.cond.notify_all()

    def pump(self) -> None:
        kind, namespace, label_selector, field_selector = self.key
        failures = 0
        while True:
            with self.cond:
                if self.closing or self.hub._stopped:
                    return
                resume = self.resume_rv
                epoch = self.stream_epoch
                from .rest import WatchHandle

                self.handle = WatchHandle()
                handle = self.handle
                self.upstream_watches_opened += 1
            try:
                stream = self.hub._client.watch(
                    kind,
                    namespace=namespace,
                    label_selector=label_selector or None,
                    field_selector=field_selector or None,
                    timeout_seconds=self.hub.upstream_window_seconds,
                    resource_version=resume,
                    handle=handle,
                    allow_bookmarks=True,
                )
                for event_type, obj in stream:
                    raw = obj.raw
                    rv_str = str(
                        (raw.get("metadata") or {}).get("resourceVersion", "")
                    )
                    rv = int(rv_str) if rv_str.isdigit() else 0
                    with self.cond:
                        if self.closing or self.hub._stopped:
                            return
                        if self.stream_epoch != epoch:
                            # A joiner rewound the stream and cancelled
                            # this window; frames still in flight from
                            # it must not advance resume_rv or land in
                            # the journal — the restarted window will
                            # replay them from the rewound cursor.
                            break
                        if self._idle_expired_locked():
                            # Nobody resubscribed within the linger:
                            # retire mid-window (bookmark frames drive
                            # this check on quiet scopes).
                            break
                        failures = 0
                        if rv:
                            self.last_rv = max(self.last_rv, rv)
                            self.resume_rv = str(self.last_rv)
                        if event_type == "BOOKMARK":
                            self._deliver_locked(rv, event_type, None)
                            continue
                        self.frames_upstream += 1
                        self.journal.append((rv, event_type, raw))
                        while len(self.journal) > self.hub.journal_window:
                            evicted_rv, _, _ = self.journal.popleft()
                            self.covered_from = evicted_rv
                        self._deliver_locked(rv, event_type, raw)
                # Clean window end: resume from last_rv on the next loop.
                failures = 0
            except Exception as e:  # noqa: BLE001 - stream died; resume
                if has_reason(e, WatchExpiredError):
                    # By reason: the hub's client may be another
                    # package's, raising its own class for a 410.
                    with self.cond:
                        log.warning(
                            "hub upstream %s expired at rv=%s; subscribers "
                            "must re-list", kind, self.resume_rv,
                        )
                        self._broadcast_expired_locked()
                    if self._retire_if_idle():
                        return
                    continue
                with self.cond:
                    if self.closing or self.hub._stopped:
                        return
                    if self.stream_epoch != epoch:
                        # The cancelled (rewound) stream died, as asked:
                        # not a failure of the CURRENT stream.
                        continue
                    failures += 1
                    if (
                        self.resume_rv is not None
                        and failures <= self.hub.max_resume_attempts
                    ):
                        # The SHARED resume: one re-watch from the hub's
                        # last revision heals every subscriber at once —
                        # the server journal replays what the dead
                        # stream swallowed, and no subscriber sees a gap.
                        self.upstream_resumes += 1
                        log.warning(
                            "hub upstream %s died (%s); resuming from "
                            "rv=%s (attempt %d/%d)", kind, e,
                            self.resume_rv, failures,
                            self.hub.max_resume_attempts,
                        )
                    else:
                        log.warning(
                            "hub upstream %s failed repeatedly (%s); "
                            "subscribers must re-list", kind, e,
                        )
                        self._broadcast_expired_locked()
                        failures = 0
                time.sleep(min(0.05 * failures, 0.5))
            if self._retire_if_idle():
                return

    def _idle_expired_locked(self) -> bool:
        """True when the linger has elapsed with no subscriber; caller
        holds ``cond``."""
        return (
            not self.subscribers
            and self.idle_since is not None
            and time.monotonic() - self.idle_since
            >= self.hub.idle_linger_s
        )

    def _retire_if_idle(self) -> bool:
        """Window-boundary retirement check: close and deregister this
        upstream when it has been subscriber-free past the linger (or
        was already marked closing). Takes the hub registry lock ALONE
        — never while holding ``cond`` (lock order)."""
        with self.cond:
            if self._idle_expired_locked():
                self.closing = True
            if not self.closing:
                return False
        self.hub._deregister(self)
        return True


@lifecycle_resource(acquire="__init__", release="stop")
class WatchHub:
    """Multiplex upstream watch streams to in-process subscribers.

    One hub per process (or per co-hosted worker group) and one
    ``client`` for all upstream traffic; hand the hub to every
    ``Informer``/``InformerSnapshotSource``/``HealthSource``/
    ``ShardWorker`` via their ``stream_source``/``watch_hub`` hooks and
    their watches collapse onto one upstream stream per scope.
    """

    def __init__(
        self,
        client: Client,
        journal_window: int = DEFAULT_JOURNAL_WINDOW,
        buffer_limit: int = DEFAULT_BUFFER_LIMIT,
        upstream_window_seconds: int = 300,
        max_resume_attempts: int = 3,
        idle_linger_s: float = 30.0,
    ) -> None:
        self._client = client
        self.journal_window = int(journal_window)
        self.buffer_limit = int(buffer_limit)
        self.upstream_window_seconds = int(upstream_window_seconds)
        self.max_resume_attempts = int(max_resume_attempts)
        #: How long a subscriber-free upstream LINGERS before retiring.
        #: Subscriber windows end on a timer (every informer
        #: re-subscribes each ``watch_timeout_seconds``); tearing the
        #: upstream down on every momentary zero would cost a fresh
        #: stream + journal per window — and synchronized rejoins whose
        #: cursors differ would spuriously expire against the emptied
        #: replay window. 0 retires immediately (tests).
        self.idle_linger_s = float(idle_linger_s)
        self._lock = threading.Lock()
        self._scopes: dict[tuple[str, str, str, str], _Upstream] = {}
        self._stopped = False

    # -- lifecycle ---------------------------------------------------------
    def stop(self) -> None:
        """End every upstream stream and wake every subscriber (their
        generators end as if the window closed)."""
        self._stopped = True
        with self._lock:
            upstreams = list(self._scopes.values())
            self._scopes.clear()
        for up in upstreams:
            with up.cond:
                up.closing = True
                handle = up.handle
                up.cond.notify_all()
            if handle is not None:
                handle.cancel()
            if up.thread is not None:
                up.thread.join(timeout=10)

    def __enter__(self) -> "WatchHub":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- stats (the tpu_operator_wire_* feed) ------------------------------
    def stats(self) -> dict:
        """Hub observability: active upstream streams, per-scope
        subscriber counts + buffer depths, frames upstream vs delivered
        (the fan-out ratio), stale self-resumes, expiries."""
        with self._lock:
            upstreams = dict(self._scopes)
        scopes = {}
        frames_upstream = frames_delivered = stale = 0
        subscribers_total = 0
        for key, up in upstreams.items():
            with up.cond:
                if up.closing:
                    continue  # retired; registry entry is on its way out
                depths = [len(s.buffer) for s in up.subscribers]
                scopes["/".join(k for k in key if k) or key[0]] = {
                    "kind": key[0],
                    "subscribers": len(up.subscribers),
                    "buffer_depths": depths,
                    "frames_upstream": up.frames_upstream,
                    "frames_delivered": up.frames_delivered,
                    "stale_resumes": up.stale_resumes,
                    "expiries": up.expiries,
                    "upstream_watches_opened": up.upstream_watches_opened,
                    "upstream_resumes": up.upstream_resumes,
                }
                frames_upstream += up.frames_upstream
                frames_delivered += up.frames_delivered
                stale += up.stale_resumes
                subscribers_total += len(up.subscribers)
        return {
            "upstream_streams": len(upstreams),
            "subscribers": subscribers_total,
            "frames_upstream": frames_upstream,
            "frames_delivered": frames_delivered,
            "fanout_ratio": (
                round(frames_delivered / frames_upstream, 3)
                if frames_upstream
                else 0.0
            ),
            "stale_resumes": stale,
            "scopes": scopes,
        }

    # -- subscription ------------------------------------------------------
    def _upstream_for(self, key: tuple[str, str, str, str]) -> _Upstream:
        with self._lock:
            if self._stopped:
                raise RuntimeError("WatchHub is stopped")
            up = self._scopes.get(key)
            if up is None or up.closing:
                up = _Upstream(self, key)
                self._scopes[key] = up
            return up

    def _deregister(self, up: _Upstream) -> None:
        """Drop a (closing) upstream from the registry; hub lock only."""
        with self._lock:
            if self._scopes.get(up.key) is up:
                del self._scopes[up.key]

    def _retire_if_empty(self, up: _Upstream) -> None:
        """Immediate retirement (the ``idle_linger_s <= 0`` path): hub
        lock first, then the upstream's condition — the one place both
        are held (lock order documented in the module docstring)."""
        with self._lock:
            with up.cond:
                if up.subscribers or up.closing:
                    return
                up.closing = True
                handle = up.handle
                up.cond.notify_all()
            if self._scopes.get(up.key) is up:
                del self._scopes[up.key]
        if handle is not None:
            handle.cancel()

    def watch(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
        field_selector: Optional[str] = None,
        timeout_seconds: Optional[int] = None,
        resource_version: Optional[str] = None,
        handle=None,
        allow_bookmarks: bool = False,
    ):
        """``Client.watch`` drop-in served from the shared upstream.

        ``resource_version`` is THIS subscriber's cursor: frames after
        it replay from the hub journal (join-mid-stream sees no gap),
        then live frames stream from the subscriber's bounded buffer.
        A cursor behind the hub's replay window raises
        ``WatchExpiredError`` — the caller re-lists, exactly as against
        the apiserver. ``timeout_seconds`` bounds the subscription
        window (the generator ends; re-subscribing replays from the
        cursor — no upstream traffic at all). The subscription is made
        at the first ``next()``, as a client's watch is."""
        yield from self.open(
            kind, namespace, label_selector, field_selector, timeout_seconds,
            resource_version, handle, allow_bookmarks,
        )

    def open(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
        field_selector: Optional[str] = None,
        timeout_seconds: Optional[int] = None,
        resource_version: Optional[str] = None,
        handle=None,
        allow_bookmarks: bool = False,
    ):
        """:meth:`watch`, subscribed now: a cursor the hub cannot vouch for
        raises ``WatchExpiredError`` here, before any frame, and the
        stream returned is live (the relay answers its subscriber's
        request at once, on a scope with no frame to send too). The caller
        exhausts or closes the stream, which ends the subscription."""
        stream = self._subscription(
            kind, namespace, label_selector, field_selector, timeout_seconds,
            resource_version, handle, allow_bookmarks,
        )
        next(stream)  # the join; the stream now stands inside its cleanup
        return stream

    def _subscription(
        self,
        kind: str,
        namespace: str,
        label_selector: Optional[str | Mapping[str, str]],
        field_selector: Optional[str],
        timeout_seconds: Optional[int],
        resource_version: Optional[str],
        handle,
        allow_bookmarks: bool,
    ):
        """The subscription's generator: it joins at its first ``next()``
        and yields None once joined, then the frames."""
        if timeout_seconds is None:
            from .rest import DEFAULT_WATCH_TIMEOUT_SECONDS

            timeout_seconds = DEFAULT_WATCH_TIMEOUT_SECONDS
        key = _scope_key(kind, namespace, label_selector, field_selector)
        cursor = 0
        has_cursor = resource_version not in (None, "")
        if has_cursor:
            try:
                cursor = int(resource_version)
            except ValueError:
                raise WatchExpiredError(
                    f"invalid resourceVersion {resource_version!r}"
                ) from None

        while True:  # rarely loops: only on a just-closing upstream race
            up = self._upstream_for(key)
            with up.cond:
                if up.closing:
                    continue
                replay, sub = self._join_locked(up, cursor, has_cursor,
                                                allow_bookmarks)
                break
        try:
            yield None  # joined: ``open`` returns the stream from here
            for rv, event_type, raw in replay:
                if handle is not None and handle.cancelled:
                    return
                yield event_type, wrap(raw)
                if rv:
                    cursor = max(cursor, rv)
            deadline = time.monotonic() + timeout_seconds
            while True:
                batch: list = []
                with up.cond:
                    while True:
                        if self._stopped or up.closing:
                            return
                        if handle is not None and handle.cancelled:
                            return
                        if sub.expired:
                            raise WatchExpiredError(
                                f"hub upstream for {kind} expired; re-list"
                            )
                        if sub.stale:
                            # Self-resume: replay the journal past OUR
                            # cursor — the upstream stream and every
                            # other subscriber are untouched.
                            if (
                                up.covered_from is not None
                                and cursor < up.covered_from
                            ):
                                raise WatchExpiredError(
                                    f"subscriber cursor {cursor} fell out "
                                    f"of the hub replay window for {kind}"
                                )
                            batch = [
                                entry for entry in up.journal
                                if entry[0] > cursor
                            ]
                            sub.stale = False
                            sub.stale_resumes += 1
                            up.stale_resumes += 1
                            up.frames_delivered += len(batch)
                            break
                        if sub.buffer:
                            while sub.buffer:
                                batch.append(sub.buffer.popleft())
                            break
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return  # window end; caller resumes by cursor
                        up.cond.wait(min(0.2, remaining))
                for rv, event_type, raw in batch:
                    if handle is not None and handle.cancelled:
                        return
                    if raw is None:
                        # BOOKMARK: resume-point refresh only.
                        yield "BOOKMARK", wrap({
                            "kind": kind,
                            "metadata": {"resourceVersion": str(rv)},
                        })
                    else:
                        yield event_type, wrap(raw)
                    if rv:
                        cursor = max(cursor, rv)
                if time.monotonic() >= deadline:
                    return
        finally:
            with up.cond:
                try:
                    up.subscribers.remove(sub)
                except ValueError:
                    pass
                empty = not up.subscribers
                if empty:
                    # Start the linger clock; the pump retires the
                    # upstream only if nobody resubscribes in time —
                    # a window-end resubscribe (microseconds away)
                    # finds the same stream and journal.
                    up.idle_since = time.monotonic()
            if empty and self.idle_linger_s <= 0:
                self._retire_if_empty(up)

    def _join_locked(
        self,
        up: _Upstream,
        cursor: int,
        has_cursor: bool,
        allow_bookmarks: bool,
    ) -> tuple[list, _Subscriber]:
        """Register a subscriber and compute its journal replay — one
        critical section, so no event between the two can be lost.
        Caller holds ``up.cond``."""
        if up.thread is None:
            # First subscriber defines where upstream coverage starts:
            # its cursor (a live-only start covers nothing and forces
            # cursor-bearing joiners through _ensure below).
            if has_cursor:
                up.resume_rv = str(cursor)
                up.covered_from = cursor
            up.thread = threading.Thread(
                target=up.pump, name=f"watchhub-{up.key[0]}", daemon=True
            )
            up.thread.start()
        replay: list = []
        if has_cursor:
            if up.covered_from is None:
                # Live-only upstream cannot vouch for this cursor:
                # restart the window FROM the cursor. The server journal
                # replays the gap into the new window; duplicate frames
                # for live-only subscribers are at-least-once noise
                # (informer stores are rv-forward-only). The epoch bump
                # makes the pump DISCARD frames still in flight from
                # the cancelled stream — one of them advancing
                # resume_rv past the cursor would silently skip the
                # replayed gap.
                up.covered_from = cursor
                up.resume_rv = str(cursor)
                up.stream_epoch += 1
                handle = up.handle
                if handle is not None:
                    handle.cancel()
            elif cursor < up.covered_from:
                raise WatchExpiredError(
                    f"resourceVersion {cursor} is behind the hub replay "
                    f"window for {up.key[0]} (covered from "
                    f"{up.covered_from})"
                )
            else:
                replay = [e for e in up.journal if e[0] > cursor]
                up.frames_delivered += len(replay)
        sub = _Subscriber(allow_bookmarks)
        up.subscribers.append(sub)
        up.idle_since = None  # alive again: stop the linger clock
        return replay, sub
