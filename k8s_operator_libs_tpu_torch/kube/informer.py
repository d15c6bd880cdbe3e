"""Informer — a list-watch cache with event handlers.

The JAX package's ``kube/informer.py``. With a tracer installed each
delivery is an ``informer.deliver`` span (category ``wire``) that joins
the trace of the write it delivers (``utils/tracing.py``'s write-origin
book, keyed by resourceVersion) and starts at that write's wall time, so
its length is the write-to-handler lag; the handlers run inside it. The
watch loop consults the ``watch.deliver`` fault point
(``utils/faultpoints.chaos_hold``): while a plan holds it, events wait
upstream and the store goes stale. A watch hub's stream (``stream_source``)
keeps each frame's resourceVersion, so a delivery of a frame the hub or a
relay resumed or replayed still joins its write's trace.

The reference never touches the apiserver directly for reads:
controller-runtime's manager gives it a cache fed by list+watch informers,
and reconciles are *triggered* by watch deltas filtered through predicates
(upgrade_requestor.go:115-159 registers exactly such handlers). This is
that layer over ``Client.watch``:

* one ``Informer`` maintains a local store for one kind, seeded by a list
  and kept current by a watch resumed from the list's revision — the
  journal-backed resumption means no event is lost between the two;
* a watch window that ENDS (server-side bound) re-watches from the last
  delivered or bookmarked revision; a watch whose CONNECTION dies does
  the same (up to ``max_resume_attempts`` — the journal replays what the
  dead stream swallowed); only a watch that EXPIRES (an error with
  ``WatchExpiredError``'s reason, the 410 Gone analog — the revision fell
  out of the journal) or keeps failing re-lists, diffing the relisted
  state against the store so handlers see synthetic
  ADDED/MODIFIED/DELETED for anything missed. The client's errors are
  recognised by their reason, whichever client's class raised them;
* a degraded re-list asks a client that has ``list_delta`` (the port's
  ``RestClient`` has) for the changes since the informer's revision first
  (O(what changed)); a client without it re-lists whole;
* handlers run on the informer thread with ``(event_type, obj, old)`` —
  pair them with the requestor's plain-function predicates;
* reads (``get``/``list``) serve from the local store: cheap, point-in-time
  consistent, and exactly as stale as a controller-runtime cached client.

Deltas are **rv-ordered and resync-aware**: the informer remembers the
resourceVersion each key last *dispatched* to handlers, and a resync
sweep (:meth:`resync_once`) coalesces replays whose stored rv handlers
have already seen — a resync tick over a settled store delivers ZERO
events, instead of client-go's replay-everything storm. A resync still
re-delivers any object whose store entry got ahead of dispatch (e.g. a
``record_write`` store repair whose watch echo never arrived), which is
the self-heal a resync exists for. Delta consumers building incremental
state rely on exactly this contract.
"""

from __future__ import annotations

import threading
from typing import Callable, Mapping, Optional

from .client import Client, WatchExpiredError, has_reason
from .objects import KubeObject, deep_copy_json, wrap
from .rest import WatchHandle
from .selectors import parse_selector
from ..utils import tracing
from ..utils.faultpoints import chaos_hold
from ..utils.lifecycle import lifecycle_resource
from ..utils.log import get_logger

log = get_logger("kube.informer")

#: handler signature: (event_type, object, old_object_or_None)
EventHandler = Callable[[str, KubeObject, Optional[KubeObject]], None]


@lifecycle_resource(acquire="start", release="stop")
class Informer:
    def __init__(
        self,
        client: Client,
        kind: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
        field_selector: Optional[str] = None,
        watch_timeout_seconds: int = 300,
        resync_period_s: float = 0.0,
        stream_source=None,
    ) -> None:
        self._client = client
        #: Where the WATCH stream comes from: any object with the
        #: ``Client.watch`` signature. None = the client itself; a shared
        #: hub here (``kube/watchhub.py``'s ``WatchHub``, or a relay's
        #: ``RelayWatchSource``) multiplexes co-hosted informers of one
        #: scope onto one upstream watch. Lists (seed + relist) stay on the client —
        #: the hub only owns watches.
        self._stream_source = stream_source
        self.kind = kind
        self.namespace = namespace
        self.label_selector = label_selector
        self.field_selector = field_selector
        #: Bounded watch windows so a dead-silent stream cannot park the
        #: informer forever; each window resumes from the last revision.
        self.watch_timeout_seconds = watch_timeout_seconds
        #: How many consecutive watch-stream failures resume from the
        #: last delivered/bookmarked revision before degrading to a full
        #: re-list (a killed connection costs a re-watch, not an O(pool)
        #: LIST). Reset by any delivered event or cleanly ended window.
        self.max_resume_attempts = 3
        #: client-go's resync: every period, every cached object is
        #: re-delivered to handlers as MODIFIED with old == new (the
        #: SharedInformer UpdateFunc(obj, obj) shape) — the self-heal
        #: tick controllers lean on to requeue work lost to a handler
        #: bug. 0 (the default) disables it, like controller-runtime
        #: builders that pass no resync.
        self.resync_period_s = resync_period_s
        self._store: dict[tuple[str, str], dict] = {}
        #: client-go cache.Indexer: name -> fn(KubeObject) -> [values];
        #: indices are maintained incrementally on every store mutation
        #: and rebuilt on relist, so by_index reads are O(bucket).
        self._indexers: dict[str, Callable[[KubeObject], list[str]]] = {}
        self._indices: dict[str, dict[str, set[tuple[str, str]]]] = {}
        # Reentrant: index functions run under this lock (they must see
        # a consistent store) and may legitimately read back through
        # get()/list()/by_index() on the same thread — a plain Lock
        # would self-deadlock the watch thread on the first event.
        self._lock = threading.RLock()
        # Handler deliveries are SERIALIZED across the watch and resync
        # threads (client-go's sharedProcessor delivers through one
        # queue; handlers are never invoked concurrently). Reentrant so
        # the resync loop can hold it across its store re-check.
        self._dispatch_lock = threading.RLock()
        self._handlers: list[EventHandler] = []
        #: resourceVersion last DELIVERED per key: recorded once every
        #: registered handler returned without raising (trivially so with
        #: zero handlers), left behind on a handler failure so the next
        #: resync sweep re-delivers that revision. Guarded by the
        #: dispatch lock; resync_once compares it against the store to
        #: coalesce replays handlers have already seen.
        self._dispatched_rv: dict[tuple[str, str], str] = {}
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._resource_version: Optional[str] = None
        #: Last revision this informer is CURRENT through — survives the
        #: resume bookkeeping resets so a degraded re-list can ask the
        #: server for deltas-since-rv (``Client.list_delta``) instead of
        #: a full O(collection) snapshot. Cleared only on 410 (the
        #: revision fell out of the server journal, so the delta ask
        #: would fail the same way).
        self._delta_base_rv: Optional[str] = None
        #: Relist accounting: (full relists, delta relists) — the bench/
        #: test hook proving the delta path carried a repair.
        self.full_relists = 0
        self.delta_relists = 0
        #: Consumer identity: a fault plan's ``watch.deliver`` consult gets
        #: it as ``tag``, so a plan can hold ONE consumer's stream, and the
        #: delivery span carries it as ``consumer``.
        self.chaos_tag = ""
        self._watch_handle = None

    # -- lifecycle ---------------------------------------------------------
    def add_event_handler(self, handler: EventHandler) -> None:
        """Register a handler; called as (event_type, obj, old). Watch
        deliveries run on the informer thread, resyncs on the resync
        timer thread — but deliveries are serialized, a handler is never
        invoked concurrently. A handler registered after objects are
        cached is caught up client-go-style: the current store is
        replayed to it (and only it) as synthetic ADDEDs, so late
        registrants see every existing object — deliberately NOT gated
        on the synced flag, which a watch expiry clears while the store
        still holds the last-known objects (a re-list only dispatches
        diffs, so skipping the replay there would lose the unchanged
        ones). Deliveries are at-least-once — an event racing the replay
        can arrive again after it; handlers must be level-driven, as
        controller handlers are."""
        with self._dispatch_lock:
            with self._lock:
                snapshot = list(self._store.values())
            if snapshot:
                for raw in snapshot:
                    obj = wrap(raw)
                    try:
                        handler("ADDED", obj, None)
                    except Exception:  # noqa: BLE001 - handlers own errors
                        log.exception(
                            "informer handler failed during replay for %s",
                            obj.name,
                        )
            self._handlers.append(handler)

    @property
    def started(self) -> bool:
        """True while the informer is RUNNING — the public signal for
        wrappers like ``Controller`` deciding whose lifecycle this is.
        A stopped informer reads False and may be start()ed again."""
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "Informer":
        """Start (or restart after stop()). Restart takes fresh control
        state — a previous run that failed to join within stop()'s
        timeout keeps its own stop event and cannot be resurrected —
        and forces a re-list, which repairs the kept store with
        synthetic diff events."""
        if self.started:
            raise RuntimeError(f"informer for {self.kind} already started")
        self._stop = threading.Event()
        self._synced = threading.Event()
        self._resource_version = None
        self._watch_handle = None
        # The run loops capture THIS event as a local: a wedged previous
        # thread (one that outlived stop()'s join timeout) still polls
        # its own event and can never be re-armed by the fresh one.
        stop = self._stop
        self._thread = threading.Thread(
            target=self._run, args=(stop,),
            name=f"informer-{self.kind}", daemon=True,
        )
        self._thread.start()
        if self.resync_period_s > 0:
            self._resync_thread = threading.Thread(
                target=self._resync_loop, args=(stop,),
                name=f"informer-{self.kind}-resync",
                daemon=True,
            )
            self._resync_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        handle = self._watch_handle
        if handle is not None:
            handle.cancel()  # unblock the parked socket read promptly
        if self._thread is not None:
            self._thread.join(timeout=10)
        resync_thread = getattr(self, "_resync_thread", None)
        if resync_thread is not None:
            resync_thread.join(timeout=10)

    def _resync_loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.resync_period_s):
            if not self._synced.is_set():
                continue  # nothing meaningful to re-deliver mid-relist
            self.resync_once(stop)

    def resync_once(self, stop: Optional[threading.Event] = None) -> int:
        """One coalescing resync sweep; returns how many objects were
        re-delivered. Unlike client-go's replay-everything resync, a key
        whose stored resourceVersion handlers were already offered is
        SKIPPED — a sweep over a settled store delivers zero events — and
        only entries the store holds *ahead of dispatch* (a
        ``record_write`` store repair whose watch echo never arrived, or
        an event delivery that died mid-flight) are re-delivered in the
        client-go resync shape, ``UpdateFunc(obj, obj)``. This is the
        self-heal a resync exists for, minus the O(store) replay storm
        on every tick."""
        delivered = 0
        with self._lock:
            keys = list(self._store)
        for key in keys:
            if stop is not None and stop.is_set():
                return delivered
            # Under the dispatch lock, re-check the object is still
            # cached: the watch thread removes from the store BEFORE
            # dispatching DELETED, so a gone object is skipped here
            # and a resync MODIFIED can never follow its DELETED.
            with self._dispatch_lock:
                with self._lock:
                    raw = self._store.get(key)
                if raw is None:
                    continue
                rv = str(
                    (raw.get("metadata") or {}).get("resourceVersion", "")
                )
                if self._dispatched_rv.get(key) == rv:
                    continue  # handlers already saw this exact revision
                # client-go resync shape: UpdateFunc(obj, obj).
                self._dispatch("MODIFIED", raw, raw)
                delivered += 1
        return delivered

    def _in_flight(self) -> tuple[dict, list[dict], int]:
        """One consistent view under the dispatch lock (re-entrant for
        callers already inside it): the store snapshot, the entries
        whose revision has not yet been offered to handlers (the watch
        thread writes the store BEFORE dispatching, so a reader can
        observe the new object while its handlers are still pending),
        and the count of dispatched keys whose store entry is already
        gone (a DELETED mid-flight — its raw is no longer available).
        THE settledness scan: ``pending_dispatch`` and
        ``with_settled_store`` must agree on what "in flight" means, so
        they both read it here."""
        with self._dispatch_lock:
            with self._lock:
                store = dict(self._store)
            pending = []
            for key, raw in store.items():
                rv = str(
                    (raw.get("metadata") or {}).get("resourceVersion", "")
                )
                if self._dispatched_rv.get(key) != rv:
                    pending.append(raw)
            gone = sum(1 for k in self._dispatched_rv if k not in store)
            return store, pending, gone

    def pending_dispatch(self) -> tuple[list[dict], int]:
        """In-flight deliveries: (pending raws, gone-key count).
        ``resync_once`` eventually re-delivers the former; the
        incremental audit path uses this to keep event races out of the
        divergence count."""
        _, pending, gone = self._in_flight()
        return pending, gone

    def with_settled_store(self, fn) -> bool:
        """Run ``fn(raws)`` over the store contents under the dispatch
        lock, but ONLY when no delivery is in flight — returns False
        without calling ``fn`` otherwise. Holding the dispatch lock
        across ``fn`` means no handler can run concurrently, so a
        consumer maintaining an event-derived book (per-DS pod counts,
        say) can rebase it on the store without losing an increment to
        a racing handler: any event arriving after ``fn`` ran is NOT in
        the raws it saw and will be applied by its handler on top of
        the rebased book. ``fn`` sees the SAME snapshot the settledness
        scan checked — a store write landing between the two would
        otherwise hand ``fn`` a pod whose pending dispatch later
        double-counts. ``fn`` must be quick and must not touch this
        informer — it runs inside the dispatch critical section, where
        a re-entrant informer call deadlocks."""
        with self._dispatch_lock:
            store, pending, gone = self._in_flight()
            if pending or gone:
                return False
            fn(list(store.values()))
            return True

    def wait_for_sync(self, timeout: Optional[float] = None) -> bool:
        """Block until the initial list has populated the store."""
        return self._synced.wait(timeout)

    def __enter__(self) -> "Informer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- indexers (client-go cache.Indexer) --------------------------------
    def add_indexer(
        self, name: str, fn: Callable[[KubeObject], list[str]]
    ) -> None:
        """Register a named index: ``fn(obj) -> [values]`` (client-go's
        IndexFunc; multiple values per object are allowed, e.g. one
        bucket per ready condition AND per node). Safe to add after
        start — the index is built from the current store. ``fn`` runs
        under the store lock: keep it fast, and read back through this
        informer only (same-thread reads are safe; blocking on OTHER
        locks from inside an index fn invites deadlock)."""
        with self._lock:
            self._indexers[name] = fn
            self._indices[name] = self._build_index(fn, self._store)

    def _build_index(
        self, fn, store: dict
    ) -> dict[str, set[tuple[str, str]]]:
        """Full build from a store snapshot; caller holds the lock."""
        index: dict[str, set[tuple[str, str]]] = {}
        for key, raw in store.items():
            for value in self._index_values(fn, raw):
                index.setdefault(value, set()).add(key)
        return index

    def by_index(self, name: str, value: str) -> list[KubeObject]:
        """Objects whose index function yielded ``value`` — the
        controller-runtime ``client.MatchingFields`` read path (e.g.
        pods by spec.nodeName) at O(bucket) instead of a store scan."""
        with self._lock:
            if name not in self._indexers:
                raise KeyError(f"no indexer named {name!r}")
            keys = self._indices.get(name, {}).get(value, set())
            out = [
                wrap(deep_copy_json(self._store[k]))
                for k in keys
                if k in self._store
            ]
        return sorted(out, key=lambda o: (o.namespace, o.name))

    @staticmethod
    def _index_values(fn, raw: dict) -> list[str]:
        try:
            return [v for v in fn(wrap(raw)) if v is not None]
        except Exception:  # noqa: BLE001 - index fns own their errors
            log.exception("indexer function failed for %s", raw)
            return []

    def _index_remove(self, key: tuple[str, str], raw: dict) -> None:
        for name, fn in self._indexers.items():
            index = self._indices[name]
            for value in self._index_values(fn, raw):
                bucket = index.get(value)
                if bucket is not None:
                    bucket.discard(key)
                    if not bucket:
                        index.pop(value, None)

    def _index_add(self, key: tuple[str, str], raw: dict) -> None:
        for name, fn in self._indexers.items():
            index = self._indices[name]
            for value in self._index_values(fn, raw):
                index.setdefault(value, set()).add(key)

    def _store_set(self, key: tuple[str, str], raw: dict) -> None:
        """Store write + incremental index maintenance; caller holds
        the lock."""
        old = self._store.get(key)
        if old is not None:
            self._index_remove(key, old)
        self._store[key] = raw
        self._index_add(key, raw)

    def _store_pop(self, key: tuple[str, str]) -> None:
        old = self._store.pop(key, None)
        if old is not None:
            self._index_remove(key, old)

    # -- write-through -----------------------------------------------------
    def record_write(self, obj: "KubeObject | dict") -> None:
        """Write-through from the object's writer: store the write result
        NOW so the writer's next cached read reflects its own write
        (read-your-writes), instead of waiting for the watch to deliver
        it. The watch event still arrives later; deliveries being
        at-least-once, handlers are level-driven and tolerate the replay.

        Ignored when the store already holds a strictly newer
        resourceVersion (the watch outran the caller), and never
        dispatched to handlers — this is a store repair, not an event.
        """
        raw = obj.raw if isinstance(obj, KubeObject) else obj
        key = self._key(raw)
        new_rv = str((raw.get("metadata") or {}).get("resourceVersion", ""))
        with self._lock:
            old = self._store.get(key)
            if old is not None:
                old_rv = str(
                    (old.get("metadata") or {}).get("resourceVersion", "")
                )
                if (
                    old_rv.isdigit()
                    and new_rv.isdigit()
                    and int(new_rv) <= int(old_rv)
                ):
                    return  # store is already as new as (or newer than) us
            self._store_set(key, deep_copy_json(raw))

    # -- cached reads ------------------------------------------------------
    # get/list/by_index return DEEP COPIES, like a controller-runtime
    # cached client: callers mutate their results (the state provider
    # updates node labels in place; cordon flips unschedulable), and an
    # aliased store object would let those mutations corrupt the shared
    # cache from outside its lock.
    def get(self, name: str, namespace: str = "") -> Optional[KubeObject]:
        with self._lock:
            raw = self._store.get((namespace, name))
            return wrap(deep_copy_json(raw)) if raw is not None else None

    def list(
        self,
        label_selector: Optional[str | Mapping[str, str]] = None,
        copy: bool = True,
    ) -> list[KubeObject]:
        """``copy=False`` skips the defensive copy and wraps the store's
        own dicts — STRICTLY read-only (``FakeCluster.list_peek``'s
        contract): store entries are never edited in place (watch/
        record_write/relist all swap whole dicts), so the refs form a
        consistent snapshot, but a caller mutation would corrupt the
        cache. Reserved for consumers that provably never mutate — the
        snapshot source's Pod/DaemonSet/ControllerRevision reads."""
        if isinstance(label_selector, Mapping):
            label_selector = ",".join(
                f"{k}={v}" for k, v in sorted(label_selector.items())
            )
        selector = parse_selector(label_selector)
        with self._lock:
            out = []
            for raw in self._store.values():
                labels = (raw.get("metadata") or {}).get("labels") or {}
                if selector.matches(labels):
                    out.append(wrap(raw if not copy else deep_copy_json(raw)))
            return sorted(out, key=lambda o: (o.namespace, o.name))

    # -- internals ---------------------------------------------------------
    @staticmethod
    def _key(raw: dict) -> tuple[str, str]:
        meta = raw.get("metadata") or {}
        return (meta.get("namespace", ""), meta.get("name", ""))

    def _dispatch(self, event: str, raw: dict, old: Optional[dict]) -> None:
        tracer = tracing.tracer()
        if tracer is None:
            self._dispatch_inner(event, raw, old)
            return
        # The delivery joins the trace of the write that made this
        # revision and starts at its wall time; a dirty mark made by a
        # handler records this trace as a wake of the next pass.
        meta = raw.get("metadata") or {}
        rv = str(meta.get("resourceVersion", ""))
        origin = tracer.write_origin(rv)
        attrs = {"kind": self.kind, "name": meta.get("name", ""), "event": event, "rv": rv}
        if self.chaos_tag:
            attrs["consumer"] = self.chaos_tag
        deliver_span = tracer.start_span(
            "informer.deliver",
            category="wire",
            trace_id=origin[0] if origin else None,
            parent_id=origin[1] if origin else "",
            start=origin[2] if origin else None,
            attrs=attrs,
        )
        try:
            with tracing.use_span(deliver_span):
                self._dispatch_inner(event, raw, old)
        finally:
            tracer.end_span(deliver_span)

    def _dispatch_inner(self, event: str, raw: dict, old: Optional[dict]) -> None:
        obj = wrap(raw)
        old_obj = wrap(old) if old is not None else None
        with self._dispatch_lock:
            key = self._key(raw)
            delivered = True
            for handler in self._handlers:
                try:
                    handler(event, obj, old_obj)
                except Exception:  # noqa: BLE001 - handlers own their errors
                    delivered = False
                    log.exception(
                        "informer handler failed for %s %s", event, obj.name
                    )
            # Record the rv only after every handler returned: a raising
            # handler leaves the key behind dispatch, so the next resync
            # sweep re-delivers this revision (the "delivery died
            # mid-flight" self-heal resync_once promises). A DELETED is
            # un-healable either way — the store entry is already gone —
            # so its book entry is dropped regardless.
            if event == "DELETED":
                self._dispatched_rv.pop(key, None)
            elif delivered:
                self._dispatched_rv[key] = str(
                    (raw.get("metadata") or {}).get("resourceVersion", "")
                )

    def _try_delta_relist(self, stop) -> bool:
        """Repair the store from a deltas-since-rv LIST when the client
        and server support it (``list_delta`` + the journal window):
        O(what changed) instead of O(collection), which is what keeps a
        degraded re-list (``max_resume_attempts`` exhausted) from
        costing O(fleet) at fan-out. Returns False to fall back to the
        full snapshot path — outside the window, unsupported, first
        seed, or any error."""
        since = self._delta_base_rv
        lister = getattr(self._client, "list_delta", None)
        with self._lock:
            have_store = bool(self._store)
        if lister is None or not since or not have_store:
            return False
        try:
            delta = lister(
                self.kind,
                since,
                namespace=self.namespace,
                label_selector=self.label_selector,
                field_selector=self.field_selector,
            )
        except Exception:  # noqa: BLE001 - delta is an optimization
            log.debug("delta list failed for %s; full re-list", self.kind,
                      exc_info=True)
            return False
        if delta is None:
            return False  # outside the journal window: full snapshot
        if stop.is_set():
            return True  # superseded: discard; _run exits on stop
        rvs = [int(since)] if since.isdigit() else []
        if str(delta.revision or "").isdigit():
            rvs.append(int(delta.revision))
        changed: list[tuple[tuple[str, str], dict, Optional[dict]]] = []
        dropped: list[tuple[tuple[str, str], dict]] = []
        deleted_keys = list(delta.deleted)
        if delta.full:
            # The server answered a FULL list (it predates delta
            # lists): items is the whole collection, already in hand —
            # diff it against the store instead of refetching the same
            # bytes through the plain-list path. Anything we hold that
            # the list lacks is gone.
            fresh_keys = {self._key(obj.raw) for obj in delta.items}
            with self._lock:
                deleted_keys.extend(
                    key for key in self._store if key not in fresh_keys
                )
        with self._lock:
            for obj in delta.items:
                raw = obj.raw
                key = self._key(raw)
                old = self._store.get(key)
                old_rv = str(
                    ((old or {}).get("metadata") or {}).get(
                        "resourceVersion", ""
                    )
                )
                new_rv = str(
                    (raw.get("metadata") or {}).get("resourceVersion", "")
                )
                if new_rv.isdigit():
                    rvs.append(int(new_rv))
                if (
                    old is not None
                    and old_rv.isdigit()
                    and new_rv.isdigit()
                    and int(new_rv) <= int(old_rv)
                ):
                    continue  # record_write already holds something newer
                self._store_set(key, raw)
                changed.append((key, raw, old))
            for namespace, name in deleted_keys:
                key = (namespace, name)
                old = self._store.get(key)
                if old is not None:
                    self._store_pop(key)
                    dropped.append((key, old))
        for _key, raw, old in changed:
            self._dispatch("MODIFIED" if old is not None else "ADDED",
                           raw, old)
        for _key, old in dropped:
            self._dispatch("DELETED", old, old)
        self._resource_version = str(max(rvs)) if rvs else None
        self._delta_base_rv = self._resource_version
        if delta.full:
            self.full_relists += 1  # a whole collection crossed the wire
        else:
            self.delta_relists += 1
        self._synced.set()
        return True

    def _relist(self, stop) -> None:
        """Seed/repair the store from a fresh list, emitting synthetic
        events for every difference a lapsed watch may have missed.
        ``stop`` is THIS run's stop event: a run superseded while blocked
        in the list call (stop() gave up joining, start() launched a new
        run) must discard its result instead of clobbering the new run's
        store/synced/resume state."""
        if self._try_delta_relist(stop):
            return
        list_kwargs = dict(
            namespace=self.namespace,
            label_selector=self.label_selector,
            field_selector=self.field_selector,
        )
        collection_rv = ""
        lister = getattr(self._client, "list_with_revision", None)
        if lister is not None:
            items, collection_rv = lister(self.kind, **list_kwargs)
        else:
            items = self._client.list(self.kind, **list_kwargs)
        fresh = {self._key(o.raw): o.raw for o in items}
        rvs = [
            int(o.resource_version)
            for o in items
            if str(o.resource_version or "").isdigit()
        ]
        if collection_rv.isdigit():
            rvs.append(int(collection_rv))
        if stop.is_set():
            return  # superseded (or stopping): discard the stale list
        with self._lock:
            previous = self._store
            self._store = fresh
            # Rebuild every index from the fresh snapshot.
            for name, fn in self._indexers.items():
                self._indices[name] = self._build_index(fn, fresh)
        for key, raw in fresh.items():
            old = previous.get(key)
            if old is None:
                self._dispatch("ADDED", raw, None)
            elif old.get("metadata", {}).get("resourceVersion") != raw.get(
                "metadata", {}
            ).get("resourceVersion"):
                self._dispatch("MODIFIED", raw, old)
        for key, old in previous.items():
            if key not in fresh:
                self._dispatch("DELETED", old, old)
        # Resume from the newest revision the list showed; watching from
        # an older one would replay events already reflected in the store.
        self._resource_version = str(max(rvs)) if rvs else None
        self._delta_base_rv = self._resource_version
        self.full_relists += 1
        self._synced.set()

    def _run(self, stop: threading.Event) -> None:
        consecutive_failures = 0
        while not stop.is_set():
            try:
                if not self._synced.is_set() or self._resource_version is None:
                    self._relist(stop)
                    if stop.is_set():
                        return
                watch_kwargs = dict(
                    namespace=self.namespace,
                    label_selector=self.label_selector,
                    field_selector=self.field_selector,
                    timeout_seconds=self.watch_timeout_seconds,
                    resource_version=self._resource_version,
                    # Reflector shape: request bookmarks so a quiet
                    # scoped watch keeps a fresh resume point while the
                    # journal advances under it (no 410 + relist decay).
                    allow_bookmarks=True,
                )
                if stop.is_set():
                    # A superseded run must not clobber the live run's
                    # handle with a stale one.
                    return
                self._watch_handle = WatchHandle()
                # stop() may have run between the check above and the
                # assignment, when there was no handle to cancel —
                # re-check after publishing the handle so that window
                # cannot park us in a full watch timeout.
                if stop.is_set():
                    return
                watch_source = self._stream_source or self._client
                watch_iter = watch_source.watch(
                    self.kind, handle=self._watch_handle, **watch_kwargs
                )
                for event_type, obj in watch_iter:
                    if stop.is_set():
                        return
                    # While a plan holds this stream, events wait upstream
                    # (the watch is not pulled) and the store goes stale;
                    # the release delivers them in order.
                    chaos_hold("watch.deliver", stop.is_set, kind=self.kind, tag=self.chaos_tag)
                    if stop.is_set():
                        return
                    consecutive_failures = 0  # the stream delivered
                    raw = obj.raw
                    if event_type == "BOOKMARK":
                        # Resume-point refresh only: no object payload,
                        # nothing to store or dispatch.
                        rv = str(
                            (raw.get("metadata") or {}).get(
                                "resourceVersion", ""
                            )
                        )
                        if rv.isdigit():
                            self._resource_version = rv
                            self._delta_base_rv = rv
                        continue
                    key = self._key(raw)
                    rv = str(
                        (raw.get("metadata") or {}).get("resourceVersion", "")
                    )
                    with self._lock:
                        old = self._store.get(key)
                        if event_type == "DELETED":
                            self._store_pop(key)
                        else:
                            # record_write (provider write-through) may
                            # have landed a NEWER object than this
                            # delivery — applying a lagging event would
                            # regress the store below the caller's own
                            # write, exactly the staleness write-through
                            # exists to remove. Same forward-only rule
                            # record_write itself follows. The event is
                            # still DISPATCHED below: record_write never
                            # dispatches, so dropping the watch echo too
                            # would deliver the write zero times and
                            # starve trigger handlers of their wake-up
                            # (handlers are level-driven; a stale payload
                            # is at-least-once noise, a missing one is a
                            # lost event).
                            old_rv = str(
                                ((old or {}).get("metadata") or {}).get(
                                    "resourceVersion", ""
                                )
                            )
                            if not (
                                old is not None
                                and old_rv.isdigit()
                                and rv.isdigit()
                                and int(rv) <= int(old_rv)
                            ):
                                self._store_set(key, raw)
                    if rv.isdigit():
                        self._resource_version = rv
                        self._delta_base_rv = rv
                    self._dispatch(event_type, raw, old)
                # Watch window ended (server timeout): resume from the
                # last seen revision on the next loop iteration.
                consecutive_failures = 0
            except NotImplementedError:
                # A client with no watch path must fail fast, not be
                # silently degraded into a re-list hot loop.
                raise
            except Exception as e:  # noqa: BLE001 - stream died; back off
                if has_reason(e, WatchExpiredError):
                    # By reason, not class: the client may be another
                    # package's, raising its own class for a 410.
                    log.info(
                        "%s watch expired at rv=%s; re-listing",
                        self.kind, self._resource_version,
                    )
                    self._resource_version = None
                    if self._stream_source is None:
                        # The revision fell out of the SERVER journal; a
                        # delta LIST from it would be outside the window
                        # too — take the full snapshot directly, not
                        # after a failed ask.
                        self._delta_base_rv = None
                    # With a hub stream source the 410 usually means only
                    # the HUB's replay window lapsed (slow subscriber);
                    # the server-side journal is typically deeper, so
                    # KEEP the base rv and let the delta LIST repair in
                    # O(changed) — if the server journal lapsed too,
                    # list_delta answers None and the full path runs.
                    self._synced.clear()
                    continue
                if stop.is_set():
                    return
                consecutive_failures += 1
                if (
                    self._resource_version is not None
                    and consecutive_failures <= self.max_resume_attempts
                ):
                    # A dead CONNECTION is not a lost CACHE: the store is
                    # still valid through the last delivered revision
                    # (bookmarks keep it fresh on quiet watches), so
                    # resume the watch from there — the journal replays
                    # whatever the dead stream swallowed. Re-listing here
                    # would put an O(pool) LIST on every network blip;
                    # only a 410 (revision fell out of the journal) or
                    # repeated resume failures earn that.
                    log.warning(
                        "%s watch died (%s); resuming from rv=%s "
                        "(attempt %d/%d)",
                        self.kind, e, self._resource_version,
                        consecutive_failures, self.max_resume_attempts,
                    )
                    stop.wait(min(0.2 * consecutive_failures, 1.0))
                    continue
                log.warning("%s watch failed (%s); re-listing", self.kind, e)
                self._resource_version = None
                self._synced.clear()
                stop.wait(1.0)
