"""Causally linked spans of a roll, from a pass to each node's state
transitions, the writes that woke it and the requests it sent.

The JAX package's ``utils/tracing.py``, copied whole, so a trace of the
port's machine is what a trace of the JAX machine is and the port's
``tools/trace_view.py`` reads either:

* **spans**: trace id, span id, parent id, wall timestamps from
  :func:`~.faultpoints.wall_now` (``time.time``, or the installed virtual
  clock, which is what makes an export deterministic), a category from
  the attribution taxonomy (:data:`CATEGORIES`), attributes, and
  **events** (a node's state transition with its cause rides the bucket
  span that caused it);
* **a bounded ring** of finished spans: a flight recorder, never a leak;
* **JSONL export**, one span a line; ``deterministic=True`` renumbers ids
  in content order, so one execution exports the same bytes whatever the
  threads' interleaving;
* **wire context**: ``traceparent`` strings (``00-<trace>-<span>-01``)
  that ``kube/rest.py`` sends and an API server parses, so the server's
  span joins the client's trace;
* **write origins**: an API server's write choke point records, per
  resourceVersion, the trace that made the write; the informer's
  delivery span joins it, and the pass that delivery woke links to it.

Stdlib only. One process-wide :class:`Tracer`, installed and cleared by
the observer, as ``faultpoints`` installs a plan: with none installed
every site costs one module-global ``None`` check. With one installed a
settled pool's pass still emits no span (the pass span opens only when
the pass has work).

The spans the port emits are the machine's (``reconcile.pass``,
``bucket.*``, ``drain.node``, ``evict.node``, ``validate.node``,
``write.flush``, the ``state.transition`` and ``checkpoint.*`` events),
the informer's ``informer.deliver``, the client's ``http.request``, the
leader election's ``lease.round`` (``kube/leader.py``) and the fleet's
``fleet.grant_round`` (with a ``fleet.grant`` event a pool granted) and
``fleet.report_done`` (``fleet/``). The server side's ``server.request``
(joined to the client's trace by its ``traceparent``) and ``apf.queue``
(its priority-and-fairness queue wait) are the in-memory API server's
(``kube/apiserver.py``). The health gate's battery is ``gate.run``, its
probes ``gate.collectives``, ``gate.mxu``, ``gate.burnin`` and
``gate.flash`` below it, and inside those ``mxu.check``, ``flash.inputs``,
``flash.oracle`` and ``flash.check`` (``tpu/health.py``, ``ops/``).
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Optional

from .faultpoints import wall_now

#: Attribution taxonomy: every span carries one of these;
#: ``tools/trace_view.py`` buckets the critical path by them and treats
#: anything else as unattributed. ``idle`` is derived (wall time no span
#: covers), never stamped on a span. The port's machine stamps
#: ``reconcile``, ``wire``, ``drain``, ``checkpoint``, ``probe`` and
#: ``write``, the leader election ``lease``, the fleet ``grant``;
#: ``queue`` is the API server's (``kube/apiserver.py``).
CATEGORIES = (
    "grant",      # the fleet orchestrator's grant rounds / done reports
    "lease",      # the leader election's protocol rounds
    "reconcile",  # build_state/apply_state passes + their buckets
    "wire",       # HTTP requests, server dispatch, informer delivery
    "queue",      # the API server's priority-and-fairness queue wait
    "drain",      # node drain / eviction waits
    "checkpoint", # checkpoint request→ack→manifest arcs
    "probe",      # validation batteries / restore gates
    "write",      # provider write-batch flushes (upgrade/write_batch.py)
)

#: Default ring capacity: a 64-pool roll at 2 workers produces a few
#: tens of thousands of spans; the flight recorder keeps the most
#: recent window and drops the oldest beyond this.
DEFAULT_CAPACITY = 262_144

#: Bounded write-origin book: rv -> (trace, span, wall). Keyed by the
#: monotonically increasing resourceVersion, so eviction is FIFO.
DEFAULT_ORIGIN_CAPACITY = 16_384

#: Deterministic-export cutoff for runs on a virtual clock that starts
#: at wall 1.7e9 and advances in seconds: anything below this bound is
#: virtual time; spans stamped on real time (teardown, after the clock
#: is cleared) sit far above it and are outside the deterministic record.
CHAOS_EXPORT_CUTOFF = 1_750_000_000.0


class Span:
    """One in-flight or finished span. Mutation (events, links, attrs)
    is guarded by the owning tracer's lock — bucket fan-out threads
    append state-transition events to one shared bucket span."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "category",
        "start", "end", "attrs", "events", "links",
    )

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        parent_id: str,
        name: str,
        category: str,
        start: float,
        attrs: Optional[dict[str, Any]] = None,
    ) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.category = category
        self.start = start
        self.end: Optional[float] = None
        self.attrs: dict[str, Any] = attrs or {}
        #: (ts, name, attrs) triples — the flight recorder's raw
        #: material (per-node state transitions with cause).
        self.events: list[tuple[float, str, dict[str, Any]]] = []
        #: Trace ids this span is causally linked to beyond its parent
        #: (the writes whose watch deltas woke this reconcile pass).
        self.links: list[str] = []

    def to_record(self) -> dict[str, Any]:
        return {
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "category": self.category,
            "start": round(self.start, 6),
            "end": round(self.end if self.end is not None else self.start, 6),
            "attrs": self.attrs,
            "events": [
                {"ts": round(ts, 6), "name": name, "attrs": attrs}
                for ts, name, attrs in self.events
            ],
            "links": list(self.links),
        }


class Tracer:
    """The process-wide span recorder (flight-recorder ring + id
    allocation + the write-origin book). One per process at a time,
    installed via :func:`install_tracer` — the ``faultpoints`` pattern.
    All internal state is guarded by ONE leaf lock; nothing blocks
    under it."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        origin_capacity: int = DEFAULT_ORIGIN_CAPACITY,
    ) -> None:
        self._lock = threading.Lock()
        self._finished: deque[dict[str, Any]] = deque(maxlen=int(capacity))
        self._trace_seq = 0
        self._span_seq = 0
        self.started = 0
        self.finished = 0
        #: rv(str) -> (trace_id, span_id, wall) — the write-origin book
        #: informer deliveries link against. FIFO-bounded.
        self._origins: dict[str, tuple[str, str, float]] = {}
        self._origin_order: deque[str] = deque()
        self._origin_capacity = int(origin_capacity)

    # -- id allocation ------------------------------------------------------
    def new_trace_id(self) -> str:
        with self._lock:
            self._trace_seq += 1
            return f"{self._trace_seq:032x}"

    def _new_span_id_locked(self) -> str:
        self._span_seq += 1
        return f"{self._span_seq:016x}"

    # -- span lifecycle -----------------------------------------------------
    def start_span(
        self,
        name: str,
        category: str = "",
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        start: Optional[float] = None,
        attrs: Optional[dict[str, Any]] = None,
        parent: Optional[Span] = None,
    ) -> Span:
        """Open a span. Parentage, most specific wins: an explicit
        ``parent`` span, else explicit ``trace_id``/``parent_id`` (the
        wire-propagation path), else the calling thread's current span,
        else a fresh root trace."""
        if parent is None and trace_id is None and parent_id is None:
            parent = current_span()
        if parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        with self._lock:
            if trace_id is None:
                self._trace_seq += 1
                trace_id = f"{self._trace_seq:032x}"
            span = Span(
                trace_id,
                self._new_span_id_locked(),
                parent_id or "",
                name,
                category,
                start if start is not None else wall_now(),
                attrs,
            )
            self.started += 1
        return span

    def end_span(self, span: Optional[Span], end: Optional[float] = None) -> None:
        if span is None:
            return
        with self._lock:
            if span.end is not None:
                return  # already finished (idempotent teardown paths)
            span.end = end if end is not None else wall_now()
            self._finished.append(span.to_record())
            self.finished += 1

    def add_span(
        self,
        name: str,
        category: str,
        start: float,
        end: float,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        attrs: Optional[dict[str, Any]] = None,
        parent: Optional[Span] = None,
    ) -> None:
        """Record an already-measured interval in one call (the APF
        queue-wait shape: enqueue/dispatch stamps exist before the span
        does)."""
        span = self.start_span(
            name, category, trace_id=trace_id, parent_id=parent_id,
            start=start, attrs=attrs, parent=parent,
        )
        self.end_span(span, end=end)

    def add_event(self, span: Span, name: str, **attrs: Any) -> None:
        with self._lock:
            span.events.append((wall_now(), name, attrs))

    def add_link(self, span: Span, trace_id: str) -> None:
        with self._lock:
            if trace_id and trace_id != span.trace_id and (
                trace_id not in span.links
            ):
                span.links.append(trace_id)

    # -- write origins ------------------------------------------------------
    def record_write_origin(
        self, rv: str, trace_id: str, span_id: str
    ) -> None:
        """Remember which trace performed the write that produced ``rv``
        (called by the fake apiserver's emit choke point under an active
        server/bucket span). Keyed by rv so the link survives watch
        windows, killed connections, and hub journal replays."""
        rv = str(rv)
        with self._lock:
            if rv not in self._origins:
                self._origin_order.append(rv)
                while len(self._origin_order) > self._origin_capacity:
                    self._origins.pop(self._origin_order.popleft(), None)
            self._origins[rv] = (trace_id, span_id, wall_now())

    def write_origin(
        self, rv: str
    ) -> Optional[tuple[str, str, float]]:
        """(trace_id, span_id, write_wall) for a revision, if the write
        happened under a traced context in this process."""
        with self._lock:
            return self._origins.get(str(rv))

    # -- export -------------------------------------------------------------
    def records(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._finished)

    def export_jsonl(
        self, path: str, deterministic: bool = False
    ) -> int:
        """Write one JSON object per finished span; returns the span
        count. ``deterministic=True`` normalizes first (see
        :func:`normalize_records`) so the same execution exports the
        same bytes regardless of thread interleavings — the chaos
        harness's run-twice determinism contract."""
        records = self.records()
        if deterministic:
            records = normalize_records(records)
        with open(path, "w", encoding="utf-8") as f:
            for record in records:
                f.write(json.dumps(record, sort_keys=True) + "\n")
        return len(records)

    def export_bytes(
        self,
        deterministic: bool = True,
        end_before: Optional[float] = None,
    ) -> bytes:
        """The normalized export as bytes — what the chaos runner's
        ``--trace-json`` writes and the run-twice determinism pin
        compares. ``end_before`` drops spans finishing at or past that
        wall time; pass :data:`CHAOS_EXPORT_CUTOFF` for chaos runs
        (teardown happens after the virtual clock retires, on real
        time — those spans are outside the deterministic record)."""
        records = self.records()
        if end_before is not None:
            records = [r for r in records if r["end"] < end_before]
        if deterministic:
            records = normalize_records(records)
        return "".join(
            json.dumps(record, sort_keys=True) + "\n" for record in records
        ).encode()


def _content_key(record: dict[str, Any]) -> str:
    """A span's identity MINUS its allocated ids: what it did, when,
    with which attrs/events. Two runs of the same (virtual-clock)
    execution produce the same content keys whatever order threads
    allocated ids in."""
    return json.dumps(
        [
            record["start"], record["end"], record["name"],
            record["category"], record["attrs"],
            sorted(
                json.dumps(e, sort_keys=True) for e in record["events"]
            ),
        ],
        sort_keys=True,
    )


def normalize_records(records: list[dict]) -> list[dict]:
    """Deterministic export order + id renumbering.

    Spans are sorted by content (start/end/name/category/attrs/events),
    disambiguated through their FULL ancestor chain's content keys —
    two workers' same-shaped bucket spans differ through their pass
    spans' ``worker`` attr, and an ``apf.queue`` under a
    ``server.request`` under an ``http.request`` still reaches the
    distinguishing pass span four levels up. Then trace/span ids are
    renumbered in that order and parent/link references remapped.
    Events within a span are sorted by (ts, name, attrs) — bucket
    fan-out threads append them in arrival order, which is not
    deterministic; their content is."""
    by_span = {r["span"]: r for r in records}
    keys = {r["span"]: _content_key(r) for r in records}

    def lineage_key(record: dict) -> tuple:
        chain = [keys[record["span"]]]
        seen = {record["span"]}
        parent = by_span.get(record["parent"])
        while parent is not None and parent["span"] not in seen:
            seen.add(parent["span"])
            chain.append(keys[parent["span"]])
            parent = by_span.get(parent["parent"])
        return (record["start"], tuple(chain))

    ordered = sorted(records, key=lineage_key)
    trace_map: dict[str, str] = {}
    span_map: dict[str, str] = {}
    for record in ordered:
        if record["trace"] not in trace_map:
            trace_map[record["trace"]] = f"{len(trace_map) + 1:032x}"
        span_map[record["span"]] = f"{len(span_map) + 1:016x}"
    out = []
    for record in ordered:
        fresh = dict(record)
        fresh["trace"] = trace_map[record["trace"]]
        fresh["span"] = span_map[record["span"]]
        # A parent that never finished (or fell off the ring) keeps no
        # id: map it to "" so both runs agree.
        fresh["parent"] = span_map.get(record["parent"], "")
        fresh["links"] = sorted(
            trace_map.get(link, "external") for link in record["links"]
        )
        fresh["events"] = sorted(
            record["events"],
            key=lambda e: (e["ts"], e["name"],
                           json.dumps(e["attrs"], sort_keys=True)),
        )
        out.append(fresh)
    return out


# -- the process-wide registry (the faultpoints pattern) --------------------
_tracer: Optional[Tracer] = None
_ctx = threading.local()


def install_tracer(tracer: Optional[Tracer]) -> None:
    """Install the process-wide tracer. Refuses to stack — overlapping
    observers would interleave unrelated rolls into one flight record."""
    global _tracer
    if _tracer is not None and tracer is not None:
        raise RuntimeError("a tracer is already installed")
    _tracer = tracer


def clear_tracer() -> None:
    global _tracer
    _tracer = None


def tracer() -> Optional[Tracer]:
    """The installed tracer, or None. THE fast path: every
    instrumentation site reads this one global and stops there when
    tracing is off."""
    return _tracer


def current_span() -> Optional[Span]:
    """The calling thread's active span (None when tracing is off or
    nothing is active). One global read on the disabled path."""
    if _tracer is None:
        return None
    return getattr(_ctx, "span", None)


def current_trace_id() -> Optional[str]:
    span = current_span()
    return span.trace_id if span is not None else None


class _Activation:
    """Handle for an explicitly activated span: ``close()`` restores the
    thread's previous current span (the pass-span lifecycle, which
    outlives any single ``with`` block)."""

    __slots__ = ("_previous",)

    def __init__(self, previous: Optional[Span]) -> None:
        self._previous = previous

    def close(self) -> None:
        _ctx.span = self._previous


def activate(span: Optional[Span]) -> _Activation:
    previous = getattr(_ctx, "span", None)
    _ctx.span = span
    return _Activation(previous)


class _UseSpan:
    """Context manager: run a block with ``span`` as the thread's
    current span (cross-thread propagation: TaskRunner installs the
    bucket span in its fan-out workers)."""

    __slots__ = ("_span", "_previous")

    def __init__(self, span: Optional[Span]) -> None:
        self._span = span
        self._previous = None

    def __enter__(self) -> Optional[Span]:
        self._previous = getattr(_ctx, "span", None)
        _ctx.span = self._span
        return self._span

    def __exit__(self, *exc) -> None:
        _ctx.span = self._previous


class _NullScope:
    """The disabled path's context manager: ONE module-level singleton,
    so ``with span(...)`` costs no allocation when tracing is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NULL_SCOPE = _NullScope()


def use_span(span: Optional[Span]):
    """``with use_span(s):`` — thread-context propagation. Returns the
    null singleton when there is nothing to install."""
    if span is None:
        return _NULL_SCOPE
    return _UseSpan(span)


class _SpanScope:
    """``with span(...) as s:`` — open on enter (as the thread's
    current), end + restore on exit."""

    __slots__ = ("_tracer", "_name", "_category", "_attrs", "_span",
                 "_previous")

    def __init__(self, tracer: Tracer, name: str, category: str,
                 attrs: dict[str, Any]) -> None:
        self._tracer = tracer
        self._name = name
        self._category = category
        self._attrs = attrs
        self._span: Optional[Span] = None
        self._previous: Optional[Span] = None

    def __enter__(self) -> Span:
        self._span = self._tracer.start_span(
            self._name, self._category, attrs=self._attrs
        )
        self._previous = getattr(_ctx, "span", None)
        _ctx.span = self._span
        return self._span

    def __exit__(self, *exc) -> None:
        _ctx.span = self._previous
        self._tracer.end_span(self._span)


def span(name: str, category: str = "", **attrs: Any):
    """Open a span as a context manager, parented to the thread's
    current span. The disabled path returns the null singleton — one
    global read, zero allocation."""
    t = _tracer
    if t is None:
        return _NULL_SCOPE
    return _SpanScope(t, name, category, attrs)


def add_event(name: str, **attrs: Any) -> None:
    """Attach an event to the thread's current span; no-op (one global
    read) when tracing is off or nothing is active. THE state-transition
    hook: the provider calls this under the bucket span that caused the
    transition, so the flight recorder sees (node, from, to, cause,
    pass) with full causal parentage."""
    t = _tracer
    if t is None:
        return
    span_ = getattr(_ctx, "span", None)
    if span_ is None:
        return
    t.add_event(span_, name, **attrs)


# -- W3C-style wire context -------------------------------------------------

def traceparent() -> Optional[str]:
    """``00-<trace>-<span>-01`` for the thread's current span — what
    RestClient stamps on every request. None when tracing is off or no
    span is active (the header is simply not sent)."""
    span_ = current_span()
    if span_ is None:
        return None
    return f"00-{span_.trace_id}-{span_.span_id}-01"


def parse_traceparent(header: str) -> Optional[tuple[str, str]]:
    """(trace_id, span_id) from a traceparent header; None on anything
    malformed — a bad header must never fail a request."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4 or parts[0] != "00":
        return None
    trace_id, span_id = parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return trace_id, span_id


def record_write_origin(rv: Any) -> None:
    """Fake-apiserver choke point: remember the current trace context as
    the origin of the write that produced ``rv``. One global read when
    tracing is off; a write outside any span records nothing."""
    t = _tracer
    if t is None:
        return
    span_ = getattr(_ctx, "span", None)
    if span_ is None:
        return
    t.record_write_origin(str(rv), span_.trace_id, span_.span_id)
