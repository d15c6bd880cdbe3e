"""Prometheus text exposition, and a ``/metrics`` endpoint on the stdlib.

The JAX package's ``upgrade/metrics.py``: the emitter the monitor's
``MonitorMetrics`` and the health source's ``HealthMetrics`` and
``LinkMetrics`` render through, its histogram, the server
``--metrics-port`` starts, and the state machine's own family,
:class:`UpgradeMetrics` (the node counts of a snapshot, the last pass's
``PassStats``, the checkpoint arc's gauges, each bucket's seconds and the
passes observed), rendered byte for byte as the JAX collector renders
them; and :class:`WireMetrics`, the ``tpu_operator_wire_*`` family, which
reads the watch hub, the relay and its client side, an API server's
priority-and-fairness layer (any object with ``apf_stats()``) and the wire
loop's watchdog, each half duck-typed and optional.
"""

from __future__ import annotations

import itertools
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Protocol

from ..utils.log import get_logger

log = get_logger("upgrade.metrics")


class Renderable(Protocol):
    """Anything the server can expose."""

    def render(self) -> str: ...  # pragma: no cover - typing only


def prom_label(name: str, value: str) -> str:
    """One ``{name="value"}`` label set, the value escaped as the text
    format requires (backslash, double quote, newline)."""
    escaped = value.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    return f'{{{name}="{escaped}"}}'


def merge_label(label: str, name: str, value: str) -> str:
    """One more ``name="value"`` pair spliced into a label set built by
    :func:`prom_label` (a histogram's ``le`` beside the collector's own
    label), escaped the same way."""
    extra = prom_label(name, value)
    if not label:
        return extra
    return label[:-1] + "," + extra[1:]


def render_samples(prefix: str, rows) -> str:
    """``rows`` of (suffix, kind, help text, samples), ``samples`` a list of
    (label set, value): one HELP and TYPE header a row, one line a sample.
    A ``histogram`` row's values are :meth:`Histogram.snapshot` mappings,
    rendered as cumulative ``_bucket`` lines (``le`` spliced into the
    sample's labels), ``_sum`` and ``_count``."""
    out: list[str] = []
    for suffix, kind, help_text, samples in rows:
        name = f"{prefix}_{suffix}"
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} {kind}")
        for label, value in samples:
            if kind == "histogram":
                for le, count in value["buckets"]:
                    out.append(f"{name}_bucket{merge_label(label, 'le', le)} {count}")
                out.append(f"{name}_sum{label} {value['sum']}")
                out.append(f"{name}_count{label} {value['count']}")
            else:
                out.append(f"{name}{label} {value}")
    return "\n".join(out) + "\n"


def render_rows(prefix: str, label: str, rows) -> str:
    """``rows`` of (suffix, kind, help text, value), each with the one label
    set ``label``, through :func:`render_samples`."""
    return render_samples(
        prefix,
        [(suffix, kind, help_text, [(label, value)]) for suffix, kind, help_text, value in rows],
    )


#: Histogram buckets for a battery's latency: a quick battery's fraction of
#: a second to a cold battery's minutes.
DEFAULT_LATENCY_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

#: Histogram buckets for one link's hop: micro- to milliseconds healthy,
#: seconds sick (the battery's buckets would put every healthy hop in the
#: first).
DEFAULT_LINK_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.05, 0.1,
    0.5, 1.0, 5.0,
)


class Histogram:
    """A Prometheus histogram: fixed cumulative buckets (sorted, without
    duplicates; ``+Inf`` implied), observed under a leaf lock and
    snapshotted for :func:`render_samples`."""

    def __init__(self, buckets=DEFAULT_LATENCY_BUCKETS) -> None:
        bounds = sorted({float(b) for b in buckets})
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * len(bounds)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            for i, bound in enumerate(self._bounds):
                if value <= bound:
                    self._counts[i] += 1

    def snapshot(self) -> dict:
        """``{"buckets": [(le, cumulative count), ..., ("+Inf", total)],
        "sum": ..., "count": ...}``, each ``le`` in its shortest form."""
        with self._lock:
            buckets = [
                (format(bound, "g"), count) for bound, count in zip(self._bounds, self._counts)
            ]
            buckets.append(("+Inf", self._count))
            return {"buckets": buckets, "sum": round(self._sum, 6), "count": self._count}


class MetricsServer(ThreadingHTTPServer):
    """``GET /metrics`` over the stdlib's HTTP server. Bind ``0.0.0.0`` in a
    pod, or Prometheus cannot scrape it."""

    daemon_threads = True

    def __init__(self, metrics: Renderable, port: int = 0, host: str = "127.0.0.1") -> None:
        self.metrics = metrics

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - http.server API
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = self.server.metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # noqa: D102
                pass

        super().__init__((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self.server_address[0], self.server_address[1]
        return f"http://{host}:{port}/metrics"

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        log.info("metrics served at %s", self.url)
        return self

    def stop(self) -> None:
        self.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.server_close()

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


_PREFIX = "tpu_operator_upgrade"

#: (metric suffix, help text, manager accessor name)
_GAUGES = [
    ("managed_nodes", "Nodes currently managed by the upgrade flow",
     "get_total_managed_nodes"),
    ("in_progress", "Nodes with an upgrade in progress",
     "get_upgrades_in_progress"),
    ("done", "Nodes that completed the upgrade",
     "get_upgrades_done"),
    ("failed", "Nodes in upgrade-failed",
     "get_upgrades_failed"),
    ("pending", "Nodes waiting in upgrade-required",
     "get_upgrades_pending"),
]

#: The last pass's gauges, read off the manager's ``last_pass_stats``:
#: (metric suffix, help text, ``PassStats`` attribute). The help texts
#: are the JAX collector's, word for word, so the two render alike.
_PASS_GAUGES = [
    ("pass_snapshot_seconds",
     "Wall-clock of the last build_state snapshot phase", "snapshot_s"),
    ("pass_apply_seconds",
     "Wall-clock of the last apply_state phase", "apply_s"),
    ("pass_snapshot_cached",
     "1 when the last snapshot came from informer-backed stores",
     "snapshot_cached"),
    ("pass_reads_issued",
     "Client read calls issued by the last snapshot", "reads_issued"),
    ("pass_writes_issued",
     "State/annotation patches issued during the last apply",
     "writes_issued"),
    ("pass_writes_skipped",
     "No-op patches coalesced away during the last apply",
     "writes_skipped"),
    ("pass_writes_coalesced",
     "Extra keys that rode an issued patch instead of their own "
     "during the last apply (same-node label+annotation coalescing)",
     "writes_coalesced"),
    ("pass_writes_batched",
     "Patches routed through the write-batching tier during the last "
     "apply (0 with batching off)",
     "writes_batched"),
    ("pass_node_errors",
     "Per-node failures isolated inside buckets during the last apply",
     "node_errors"),
    # The incremental source's gauges: all 0 on the other sources.
    ("pass_snapshot_incremental",
     "1 when the snapshot was served by delta-driven incremental state",
     "snapshot_incremental"),
    ("pass_snapshot_skipped",
     "1 when a settled pass served the cached state with zero work",
     "snapshot_skipped"),
    ("pass_full_rebuild",
     "1 when the last pass reclassified every node (first build, "
     "rollout delta, invalidation, or verify audit)",
     "full_rebuild"),
    ("pass_dirty_nodes",
     "Dirty-node set size consumed by the last snapshot",
     "dirty_node_count"),
    ("pass_nodes_reclassified",
     "Nodes reclassified by the last snapshot",
     "nodes_reclassified"),
    ("pass_verify_divergences",
     "Incremental-vs-full divergences repaired by the last audit pass",
     "verify_divergences"),
    ("pass_delta_hit_rate",
     "Lifetime fraction of passes served from deltas without a full "
     "rebuild",
     "delta_hit_rate"),
    ("pass_aborted_completeness_races",
     "Lifetime passes aborted by the snapshot completeness invariant "
     "racing an in-flight pod delivery (bounded-race signal; a wedge "
     "shows as this climbing every pass)",
     "aborted_completeness_races"),
]

#: The checkpoint arc's gauges (``tpu_operator_upgrade_checkpoint_*``), read
#: off ``PassStats`` like :data:`_PASS_GAUGES`. ``checkpoint_escalations_total``
#: is the alert: nonzero means a workload met the deadline and started over.
_CHECKPOINT_GAUGES = [
    ("checkpoint_nodes_waiting",
     "Nodes gated in checkpoint-required after the last pass",
     "checkpoint_nodes_waiting"),
    ("checkpoint_requests_issued",
     "Checkpoint requests written to workload pods during the last pass",
     "checkpoint_requests_issued"),
    ("checkpoint_completions",
     "Nodes whose checkpoint gate completed during the last pass",
     "checkpoint_completions"),
    ("checkpoint_escalations",
     "Checkpoint deadline escalations to a plain drain during the last "
     "pass",
     "checkpoint_escalations"),
    ("checkpoint_escalations_total",
     "Lifetime checkpoint deadline escalations (alert on nonzero)",
     "checkpoint_escalations_total"),
    ("checkpoint_completed_total",
     "Lifetime nodes that completed the checkpoint gate",
     "checkpoints_completed_total"),
    ("checkpoint_restores_verified_total",
     "Lifetime nodes whose checkpoints were verified restorable before "
     "uncordon",
     "checkpoint_restores_verified_total"),
    ("checkpoint_restore_escalations_total",
     "Lifetime restore-verification deadline expiries (workloads "
     "cold-started)",
     "checkpoint_restore_escalations_total"),
]

#: Every ``PassStats`` gauge, iterated by ``observe`` and ``render`` alike.
_ALL_PASS_GAUGES = _PASS_GAUGES + _CHECKPOINT_GAUGES


class UpgradeMetrics:
    """The state machine's gauges and its count of passes.

    :meth:`observe` each ``build_state`` snapshot (after its
    ``apply_state``, so the pass's ``PassStats`` is complete);
    :meth:`render` gives the Prometheus text that :class:`MetricsServer`
    serves."""

    def __init__(self, manager, device_label: Optional[str] = None) -> None:
        self._manager = manager
        self._device = device_label or manager.keys.device.name
        self._lock = threading.Lock()
        self._values: dict[str, "int | float"] = {}
        #: bucket label -> seconds of the last pass that ran a bucket,
        #: replaced only by a non-empty one, so a settled pool keeps
        #: exporting the last roll's timings under a stable label set.
        self._bucket_seconds: dict[str, float] = {}
        self._reconcile_passes = 0
        #: observe()'s entry tickets: values are computed outside the lock,
        #: so two observes may reach the commit in either order; a commit
        #: that lost to a later-entering observe is dropped
        #: (``itertools.count.__next__`` is atomic).
        self._ticket = itertools.count(1)
        self._committed = 0

    def observe(self, state) -> None:
        # The accessors walk the snapshot outside the lock, so a slow pass
        # never stalls a scrape; the lock guards the swap alone.
        ticket = next(self._ticket)
        values = {
            suffix: getattr(self._manager, accessor)(state)
            for suffix, _, accessor in _GAUGES
        }
        pass_stats = getattr(self._manager, "last_pass_stats", None)
        bucket_seconds: dict[str, float] = {}
        if pass_stats is not None:
            for suffix, _, attr in _ALL_PASS_GAUGES:
                raw = getattr(pass_stats, attr, 0)
                if isinstance(raw, bool):
                    values[suffix] = int(raw)
                elif isinstance(raw, float):
                    values[suffix] = round(raw, 6)
                else:
                    values[suffix] = raw
            bucket_seconds = {
                bucket: round(float(seconds), 6)
                for bucket, seconds in getattr(pass_stats, "bucket_seconds", {}).items()
            }
        with self._lock:
            self._reconcile_passes += 1
            if ticket > self._committed:
                self._committed = ticket
                self._values.update(values)
                if bucket_seconds:
                    self._bucket_seconds = bucket_seconds

    def render(self) -> str:
        label = prom_label("device", self._device)
        with self._lock:
            rows = [
                (suffix, "gauge", help_text, [(label, self._values.get(suffix, 0))])
                for suffix, help_text, _ in _GAUGES
            ]
            # The pass gauges once a pass recorded them: over a manager
            # without PassStats the text stays the five gauges and the count.
            rows.extend(
                (suffix, "gauge", help_text, [(label, self._values[suffix])])
                for suffix, help_text, _ in _ALL_PASS_GAUGES
                if suffix in self._values
            )
            if self._bucket_seconds:
                rows.append((
                    "pass_bucket_seconds", "gauge",
                    "Per-bucket apply wall seconds of the most recent "
                    "pass that ran any bucket (the gauge twin of the "
                    "pass span's bucket children; docs/tracing.md)",
                    [
                        (merge_label(label, "bucket", bucket), seconds)
                        for bucket, seconds in sorted(self._bucket_seconds.items())
                    ],
                ))
            rows.append((
                "reconcile_passes_total", "counter", "Reconcile passes observed",
                [(label, self._reconcile_passes)],
            ))
        return render_samples(_PREFIX, rows)


_WIRE_PREFIX = "tpu_operator_wire"


class WireMetrics:
    """The ``tpu_operator_wire_*`` family, the wire path's gauges and
    counters, served by :class:`MetricsServer` like every other collector:

    * **watch hub** (from ``WatchHub.stats()``): upstream streams,
      subscribers, frames upstream vs delivered and their ratio (the
      fan-out multiplier the hub exists to buy), per-subscriber buffer
      depths (max exported), stale self-resumes, per-scope subscriber
      gauges;
    * **APF** (from ``LocalApiServer.apf_stats()``): per-flow queue
      depth, admitted/shed totals (a shed IS a 429), high-water depth;
    * **relay** (from ``WatchRelay.stats()``, as ``relay=``) and its
      client half (``RelayWatchSource.stats()``, as ``relay_source=``):
      ``tpu_operator_wire_relay_*`` — live subscriber connections,
      shared streams per scope, upstream vs fanned-out bytes (the
      cross-process fan-out multiplier the relay exists to buy), and
      the fallback-to-direct count (each one is a window a subscriber
      rode the degraded path);
    * **loop stall watchdog** — pass either a
      ``kube.loopwatch.LoopStallWatchdog`` (its ``stats()`` shape) or a
      ``LocalApiServer`` directly (its ``loop_stall_stats()`` shape) as
      ``loop_watchdog=``: heartbeat-measured event-loop stalls over
      threshold and the worst observed stall. An API server with the
      watchdog off renders nothing (empty stats).

    All halves are optional and duck-typed (any object with the same
    ``stats()``/``apf_stats()`` shape works), so the collector can sit
    beside a client-only process (hub, no server) or a server-only one.
    """

    def __init__(
        self,
        hub=None,
        apiserver=None,
        loop_watchdog=None,
        relay=None,
        relay_source=None,
    ) -> None:
        self._hub = hub
        self._apiserver = apiserver
        self._loop_watchdog = loop_watchdog
        self._relay = relay
        self._relay_source = relay_source

    def render(self) -> str:
        out: list[str] = []
        if self._hub is not None:
            stats = self._hub.stats()
            depths = [
                depth
                for scope in stats["scopes"].values()
                for depth in scope["buffer_depths"]
            ]
            out.append(render_rows(_WIRE_PREFIX, "", [
                ("hub_upstream_streams", "gauge",
                 "Live upstream watch streams the hub multiplexes",
                 stats["upstream_streams"]),
                ("hub_subscribers", "gauge",
                 "Subscribers across all hub scopes",
                 stats["subscribers"]),
                ("hub_frames_upstream_total", "counter",
                 "Watch frames received on upstream streams",
                 stats["frames_upstream"]),
                ("hub_frames_delivered_total", "counter",
                 "Watch frames delivered to subscribers (fan-out)",
                 stats["frames_delivered"]),
                ("hub_fanout_ratio", "gauge",
                 "Frames delivered / frames received upstream",
                 stats["fanout_ratio"]),
                ("hub_subscriber_buffer_depth_max", "gauge",
                 "Deepest per-subscriber buffer right now",
                 max(depths) if depths else 0),
                ("hub_stale_resumes_total", "counter",
                 "Slow-subscriber buffer overflows healed by a journal "
                 "self-resume (no upstream re-LIST)",
                 stats["stale_resumes"]),
            ]))
            out.append(render_samples(_WIRE_PREFIX, [
                ("hub_scope_subscribers", "gauge",
                 "Subscribers per hub scope",
                 [
                     (prom_label("scope", scope_name), scope["subscribers"])
                     for scope_name, scope in sorted(
                         stats["scopes"].items()
                     )
                 ]),
            ]))
        if self._relay is not None:
            stats = self._relay.stats()
            out.append(render_rows(_WIRE_PREFIX, "", [
                ("relay_clients", "gauge",
                 "Live subscriber connections on the relay",
                 stats["clients_active"]),
                ("relay_streams_total", "counter",
                 "Watch streams the relay has served",
                 stats["streams_total"]),
                ("relay_streams_compact_total", "counter",
                 "Relay streams served with the compact codec (the "
                 "negotiated default on relay connections)",
                 stats["streams_compact"]),
                ("relay_upstream_bytes_total", "counter",
                 "Bytes received on the relay's shared upstream streams",
                 stats["upstream_bytes"]),
                ("relay_fanout_bytes_total", "counter",
                 "Bytes fanned out to relay subscribers (the "
                 "cross-process multiplier over upstream bytes)",
                 stats["bytes_fanned_out"]),
                ("relay_refused_requests_total", "counter",
                 "Non-watch requests refused with 400 (LISTs and "
                 "writes belong on the apiserver)",
                 stats["refused_requests"]),
            ]))
            out.append(render_samples(_WIRE_PREFIX, [
                ("relay_scope_streams", "gauge",
                 "Shared upstream streams per relay scope (the hard-1 "
                 "the fleet bench asserts per kind)",
                 [
                     (prom_label("scope", scope_name),
                      1 if scope["subscribers"] else 0)
                     for scope_name, scope in sorted(
                         stats["hub"].get("scopes", {}).items()
                     )
                 ]),
                ("relay_scope_subscribers", "gauge",
                 "Relay-side subscribers per scope",
                 [
                     (prom_label("scope", scope_name),
                      scope["subscribers"])
                     for scope_name, scope in sorted(
                         stats["hub"].get("scopes", {}).items()
                     )
                 ]),
            ]))
        if self._relay_source is not None:
            stats = self._relay_source.stats()
            out.append(render_rows(_WIRE_PREFIX, "", [
                ("relay_windows_total", "counter",
                 "Watch windows this process served through the relay",
                 stats["relay_windows"]),
                ("relay_direct_windows_total", "counter",
                 "Watch windows served DIRECT from the apiserver (the "
                 "degraded path while the relay is down)",
                 stats["direct_windows"]),
                ("relay_fallback_to_direct_total", "counter",
                 "Relay failures that opened a bounded direct-watch "
                 "fallback window",
                 stats["fallbacks_to_direct"]),
            ]))
        if self._apiserver is not None:
            flows = self._apiserver.apf_stats()
            labeled = [
                (prom_label("flow", flow), stats)
                for flow, stats in sorted(flows.items())
            ]
            out.append(render_samples(_WIRE_PREFIX, [
                ("apf_queue_depth", "gauge",
                 "Requests queued per priority-and-fairness flow",
                 [(label, s["queued"]) for label, s in labeled]),
                ("apf_queue_depth_max", "gauge",
                 "High-water queue depth per flow",
                 [(label, s["max_queued"]) for label, s in labeled]),
                ("apf_admitted_total", "counter",
                 "Requests dispatched per flow",
                 [(label, s["admitted_total"]) for label, s in labeled]),
                ("apf_shed_429_total", "counter",
                 "Requests shed as 429 + Retry-After per flow",
                 [(label, s["shed_429_total"]) for label, s in labeled]),
            ]))
        if self._loop_watchdog is not None:
            source = getattr(
                self._loop_watchdog, "loop_stall_stats", None
            ) or self._loop_watchdog.stats
            stats = source()
            if stats:
                out.append(render_rows(_WIRE_PREFIX, "", [
                    ("loop_stall_total", "counter",
                     "Event-loop heartbeat wakeups that arrived over the "
                     "stall threshold late (each one is a window in "
                     "which a callback held the loop)",
                     stats["stalls_over_threshold"]),
                    ("loop_stall_max_seconds", "gauge",
                     "Worst observed event-loop stall since the "
                     "watchdog started (heartbeat lateness, seconds)",
                     stats["max_stall_s"]),
                    ("loop_stall_threshold_seconds", "gauge",
                     "Configured stall threshold of the loop watchdog",
                     stats["threshold_s"]),
                ]))
        return "".join(out)
