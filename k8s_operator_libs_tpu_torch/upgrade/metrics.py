"""Prometheus text exposition, and a ``/metrics`` endpoint on the stdlib.

A subset of the JAX package's ``upgrade/metrics.py``: the emitter the
monitor's ``MonitorMetrics`` and the health source's ``HealthMetrics`` and
``LinkMetrics`` render through, its histogram, and the server
``--metrics-port`` starts. The state machine's own families
(``UpgradeMetrics``, ``WireMetrics``) wait for ROADMAP A15.
"""

from __future__ import annotations

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
