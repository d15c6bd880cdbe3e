"""Prometheus text exposition, and a ``/metrics`` endpoint on the stdlib.

A subset of the JAX package's ``upgrade/metrics.py``: what the monitor's
``MonitorMetrics`` renders through and ``--metrics-port`` serves.
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


def render_rows(prefix: str, label: str, rows) -> str:
    """``rows`` of (suffix, kind, help text, value) as exposition lines,
    each under its HELP and TYPE header, with one label set."""
    out: list[str] = []
    for suffix, kind, help_text, value in rows:
        name = f"{prefix}_{suffix}"
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} {kind}")
        out.append(f"{name}{label} {value}")
    return "\n".join(out) + "\n"


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
