"""WatchRelay: the WatchHub's fan-out behind a listening socket.

The JAX package's ``kube/relay.py``. A :class:`~.watchhub.WatchHub`
collapses N subscribers onto one upstream watch, but only within one
process; fleet workers run as processes of their own, and each would pay
its own full set of watches again. The relay puts the hub's journal,
cursors and self-resume behind a socket that speaks the watch wire
protocol the API server speaks, so the worker processes of one host share
one upstream stream a (kind, scope).

The wire contract is the whole design: to the client a relay is one more
server. ``GET .../<plural>?watch=true&resourceVersion=N`` in, chunked
``encode_watch_frame`` events out, a ``410 Gone`` before the stream or an
``ERROR`` frame inside it when a cursor fell off the journal: the API
server's watch surface, so the client's ``WatchHandle`` and the
informer's resume need no fork. Every other request is refused with 400:
LISTs and writes go to the API server; the relay shares exactly the
streams that were duplicated. The plural of a path maps to its kind
through the resource registry (``kube/resources.py``).

Threads, not asyncio: the relay serves a bounded set of long-lived
streams (the worker processes of one host), and each stream is one
blocking ``hub.watch`` generator, so a thread a connection maps onto it
with no loop to stall.

Degradation: a dead relay never means silence. :class:`RelayWatchSource`,
the client side that workers plug into the informer's ``stream_source``
hook, watches through the relay while it answers and falls back to
direct upstream watches (resuming from the last delivered revision) for
a bounded window when it does not, then tries the relay again.
``WatchExpiredError`` is never swallowed: it is the protocol's signal to
re-list, and reaches the informer either way.

Encoding: the compact codec is the default on both hops: the relay's
upstream client asks for it, and the fan-out answers each subscriber's
``Accept`` (JSON where it asks for nothing else).

Frames pass with ``metadata.resourceVersion`` intact, so a delivery
through the relay still joins its write's trace.
"""

from __future__ import annotations

import re
import socket
import threading
import time
from typing import Any, Iterator, Mapping, Optional, Union
from urllib.parse import parse_qsl, urlsplit

from .client import ApiError, Client, WatchExpiredError
from .resources import resource_for_plural
from .rest import RestClient, RestConfig
from .watchhub import (
    DEFAULT_JOURNAL_WINDOW,
    WatchHub,
)
from .wire import (
    content_type_for,
    encode_body,
    encode_watch_frame,
    negotiate_encoding,
)
from ..utils.lifecycle import lifecycle_resource
from ..utils.log import get_logger

log = get_logger("kube.relay")

__all__ = ["WatchRelay", "RelayWatchSource"]

#: Seconds a RelayWatchSource stays on direct upstream watches after a
#: relay failure before probing the relay again — long enough to ride
#: out a relay restart, short enough that the shared-stream economics
#: return promptly.
DEFAULT_FALLBACK_WINDOW_S = 15.0

#: Upstream watch window the relay's hub uses. Longer than the client
#: default (300s): every rotation is one upstream re-subscribe per
#: scope, and the relay exists to keep upstream streams at exactly one
#: per (kind, scope) — including across its subscribers' own windows.
DEFAULT_UPSTREAM_WINDOW_S = 900.0

_MAX_REQUEST_LINE = 65536

#: The API server's path grammar (the JAX package's ``kube/apiserver.py``).
_PATH_RE = re.compile(
    r"^/(?:api|apis)(?:/(?P<group>[^/]+(?:\.[^/]+)*))?/(?P<version>v[^/]+)"
    r"(?:/namespaces/(?P<namespace>[^/]+))?"
    r"/(?P<plural>[^/]+)"
    r"(?:/(?P<name>[^/]+))?"
    r"(?:/(?P<subresource>status|eviction))?$"
)


def _read_http_request(
    rfile,
) -> Optional[tuple[str, str, dict[str, str]]]:
    """Blocking request parse off a socket file: (method, target,
    lower-cased headers), or None on clean EOF. Bodies are drained and
    discarded — every request the relay accepts is bodiless."""
    line = rfile.readline(_MAX_REQUEST_LINE)
    if not line:
        return None
    parts = line.decode("latin-1").strip().split()
    if len(parts) != 3:
        raise ValueError(f"malformed request line: {line[:80]!r}")
    method, target = parts[0].upper(), parts[1]
    headers: dict[str, str] = {}
    total = len(line)
    while True:
        raw = rfile.readline(_MAX_REQUEST_LINE)
        total += len(raw)
        if total > _MAX_REQUEST_LINE:
            raise ValueError("request headers too large")
        if raw in (b"\r\n", b"\n", b""):
            break
        name, _, value = raw.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    body_len = int(headers.get("content-length") or 0)
    if body_len:
        rfile.read(body_len)
    return method, target, headers


def _status_payload(code: int, reason: str, message: str) -> dict[str, Any]:
    # Same Status shape the LocalApiServer emits (_status_body) — the
    # client's _api_error path decodes both identically.
    return {
        "kind": "Status",
        "apiVersion": "v1",
        "metadata": {},
        "status": "Failure",
        "message": message,
        "reason": reason,
        "code": code,
    }


@lifecycle_resource(acquire="start", release="stop")
class WatchRelay:
    """One host's shared watch plane: a WatchHub serving the watch wire
    protocol on a local socket (``runtime/`` Component: name/start/
    stop/healthy — deploys under the supervision tree next to the
    worker processes it serves)."""

    def __init__(
        self,
        upstream: Union[Client, Any],
        port: int = 0,
        name: str = "watch-relay",
        journal_window: int = DEFAULT_JOURNAL_WINDOW,
        upstream_window_seconds: float = DEFAULT_UPSTREAM_WINDOW_S,
    ) -> None:
        self.name = name
        self._port = port
        self._journal_window = journal_window
        self._upstream_window_seconds = upstream_window_seconds
        #: Accepted either way: a ready Client, or a RestConfig the
        #: relay builds (and owns) its own upstream client from — with
        #: the compact encoding as the negotiated default, because the
        #: relay hop is exactly the loopback-free path where bytes are
        #: real money.
        self._owned_client: Optional[RestClient] = None
        if isinstance(upstream, RestConfig):
            if upstream.wire_encoding != "compact":
                import dataclasses

                # The caller's credential files stay the caller's: the
                # owned client's close() must not remove them.
                upstream = dataclasses.replace(
                    upstream, wire_encoding="compact", temp_files=[]
                )
            self._owned_client = RestClient(upstream)
            self._upstream: Client = self._owned_client
        else:
            self._upstream = upstream
        self._hub: Optional[WatchHub] = None
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._started = False
        # -- counters (tpu_operator_wire_relay_* gauges) ----------------
        self.clients_total = 0
        self.streams_total = 0
        #: Streams served with the compact codec (the negotiated
        #: default on relay connections);
        #: the difference from streams_total is the JSON fallback count.
        self.streams_compact = 0
        self.frames_fanned_out = 0
        self.bytes_fanned_out = 0
        self.refused_requests = 0

    # -- Component protocol -------------------------------------------------
    def start(self) -> "WatchRelay":
        if self._started:
            raise RuntimeError("relay already started")
        self._stopping.clear()
        self._hub = WatchHub(
            self._upstream,
            journal_window=self._journal_window,
            upstream_window_seconds=self._upstream_window_seconds,
        )
        listener = socket.create_server(("127.0.0.1", self._port))
        self._listener = listener
        self._port = listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"{self.name}-accept",
            daemon=True,
        )
        self._started = True
        self._accept_thread.start()
        log.info("relay %s listening on %s", self.name, self.url)
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """Idempotent drain: close the listener, tear every client
        connection, stop the hub (ending its upstream streams), close
        the owned upstream client."""
        if not self._started and self._hub is None:
            return
        self._stopping.set()
        self._started = False
        listener, self._listener = self._listener, None
        if listener is not None:
            # Closing a socket does not wake a thread blocked in its
            # accept(); shutting it down does, so the join below returns
            # at once instead of waiting out its timeout.
            try:
                listener.shutdown(socket.SHUT_RDWR)
            except OSError:  # pragma: no cover - not connected on some kernels
                pass
            try:
                listener.close()
            except OSError:  # pragma: no cover - close is best-effort
                pass
        self.kill_connections()
        thread, self._accept_thread = self._accept_thread, None
        if thread is not None:
            thread.join(timeout=timeout if timeout is not None else 5.0)
        if self._hub is not None:
            self._hub.stop()
            self._hub = None
        if self._owned_client is not None:
            self._owned_client.close()
            self._owned_client = None

    def healthy(self) -> bool:
        thread = self._accept_thread
        return bool(
            self._started and thread is not None and thread.is_alive()
        )

    # -- surface ------------------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._port}"

    @property
    def server_address(self) -> tuple[str, int]:
        return ("127.0.0.1", self._port)

    def kill_connections(self) -> int:
        """Abort every live subscriber connection (chaos ``relay_kill``
        fires this): subscribers observe a dead stream and either
        resume through the relay or degrade to direct watches."""
        with self._lock:
            victims = list(self._conns)
        for conn in victims:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:  # pragma: no cover - already dead
                pass
        return len(victims)

    def active_clients(self) -> int:
        with self._lock:
            return len(self._conns)

    def stats(self) -> dict[str, Any]:
        """Relay-side counters + the hub's own stats — what WireMetrics
        renders as the ``tpu_operator_wire_relay_*`` family."""
        hub = self._hub
        upstream_bytes = 0
        if self._owned_client is not None:
            upstream_bytes = int(
                self._owned_client.transport_stats()["bytes_received"]
            )
        return {
            "clients_active": self.active_clients(),
            "clients_total": self.clients_total,
            "streams_total": self.streams_total,
            "streams_compact": self.streams_compact,
            "frames_fanned_out": self.frames_fanned_out,
            "bytes_fanned_out": self.bytes_fanned_out,
            "refused_requests": self.refused_requests,
            "upstream_bytes": upstream_bytes,
            "hub": hub.stats() if hub is not None else {},
        }

    # -- accept / serve -----------------------------------------------------
    def _accept_loop(self) -> None:
        listener = self._listener
        while listener is not None and not self._stopping.is_set():
            try:
                conn, _addr = listener.accept()
            except OSError:
                break  # listener closed — the stop path
            with self._lock:
                if self._stopping.is_set():
                    try:
                        conn.close()
                    except OSError:  # pragma: no cover
                        pass
                    break
                self._conns.add(conn)
                self.clients_total += 1
            threading.Thread(
                target=self._serve_connection, args=(conn,),
                name=f"{self.name}-conn", daemon=True,
            ).start()

    def _serve_connection(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb")
        try:
            while not self._stopping.is_set():
                try:
                    req = _read_http_request(rfile)
                except (ValueError, OSError):
                    break
                if req is None:
                    break
                if not self._serve_request(conn, *req):
                    break
        finally:
            try:
                rfile.close()
            except OSError:  # pragma: no cover
                pass
            try:
                conn.close()
            except OSError:  # pragma: no cover
                pass
            with self._lock:
                self._conns.discard(conn)

    def _refuse(
        self,
        conn: socket.socket,
        code: int,
        reason: str,
        message: str,
        encoding: str,
        keep_alive: bool,
    ) -> bool:
        self.refused_requests += 1
        self._respond(
            conn, code, reason,
            encode_body(_status_payload(code, reason, message), encoding),
            content_type_for(encoding), keep_alive,
        )
        return keep_alive

    @staticmethod
    def _respond(
        conn: socket.socket,
        code: int,
        reason: str,
        body: bytes,
        content_type: str,
        keep_alive: bool,
    ) -> None:
        head = (
            f"HTTP/1.1 {code} {reason}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n"
            "\r\n"
        )
        conn.sendall(head.encode("latin-1") + body)

    def _serve_request(
        self,
        conn: socket.socket,
        method: str,
        target: str,
        headers: Mapping[str, str],
    ) -> bool:
        """Serve one request; returns False when the connection must
        close (protocol error, client gone, or Connection: close)."""
        keep_alive = headers.get("connection", "").lower() != "close"
        encoding = negotiate_encoding(headers.get("accept"))
        split = urlsplit(target)
        query = dict(parse_qsl(split.query))
        if method != "GET" or query.get("watch") != "true":
            return self._refuse(
                conn, 400, "Bad Request",
                "the relay serves watch streams only; send LISTs and "
                "writes to the apiserver",
                encoding, keep_alive,
            )
        match = _PATH_RE.match(split.path)
        if not match:
            return self._refuse(
                conn, 404, "Not Found", f"no route for {split.path}",
                encoding, keep_alive,
            )
        try:
            info = resource_for_plural(
                match.group("group") or "", match.group("plural")
            )
        except KeyError:
            return self._refuse(
                conn, 404, "Not Found",
                f"unknown resource {match.group('plural')!r}",
                encoding, keep_alive,
            )
        return self._stream_watch(
            conn,
            kind=info.kind,
            namespace=match.group("namespace") or "",
            query=query,
            encoding=encoding,
            keep_alive=keep_alive,
        )

    def _stream_watch(
        self,
        conn: socket.socket,
        kind: str,
        namespace: str,
        query: Mapping[str, str],
        encoding: str,
        keep_alive: bool,
    ) -> bool:
        hub = self._hub
        if hub is None:  # stopping raced the request
            return False
        timeout_s: Optional[float] = None
        if query.get("timeoutSeconds"):
            timeout_s = float(query["timeoutSeconds"])
        self.streams_total += 1
        if encoding == "compact":
            self.streams_compact += 1
        try:
            # Subscribed before the answer: a cursor the hub cannot vouch
            # for is a plain 410 (the client raises it from the response).
            stream = hub.open(
                kind,
                namespace=namespace,
                label_selector=query.get("labelSelector") or None,
                field_selector=query.get("fieldSelector") or None,
                timeout_seconds=timeout_s,
                resource_version=query.get("resourceVersion") or None,
                allow_bookmarks=query.get("allowWatchBookmarks") == "true",
            )
        except WatchExpiredError as e:
            return self._refuse(
                conn, 410, "Gone", str(e) or "watch expired", encoding, keep_alive,
            )
        content_type = content_type_for(encoding)
        head = (
            "HTTP/1.1 200 OK\r\n"
            f"Content-Type: {content_type}\r\n"
            "Transfer-Encoding: chunked\r\n"
            "\r\n"
        ).encode("latin-1")
        try:
            # The head goes out now, not with the first frame: a scope
            # with nothing to send (and a server that sends no bookmarks)
            # would otherwise keep the subscriber waiting for the answer
            # past its read timeout, which it takes for a dead relay.
            conn.sendall(head)
            try:
                for event_type, obj in stream:
                    frame = encode_watch_frame(
                        {"type": event_type, "object": obj.raw}, encoding
                    )
                    chunk = b"%x\r\n" % len(frame) + frame + b"\r\n"
                    conn.sendall(chunk)
                    self.frames_fanned_out += 1
                    self.bytes_fanned_out += len(chunk)
            except WatchExpiredError as e:
                # Mid-stream: the in-band ERROR frame, which the client
                # raises as WatchExpiredError, the informer's signal to
                # re-list.
                frame = encode_watch_frame(
                    {
                        "type": "ERROR",
                        "object": _status_payload(
                            410, "Expired", str(e) or "watch expired"
                        ),
                    },
                    encoding,
                )
                conn.sendall(
                    b"%x\r\n" % len(frame) + frame + b"\r\n0\r\n\r\n"
                )
                return keep_alive
            # Clean window end: terminal chunk; the subscriber
            # re-subscribes from its cursor on the same connection.
            conn.sendall(b"0\r\n\r\n")
            self.bytes_fanned_out += 5
            return keep_alive
        except OSError:
            return False  # subscriber went away mid-stream
        finally:
            stream.close()


class RelayWatchSource:
    """Client-side facade: ``Client.watch``-shaped, so it plugs into
    ``FleetWorkerConfig.watch_hub`` / the informer ``stream_source``
    hook unchanged. Watches via the relay while it answers; on relay
    failure, falls back to DIRECT upstream watches — resuming from the
    last delivered revision, so no events are replayed or lost — for
    ``fallback_window_s``, then probes the relay again. Bounded
    degradation, never silence (chaos point ``relay_kill``)."""

    def __init__(
        self,
        relay_url: str,
        direct: Client,
        fallback_window_s: float = DEFAULT_FALLBACK_WINDOW_S,
        mono=time.monotonic,
    ) -> None:
        self._relay_client: Client = RestClient(
            RestConfig(server=relay_url, wire_encoding="compact")
        )
        self._direct = direct
        self._fallback_window_s = fallback_window_s
        self._mono = mono
        self._fallback_until = 0.0
        self._lock = threading.Lock()
        # -- counters (tpu_operator_wire_relay_* client half) -----------
        self.relay_windows = 0
        self.direct_windows = 0
        self.fallbacks_to_direct = 0
        self.frames_via_relay = 0

    def close(self) -> None:
        self._relay_client.close()

    def stats(self) -> dict[str, int]:
        return {
            "relay_windows": self.relay_windows,
            "direct_windows": self.direct_windows,
            "fallbacks_to_direct": self.fallbacks_to_direct,
            "frames_via_relay": self.frames_via_relay,
        }

    def _relay_usable(self) -> bool:
        with self._lock:
            return self._mono() >= self._fallback_until

    def _note_relay_failure(self, error: BaseException) -> None:
        with self._lock:
            self.fallbacks_to_direct += 1
            self._fallback_until = self._mono() + self._fallback_window_s
        log.warning(
            "relay watch failed (%s); direct upstream for %.0fs",
            error, self._fallback_window_s,
        )

    def watch(
        self,
        kind: str,
        namespace: str = "",
        label_selector=None,
        field_selector=None,
        timeout_seconds: Optional[float] = None,
        resource_version: Optional[str] = None,
        handle=None,
        allow_bookmarks: bool = False,
    ) -> Iterator[tuple[str, Any]]:
        kwargs: dict[str, Any] = dict(
            namespace=namespace,
            label_selector=label_selector,
            field_selector=field_selector,
            timeout_seconds=timeout_seconds,
            handle=handle,
            allow_bookmarks=allow_bookmarks,
        )
        last_rv = resource_version
        if self._relay_usable():
            gen = self._relay_client.watch(
                kind, resource_version=last_rv, **kwargs
            )
            while True:
                try:
                    event_type, obj = next(gen)
                except StopIteration:
                    self.relay_windows += 1
                    return  # clean window end
                except WatchExpiredError:
                    # The protocol's re-list signal — NOT a relay
                    # failure; the informer must see it either way.
                    raise
                except (ApiError, OSError, RuntimeError) as e:
                    self._note_relay_failure(e)
                    break  # degrade to direct below, from last_rv
                yield event_type, obj
                self.frames_via_relay += 1
                rv = (obj.raw.get("metadata") or {}).get(
                    "resourceVersion"
                )
                if rv is not None:
                    last_rv = str(rv)
        self.direct_windows += 1
        yield from self._direct.watch(
            kind, resource_version=last_rv, **kwargs
        )
