"""A Kubernetes API client on the standard library: the JAX package's
``kube/rest.py`` transport behind the port's own surface.

:meth:`RestClient.from_environment` takes the in-cluster service account
first (its token and CA under ``/var/run/secrets/kubernetes.io/
serviceaccount``, the API server from ``KUBERNETES_SERVICE_HOST`` and
``_PORT``), else ``$KUBECONFIG`` (or ``~/.kube/config``). A kubeconfig is
read as JSON, which kubectl also accepts; a YAML one needs PyYAML, and
the error says so where it is missing.

The transport is an asyncio HTTP/1.1 stack behind the sync client; the
caller never sees the event loop, one daemon thread for every client of
the process (``_get_wire_loop``):

* **keep-alive pool**: connections are pooled and reused across requests
  and watch windows (a window that ends cleanly gives its connection
  back), so a reconcile pass pays no TCP or TLS set-up in steady state. A
  request that fails on a stale pooled connection is retried once on a
  fresh one: at the send for any verb, at the read for any verb but POST
  (a create may have been done);
* **pipelining**: ``request_many`` writes a batch of requests before it
  reads the first response, so ``prime_list_cache`` (the informers'
  seed) and ``patch_many`` (the write batcher's slots) cost one round
  trip a batch; any hiccup on the stream falls back to one request after
  another;
* **negotiated encoding**: with ``RestConfig.wire_encoding="compact"``
  (the default from a kubeconfig and in a cluster) ``Accept`` lists the
  compact encoding (``kube/wire.py``) before JSON; write bodies switch to
  compact only once the server has answered compact, so a JSON-only
  server never receives a body it cannot read;
* **read replicas**: ``RestConfig.read_servers`` serve GETs and watch
  windows round robin; a replica that fails a request is set aside for a
  few seconds and the request is made again on the primary
  (``read_failovers``);
* **shed retries**: a 429 is retried after its ``Retry-After`` (capped)
  up to ``too_many_requests_retries`` times before it is raised.

The operations are those of the operator's client: ``get``,
``get_or_none``, ``list`` and ``list_with_revision`` (label and field
selectors, paged with ``limit``/``continue``; the latter also returns the
collection's resourceVersion), ``list_delta`` (the changes since a
revision), ``prime_list_cache``, ``watch`` (a bounded stream of watch
events, resumable from a revision and cancelled through a
:class:`WatchHandle`), ``create``, ``update``, ``update_status``,
``apply`` (server-side apply), ``patch``, ``patch_many``, ``delete``,
``delete_collection`` and ``evict`` (the pod's eviction subresource), on
the kinds of the resource registry (``kube/resources.py``); and ``discover``, the API's discovery
document of one group/version. Objects come back as the views of
``kube/objects.py``. An API error is raised with the API's
``Status.reason`` (and its HTTP ``code``), as the classes of
``kube/client.py`` where it is one of theirs, so ``has_reason`` and
``retry_on_conflict`` read it.

With a tracer installed (``utils/tracing.py``) every request made under a
span, a watch's and each pipelined one's included, carries its
``traceparent`` header, so the server's span joins the caller's trace.
Each call of ``_request`` is one ``http.request`` span (category
``wire``, with ``method``, ``path`` and the response's ``status``); each
shed retry is an ``http.attempt`` child, and each wait on a
``Retry-After`` an ``http.backoff`` (category ``queue``); a pipelined
batch of patches is one ``http.request_many`` span.
"""

from __future__ import annotations

import asyncio
import atexit
import base64
import concurrent.futures
import json
import os
import queue as queue_mod
import ssl
import tempfile
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Optional, Sequence

from .client import (
    AlreadyExistsError,
    ApiError,
    BadRequestError,
    ConflictError,
    InvalidError,
    ListDelta,
    NotFoundError,
    TooManyRequestsError,
    UnsupportedMediaTypeError,
    WatchExpiredError,
)
from .objects import KubeObject, wrap
from .resources import resource_for_kind
from .wire import (
    CLIENT_ACCEPT_COMPACT,
    COMPACT_CONTENT_TYPE,
    JSON_CONTENT_TYPE,
    FrameDecoder,
    decode_body,
    encode_compact,
    is_compact_content_type,
)
from ..utils import tracing

#: Where a pod's service-account credentials are mounted.
SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

_ERRORS_BY_REASON = {
    cls.reason: cls
    for cls in (
        NotFoundError, AlreadyExistsError, ConflictError, BadRequestError,
        InvalidError, TooManyRequestsError, WatchExpiredError,
        UnsupportedMediaTypeError,
    )
}
_ERRORS_BY_CODE = {
    400: BadRequestError,
    404: NotFoundError,
    409: ConflictError,
    410: WatchExpiredError,
    415: UnsupportedMediaTypeError,
    422: InvalidError,
    429: TooManyRequestsError,
}

#: The stream bound of a watch called without ``timeout_seconds``. An
#: unbounded watch would need an unbounded socket read, which parks on a
#: half-open connection for ever; bounded windows resumed from the last
#: revision are the shape client-go's reflector takes for the same reason.
DEFAULT_WATCH_TIMEOUT_SECONDS = 300

#: How long a read replica stays out of the rotation after a failed
#: request: a restarted replica rejoins within a Lease period, and while
#: it is down a read costs one extra attempt at most.
_READ_DOWN_SECONDS = 5.0

_PATCH_TYPES = {
    "merge": "application/merge-patch+json",
    "strategic": "application/strategic-merge-patch+json",
    "json": "application/json-patch+json",
}


class RestConfigError(Exception):
    """No usable credentials were found."""


class WatchHandle:
    """Cancels a streaming watch from another thread. The consumer waits
    on the stream's frames, which no flag can interrupt, so ``cancel()``
    aborts the stream's connection on the wire loop, which ends the
    pending read and the generator. ``_sock`` is the stream's socket once
    the watch is established (the sign that the watch is live)."""

    def __init__(self) -> None:
        self._sock = None
        self._cancel_cb = None
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True
        cb = self._cancel_cb
        if cb is not None:
            try:
                cb()
            except RuntimeError:
                pass  # the wire loop is closed: the stream died with it


def _load_kubeconfig(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text) or {}
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError:
        raise RestConfigError(
            f"{path} is not JSON and PyYAML is not installed to read it as YAML; "
            "write the kubeconfig as JSON (kubectl reads both)"
        ) from None
    return yaml.safe_load(text) or {}


def _named(doc: dict, section: str, name: str) -> Optional[dict]:
    for entry in doc.get(section) or []:
        if entry.get("name") == name:
            return entry.get(section[:-1]) or {}
    return None


def _remove(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


@dataclass
class RestConfig:
    """Where the API server is, how to authenticate to it, and how to
    talk to it."""

    server: str
    token: str = ""
    ca_file: str = ""
    ca_data: str = ""
    insecure_skip_tls_verify: bool = False
    client_cert_file: str = ""
    client_key_file: str = ""
    namespace: str = "default"
    #: Files this config wrote (client certificates given inline).
    temp_files: list[str] = field(default_factory=list)
    #: Page size of a paged list (client-go's pager's 500); 0 asks for
    #: everything in one response.
    list_page_size: int = 500
    #: The encoding asked for in ``Accept``: ``"json"`` or ``"compact"``
    #: (``kube/wire.py``). A server that speaks only JSON answers JSON;
    #: write bodies switch to compact only after a compact response.
    wire_encoding: str = "json"
    #: Read-replica URLs: GETs and watch windows go round robin over the
    #: healthy ones, writes always to ``server``; a failed read sets its
    #: replica aside and is made again on ``server``. They share the
    #: primary's TLS material.
    read_servers: tuple = ()
    #: How many times a request shed with 429 is retried after the
    #: server's ``Retry-After`` before ``TooManyRequestsError`` is raised.
    too_many_requests_retries: int = 2
    #: The longest one ``Retry-After`` wait, whatever the server says.
    retry_after_cap_s: float = 5.0

    def close(self) -> None:
        """Remove the credential files the config wrote."""
        while self.temp_files:
            _remove(self.temp_files.pop())

    @classmethod
    def in_cluster(cls, sa_dir: str = SERVICE_ACCOUNT_DIR) -> "RestConfig":
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        token_path = os.path.join(sa_dir, "token")
        if not host or not os.path.exists(token_path):
            raise RestConfigError("not running in a cluster")
        with open(token_path) as f:
            token = f.read().strip()
        namespace = "default"
        ns_path = os.path.join(sa_dir, "namespace")
        if os.path.exists(ns_path):
            with open(ns_path) as f:
                namespace = f.read().strip() or "default"
        if ":" in host and not host.startswith("["):
            host = f"[{host}]"  # an IPv6 address
        return cls(
            server=f"https://{host}:{port}",
            token=token,
            ca_file=os.path.join(sa_dir, "ca.crt"),
            namespace=namespace,
            # A pod to its API server is a real network hop: compact
            # first, JSON where the server speaks only that.
            wire_encoding="compact",
        )

    @classmethod
    def from_kubeconfig(cls, path: str = "", context: str = "") -> "RestConfig":
        if not path:
            env = os.environ.get("KUBECONFIG", "")
            paths = [p for p in env.split(os.pathsep) if p] or [
                os.path.expanduser("~/.kube/config")
            ]
            path = next((p for p in paths if os.path.exists(p)), "")
            if not path:
                raise RestConfigError(f"kubeconfig not found at {os.pathsep.join(paths)}")
        doc = _load_kubeconfig(path)
        ctx_name = context or doc.get("current-context", "")
        ctx = _named(doc, "contexts", ctx_name)
        if ctx is None:
            raise RestConfigError(f"context {ctx_name!r} not found in {path}")
        cluster = _named(doc, "clusters", ctx.get("cluster", ""))
        if cluster is None:
            raise RestConfigError(f"cluster for context {ctx_name!r} not found in {path}")
        user = _named(doc, "users", ctx.get("user", "")) or {}
        if user.get("exec") or user.get("auth-provider"):
            raise RestConfigError(
                "exec/auth-provider credential plugins are not supported; "
                "use a token or client certificates"
            )
        cfg = cls(
            server=cluster.get("server", ""),
            token=user.get("token", ""),
            ca_file=cluster.get("certificate-authority", ""),
            insecure_skip_tls_verify=bool(cluster.get("insecure-skip-tls-verify", False)),
            client_cert_file=user.get("client-certificate", ""),
            client_key_file=user.get("client-key", ""),
            namespace=ctx.get("namespace", "default"),
            wire_encoding="compact",
        )
        if not cfg.server:
            raise RestConfigError(f"the cluster in {path} has no server")
        if cluster.get("certificate-authority-data"):
            cfg.ca_data = base64.b64decode(cluster["certificate-authority-data"]).decode()
        for key, attr in (("client-certificate-data", "client_cert_file"),
                          ("client-key-data", "client_key_file")):
            if user.get(key):
                setattr(cfg, attr, cfg._temp_pem(base64.b64decode(user[key])))
        return cfg

    @classmethod
    def from_environment(cls, sa_dir: str = SERVICE_ACCOUNT_DIR) -> "RestConfig":
        """In-cluster if the service account is mounted, else kubeconfig."""
        errors = []
        for build in (lambda: cls.in_cluster(sa_dir), cls.from_kubeconfig):
            try:
                return build()
            except RestConfigError as e:
                errors.append(str(e))
        raise RestConfigError("; ".join(errors))

    def _temp_pem(self, pem: bytes) -> str:
        fd, path = tempfile.mkstemp(prefix="kubecfg-", suffix=".pem")
        with os.fdopen(fd, "wb") as f:
            f.write(pem)
        self.temp_files.append(path)
        atexit.register(_remove, path)
        return path

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        if not self.server.startswith("https"):
            return None
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        if self.insecure_skip_tls_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        elif self.ca_file or self.ca_data:
            ctx.load_verify_locations(cafile=self.ca_file or None, cadata=self.ca_data or None)
        else:
            ctx.load_default_certs()
        if self.client_cert_file:
            ctx.load_cert_chain(self.client_cert_file, self.client_key_file or None)
        return ctx


def _retry_after_seconds(headers: Mapping[str, str], cap_s: float) -> float:
    """The server's ``Retry-After`` in seconds, clamped to [0, cap] (the
    delta-seconds form; anything else reads as 1 s)."""
    try:
        value = float(headers.get("retry-after", ""))
    except (TypeError, ValueError):
        value = 1.0
    return max(0.0, min(value, cap_s))


def _api_error(code: int, body: bytes, content_type: Optional[str] = None) -> ApiError:
    """The API error of a response: its class by the ``Status.reason``
    (else by the HTTP code), with ``code`` set and an unknown reason
    kept."""
    status: Any = {}
    try:
        status = decode_body(body or b"{}", content_type)
    except ValueError:  # not JSON, nor compact (WireDecodeError is one)
        pass
    if not isinstance(status, dict):
        status = {}
    reason = status.get("reason") or ""
    message = status.get("message") or body.decode(errors="replace")[:500] or f"HTTP {code}"
    cls = _ERRORS_BY_REASON.get(reason) or _ERRORS_BY_CODE.get(code)
    error = cls(message) if cls is not None else ApiError(message)
    if cls is None and reason:
        error.reason = reason
    error.code = code
    return error


class _TransportError(Exception):
    """A failure of the connection (an ``ApiError`` at the client)."""


_wire_loop_lock = threading.Lock()
_wire_loop: Optional[asyncio.AbstractEventLoop] = None


def _get_wire_loop() -> asyncio.AbstractEventLoop:
    """The client side's event loop: one daemon thread for every
    RestClient of the process. The loop only moves bytes; nothing
    CPU-bound runs on it."""
    global _wire_loop
    with _wire_loop_lock:
        if _wire_loop is None or _wire_loop.is_closed():
            loop = asyncio.new_event_loop()
            thread = threading.Thread(
                target=loop.run_forever, name="kube-wire-client", daemon=True
            )
            thread.start()
            _wire_loop = loop
        return _wire_loop


class _Conn:
    """One pooled connection (asyncio streams and its reuse mark)."""

    __slots__ = ("reader", "writer", "reused")

    def __init__(self, reader, writer) -> None:
        self.reader = reader
        self.writer = writer
        self.reused = False

    def abort(self) -> None:
        transport = self.writer.transport
        if transport is not None:
            transport.abort()


async def _read_headers(reader) -> tuple[int, dict[str, str]]:
    line = await reader.readline()
    if not line:
        raise _TransportError("connection closed before response")
    parts = line.decode("latin-1").split(" ", 2)
    if len(parts) < 2 or not parts[0].startswith("HTTP/"):
        raise _TransportError(f"malformed status line {line!r}")
    status = int(parts[1])
    headers: dict[str, str] = {}
    while True:
        line = await reader.readline()
        if not line:
            raise _TransportError("connection closed in response headers")
        if line in (b"\r\n", b"\n"):
            if status == 100:
                # An interim "100 Continue": the real response follows.
                return await _read_headers(reader)
            return status, headers
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()


async def _read_chunk(reader) -> bytes:
    """One chunk of a chunked body; b"" at the terminal chunk."""
    size_line = await reader.readline()
    if not size_line:
        raise _TransportError("connection closed mid-stream")
    try:
        size = int(size_line.strip().split(b";")[0], 16)
    except ValueError:
        raise _TransportError(f"bad chunk size {size_line!r}") from None
    if size == 0:
        await reader.readline()  # the CRLF that ends the terminal chunk
        return b""
    data = await reader.readexactly(size)
    await reader.readexactly(2)  # the chunk's CRLF
    return data


def _keeps_alive(headers: dict[str, str]) -> bool:
    return headers.get("connection", "").lower() != "close"


async def _read_body(reader, headers: dict[str, str]) -> tuple[bytes, bool]:
    """A buffered response body, and whether its connection may be reused."""
    if "chunked" in headers.get("transfer-encoding", "").lower():
        parts = []
        while True:
            chunk = await _read_chunk(reader)
            if not chunk:
                break
            parts.append(chunk)
        return b"".join(parts), _keeps_alive(headers)
    if "content-length" in headers:
        body = await reader.readexactly(int(headers["content-length"]))
        return body, _keeps_alive(headers)
    # Delimited by the end of the connection, which dies with the body.
    return await reader.read(), False


class _Transport:
    """A keep-alive connection pool and the request, pipeline and stream
    primitives, all on the shared wire loop. One per server a client
    talks to."""

    def __init__(
        self,
        host: str,
        port: int,
        ssl_ctx: Optional[ssl.SSLContext],
        server_hostname: Optional[str],
        timeout: float,
    ) -> None:
        self._host = host
        self._port = port
        self._ssl = ssl_ctx
        self._server_hostname = server_hostname
        self._timeout = timeout
        self._idle: list[_Conn] = []  # the loop thread's only
        self.closed = False
        # Counters: written on the loop thread, read anywhere (an int
        # read is atomic under the GIL).
        self.connections_opened = 0
        self.requests_sent = 0
        self.pipelined_batches = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self.watch_frames_received = 0

    # -- the pool (every method below runs on the wire loop) -----------------
    async def _acquire(self) -> _Conn:
        while self._idle:
            conn = self._idle.pop()
            if not conn.reader.at_eof():
                conn.reused = True
                return conn
            conn.abort()
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(
                self._host, self._port, ssl=self._ssl,
                server_hostname=self._server_hostname,
            ),
            self._timeout,
        )
        self.connections_opened += 1
        return _Conn(reader, writer)

    def _release(self, conn: _Conn) -> None:
        """Return a connection to the idle pool. Runs on the wire loop
        only: the pool is the loop's state."""
        if self.closed:
            conn.abort()
        else:
            self._idle.append(conn)

    def _discard(self, conn: _Conn) -> None:
        """Abort a connection instead of pooling it. Runs on the wire
        loop only, like every pool method."""
        conn.abort()

    async def close(self) -> None:
        self.closed = True
        while self._idle:
            self._idle.pop().abort()

    def _request_bytes(
        self, method: str, target: str, headers: Mapping[str, str],
        body: Optional[bytes],
    ) -> bytes:
        lines = [f"{method} {target} HTTP/1.1", f"Host: {self._host}:{self._port}"]
        for name, value in headers.items():
            lines.append(f"{name}: {value}")
        if body is not None:
            lines.append(f"Content-Length: {len(body)}")
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        return head + (body or b"")

    async def request(
        self, method: str, target: str, headers: Mapping[str, str],
        body: Optional[bytes],
    ) -> tuple[int, dict[str, str], bytes]:
        """One request and its response on a pooled connection, with the
        stale keep-alive retry: a failure at the send is retried once on
        a fresh connection for any verb (nothing reached the server), one
        at the read only for a verb other than POST (a create may have
        been done)."""
        data = self._request_bytes(method, target, headers, body)
        for attempt in (0, 1):
            try:
                conn = await self._acquire()
            except (OSError, asyncio.TimeoutError) as e:
                # Refused, unreachable, a failed TLS handshake: an API
                # error like any other failure of the transport.
                if attempt == 0:
                    continue
                raise _TransportError(str(e) or type(e).__name__) from None
            try:
                conn.writer.write(data)
                await asyncio.wait_for(conn.writer.drain(), self._timeout)
            except (OSError, asyncio.TimeoutError) as e:
                self._discard(conn)
                if attempt == 0:
                    continue
                raise _TransportError(str(e) or type(e).__name__) from None
            self.requests_sent += 1
            self.bytes_sent += len(data)
            try:
                status, rheaders = await asyncio.wait_for(
                    _read_headers(conn.reader), self._timeout
                )
                payload, reusable = await asyncio.wait_for(
                    _read_body(conn.reader, rheaders), self._timeout
                )
            except (
                OSError, asyncio.TimeoutError,
                asyncio.IncompleteReadError, _TransportError,
            ) as e:
                self._discard(conn)
                if attempt == 0 and method != "POST":
                    continue
                raise _TransportError(str(e) or type(e).__name__) from None
            self.bytes_received += len(payload)
            if reusable:
                self._release(conn)
            else:
                self._discard(conn)
            return status, rheaders, payload
        raise AssertionError("unreachable")  # pragma: no cover

    async def request_many(
        self, requests: list[tuple[str, str, Mapping[str, str], Optional[bytes]]],
    ) -> list[tuple[int, dict[str, str], bytes]]:
        """HTTP/1.1 pipelining: write every request on one connection
        before reading the first response, then read the responses in
        order, so a batch costs one round trip. Any hiccup on the stream
        falls back to one request after another: pipelining is a saving,
        never a condition of a right answer."""
        if not requests:
            return []
        conn = None
        try:
            conn = await self._acquire()
            blob = b"".join(self._request_bytes(m, t, h, b) for m, t, h, b in requests)
            conn.writer.write(blob)
            await asyncio.wait_for(conn.writer.drain(), self._timeout)
            self.bytes_sent += len(blob)
            out = []
            reusable = True
            for _ in requests:
                status, rheaders = await asyncio.wait_for(
                    _read_headers(conn.reader), self._timeout
                )
                payload, this_reusable = await asyncio.wait_for(
                    _read_body(conn.reader, rheaders), self._timeout
                )
                self.requests_sent += 1
                self.bytes_received += len(payload)
                out.append((status, rheaders, payload))
                reusable = reusable and this_reusable
            self.pipelined_batches += 1
            if reusable:
                self._release(conn)
            else:
                self._discard(conn)
            return out
        except (
            OSError, asyncio.TimeoutError,
            asyncio.IncompleteReadError, _TransportError,
        ):
            if conn is not None:
                self._discard(conn)
            # One after another: a close in the middle of the pipeline (a
            # proxy that answers Connection: close) must not fail the batch.
            return [await self.request(m, t, h, b) for m, t, h, b in requests]

    async def watch_pump(
        self,
        target: str,
        headers: Mapping[str, str],
        out: "queue_mod.Queue",
        handle: Optional[WatchHandle],
        read_timeout: float,
    ) -> None:
        """Drive one watch stream: establish it, then put its decoded
        frames into ``out`` as ``(kind, payload)``: ``("event", dict)``,
        ``("httperror", (status, content_type, body))``, ``("error",
        exc)``, ``("end", None)``. Always ends the queue. A window that
        ends cleanly (the terminal chunk) gives its connection back to
        the pool: the next window rides the same socket."""
        loop = asyncio.get_running_loop()
        conn = None
        try:
            conn = await self._acquire()
            if handle is not None:
                this_conn = conn

                def _abort() -> None:
                    loop.call_soon_threadsafe(this_conn.abort)

                handle._cancel_cb = _abort
                if handle.cancelled:
                    # cancel() ran before there was a connection to abort.
                    handle._cancel_cb = None
                    self._discard(conn)
                    out.put_nowait(("end", None))
                    return
            data = self._request_bytes("GET", target, headers, None)
            conn.writer.write(data)
            await asyncio.wait_for(conn.writer.drain(), self._timeout)
            self.requests_sent += 1
            self.bytes_sent += len(data)
            status, rheaders = await asyncio.wait_for(
                _read_headers(conn.reader), self._timeout
            )
            if status >= 400:
                payload, reusable = await asyncio.wait_for(
                    _read_body(conn.reader, rheaders), self._timeout
                )
                self.bytes_received += len(payload)
                if handle is not None:
                    handle._cancel_cb = None  # the handle owns it no more
                if reusable:
                    self._release(conn)
                else:
                    self._discard(conn)
                conn = None
                out.put_nowait(("httperror", (status, rheaders.get("content-type"), payload)))
                return
            if handle is not None:
                handle._sock = conn.writer.get_extra_info("socket")
                if handle.cancelled:
                    handle._cancel_cb = None
                    self._discard(conn)
                    conn = None
                    out.put_nowait(("end", None))
                    return
            decoder = FrameDecoder(rheaders.get("content-type"))
            chunked = "chunked" in rheaders.get("transfer-encoding", "").lower()
            while True:
                if chunked:
                    piece = await asyncio.wait_for(_read_chunk(conn.reader), read_timeout)
                    if piece == b"":
                        # A clean window end: the connection goes back to
                        # the pool. The handle's cancel hook is detached
                        # first: a late cancel() (an informer stopping
                        # between windows) must never abort a connection
                        # this stream no longer owns.
                        if handle is not None:
                            handle._cancel_cb = None
                        if _keeps_alive(rheaders):
                            self._release(conn)
                        else:
                            self._discard(conn)
                        conn = None
                        break
                else:
                    # Delimited by the end of the connection, which dies
                    # with the stream.
                    piece = await asyncio.wait_for(conn.reader.read(65536), read_timeout)
                    if not piece:
                        if handle is not None:
                            handle._cancel_cb = None
                        self._discard(conn)
                        conn = None
                        break
                self.bytes_received += len(piece)
                for event in decoder.feed(piece):
                    self.watch_frames_received += 1
                    out.put_nowait(("event", event))
            out.put_nowait(("end", None))
        except asyncio.CancelledError:
            if conn is not None:
                self._discard(conn)
            out.put_nowait(("end", None))
            raise
        except (
            OSError, asyncio.TimeoutError,
            asyncio.IncompleteReadError, _TransportError,
        ) as e:
            if conn is not None:
                self._discard(conn)
            if handle is not None and handle.cancelled:
                out.put_nowait(("end", None))
            else:
                out.put_nowait(("error", _TransportError(str(e) or type(e).__name__)))
        except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
            if conn is not None:
                self._discard(conn)
            out.put_nowait(("error", e))


class RestClient:
    """The operator's client operations over HTTP (see the module doc).
    One client a cluster; its connections are pooled."""

    def __init__(self, config: RestConfig, timeout: float = 30.0) -> None:
        self.config = config
        self.timeout = timeout
        self._ssl = config.ssl_context()
        parsed = urllib.parse.urlsplit(config.server)
        if not parsed.hostname:
            raise RestConfigError(f"invalid server URL {config.server!r}")
        https = parsed.scheme == "https"
        self._base_path = parsed.path.rstrip("/")
        self._transport = _Transport(
            parsed.hostname, parsed.port or (443 if https else 80), self._ssl,
            parsed.hostname if https else None, timeout,
        )
        #: The read replicas' transports, each ``[transport,
        #: down_until_monotonic]``.
        self._read_transports: list[list] = []
        for read_server in config.read_servers:
            rparsed = urllib.parse.urlsplit(read_server)
            if not rparsed.hostname:
                raise RestConfigError(f"invalid read server URL {read_server!r}")
            rhttps = rparsed.scheme == "https"
            self._read_transports.append([
                _Transport(
                    rparsed.hostname, rparsed.port or (443 if rhttps else 80),
                    self._ssl if rhttps else None,
                    rparsed.hostname if rhttps else None, timeout,
                ),
                0.0,
            ])
        self._read_rr = 0
        self._read_lock = threading.Lock()
        #: Reads that failed on a replica and were made again on the primary.
        self.read_failovers = 0
        self._accept = (
            CLIENT_ACCEPT_COMPACT if config.wire_encoding == "compact" else JSON_CONTENT_TYPE
        )
        #: True once the server has answered compact: only then do write
        #: bodies go compact.
        self._server_speaks_compact = False
        #: One-shot primed LIST results (``prime_list_cache``).
        self._list_cache: dict[tuple, tuple[list[KubeObject], str]] = {}
        self._list_cache_lock = threading.Lock()

    @classmethod
    def from_environment(cls, sa_dir: str = SERVICE_ACCOUNT_DIR) -> "RestClient":
        return cls(RestConfig.from_environment(sa_dir))

    # -- plumbing ------------------------------------------------------------
    def _call(self, coro, timeout: Optional[float] = None):
        """Run a transport coroutine on the shared wire loop and wait for
        it: the sync client over the async transport."""
        future = asyncio.run_coroutine_threadsafe(coro, _get_wire_loop())
        try:
            # The transport bounds each of its own steps; this bound only
            # keeps a lost loop from parking the caller for ever.
            return future.result(timeout if timeout is not None else self.timeout * 2 + 10)
        except (asyncio.TimeoutError, concurrent.futures.TimeoutError):
            future.cancel()
            raise _TransportError("wire-loop call timed out") from None

    def close(self) -> None:
        """Close the pooled connections and remove the credential files
        the config wrote."""
        for transport in [entry[0] for entry in self._read_transports] + [self._transport]:
            try:
                self._call(transport.close())
            except (_TransportError, RuntimeError):  # the loop is gone
                pass
        self.config.close()

    def _pick_read_transport(self) -> Optional[_Transport]:
        """The next healthy replica (round robin), or None where there is
        none (the read then goes to the primary)."""
        if not self._read_transports:
            return None
        now = time.monotonic()
        with self._read_lock:
            n = len(self._read_transports)
            for offset in range(n):
                entry = self._read_transports[(self._read_rr + offset) % n]
                if entry[1] <= now:
                    self._read_rr = (self._read_rr + offset + 1) % n
                    return entry[0]
        return None

    def _mark_read_down(self, transport: _Transport) -> None:
        now = time.monotonic()
        with self._read_lock:
            for entry in self._read_transports:
                if entry[0] is transport:
                    entry[1] = now + _READ_DOWN_SECONDS
            self.read_failovers += 1

    def transport_stats(self) -> dict[str, int | bool]:
        """The wire path's counters: connections opened, requests sent,
        pipelined batches, bytes each way, watch frames received, whether
        the server answered compact, and the read replicas' share."""
        t = self._transport
        return {
            "connections_opened": t.connections_opened,
            "requests_sent": t.requests_sent,
            "pipelined_batches": t.pipelined_batches,
            "bytes_sent": t.bytes_sent,
            "bytes_received": t.bytes_received,
            "watch_frames_received": t.watch_frames_received,
            "server_speaks_compact": self._server_speaks_compact,
            "read_requests_sent": sum(e[0].requests_sent for e in self._read_transports),
            "read_bytes_received": sum(e[0].bytes_received for e in self._read_transports),
            "read_failovers": self.read_failovers,
        }

    def _path(self, kind: str, namespace: str = "", name: str = "", sub: str = "") -> str:
        try:
            info = resource_for_kind(kind)
        except KeyError:
            raise ValueError(f"kind {kind!r} is not one this client serves") from None
        parts = [info.path_prefix]
        if info.namespaced and namespace:
            parts.append(f"/namespaces/{urllib.parse.quote(namespace)}")
        parts.append(f"/{info.plural}")
        if name:
            parts.append(f"/{urllib.parse.quote(name)}")
            if sub:
                parts.append(f"/{sub}")
        return "".join(parts)

    def _namespace(self, kind: str, namespace: str) -> str:
        return namespace or (self.config.namespace if resource_for_kind(kind).namespaced else "")

    def _headers(self, body: Optional[bytes] = None,
                 content_type: str = JSON_CONTENT_TYPE) -> dict[str, str]:
        headers = {"Accept": self._accept}
        if body is not None:
            headers["Content-Type"] = content_type
        if self.config.token:
            headers["Authorization"] = f"Bearer {self.config.token}"
        traceparent = tracing.traceparent()
        if traceparent is not None:
            headers["traceparent"] = traceparent
        return headers

    def _encode_write_body(self, body: Any, content_type: str) -> tuple[bytes, str]:
        """JSON, unless the caller asked for compact, the server has
        answered compact and this is a plain object body (a patch keeps
        its own content type)."""
        if (
            self._server_speaks_compact
            and content_type == JSON_CONTENT_TYPE
            and self.config.wire_encoding == "compact"
        ):
            return encode_compact(body), COMPACT_CONTENT_TYPE
        return json.dumps(body).encode(), content_type

    def _note_content_type(self, content_type: Optional[str]) -> None:
        if is_compact_content_type(content_type):
            self._server_speaks_compact = True

    def _url(self, path: str, query: Optional[Mapping[str, str]] = None) -> str:
        url = self._base_path + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        return url

    def _request(self, method: str, path: str, body: Any = None,
                 content_type: str = JSON_CONTENT_TYPE,
                 query: Optional[Mapping[str, str]] = None) -> Any:
        url = self._url(path, query)
        data: Optional[bytes] = None
        if body is not None:
            data, content_type = self._encode_write_body(body, content_type)
        shed_retries = max(0, int(self.config.too_many_requests_retries))
        # One request span whatever the shed retries; each retry is an
        # attempt span inside it.
        with tracing.span("http.request", category="wire", method=method,
                          path=path) as request_span:
            for attempt in range(shed_retries + 1):
                attempt_scope = (
                    tracing.span("http.attempt", category="wire", attempt=attempt)
                    if request_span is not None and attempt > 0
                    else tracing.use_span(None)
                )
                read_transport = self._pick_read_transport() if method == "GET" else None
                with attempt_scope:
                    # Headers inside the span: the traceparent names this
                    # request (or this attempt).
                    headers = self._headers(data, content_type)
                    try:
                        status, rheaders, payload = self._call(
                            (read_transport or self._transport).request(method, url, headers, data)
                        )
                    except _TransportError as e:
                        if read_transport is None:
                            raise ApiError(f"{method} {url}: {e}") from None
                        # A replica failed: set it aside, ask the primary.
                        self._mark_read_down(read_transport)
                        try:
                            status, rheaders, payload = self._call(
                                self._transport.request(method, url, headers, data)
                            )
                        except _TransportError as e2:
                            raise ApiError(f"{method} {url}: {e2}") from None
                response_ct = rheaders.get("content-type")
                self._note_content_type(response_ct)
                if request_span is not None:
                    request_span.attrs["status"] = status
                if status == 429:
                    # Shed before dispatch: safe to retry for any verb.
                    retry_after = _retry_after_seconds(rheaders, self.config.retry_after_cap_s)
                    if attempt < shed_retries:
                        with tracing.span("http.backoff", category="queue",
                                          retry_after=retry_after):
                            time.sleep(retry_after)
                        continue
                    error = _api_error(status, payload, response_ct)
                    if isinstance(error, TooManyRequestsError):
                        error.retry_after_s = retry_after
                    raise error
                if status >= 400:
                    raise _api_error(status, payload, response_ct)
                if not payload:
                    return {}
                return decode_body(payload, response_ct)
        raise AssertionError("unreachable")  # pragma: no cover

    @staticmethod
    def _selector_query(label_selector: Optional[str | Mapping[str, str]],
                        field_selector: Optional[str]) -> dict[str, str]:
        query = {}
        if isinstance(label_selector, Mapping):
            label_selector = ",".join(f"{k}={v}" for k, v in sorted(label_selector.items()))
        if label_selector:
            query["labelSelector"] = label_selector
        if field_selector:
            query["fieldSelector"] = field_selector
        return query

    @staticmethod
    def _wrap(kind: str, data: dict) -> KubeObject:
        data.setdefault("kind", kind)
        data.setdefault("apiVersion", resource_for_kind(kind).api_version)
        return wrap(data)

    @staticmethod
    def _write_query(field_manager: str, dry_run: bool) -> Optional[dict[str, str]]:
        query: dict[str, str] = {}
        if field_manager:
            query["fieldManager"] = field_manager
        if dry_run:
            query["dryRun"] = "All"  # the only value the API server takes
        return query or None

    # -- reads ---------------------------------------------------------------
    def get(self, kind: str, name: str, namespace: str = "") -> KubeObject:
        path = self._path(kind, self._namespace(kind, namespace), name)
        return self._wrap(kind, self._request("GET", path))

    def get_or_none(self, kind: str, name: str, namespace: str = "") -> Optional[KubeObject]:
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: str = "",
             label_selector: Optional[str | Mapping[str, str]] = None,
             field_selector: Optional[str] = None) -> list[KubeObject]:
        """Every object of ``kind`` (in ``namespace``; all namespaces when
        it is empty) that the selectors match."""
        return self.list_with_revision(kind, namespace, label_selector, field_selector)[0]

    def list_with_revision(self, kind: str, namespace: str = "",
                           label_selector: Optional[str | Mapping[str, str]] = None,
                           field_selector: Optional[str] = None,
                           ) -> tuple[list[KubeObject], str]:
        """``list`` and the collection's ``metadata.resourceVersion``: the
        revision a watch resumes from with no event lost in between, which
        an empty list has too.

        Paged with ``limit``/``continue`` as client-go's pager is
        (``RestConfig.list_page_size`` a page); every page comes from one
        snapshot of the server's and the revision is that snapshot's. A
        continue token the server no longer holds (410) takes the pager's
        way out: one whole list, unpaged. A result that
        ``prime_list_cache`` primed is served once from there."""
        path = self._path(kind, namespace)
        base_query = self._selector_query(label_selector, field_selector)
        primed = self._take_primed(kind, namespace, base_query)
        if primed is not None:
            return primed
        page_size = max(0, int(self.config.list_page_size or 0))
        try:
            return self._list_pages(kind, path, base_query, page_size)
        except WatchExpiredError:
            if not page_size:
                raise
            return self._list_pages(kind, path, base_query, 0)

    def _list_pages(self, kind: str, path: str, base_query: dict,
                    page_size: int) -> tuple[list[KubeObject], str]:
        items: list[KubeObject] = []
        revision = ""
        continue_token = ""
        while True:
            query = dict(base_query)
            if page_size:
                query["limit"] = str(page_size)
            if continue_token:
                query["continue"] = continue_token
            out = self._request("GET", path, query=query) or {}
            items.extend(self._wrap(kind, item) for item in out.get("items") or [])
            meta = out.get("metadata") or {}
            if not revision:
                revision = str(meta.get("resourceVersion", ""))
            continue_token = str(meta.get("continue") or "")
            if not continue_token:
                return items, revision

    def list_delta(self, kind: str, since_resource_version: str, namespace: str = "",
                   label_selector: Optional[str | Mapping[str, str]] = None,
                   field_selector: Optional[str] = None) -> Optional[ListDelta]:
        """The changes since a revision (``sinceResourceVersion``): the
        changed objects, the departed keys and the new collection
        revision. None where the revision fell out of the server's
        journal (410): the caller lists whole. A server that predates
        delta lists answers a whole list (no ``metadata.deltaSince``),
        which comes back as a ``full=True`` ListDelta rather than be
        fetched again."""
        query = self._selector_query(label_selector, field_selector)
        query["sinceResourceVersion"] = str(since_resource_version)
        try:
            out = self._request("GET", self._path(kind, namespace), query=query) or {}
        except WatchExpiredError:
            return None
        meta = out.get("metadata") or {}
        items = [self._wrap(kind, item) for item in out.get("items") or []]
        revision = str(meta.get("resourceVersion", ""))
        if "deltaSince" not in meta:
            return ListDelta(items, [], revision, full=True)
        deleted = [(d.get("namespace", ""), d.get("name", ""))
                   for d in out.get("deletedItems") or []]
        return ListDelta(items, deleted, revision)

    @staticmethod
    def _prime_key(kind: str, namespace: str, base_query: dict) -> tuple:
        return (kind, namespace, tuple(sorted(base_query.items())))

    def _take_primed(self, kind: str, namespace: str,
                     base_query: dict) -> Optional[tuple[list[KubeObject], str]]:
        with self._list_cache_lock:
            return self._list_cache.pop(self._prime_key(kind, namespace, base_query), None)

    def prime_list_cache(self, specs: Sequence[tuple[str, str, Any, Optional[str]]]) -> int:
        """Pipeline a batch of collection LISTs, ``(kind, namespace,
        label_selector, field_selector)`` each, on one pooled connection,
        their pages round by round, and keep the results; the next
        matching ``list_with_revision`` takes its entry (once). Returns
        how many lists were primed; a list whose request failed is not
        kept, and the consumer's own list meets the error. Each result
        carries its collection revision, and the consumer's watch resumes
        from it, so nothing after the prime is lost."""
        page_size = max(0, int(self.config.list_page_size or 0))
        pending: list[dict] = []
        for kind, namespace, label_selector, field_selector in specs:
            base_query = self._selector_query(label_selector, field_selector)
            query = dict(base_query)
            if page_size:
                query["limit"] = str(page_size)
            pending.append({
                "kind": kind,
                "key": self._prime_key(kind, namespace, base_query),
                "path": self._path(kind, namespace),
                "query": query,
                "items": [],
                "revision": "",
            })
        headers = self._headers()
        primed = 0
        while pending:
            batch = [("GET", self._url(spec["path"], spec["query"]), headers, None)
                     for spec in pending]
            try:
                responses = self._call(self._transport.request_many(batch))
            except _TransportError:
                return primed  # a saving only: the lists ask again
            next_round = []
            for spec, (status, rheaders, payload) in zip(pending, responses):
                if status >= 400:
                    continue  # not kept; the consumer's list asks again
                self._note_content_type(rheaders.get("content-type"))
                out = decode_body(payload, rheaders.get("content-type")) if payload else {}
                spec["items"].extend(self._wrap(spec["kind"], item)
                                     for item in out.get("items") or [])
                meta = out.get("metadata") or {}
                if not spec["revision"]:
                    spec["revision"] = str(meta.get("resourceVersion", ""))
                continue_token = str(meta.get("continue") or "")
                if continue_token:
                    spec["query"]["continue"] = continue_token
                    next_round.append(spec)
                    continue
                with self._list_cache_lock:
                    self._list_cache[spec["key"]] = (spec["items"], spec["revision"])
                primed += 1
            pending = next_round
        return primed

    def watch(self, kind: str, namespace: str = "",
              label_selector: Optional[str | Mapping[str, str]] = None,
              field_selector: Optional[str] = None,
              timeout_seconds: Optional[int] = None,
              resource_version: Optional[str] = None,
              handle: Optional[WatchHandle] = None,
              allow_bookmarks: bool = False) -> Iterator[tuple[str, KubeObject]]:
        """Stream watch events as ``(event_type, object)`` pairs.

        With ``resource_version`` the events after that revision replay
        first, so a list followed by a watch from the list's revision
        loses nothing; a revision the server's journal no longer holds
        raises ``WatchExpiredError`` (410), and the caller re-lists. The
        server ends the stream after ``timeout_seconds``
        (``DEFAULT_WATCH_TIMEOUT_SECONDS`` when None) and the generator
        ends with it; a frame read times out a client timeout later, so a
        half-open connection cannot park the caller. An ``ERROR`` frame
        inside the stream raises its ``Status``'s error.
        ``allow_bookmarks`` asks for ``BOOKMARK`` events, which carry only
        a fresh resume revision. ``handle.cancel()`` ends the stream from
        another thread. A window that ends cleanly gives its connection
        back to the pool; a stream left half read is aborted. A watch
        rides a read replica where one is healthy.
        """
        if timeout_seconds is None:
            timeout_seconds = DEFAULT_WATCH_TIMEOUT_SECONDS
        query = self._selector_query(label_selector, field_selector)
        query["watch"] = "true"
        query["timeoutSeconds"] = str(int(timeout_seconds))  # an int64 to the server
        if allow_bookmarks:
            query["allowWatchBookmarks"] = "true"
        if resource_version is not None:
            query["resourceVersion"] = resource_version
        url = self._url(self._path(kind, namespace), query)
        read_timeout = timeout_seconds + self.timeout
        frames: queue_mod.Queue = queue_mod.Queue()
        read_transport = self._pick_read_transport()
        future = asyncio.run_coroutine_threadsafe(
            (read_transport or self._transport).watch_pump(
                url, self._headers(), frames, handle, read_timeout
            ),
            _get_wire_loop(),
        )
        try:
            while True:
                try:
                    what, payload = frames.get(timeout=read_timeout + 10)
                except queue_mod.Empty:
                    # The pump always ends the queue: the loop is gone.
                    raise ApiError(f"GET {url}: watch stream stalled") from None
                if what == "event":
                    if payload.get("type") == "ERROR":
                        status = payload.get("object") or {}
                        raise _api_error(int(status.get("code") or 500),
                                         json.dumps(status).encode())
                    yield payload["type"], self._wrap(kind, payload["object"])
                elif what == "end":
                    return  # the server ended the stream
                elif what == "httperror":
                    status, content_type, body = payload
                    raise _api_error(status, body, content_type)
                else:
                    if handle is not None and handle.cancelled:
                        return
                    if read_transport is not None:
                        self._mark_read_down(read_transport)
                    raise ApiError(f"GET {url}: watch stream died: {payload}")
        finally:
            if not future.done():
                # Left in the middle of a window: cancel the pump, which
                # aborts the connection, so a half-read stream never goes
                # back to the pool.
                future.cancel()

    def discover(self, group: str, version: str) -> list[dict]:
        """The resources the API serves under ``group/version`` (the core
        group when ``group`` is empty): the discovery document's
        ``resources``. A group/version not (yet) discoverable is a 404,
        raised as ``NotFoundError``."""
        path = f"/apis/{group}/{version}" if group else f"/api/{version}"
        doc = self._request("GET", path) or {}
        return list(doc.get("resources") or [])

    # -- writes --------------------------------------------------------------
    def create(self, obj: KubeObject, field_manager: str = "",
               dry_run: bool = False) -> KubeObject:
        kind = obj.raw.get("kind", "")
        path = self._path(kind, self._namespace(kind, obj.namespace))
        return self._wrap(kind, self._request(
            "POST", path, obj.raw, query=self._write_query(field_manager, dry_run)))

    def update(self, obj: KubeObject, field_manager: str = "",
               dry_run: bool = False) -> KubeObject:
        kind = obj.raw.get("kind", "")
        path = self._path(kind, self._namespace(kind, obj.namespace), obj.name)
        return self._wrap(kind, self._request(
            "PUT", path, obj.raw, query=self._write_query(field_manager, dry_run)))

    def update_status(self, obj: KubeObject, field_manager: str = "",
                      dry_run: bool = False) -> KubeObject:
        kind = obj.raw.get("kind", "")
        path = self._path(kind, self._namespace(kind, obj.namespace), obj.name, "status")
        return self._wrap(kind, self._request(
            "PUT", path, obj.raw, query=self._write_query(field_manager, dry_run)))

    def apply(self, obj: KubeObject | Mapping[str, Any], field_manager: str,
              force: bool = False, dry_run: bool = False) -> KubeObject:
        """Server-side apply: a PATCH of content type
        ``application/apply-patch+yaml`` (the body is JSON, which is YAML,
        as client-go sends it) with ``fieldManager`` and ``force``."""
        raw = dict(obj.raw if isinstance(obj, KubeObject) else obj)
        kind = raw.get("kind", "")
        meta = raw.get("metadata") or {}
        query = {"fieldManager": field_manager}
        if force:
            query["force"] = "true"
        if dry_run:
            query["dryRun"] = "All"
        path = self._path(kind, self._namespace(kind, meta.get("namespace", "")),
                          meta.get("name", ""))
        return self._wrap(kind, self._request(
            "PATCH", path, raw, content_type="application/apply-patch+yaml", query=query))

    @staticmethod
    def _patch_body(patch: Any, patch_type: str) -> Any:
        if patch_type not in _PATCH_TYPES:
            raise InvalidError(
                f"unsupported patch type {patch_type!r} (expected 'merge', 'strategic', or 'json')"
            )
        if patch_type == "json":
            # RFC 6902: a list of operations. Anything else is the
            # caller's mistake, not an empty patch.
            if not isinstance(patch, list):
                raise BadRequestError("json patch must be an array of operations")
            return list(patch)
        return dict(patch or {})

    def patch(self, kind: str, name: str, namespace: str = "",
              patch: Any = None, patch_type: str = "merge",
              field_manager: str = "", dry_run: bool = False) -> KubeObject:
        body = self._patch_body(patch, patch_type)
        path = self._path(kind, self._namespace(kind, namespace), name)
        return self._wrap(kind, self._request(
            "PATCH", path, body, content_type=_PATCH_TYPES[patch_type],
            query=self._write_query(field_manager, dry_run),
        ))

    def patch_many(self, kind: str, patches: Sequence[tuple[str, Any, str]],
                   namespace: str = "", field_manager: str = "",
                   dry_run: bool = False) -> list:
        """Pipelined PATCHes, ``(name, patch, patch_type)`` a slot, on one
        pooled connection (``request_many``): a batch costs one round
        trip. Each slot's result is the patched object or its API error;
        a failed slot never fails the batch. A shed slot (429) is not
        retried here: it comes back as ``TooManyRequestsError``, and the
        caller's per-slot handling owns the retry."""
        if not patches:
            return []
        query = self._write_query(field_manager, dry_run)
        ns = self._namespace(kind, namespace)
        batch = []
        for name, patch, patch_type in patches:
            data, content_type = self._encode_write_body(
                self._patch_body(patch, patch_type), _PATCH_TYPES[patch_type]
            )
            batch.append(("PATCH", self._url(self._path(kind, ns, name), query),
                          self._headers(data, content_type), data))
        with tracing.span("http.request_many", category="wire", method="PATCH",
                          requests=len(batch)) as span:
            try:
                responses = self._call(self._transport.request_many(batch))
            except _TransportError as e:
                raise ApiError(f"PATCH batch of {len(batch)}: {e}") from None
            results: list = []
            errors = 0
            for status, rheaders, payload in responses:
                response_ct = rheaders.get("content-type")
                self._note_content_type(response_ct)
                if status >= 400:
                    errors += 1
                    results.append(_api_error(status, payload, response_ct))
                    continue
                results.append(self._wrap(kind, decode_body(payload, response_ct))
                               if payload else KubeObject({}))
            if span is not None:
                span.attrs["errors"] = errors
        return results

    def delete(self, kind: str, name: str, namespace: str = "",
               grace_period_seconds: Optional[int] = None,
               propagation_policy: Optional[str] = None,
               precondition_uid: Optional[str] = None,
               precondition_resource_version: Optional[str] = None,
               dry_run: bool = False) -> None:
        query: dict[str, str] = {}
        if dry_run:
            query["dryRun"] = "All"
        if grace_period_seconds is not None:
            query["gracePeriodSeconds"] = str(grace_period_seconds)
        if propagation_policy is not None:
            query["propagationPolicy"] = propagation_policy  # Background | Foreground | Orphan
        body = None
        if precondition_uid is not None or precondition_resource_version is not None:
            # In the DeleteOptions body; a mismatch answers 409. An empty
            # uid is a precondition that must fail, so ``is not None``.
            preconditions: dict[str, str] = {}
            if precondition_uid is not None:
                preconditions["uid"] = precondition_uid
            if precondition_resource_version is not None:
                preconditions["resourceVersion"] = precondition_resource_version
            body = {"apiVersion": "v1", "kind": "DeleteOptions", "preconditions": preconditions}
        self._request("DELETE", self._path(kind, self._namespace(kind, namespace), name),
                      body, query=query or None)

    def delete_collection(self, kind: str, namespace: str = "",
                          label_selector: Optional[str | Mapping[str, str]] = None,
                          field_selector: Optional[str] = None,
                          propagation_policy: Optional[str] = None,
                          dry_run: bool = False) -> list[KubeObject]:
        """client-go's deleteCollection: a DELETE on the collection,
        scoped by the selectors; the objects the server addressed. An API
        server serves it only on a namespaced resource's namespaced
        collection, so an empty namespace is the config's, as for every
        other write."""
        query = self._selector_query(label_selector, field_selector)
        if propagation_policy:
            query["propagationPolicy"] = propagation_policy
        if dry_run:
            query["dryRun"] = "All"
        doc = self._request("DELETE", self._path(kind, self._namespace(kind, namespace)),
                            query=query or None) or {}
        return [self._wrap(kind, item) for item in doc.get("items") or []]

    def evict(self, pod_name: str, namespace: str = "", dry_run: bool = False) -> None:
        """Evict a pod through its policy/v1 Eviction subresource, as
        ``kubectl drain`` does; ``dry_run`` travels in the Eviction's
        DeleteOptions, as kubectl sends it."""
        namespace = self._namespace("Pod", namespace)
        body: dict[str, Any] = {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": pod_name, "namespace": namespace},
        }
        if dry_run:
            body["deleteOptions"] = {"dryRun": ["All"]}
        self._request("POST", self._path("Pod", namespace, pod_name, "eviction"), body,
                      query={"dryRun": "All"} if dry_run else None)
