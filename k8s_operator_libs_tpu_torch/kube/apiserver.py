"""LocalApiServer: the in-memory cluster served over real HTTP.

The JAX package's ``kube/apiserver.py``, ported: the port's
``FakeCluster`` (finalizers, optimistic concurrency, the patch engines,
server-side apply, CRD establishment) exposed with Kubernetes REST
conventions, so the port's ``RestClient``, and any kubeconfig-speaking
tool, exercises the whole wire path: URLs, verbs, selectors as query
params, Status errors, the eviction and status subresources, dry runs,
and bearer-token auth. The reference's suites boot a real kube-apiserver
and etcd with no nodes (envtest); this is the same harness in process.

The server is one asyncio event loop on a daemon thread, speaking
HTTP/1.1:

* **keep-alive + pipelining**: connections persist across requests and
  a client may write several requests before reading the first
  response; the per-connection loop answers them in order off the
  already-buffered bytes, so a pipelined informer seed pays one round
  trip for N LISTs;
* **streamed watch frames**: a watch is a chunked-transfer response on
  the SAME held connection: events stream as frames, periodic BOOKMARK
  frames carry the store rv, and the window's end is the terminal chunk;
  the connection goes back to keep-alive and the next watch window
  reuses it;
* **content negotiation**: object and watch-frame payloads are encoded
  per the request's ``Accept`` header (``kube/wire.py``): JSON by
  default, the compact binary encoding when the caller asks, and the
  ``;as=Table`` transform for ``kubectl get`` (``kube/table.py``),
  ``kubectl get -w`` included: a Table-negotiated watch streams
  Table-encoded event frames;
* **priority and fairness**: every request rides one of four flows
  (lease, reconcile, informer, telemetry) drained in strict priority
  order; a full flow sheds 429 with ``Retry-After``;
* **TCP_NODELAY**: asyncio sets it on every accepted socket.

Also a deployment artifact, not only a fixture: ``python -m
k8s_operator_libs_tpu_torch.kube.apiserver --port 8001 [--token T]
[--kubeconfig PATH]`` serves a scratch cluster for the port's crdutil
and upgrade-controller commands (``--port 0`` takes a free port and the
printed URL names it).
"""

from __future__ import annotations

import asyncio
import json
import re
import ssl
import threading
import urllib.parse
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

from .client import ApiError, BadRequestError, WatchExpiredError
from .fake import FakeCluster, WatchFrameSource
from .loopwatch import LoopStallWatchdog
from .objects import wrap
from .resources import ResourceInfo, resource_for_plural
from .table import accepts_table, render_table
from .wire import (
    content_type_for,
    decode_body,
    encode_body,
    encode_watch_frame,
    negotiate_encoding,
)
from ..utils import tracing
from ..utils.faultpoints import wall_now
from ..utils.lifecycle import lifecycle_resource

_PATH_RE = re.compile(
    r"^/(?:api|apis)(?:/(?P<group>[^/]+(?:\.[^/]+)*))?/(?P<version>v[^/]+)"
    r"(?:/namespaces/(?P<namespace>[^/]+))?"
    r"/(?P<plural>[^/]+)"
    r"(?:/(?P<name>[^/]+))?"
    r"(?:/(?P<subresource>status|eviction))?$"
)

#: GET /api/v1 or /apis/<group>/<version> with no resource segment =
#: API discovery (the endpoint crdutil's wait-for-established polls).
#: Core discovery lives ONLY at /api/<version>; /apis/<version> with no
#: group is a 404 on a real apiserver, so it must be one here too.
_DISCOVERY_RE = re.compile(
    r"^(?:/api/(?P<core_version>v[^/]+)"
    r"|/apis/(?P<group>[^/]+)/(?P<version>v[^/]+))$"
)

_REASONS = {
    200: "OK", 201: "Created", 400: "Bad Request", 401: "Unauthorized",
    404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
    410: "Gone", 415: "Unsupported Media Type", 422: "Unprocessable Entity",
    429: "Too Many Requests", 500: "Internal Server Error",
}

#: Upper bound on queued-but-undelivered events per watch stream; a
#: consumer this far behind loses the watch (stream ended cleanly) and
#: resumes from its last delivered revision — the journal replays what
#: the queue dropped.
_WATCH_QUEUE_LIMIT = 1024

_MAX_HEADER_BYTES = 65536


def _status_body(code: int, reason: str, message: str) -> dict[str, Any]:
    return {
        "kind": "Status",
        "apiVersion": "v1",
        "status": "Failure",
        "code": code,
        "reason": reason,
        "message": message,
    }


def _ok_status() -> dict[str, Any]:
    return {
        "kind": "Status",
        "apiVersion": "v1",
        "status": "Success",
        "code": 200,
    }


class _Request:
    """One parsed HTTP request (the transport-neutral shape the
    dispatcher consumes)."""

    __slots__ = ("method", "target", "path", "query", "headers", "body",
                 "keep_alive")

    def __init__(self, method, target, headers, body, keep_alive):
        self.method = method
        self.target = target
        parsed = urllib.parse.urlparse(target)
        self.path = parsed.path
        self.query = dict(urllib.parse.parse_qsl(parsed.query))
        self.headers = headers  # lower-cased keys
        self.body = body
        self.keep_alive = keep_alive

    def header(self, name: str, default: str = "") -> str:
        return self.headers.get(name.lower(), default)


class _Response:
    """A buffered (non-streaming) response: ``body`` is the JSON-model
    payload, encoded per negotiation at write time."""

    __slots__ = ("status", "body")

    def __init__(self, status: int, body: Optional[dict[str, Any]]):
        self.status = status
        self.body = body


class _WatchParams:
    """Marker result: the dispatcher routed a ``?watch=true`` GET; the
    connection handler streams it."""

    __slots__ = ("info", "namespace", "query")

    def __init__(self, info, namespace, query):
        self.info = info
        self.namespace = namespace
        self.query = query


@dataclass(frozen=True)
class FlowConfig:
    """One APF flow's bounds: ``queue_depth`` pending requests (overflow
    sheds 429 + Retry-After) and ``concurrency`` — the dispatch batch the
    scheduler drains from this flow before re-checking higher-priority
    queues (handlers are synchronous on the loop, so this is the unit of
    head-of-line blocking a flow may impose on flows above it)."""

    queue_depth: int
    concurrency: int = 1


#: The flow a request belongs to, in strict priority order. Lease traffic
#: (the heartbeats that keep shard ownership alive) outranks reconcile
#: writes, which outrank informer reads (seed LISTs + watch
#: establishment), which outrank telemetry status reports — so a
#: monitor-report storm from thousands of nodes degrades telemetry
#: freshness, never lease renewal (docs/wire-path.md "Priority and
#: fairness").
APF_PRIORITY = ("lease", "reconcile", "informer", "telemetry")


def _default_flows() -> dict:
    return {
        "lease": FlowConfig(queue_depth=1024, concurrency=4),
        "reconcile": FlowConfig(queue_depth=1024, concurrency=4),
        "informer": FlowConfig(queue_depth=1024, concurrency=2),
        "telemetry": FlowConfig(queue_depth=256, concurrency=2),
    }


@dataclass
class ApfConfig:
    """API priority-and-fairness at the LocalApiServer: per-flow FIFO
    queues with bounded depth, drained in strict priority order; a full
    queue sheds the request as 429 with ``Retry-After`` (honored by
    RestClient's typed-error retry path). Defaults are generous enough
    that only a genuine storm sheds; production tunings shrink the
    telemetry queue. A partial ``flows`` dict is MERGED over the
    defaults — ``ApfConfig(flows={"telemetry": FlowConfig(8)})`` tunes
    one flow without un-configuring the other three."""

    enabled: bool = True
    #: Retry-After hint sent with every 429 (seconds; fractional OK for
    #: the in-process client, rendered as-is).
    retry_after_s: float = 1.0
    flows: dict = field(default_factory=_default_flows)

    def __post_init__(self) -> None:
        for flow, cfg in _default_flows().items():
            self.flows.setdefault(flow, cfg)


def classify_flow(method: str, path: str) -> str:
    """Request → APF flow, from the RESOURCE segment of the parsed path
    (the same route grammar the dispatcher uses — a pod named
    ``leases-cache-0`` or a namespace named ``leases`` must not ride the
    lease flow): Lease objects (any verb) are ``lease``;
    NodeHealthReport writes are ``telemetry``; remaining GETs
    (list/watch) are ``informer``; every other write is ``reconcile``."""
    m = _PATH_RE.match(path)
    plural = m.group("plural") if m is not None else ""
    if plural == "leases":
        return "lease"
    if method != "GET" and plural == "nodehealthreports":
        return "telemetry"
    if method == "GET":
        return "informer"
    return "reconcile"


class _ApfShed(Exception):
    """Internal marker: the flow queue was full; answer 429."""


class _ApfScheduler:
    """Per-flow FIFO queues drained in strict priority order by ONE
    task on the server loop. Handlers are synchronous, so the scheduler
    IS the concurrency bound; its job is ordering and shedding: a lease
    renewal enqueued behind a thousand pending telemetry writes is
    served next, and telemetry past its queue depth is shed instead of
    ever entering the loop's work."""

    def __init__(self, config: ApfConfig, loop) -> None:
        self._config = config
        self._loop = loop
        self._queues: dict[str, deque] = {f: deque() for f in APF_PRIORITY}
        self._wake = asyncio.Event()
        self.stats: dict[str, dict[str, int]] = {
            f: {"admitted": 0, "shed": 0, "max_queued": 0}
            for f in APF_PRIORITY
        }
        self._task = loop.create_task(self._drain())

    def close(self) -> None:
        self._task.cancel()

    def queue_depths(self) -> dict[str, int]:
        return {f: len(q) for f, q in self._queues.items()}

    async def submit(self, flow: str, thunk):
        """Enqueue ``thunk`` on ``flow``'s FIFO and await its result;
        raises ``_ApfShed`` immediately when the queue is full."""
        q = self._queues[flow]
        cfg = self._config.flows[flow]
        stats = self.stats[flow]
        if len(q) >= cfg.queue_depth:
            stats["shed"] += 1
            raise _ApfShed()
        future = self._loop.create_future()
        q.append((future, thunk))
        if len(q) > stats["max_queued"]:
            stats["max_queued"] = len(q)
        self._wake.set()
        return await future

    async def _drain(self) -> None:
        while True:
            flow = next(
                (f for f in APF_PRIORITY if self._queues[f]), None
            )
            if flow is None:
                self._wake.clear()
                await self._wake.wait()
                continue
            q = self._queues[flow]
            batch = max(1, self._config.flows[flow].concurrency)
            for _ in range(batch):
                if not q:
                    break
                future, thunk = q.popleft()
                if future.done():
                    continue  # submitter went away (connection killed)
                self.stats[flow]["admitted"] += 1
                try:
                    future.set_result(thunk())
                except BaseException as e:  # noqa: BLE001 - to submitter
                    future.set_exception(e)
            # Yield between batches: connection tasks get to read newly
            # arrived requests, so a lease renewal landing mid-storm is
            # seen before the next telemetry batch.
            await asyncio.sleep(0)


class _Dispatcher:
    """The verb logic, transport-free: ``(method, path, query, headers,
    body) -> _Response | _WatchParams``; errors surface as ApiError and
    are rendered into Status bodies by the caller."""

    def __init__(self, server: "LocalApiServer") -> None:
        self.server = server

    def dispatch(self, req: _Request) -> "_Response | _WatchParams":
        if not self._authorized(req):
            return _Response(
                401, _status_body(401, "Unauthorized", "invalid bearer token")
            )
        if req.method == "GET":
            discovery = _DISCOVERY_RE.match(req.path)
            if discovery is not None:
                core = discovery.group("core_version")
                return self._do_discovery(
                    "" if core else discovery.group("group"),
                    core or discovery.group("version"),
                )
        route = self._route(req)
        if route is None:
            return _Response(
                404, _status_body(404, "NotFound", f"no route for {req.path}")
            )
        info, namespace, name, subresource, query = route
        if req.method == "GET" and not name and query.get("watch") in (
            "true", "1"
        ):
            return _WatchParams(info, namespace, query)
        handler = getattr(self, f"_do_{req.method.lower()}", None)
        if handler is None:
            return _Response(
                405,
                _status_body(
                    405, "MethodNotAllowed", f"method {req.method} not allowed"
                ),
            )
        return handler(req, info, namespace, name, subresource, query)

    # -- helpers -----------------------------------------------------------
    def _authorized(self, req: _Request) -> bool:
        token = self.server.token
        if not token:
            return True
        return req.header("Authorization") == f"Bearer {token}"

    def _route(self, req: _Request):
        m = _PATH_RE.match(req.path)
        if m is None:
            return None
        group = m.group("group") or ""
        # /api/v1 has no group segment; the regex puts "v1" in version there.
        try:
            info = resource_for_plural(group, m.group("plural"))
        except KeyError:
            return None
        version = m.group("version")
        requested_gv = f"{group}/{version}" if group else version
        if info.api_version != requested_gv:
            # The URL names a version the registry doesn't serve this
            # resource at. A real apiserver routes per served
            # group/version — accept only if discovery says a stored
            # CRD serves the plural at that version; otherwise 404.
            try:
                served = self.server.cluster.discover(group, version)
            except ApiError:
                return None
            if not any(
                r.get("name") == m.group("plural") for r in served
            ):
                return None
            # Downstream (list apiVersion, printer columns) must speak
            # the REQUESTED version, not the registry's default.
            info = ResourceInfo(
                info.kind, requested_gv, info.plural, info.namespaced
            )
        return (
            info,
            m.group("namespace") or "",
            m.group("name") or "",
            m.group("subresource") or "",
            req.query,
        )

    def _read_body(self, req: _Request) -> dict[str, Any]:
        """Decode a write body by its Content-Type: JSON (the default)
        or the negotiated compact encoding — a compact-speaking client
        sends its create/update payloads compact too."""
        if not req.body:
            return {}
        return decode_body(req.body, req.header("Content-Type"))

    @staticmethod
    def _dry_run(query) -> bool:
        value = query.get("dryRun", "")
        if value and value != "All":
            # Real-apiserver validation: All is the only accepted value.
            raise BadRequestError(f"invalid dryRun value {value!r}")
        return bool(value)

    @staticmethod
    def _table(cluster, info, raws, query, list_metadata=None):
        include_object = query.get("includeObject", "") or "Metadata"
        if include_object not in ("Metadata", "Object", "None"):
            raise BadRequestError(
                f"invalid includeObject value {include_object!r}"
            )
        return render_table(
            raws,
            crd_columns=cluster.printer_columns(
                info.kind, info.api_version
            ),
            include_object=include_object,
            list_metadata=list_metadata,
        )

    # -- verbs -------------------------------------------------------------
    def _do_discovery(self, group: str, version: str) -> _Response:
        """Serve the APIResourceList discovery document (what the real
        apiserver returns for /apis/<group>/<version>); 404 while the
        group/version is not yet servable — the Established-but-
        undiscoverable window crdutil polls through."""
        resources = self.server.cluster.discover(group, version)
        gv = f"{group}/{version}" if group else version
        return _Response(
            200,
            {
                "kind": "APIResourceList",
                "apiVersion": "v1",
                "groupVersion": gv,
                "resources": resources,
            },
        )

    def _do_get(self, req, info, namespace, name, subresource, query):
        cluster = self.server.cluster
        as_table = accepts_table(req.header("Accept"))
        if name:
            obj = cluster.get(info.kind, name, namespace)
            if as_table:
                return _Response(
                    200, self._table(cluster, info, [obj.raw], query)
                )
            return _Response(200, obj.raw)
        since = query.get("sinceResourceVersion", "")
        if since:
            # Delta-aware LIST (docs/wire-path.md): the client presents
            # the revision it is current through; inside the journal
            # window the response is deltas-since-rv (changed items +
            # departed keys) instead of a full snapshot. Outside the
            # window: 410 Gone, and the client takes the full path —
            # the same decay contract as watch resumption.
            delta = cluster.list_delta(
                info.kind,
                since,
                namespace=namespace,
                label_selector=query.get("labelSelector") or None,
                field_selector=query.get("fieldSelector") or None,
            )
            if delta is None:
                raise WatchExpiredError(
                    f"resourceVersion {since} fell out of the journal; "
                    "a full list is required"
                )
            return _Response(200, {
                "apiVersion": info.api_version,
                "kind": f"{info.kind}List",
                "metadata": {
                    "resourceVersion": delta.revision,
                    "deltaSince": since,
                },
                "items": [o.raw for o in delta.items],
                "deletedItems": [
                    {"namespace": ns, "name": n}
                    for ns, n in delta.deleted
                ],
            })
        try:
            limit = int(query.get("limit", "0") or "0")
        except ValueError:
            raise BadRequestError(
                f"invalid limit {query.get('limit')!r}"
            ) from None
        items, revision, next_continue, remaining = cluster.list_page(
            info.kind,
            namespace=namespace,
            label_selector=query.get("labelSelector") or None,
            field_selector=query.get("fieldSelector") or None,
            limit=limit,
            continue_token=query.get("continue", ""),
        )
        # Collection revision: what a watch resumes from even when the
        # list is empty (no items to take a revision from). On chunked
        # lists it is the first page's snapshot revision, continue and
        # remainingItemCount follow the real server's listMeta.
        metadata: dict = {"resourceVersion": revision}
        if next_continue:
            metadata["continue"] = next_continue
        if remaining is not None:
            metadata["remainingItemCount"] = remaining
        if as_table:
            return _Response(200, self._table(
                cluster, info, [o.raw for o in items], query,
                list_metadata=metadata,
            ))
        return _Response(
            200,
            {
                "apiVersion": info.api_version,
                "kind": f"{info.kind}List",
                "metadata": metadata,
                "items": [o.raw for o in items],
            },
        )

    def _do_post(self, req, info, namespace, name, subresource, query):
        cluster = self.server.cluster
        body = self._read_body(req)
        if subresource == "eviction":
            # dryRun travels either as a query param or inside the
            # Eviction body's deleteOptions (kubectl sends the latter).
            opts = (body or {}).get("deleteOptions") or {}
            body_dry = opts.get("dryRun") or []
            if body_dry and body_dry != ["All"]:
                raise BadRequestError(f"invalid dryRun value {body_dry!r}")
            cluster.evict(
                name, namespace,
                dry_run=self._dry_run(query) or bool(body_dry),
            )
            return _Response(200, _ok_status())
        meta = body.setdefault("metadata", {})
        if info.namespaced and not meta.get("namespace"):
            meta["namespace"] = namespace
        created = cluster.create(
            wrap(body),
            field_manager=query.get("fieldManager", ""),
            dry_run=self._dry_run(query),
        )
        return _Response(201, created.raw)

    def _do_put(self, req, info, namespace, name, subresource, query):
        cluster = self.server.cluster
        obj = wrap(self._read_body(req))
        manager = query.get("fieldManager", "")
        dry = self._dry_run(query)
        if subresource == "status":
            updated = cluster.update_status(
                obj, field_manager=manager, dry_run=dry
            )
        else:
            updated = cluster.update(obj, field_manager=manager, dry_run=dry)
        return _Response(200, updated.raw)

    def _do_patch(self, req, info, namespace, name, subresource, query):
        cluster = self.server.cluster
        content_type = req.header("Content-Type")
        if "apply-patch" in content_type:
            # Server-side apply: the body is the applied config itself.
            if subresource:
                raise BadRequestError(
                    "server-side apply to subresources is not supported "
                    "(PARITY: apply targets the main resource only)"
                )
            body = self._read_body(req)
            meta = body.setdefault("metadata", {})
            if meta.get("name") and meta["name"] != name:
                # Real-apiserver rule: the body may not address a
                # different object than the URL.
                raise BadRequestError(
                    f"metadata.name {meta['name']!r} does not match the "
                    f"request path name {name!r}"
                )
            meta["name"] = name
            if info.namespaced:
                if meta.get("namespace") and meta["namespace"] != namespace:
                    raise BadRequestError(
                        f"metadata.namespace {meta['namespace']!r} does not "
                        f"match the request path namespace {namespace!r}"
                    )
                meta["namespace"] = namespace
            created = (
                cluster.get_or_none(info.kind, name, namespace) is None
            )
            applied = cluster.apply(
                body,
                field_manager=query.get("fieldManager", ""),
                force=query.get("force") == "true",
                dry_run=self._dry_run(query),
            )
            return _Response(201 if created else 200, applied.raw)
        if "strategic-merge-patch" in content_type:
            patch_type = "strategic"
        elif "json-patch" in content_type:
            patch_type = "json"
        else:
            patch_type = "merge"
        patched = cluster.patch(
            info.kind,
            name,
            namespace,
            patch=self._read_body(req),
            patch_type=patch_type,
            field_manager=query.get("fieldManager", ""),
            dry_run=self._dry_run(query),
        )
        return _Response(200, patched.raw)

    def _do_delete(self, req, info, namespace, name, subresource, query):
        cluster = self.server.cluster
        if not name:
            # DELETE on the collection: client-go's deleteCollection.
            # Mirror of the fake's guard (ADVICE.md): a real apiserver
            # does not serve deletecollection on the all-namespaces path
            # of a namespaced resource — refuse before the cluster call
            # so registered custom kinds get the same protection over
            # the wire as typed kinds get in-process.
            if info.namespaced and not namespace:
                raise BadRequestError(
                    f"deleteCollection on namespaced kind {info.kind} "
                    "requires a namespace (all-namespaces "
                    "deletecollection is not served by a real apiserver)"
                )
            deleted = cluster.delete_collection(
                info.kind,
                namespace,
                label_selector=query.get("labelSelector") or None,
                field_selector=query.get("fieldSelector") or None,
                propagation_policy=query.get("propagationPolicy") or None,
                dry_run=self._dry_run(query),
            )
            return _Response(200, {
                "apiVersion": info.api_version,
                "kind": f"{info.kind}List",
                "items": [o.raw for o in deleted],
            })
        preconditions = (self._read_body(req) or {}).get("preconditions") or {}
        cluster.delete(
            info.kind,
            name,
            namespace,
            dry_run=self._dry_run(query),
            propagation_policy=query.get("propagationPolicy") or None,
            precondition_uid=preconditions.get("uid"),
            precondition_resource_version=preconditions.get(
                "resourceVersion"
            ),
        )
        return _Response(200, _ok_status())


async def _read_request(
    reader: asyncio.StreamReader, writer: asyncio.StreamWriter
) -> Optional[_Request]:
    """Parse one HTTP/1.1 request off the connection; None on a clean
    EOF between requests (keep-alive peer went away)."""
    try:
        line = await reader.readline()
    except (ConnectionError, asyncio.IncompleteReadError):
        return None
    if not line or line in (b"\r\n", b"\n"):
        return None
    try:
        method, target, version = line.decode("latin-1").strip().split(" ", 2)
    except ValueError:
        raise BadRequestError("malformed request line") from None
    headers: dict[str, str] = {}
    total = len(line)
    while True:
        line = await reader.readline()
        total += len(line)
        if total > _MAX_HEADER_BYTES:
            raise BadRequestError("request headers too large")
        if not line:
            return None  # EOF mid-headers: peer gone
        if line in (b"\r\n", b"\n"):
            break
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    if headers.get("expect", "").lower() == "100-continue":
        # We always read the full body; a conforming client (curl with a
        # large POST) WAITS for this interim response before sending it —
        # without the write both sides stall until the client's fallback
        # timer (the old BaseHTTPRequestHandler sent it automatically).
        headers.pop("expect")
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    body = b""
    length = int(headers.get("content-length") or 0)
    if length:
        body = await reader.readexactly(length)
    keep_alive = (
        version.upper() != "HTTP/1.0"
        and headers.get("connection", "").lower() != "close"
    )
    return _Request(method.upper(), target, headers, body, keep_alive)


@lifecycle_resource(acquire="start", release=("stop", "shutdown"))
class LocalApiServer:
    """Serve a FakeCluster on 127.0.0.1; use as a context manager in tests.

    One asyncio event loop on a background thread behind ``cluster``,
    ``token``, ``url``, ``start``/``stop``, the context manager and
    ``write_kubeconfig``. What the wire path is observed by: the
    ``connections_opened`` / ``requests_served`` / ``watch_streams`` /
    ``watch_frames_sent`` / ``bytes_sent`` / ``watch_bytes_sent``
    counters, ``apf_stats()``, ``loop_stall_stats()``, the request and
    wire logs; ``kill_connections()`` force-drops every live connection,
    the fault hook for watch-resume tests."""

    def __init__(
        self,
        cluster: Optional[FakeCluster] = None,
        port: int = 0,
        token: str = "",
        certfile: str = "",
        keyfile: str = "",
        bookmark_interval_s: float = 15.0,
        apf: Optional[ApfConfig] = None,
        stall_watchdog_threshold_s: float = 0.0,
        read_only: bool = False,
    ) -> None:
        self.cluster = cluster if cluster is not None else FakeCluster()
        self.token = token
        #: Read replica mode (docs/wire-path.md "Read replicas"): serve
        #: GET/HEAD — LIST, delta-LIST, watch — and refuse writes with
        #: 405, keeping every mutation ordered on the primary. Replicas
        #: share the primary's cluster journal (see :meth:`read_replica`),
        #: so a watch served here carries the same revisions in the same
        #: order the primary assigned.
        self.read_only = bool(read_only)
        #: Priority-and-fairness: per-flow FIFO queues + shedding. On by
        #: default with storm-sized bounds (see ApfConfig); pass
        #: ``ApfConfig(enabled=False)`` for the raw dispatch path.
        self.apf = apf if apf is not None else ApfConfig()
        self._apf_scheduler: Optional[_ApfScheduler] = None
        #: > 0 starts a :class:`~.loopwatch.LoopStallWatchdog` on the
        #: server loop — the runtime proof that no handler blocks it
        #: (ASY601's twin; read via :meth:`loop_stall_stats`).
        self.stall_watchdog_threshold_s = float(stall_watchdog_threshold_s)
        self._stall_watchdog: Optional[LoopStallWatchdog] = None
        #: Cadence of BOOKMARK events on watches that opted in via
        #: ``allowWatchBookmarks=true`` (the real server sends them about
        #: once a minute; tests shrink this to exercise the path).
        self.bookmark_interval_s = bookmark_interval_s
        self._port_requested = port
        self.tls = bool(certfile)
        self._ssl_ctx = None
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile or None)
            self._ssl_ctx = ctx
        self._dispatcher = _Dispatcher(self)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._port: Optional[int] = None
        self._started = threading.Event()
        self._writers: set[asyncio.StreamWriter] = set()
        # -- wire counters (loop-thread writes; cross-thread reads are
        # single-field reads of ints, safe under the GIL) --
        self.connections_opened = 0
        self.requests_served = 0
        self.watch_streams = 0
        self.watch_frames_sent = 0
        self.bytes_sent = 0
        #: Bytes written on watch STREAMS only (head + frames + terminal
        #: chunk) — the attribution the hub bench compares across worker
        #: counts (aggregate watch bytes must not multiply with workers).
        self.watch_bytes_sent = 0
        self._request_log: Optional[list] = None
        self._wire_log: Optional[list] = None

    def apf_stats(self) -> dict[str, dict[str, int]]:
        """Per-flow priority-and-fairness counters: current queue depth,
        admitted/shed totals (a shed IS a 429), high-water queue depth.
        Empty when APF is disabled. Feeds ``tpu_operator_wire_apf_*``."""
        scheduler = self._apf_scheduler
        if scheduler is None:
            return {}
        depths = scheduler.queue_depths()
        return {
            flow: {
                "queued": depths.get(flow, 0),
                "admitted_total": stats["admitted"],
                "shed_429_total": stats["shed"],
                "max_queued": stats["max_queued"],
            }
            for flow, stats in scheduler.stats.items()
        }

    def loop_stall_stats(self) -> dict:
        """Server-loop stall watchdog stats (``{}`` when the watchdog is
        off) — the ``tpu_operator_wire_loop_stall_*`` feed for the
        server side, and the ``report_storm`` bench's hard-zero."""
        watchdog = self._stall_watchdog
        return watchdog.stats() if watchdog is not None else {}

    def start_request_log(self) -> list:
        """Begin recording ``(method, path, query)`` per request served
        (the counting hook transport tests assert against — e.g. "a
        killed watch connection resumes with a watch, not a LIST").
        Returns the live list; ``stop_request_log()`` detaches it."""
        log: list = []
        self._request_log = log
        return log

    def stop_request_log(self) -> list:
        log, self._request_log = self._request_log, None
        return log if log is not None else []

    def start_wire_log(self) -> list:
        """Begin recording ``(method, path, pipelined)`` per request served,
        where ``pipelined`` means the request's bytes were ALREADY buffered
        on the connection when the previous response finished — i.e. it
        rode a pipelined burst and cost no extra round trip. A roll's
        write round trips are therefore its non-pipelined writes (the
        first request of each burst), which is what the ``write_batching``
        bench floors. Conservative in the honest direction: a request the
        client pipelined but the kernel hadn't delivered yet counts as a
        round trip. Returns the live list; ``stop_wire_log()`` detaches."""
        log: list = []
        self._wire_log = log
        return log

    def stop_wire_log(self) -> list:
        log, self._wire_log = self._wire_log, None
        return log if log is not None else []

    # -- lifecycle ---------------------------------------------------------
    @property
    def url(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://127.0.0.1:{self._port}"

    @property
    def server_address(self) -> tuple[str, int]:
        """(host, port), for callers that rebind a revived server to the
        same port."""
        return ("127.0.0.1", self._port or self._port_requested)

    def start(self) -> "LocalApiServer":
        self._thread = threading.Thread(
            target=self._run_loop, name="local-apiserver", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("LocalApiServer failed to start")
        if self._startup_error is not None:
            raise self._startup_error
        return self

    def _run_loop(self) -> None:
        self._startup_error: Optional[BaseException] = None
        loop = asyncio.new_event_loop()
        self._loop = loop
        try:
            try:
                self._server = loop.run_until_complete(
                    asyncio.start_server(
                        self._serve_connection,
                        "127.0.0.1",
                        self._port_requested,
                        ssl=self._ssl_ctx,
                    )
                )
                self._port = self._server.sockets[0].getsockname()[1]
                if self.apf.enabled:
                    self._apf_scheduler = _ApfScheduler(self.apf, loop)
                if self.stall_watchdog_threshold_s > 0:
                    self._stall_watchdog = LoopStallWatchdog(
                        loop, threshold_s=self.stall_watchdog_threshold_s
                    ).start()
            except BaseException as e:  # noqa: BLE001 - surfaced to start()
                self._startup_error = e
                return
            finally:
                self._started.set()
            loop.run_forever()
            # stop() requested: tear down the acceptor, then connections
            # (in that order — on newer Pythons Server.wait_closed blocks
            # until handlers finish, so handlers must be cancelled first,
            # and the acceptor must stop before that so no new ones land).
            self._server.close()
            for writer in list(self._writers):
                transport = writer.transport
                if transport is not None:
                    transport.abort()
            pending = [
                t for t in asyncio.all_tasks(loop) if not t.done()
            ]
            for task in pending:
                task.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
        finally:
            loop.close()

    def shutdown(self) -> None:
        """Stop serving (acceptor, live connections, loop thread) but
        leave the cluster alone, so a caller can revive a server over the
        same store."""
        watchdog = self._stall_watchdog
        if watchdog is not None:
            # Before loop.stop(): the cancel must be queued while the
            # loop still drains callbacks (LIF801). Stats stay readable.
            watchdog.stop()
        loop = self._loop
        if loop is not None and not loop.is_closed():
            loop.call_soon_threadsafe(loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10)

    def server_close(self) -> None:
        """A no-op beside ``shutdown()``, which already closed the
        listening socket (the ``socketserver`` call sequence works)."""

    def stop(self) -> None:
        self.shutdown()
        # A read replica never owns the journal: closing the shared
        # cluster would take the primary (and its watches) down with it.
        if not self.read_only:
            self.cluster.close()

    def read_replica(self, port: int = 0) -> "LocalApiServer":
        """A NOT-yet-started read-only replica over this server's
        cluster journal. Sharing the journal object is the in-process
        stand-in for journal replication: the replica serves LIST,
        delta-LIST, and watch windows with the primary's revision
        order, while every write it receives is refused with 405.
        Clients spread reads via ``RestConfig.read_servers`` and fail
        over to the primary when a replica dies mid-storm."""
        return LocalApiServer(
            cluster=self.cluster,
            port=port,
            token=self.token,
            bookmark_interval_s=self.bookmark_interval_s,
            apf=self.apf,
            read_only=True,
        )

    def serve_forever(self) -> None:  # pragma: no cover - CLI entry path
        """Block until interrupted (the __main__ demo path)."""
        if self._thread is None:
            self.start()
        self._thread.join()

    def __enter__(self) -> "LocalApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def kill_connections(self) -> int:
        """Force-close every live connection (test/fault hook: simulates
        the peer's TCP state vanishing mid-watch, the failure the
        bookmark-resume path exists for). Returns how many were hit."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return 0
        writers = list(self._writers)

        def _close_all():
            for writer in writers:
                transport = writer.transport
                if transport is not None:
                    transport.abort()

        loop.call_soon_threadsafe(_close_all)
        return len(writers)

    # -- connection handling ----------------------------------------------
    async def _serve_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self.connections_opened += 1
        self._writers.add(writer)
        served_on_connection = 0
        try:
            while True:
                # Sampled BEFORE the read blocks: bytes already buffered
                # while a previous response was in flight mean this next
                # request was pipelined — it shares the earlier request's
                # round trip (start_wire_log docstring).
                pipelined = served_on_connection > 0 and bool(
                    getattr(reader, "_buffer", b"")
                )
                try:
                    req = await _read_request(reader, writer)
                except BadRequestError as e:
                    await self._write_response(
                        writer, 400,
                        _status_body(400, "BadRequest", e.message),
                        "json", keep_alive=False,
                    )
                    return
                if req is None:
                    return
                self.requests_served += 1
                served_on_connection += 1
                request_log = self._request_log
                if request_log is not None:
                    request_log.append((req.method, req.path, dict(req.query)))
                wire_log = self._wire_log
                if wire_log is not None:
                    wire_log.append((req.method, req.path, pipelined))
                if self.read_only and req.method not in ("GET", "HEAD"):
                    await self._write_response(
                        writer, 405,
                        _status_body(
                            405, "MethodNotAllowed",
                            "read-only replica: send writes to the "
                            "primary apiserver",
                        ),
                        "json", keep_alive=req.keep_alive,
                    )
                    if not req.keep_alive:
                        return
                    continue
                scheduler = self._apf_scheduler
                # Server-side trace context (docs/tracing.md): a request
                # carrying a traceparent joins the CLIENT's trace — its
                # server span decomposes client-observed latency into
                # APF queue wait (the child span below) vs dispatch, and
                # any cluster write made during dispatch records this
                # trace as its write origin. One global read when off.
                tracer = tracing.tracer()
                server_span = None
                if tracer is not None:
                    trace_ctx = tracing.parse_traceparent(
                        req.header("traceparent")
                    )
                    server_span = tracer.start_span(
                        "server.request", category="wire",
                        trace_id=trace_ctx[0] if trace_ctx else None,
                        # "" (not None): an uncontexted request is a
                        # fresh root, never a child of a leaked span.
                        parent_id=trace_ctx[1] if trace_ctx else "",
                        attrs={"method": req.method, "path": req.path},
                    )
                try:
                    try:
                        if scheduler is not None:
                            flow = classify_flow(req.method, req.path)
                            enqueued = (
                                wall_now() if server_span is not None
                                else 0.0
                            )
                            dispatched = [0.0]

                            def _dispatch_traced(
                                req=req, server_span=server_span,
                                dispatched=dispatched,
                            ):
                                dispatched[0] = wall_now()
                                with tracing.use_span(server_span):
                                    return self._dispatcher.dispatch(req)

                            try:
                                result = await scheduler.submit(
                                    flow, _dispatch_traced
                                )
                            finally:
                                # Record the queue wait even when
                                # dispatch RAISED (routine 404/409 —
                                # error-heavy storms are exactly where
                                # queue attribution matters); a shed
                                # never dispatched, so dispatched[0]
                                # stays 0 and nothing is recorded.
                                if server_span is not None and (
                                    dispatched[0]
                                ):
                                    server_span.attrs["flow"] = flow
                                    tracer.add_span(
                                        "apf.queue", category="queue",
                                        start=enqueued,
                                        end=dispatched[0],
                                        parent=server_span,
                                        attrs={"flow": flow},
                                    )
                        else:
                            with tracing.use_span(server_span):
                                result = self._dispatcher.dispatch(req)
                    except _ApfShed:
                        # Shed, not queued: the flow is over its depth.
                        # The client backs off per Retry-After and
                        # retries; the connection stays healthy
                        # (keep-alive preserved).
                        if server_span is not None:
                            server_span.attrs["status"] = 429
                        await self._write_response(
                            writer, 429,
                            _status_body(
                                429, "TooManyRequests",
                                "request shed by priority-and-fairness; "
                                "retry after backoff",
                            ),
                            "json", keep_alive=req.keep_alive,
                            extra_headers={
                                "Retry-After": f"{self.apf.retry_after_s:g}"
                            },
                        )
                        if not req.keep_alive:
                            return
                        continue
                    except ApiError as e:
                        result = _Response(
                            e.status,
                            _status_body(e.status, e.reason, e.message),
                        )
                    except Exception as e:  # noqa: BLE001 - surfaced as 500
                        result = _Response(
                            500, _status_body(500, "InternalError", str(e))
                        )
                    if isinstance(result, _WatchParams):
                        if server_span is not None:
                            # The span measures dispatch, not the stream's
                            # lifetime; end it before streaming (end_span
                            # is idempotent for the finally below).
                            server_span.attrs["status"] = "watch"
                            tracer.end_span(server_span)
                        await self._stream_watch(writer, req, result)
                    else:
                        if server_span is not None:
                            server_span.attrs["status"] = result.status
                        encoding = (
                            "json"
                            if accepts_table(req.header("Accept"))
                            else negotiate_encoding(req.header("Accept"))
                        )
                        await self._write_response(
                            writer, result.status, result.body, encoding,
                            keep_alive=req.keep_alive,
                        )
                finally:
                    if server_span is not None:
                        tracer.end_span(server_span)
                if not req.keep_alive:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            return  # peer went away mid-exchange
        except asyncio.CancelledError:
            raise
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _write_response(
        self,
        writer: asyncio.StreamWriter,
        status: int,
        body: Optional[dict[str, Any]],
        encoding: str,
        keep_alive: bool,
        extra_headers: Optional[dict[str, str]] = None,
    ) -> None:
        payload = encode_body(body, encoding) if body is not None else b""
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}\r\n"
            f"Content-Type: {content_type_for(encoding)}\r\n"
            f"Content-Length: {len(payload)}\r\n"
        )
        for header_name, header_value in (extra_headers or {}).items():
            head += f"{header_name}: {header_value}\r\n"
        if not keep_alive:
            head += "Connection: close\r\n"
        data = head.encode("latin-1") + b"\r\n" + payload
        writer.write(data)
        self.bytes_sent += len(data)
        await writer.drain()

    # -- watch streaming ---------------------------------------------------
    async def _stream_watch(
        self, writer: asyncio.StreamWriter, req: _Request, params: _WatchParams
    ) -> None:
        """``?watch=true``: stream watch events as chunked frames on the
        held connection.

        Kubernetes watch semantics in the shape the library consumes:

        * ``resourceVersion=N`` resumes from the event journal — the
          list-then-watch pattern with no lost-event window (events since
          the listed revision replay first; an expired revision returns
          410 Gone and the client must re-list);
        * without ``resourceVersion``, events after establishment stream;
        * scope transitions follow the real apiserver: an object whose
          update makes it START matching the selector arrives as ADDED,
          one that STOPS matching arrives as DELETED;
        * a consumer too slow to drain its event queue loses the watch
          (stream ended at the last delivered revision) rather than
          silently losing events;
        * ``timeoutSeconds`` bounds the stream server-side — the window
          ends with the terminal chunk and the CONNECTION STAYS OPEN:
          the next watch window rides the same socket;
        * ``allowWatchBookmarks=true`` opts into periodic BOOKMARK frames
          carrying only the current collection resourceVersion, so a
          quiet (e.g. selector-scoped) watch keeps a fresh resume point
          and resumption does not decay into 410 + full re-list;
        * frames are encoded per the negotiated encoding (JSON lines or
          length-prefixed compact frames), and a Table-negotiated watch
          (``Accept: ...;as=Table`` — kubectl get -w) streams
          Table-transformed event frames.
        """
        info, namespace, query = params.info, params.namespace, params.query
        accept = req.header("Accept")
        as_table = accepts_table(accept)
        encoding = "json" if as_table else negotiate_encoding(accept)
        timeout_s = (
            float(query["timeoutSeconds"])
            if query.get("timeoutSeconds")
            else None
        )
        loop = asyncio.get_running_loop()
        events: asyncio.Queue = asyncio.Queue()
        overflowed = asyncio.Event()

        def emit(event_type, data, old):
            # Runs on the WRITER's thread (any cluster mutator) — or on
            # the loop thread itself when the mutation came through this
            # server; call_soon_threadsafe is correct from both. It must
            # NEVER raise into the mutator (FakeCluster._emit does not
            # isolate watcher errors): a loop torn down mid-teardown
            # reads as a dead stream, not a cluster write failure.
            def _put():
                if events.qsize() >= _WATCH_QUEUE_LIMIT:
                    overflowed.set()  # end the stream; the client resumes
                else:
                    events.put_nowait((event_type, data, old))

            try:
                loop.call_soon_threadsafe(_put)
            except RuntimeError:
                pass  # loop closed while the subscription unwound

        source = WatchFrameSource(
            self.cluster,
            info.kind,
            info.api_version,
            namespace=namespace,
            label_selector=query.get("labelSelector") or None,
            field_selector=query.get("fieldSelector") or None,
        )
        try:
            # Everything from open() on is covered by the unsubscribe
            # (close() is idempotent and safe pre-open): a cancellation
            # landing anywhere in the stream cannot leak the watcher.
            try:
                replay = source.open(emit, query.get("resourceVersion"))
            except ApiError as e:
                await self._write_response(
                    writer, e.status,
                    _status_body(e.status, e.reason, e.message),
                    "json" if as_table else encoding,
                    keep_alive=req.keep_alive,
                )
                return
            self.watch_streams += 1
            head = (
                "HTTP/1.1 200 OK\r\n"
                f"Content-Type: {content_type_for(encoding)}\r\n"
                "Transfer-Encoding: chunked\r\n"
                "\r\n"
            ).encode("latin-1")
            writer.write(head)
            self.bytes_sent += len(head)
            self.watch_bytes_sent += len(head)
            for frame, data in replay:
                await self._write_frame(
                    writer, frame, data, encoding, info, query, as_table
                )
            deadline = (
                loop.time() + timeout_s if timeout_s is not None else None
            )
            interval = self.bookmark_interval_s
            bookmarks = query.get("allowWatchBookmarks") in ("true", "1")
            next_bookmark = loop.time() + interval
            while not overflowed.is_set():
                if deadline is not None:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        break
                    poll = min(0.2, remaining)
                else:
                    poll = 0.2
                if bookmarks:
                    poll = min(poll, max(0.01, next_bookmark - loop.time()))
                try:
                    event_type, data, old = await asyncio.wait_for(
                        events.get(), poll
                    )
                except asyncio.TimeoutError:
                    if bookmarks and loop.time() >= next_bookmark:
                        # Bookmark only from a DRAINED queue — see
                        # WatchFrameSource.bookmark for the rv-before-
                        # emptiness-recheck ordering.
                        frame, data = source.bookmark()
                        if events.empty():
                            next_bookmark = loop.time() + interval
                            await self._write_frame(
                                writer, frame, data, encoding, info, query,
                                as_table,
                            )
                    continue
                mapped = source.classify(event_type, data, old)
                if mapped is None:
                    continue
                await self._write_frame(
                    writer, mapped, data, encoding, info, query, as_table
                )
            # Terminal chunk: the window is over, the connection lives on.
            writer.write(b"0\r\n\r\n")
            self.bytes_sent += 5
            self.watch_bytes_sent += 5
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            return  # consumer went away mid-stream
        finally:
            source.close()

    async def _write_frame(
        self,
        writer: asyncio.StreamWriter,
        event_type: str,
        data: dict[str, Any],
        encoding: str,
        info,
        query,
        as_table: bool,
    ) -> None:
        if as_table:
            # kubectl get -w: every event object — bookmarks included —
            # is Table-transformed, one row per event.
            data = self._dispatcher._table(self.cluster, info, [data], query)
        frame = encode_watch_frame(
            {"type": event_type, "object": data}, encoding
        )
        chunk = b"%x\r\n" % len(frame) + frame + b"\r\n"
        writer.write(chunk)
        self.watch_frames_sent += 1
        self.bytes_sent += len(chunk)
        self.watch_bytes_sent += len(chunk)
        await writer.drain()

    # -- kubeconfig emission ----------------------------------------------
    def write_kubeconfig(self, path: str, ca_file: str = "") -> str:
        """Write a kubeconfig pointing at this server (envtest does the
        same for its booted apiserver). It is written as JSON, which is
        YAML: kubectl and the port's ``RestConfig`` read it, and writing
        it needs no YAML library."""
        cluster_entry: dict[str, Any] = {"server": self.url}
        if self.tls:
            if ca_file:
                cluster_entry["certificate-authority"] = ca_file
            else:
                cluster_entry["insecure-skip-tls-verify"] = True
        user: dict[str, Any] = {}
        if self.token:
            user["token"] = self.token
        doc = {
            "apiVersion": "v1",
            "kind": "Config",
            "current-context": "local",
            "clusters": [{"name": "local", "cluster": cluster_entry}],
            "users": [{"name": "local-user", "user": user}],
            "contexts": [
                {
                    "name": "local",
                    "context": {"cluster": "local", "user": "local-user"},
                }
            ],
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
        return path


def main() -> None:  # pragma: no cover - manual demo entry point
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--port", type=int, default=8001)
    parser.add_argument("--token", default="")
    parser.add_argument(
        "--kubeconfig", default="", help="write a kubeconfig to this path"
    )
    args = parser.parse_args()
    server = LocalApiServer(port=args.port, token=args.token).start()
    try:
        if args.kubeconfig:
            server.write_kubeconfig(args.kubeconfig)
            print(f"kubeconfig written to {args.kubeconfig}", flush=True)
        print(f"serving in-memory cluster at {server.url}", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
    finally:
        server.stop()


if __name__ == "__main__":  # pragma: no cover
    main()
