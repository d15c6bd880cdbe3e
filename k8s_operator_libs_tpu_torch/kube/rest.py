"""A minimal Kubernetes API client on ``urllib``: what the monitor and the
payload's report publisher need to run in a pod.

:meth:`RestClient.from_environment` takes the in-cluster service account
first (its token and CA under ``/var/run/secrets/kubernetes.io/
serviceaccount``, the API server from ``KUBERNETES_SERVICE_HOST`` and
``_PORT``), else ``$KUBECONFIG`` (or ``~/.kube/config``). A kubeconfig is
read as JSON, which kubectl also accepts; a YAML one needs PyYAML, and
the error says so where it is missing.

The operations are those of the operator's client: ``get``,
``get_or_none``, ``list`` and ``list_with_revision`` (label and field
selectors; the latter also returns the collection's resourceVersion),
``watch`` (a bounded stream of watch events, resumable from a revision
and cancelled through a :class:`WatchHandle`), ``create``, ``update``,
``update_status``, ``patch`` (the JAX client's pipelined ``patch_many``
on one connection waits for ROADMAP A18; until then the write batcher
sends one ``patch`` a slot), ``delete`` and ``evict`` (the pod's eviction subresource), on Node,
Pod, Service, Event, DaemonSet, ControllerRevision, NodeHealthReport,
NodeMaintenance, WorkloadCheckpoint and CustomResourceDefinition; and
``discover``, the API's discovery document of one group/version. Objects come back as the views of
``kube/objects.py``. An API error is raised with the API's
``Status.reason``, as the classes of ``kube/client.py`` where it is one of
theirs, so ``has_reason`` and ``retry_on_conflict`` read it.

With a tracer installed (``utils/tracing.py``) every request made under a
span, a watch's included, carries its ``traceparent`` header, so the
server's span joins the caller's trace, and each call of ``_request`` is
one ``http.request`` span (category ``wire``, with ``method``, ``path``
and the response's ``status``). The JAX transport's shed retries and
their ``http.attempt`` and ``http.backoff`` spans, and its pipelined
``http.request_many``, wait for ROADMAP A18.
"""

from __future__ import annotations

import atexit
import base64
import http.client
import json
import os
import socket
import ssl
import tempfile
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Optional

from ..api.telemetry_v1alpha1 import NODE_HEALTH_REPORT_API_VERSION
from ..api.upgrade_v1alpha1 import (
    WORKLOAD_CHECKPOINT_API_VERSION,
    WORKLOAD_CHECKPOINT_KIND,
    WORKLOAD_CHECKPOINT_PLURAL,
)
from .client import (
    AlreadyExistsError,
    ApiError,
    BadRequestError,
    ConflictError,
    InvalidError,
    NotFoundError,
    TooManyRequestsError,
    WatchExpiredError,
)
from .objects import KubeObject, wrap
from ..utils import tracing

#: Where a pod's service-account credentials are mounted.
SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

#: kind -> (apiVersion, plural, namespaced).
RESOURCES: dict[str, tuple[str, str, bool]] = {
    "Node": ("v1", "nodes", False),
    "Pod": ("v1", "pods", True),
    "Service": ("v1", "services", True),
    "Event": ("v1", "events", True),
    "DaemonSet": ("apps/v1", "daemonsets", True),
    "ControllerRevision": ("apps/v1", "controllerrevisions", True),
    "NodeHealthReport": (NODE_HEALTH_REPORT_API_VERSION, "nodehealthreports", False),
    "NodeMaintenance": ("maintenance.nvidia.com/v1alpha1", "nodemaintenances", True),
    WORKLOAD_CHECKPOINT_KIND: (WORKLOAD_CHECKPOINT_API_VERSION, WORKLOAD_CHECKPOINT_PLURAL, True),
    "CustomResourceDefinition": (
        "apiextensions.k8s.io/v1", "customresourcedefinitions", False,
    ),
}

_ERRORS = {
    cls.reason: cls
    for cls in (
        NotFoundError, AlreadyExistsError, ConflictError, BadRequestError,
        InvalidError, TooManyRequestsError, WatchExpiredError,
    )
}

#: The stream bound of a watch called without ``timeout_seconds``. An
#: unbounded watch would need an unbounded socket read, which parks on a
#: half-open connection for ever; bounded windows resumed from the last
#: revision are the shape client-go's reflector takes for the same reason.
DEFAULT_WATCH_TIMEOUT_SECONDS = 300

_PATCH_TYPES = {
    "merge": "application/merge-patch+json",
    "strategic": "application/strategic-merge-patch+json",
    "json": "application/json-patch+json",
}


class RestConfigError(Exception):
    """No usable credentials were found."""


class WatchHandle:
    """Cancels a streaming watch from another thread. The consumer is
    parked in a socket read that no flag can interrupt, so ``cancel()``
    shuts the stream's socket down, which ends the read and the generator.
    ``_sock`` is that socket once the stream is open (the sign that the
    watch is live)."""

    def __init__(self) -> None:
        self._sock: Optional[socket.socket] = None
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closed


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
    """Where the API server is and how to authenticate to it."""

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


def _api_error(code: int, body: bytes) -> ApiError:
    try:
        status = json.loads(body or b"{}")
    except ValueError:
        status = {}
    reason = status.get("reason") or ""
    message = status.get("message") or body.decode(errors="replace")[:500] or f"HTTP {code}"
    cls = _ERRORS.get(reason)
    if cls is None and code == 410:
        cls = WatchExpiredError  # Gone: a revision the server no longer holds
    error = cls(message) if cls is not None else ApiError(message)
    if cls is None and reason:
        error.reason = reason
    error.code = code
    return error


class RestClient:
    """The operator's client operations over HTTP (see the module doc)."""

    def __init__(self, config: RestConfig, timeout: float = 30.0) -> None:
        self.config = config
        self.timeout = timeout
        self._ssl = config.ssl_context()

    @classmethod
    def from_environment(cls, sa_dir: str = SERVICE_ACCOUNT_DIR) -> "RestClient":
        return cls(RestConfig.from_environment(sa_dir))

    def close(self) -> None:
        """Remove the credential files the config wrote."""
        for path in self.config.temp_files:
            _remove(path)
        self.config.temp_files.clear()

    # -- plumbing ------------------------------------------------------------
    def _path(self, kind: str, namespace: str = "", name: str = "", sub: str = "") -> str:
        try:
            api_version, plural, namespaced = RESOURCES[kind]
        except KeyError:
            raise ValueError(f"kind {kind!r} is not one this client serves") from None
        prefix = f"/apis/{api_version}" if "/" in api_version else f"/api/{api_version}"
        parts = [prefix]
        if namespaced and namespace:
            parts.append(f"/namespaces/{urllib.parse.quote(namespace)}")
        parts.append(f"/{plural}")
        if name:
            parts.append(f"/{urllib.parse.quote(name)}")
            if sub:
                parts.append(f"/{sub}")
        return "".join(parts)

    def _namespace(self, kind: str, namespace: str) -> str:
        return namespace or (self.config.namespace if RESOURCES[kind][2] else "")

    def _headers(self) -> dict[str, str]:
        headers = {"Accept": "application/json"}
        if self.config.token:
            headers["Authorization"] = f"Bearer {self.config.token}"
        traceparent = tracing.traceparent()
        if traceparent is not None:
            headers["traceparent"] = traceparent
        return headers

    def _request(self, method: str, path: str, body: Any = None,
                 content_type: str = "application/json",
                 query: Optional[Mapping[str, str]] = None) -> Any:
        url = self.config.server.rstrip("/") + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = None
        if body is not None:
            data = json.dumps(body).encode()
        with tracing.span("http.request", category="wire", method=method, path=path) as span:
            # Headers inside the span: the traceparent names this request.
            headers = self._headers()
            if data is not None:
                headers["Content-Type"] = content_type
            request = urllib.request.Request(url, data=data, method=method, headers=headers)
            try:
                with urllib.request.urlopen(
                    request, timeout=self.timeout, context=self._ssl
                ) as resp:
                    if span is not None:
                        span.attrs["status"] = resp.status
                    payload = resp.read()
            except urllib.error.HTTPError as e:
                if span is not None:
                    span.attrs["status"] = e.code
                raise _api_error(e.code, e.read()) from None
        return json.loads(payload) if payload else None

    def _connection(self, timeout: float) -> http.client.HTTPConnection:
        """A connection of its own to the server (``urllib``'s transport,
        whose socket ``urlopen`` hides until the response's headers)."""
        url = urllib.parse.urlsplit(self.config.server)
        if url.scheme == "https":
            return http.client.HTTPSConnection(
                url.hostname, url.port, timeout=timeout, context=self._ssl
            )
        return http.client.HTTPConnection(url.hostname, url.port, timeout=timeout)

    @property
    def _base_path(self) -> str:
        """The server URL's own path, which every API path extends."""
        return urllib.parse.urlsplit(self.config.server).path.rstrip("/")

    @staticmethod
    def _selector_query(label_selector: Optional[str | Mapping[str, str]],
                        field_selector: Optional[str]) -> dict[str, str]:
        query = {}
        if isinstance(label_selector, Mapping):
            label_selector = ",".join(f"{k}={v}" for k, v in label_selector.items())
        if label_selector:
            query["labelSelector"] = label_selector
        if field_selector:
            query["fieldSelector"] = field_selector
        return query

    @staticmethod
    def _wrap(kind: str, data: dict) -> KubeObject:
        data.setdefault("kind", kind)
        data.setdefault("apiVersion", RESOURCES[kind][0])
        return wrap(data)

    # -- operations ----------------------------------------------------------
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
        an empty list has too. One request, unpaged: the ``limit`` and
        ``continue`` pager of the operator's client waits for ROADMAP
        A18."""
        body = self._request(
            "GET", self._path(kind, namespace),
            query=self._selector_query(label_selector, field_selector),
        ) or {}
        items = [self._wrap(kind, item) for item in body.get("items") or []]
        return items, str((body.get("metadata") or {}).get("resourceVersion", ""))

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
        ends with it; the socket read times out a client timeout later,
        so a half-open connection cannot park the caller. An ``ERROR``
        frame inside the stream raises its ``Status``'s error.
        ``allow_bookmarks`` asks for ``BOOKMARK`` events, which carry only
        a fresh resume revision. ``handle.cancel()`` ends the stream from
        another thread. Each watch takes a connection of its own, on
        ``http.client`` (the transport under ``urllib``), so that the
        handle holds its socket from the connect on.
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
        path = self._path(kind, namespace) + "?" + urllib.parse.urlencode(query)
        handle = handle if handle is not None else WatchHandle()
        conn = self._connection(timeout_seconds + self.timeout)
        try:
            try:
                conn.connect()
                # Known to the handle from the connect on: a server that
                # takes the request and never answers cannot park a cancel.
                handle._sock = conn.sock
                if handle.cancelled:
                    return
                conn.request("GET", self._base_path + path, headers=self._headers())
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException) as e:
                if handle.cancelled:
                    return
                raise ApiError(f"GET {path}: watch failed: {e}") from None
            if resp.status >= 300:
                raise _api_error(resp.status, resp.read())
            while not handle.cancelled:
                try:
                    line = resp.readline()
                except (OSError, http.client.HTTPException) as e:
                    if handle.cancelled:
                        return
                    raise ApiError(f"GET {path}: watch stream died: {e}") from None
                if not line:
                    return  # the server ended the stream
                if not line.strip():
                    continue
                event = json.loads(line)
                if event.get("type") == "ERROR":
                    status = event.get("object") or {}
                    raise _api_error(int(status.get("code") or 500), json.dumps(status).encode())
                yield event["type"], self._wrap(kind, event["object"])
        finally:
            conn.close()

    def create(self, obj: KubeObject) -> KubeObject:
        kind = obj.raw.get("kind", "")
        path = self._path(kind, self._namespace(kind, obj.namespace))
        return self._wrap(kind, self._request("POST", path, obj.raw))

    def update(self, obj: KubeObject) -> KubeObject:
        kind = obj.raw.get("kind", "")
        path = self._path(kind, self._namespace(kind, obj.namespace), obj.name)
        return self._wrap(kind, self._request("PUT", path, obj.raw))

    def update_status(self, obj: KubeObject) -> KubeObject:
        kind = obj.raw.get("kind", "")
        path = self._path(kind, self._namespace(kind, obj.namespace), obj.name, "status")
        return self._wrap(kind, self._request("PUT", path, obj.raw))

    def patch(self, kind: str, name: str, namespace: str = "",
              patch: Any = None, patch_type: str = "merge") -> KubeObject:
        path = self._path(kind, self._namespace(kind, namespace), name)
        body = self._request(
            "PATCH", path, patch if patch is not None else {},
            content_type=_PATCH_TYPES[patch_type],
        )
        return self._wrap(kind, body)

    def discover(self, group: str, version: str) -> list[dict]:
        """The resources the API serves under ``group/version`` (the core
        group when ``group`` is empty): the discovery document's
        ``resources``. A group/version not (yet) discoverable is a 404,
        raised as ``NotFoundError``."""
        path = f"/apis/{group}/{version}" if group else f"/api/{version}"
        doc = self._request("GET", path) or {}
        return list(doc.get("resources") or [])

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        self._request("DELETE", self._path(kind, self._namespace(kind, namespace), name))

    def evict(self, pod_name: str, namespace: str = "") -> None:
        """Evict a pod through its policy/v1 Eviction subresource, as
        ``kubectl drain`` does."""
        namespace = self._namespace("Pod", namespace)
        body = {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": pod_name, "namespace": namespace},
        }
        self._request("POST", self._path("Pod", namespace, pod_name, "eviction"), body)
