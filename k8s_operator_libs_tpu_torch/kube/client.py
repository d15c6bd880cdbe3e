"""API errors by reason, the client surface, and the client helpers.

A subset of the JAX package's ``kube/client.py``. The operator's client
raises its own exception classes, which this package does not import; it
recognises them by their ``reason`` attribute, the API's ``Status.reason``
(``NotFound``, ``AlreadyExists``, ``Conflict``, ...). The HTTP status
cannot tell them apart: ``AlreadyExists`` and ``Conflict`` are both 409.

The client itself is duck-typed: :class:`Client` names the methods the
device class, the state machine and the informer call, with the JAX
package's signatures. ``rest.RestClient`` is one; so is the JAX package's
in-memory cluster.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping, Optional, Protocol, Sequence, TypeVar

T = TypeVar("T")


class ApiError(Exception):
    """An API error; ``reason`` is the ``Status.reason`` it carries and
    ``status`` the HTTP code an API server answers it with."""

    status = 500
    reason = "InternalError"

    def __init__(self, message: str = "") -> None:
        super().__init__(message or self.reason)
        self.message = message or self.reason


class NotFoundError(ApiError):
    status = 404
    reason = "NotFound"


class AlreadyExistsError(ApiError):
    status = 409
    reason = "AlreadyExists"


class ConflictError(ApiError):
    """Optimistic-concurrency failure (stale resourceVersion)."""

    status = 409
    reason = "Conflict"


class BadRequestError(ApiError):
    """Malformed request parameters (400)."""

    status = 400
    reason = "BadRequest"


class InvalidError(ApiError):
    """The object failed validation (422)."""

    status = 422
    reason = "Invalid"


class WatchExpiredError(ApiError):
    """The watch's resume revision fell out of the server's event journal
    (410 Gone): the caller must re-list and start a fresh watch."""

    status = 410
    reason = "Expired"


class TooManyRequestsError(ApiError):
    """Shed by the server's flow control (429); ``retry_after_s`` is the
    server's Retry-After hint."""

    status = 429
    reason = "TooManyRequests"

    def __init__(self, message: str = "", retry_after_s: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s


class UnsupportedMediaTypeError(ApiError):
    """A patch content type the resource cannot take (415): an API server
    takes strategic merge patches only for built-in types; a custom
    resource takes JSON and merge patches."""

    status = 415
    reason = "UnsupportedMediaType"


class ListDelta:
    """A deltas-since-revision LIST's result: ``items`` is the current
    state of every object in scope that changed after the presented
    revision, ``deleted`` the ``(namespace, name)`` keys that left the
    collection or the selectors' scope, ``revision`` the collection
    revision a following watch resumes from. A server answers it only
    while the presented revision is inside its event journal.

    ``full=True`` means the server answered a full list instead (it
    predates delta lists): ``items`` is then the whole collection and
    ``deleted`` is empty, and the caller diffs it against its own store
    rather than fetch the same bytes again."""

    __slots__ = ("items", "deleted", "revision", "full")

    def __init__(
        self,
        items: list,
        deleted: list[tuple[str, str]],
        revision: str,
        full: bool = False,
    ) -> None:
        self.items = items
        self.deleted = deleted
        self.revision = revision
        self.full = full


class Client(Protocol):
    """The client operations the port calls. Objects come back as views
    with a ``.raw`` document (the port wraps them again by it); API
    errors carry their ``reason``."""

    def get(self, kind: str, name: str, namespace: str = "") -> Any: ...

    def list(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
        field_selector: Optional[str] = None,
    ) -> list: ...

    def create(self, obj: Any) -> Any: ...

    def update(self, obj: Any) -> Any: ...

    def patch(
        self,
        kind: str,
        name: str,
        namespace: str = "",
        patch: Any = None,
        patch_type: str = "merge",
    ) -> Any: ...

    def delete(self, kind: str, name: str, namespace: str = "") -> None: ...

    def watch(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
        field_selector: Optional[str] = None,
        timeout_seconds: Optional[int] = None,
        resource_version: Optional[str] = None,
        handle: Any = None,
        allow_bookmarks: bool = False,
    ) -> Iterator[tuple[str, Any]]:
        """Stream ``(event_type, object)`` watch events, resumed after
        ``resource_version`` (a revision that fell out of the server's
        journal raises an error of ``WatchExpiredError``'s reason); the
        stream ends after ``timeout_seconds`` or when ``handle`` is
        cancelled. ``allow_bookmarks`` opts into ``BOOKMARK`` events,
        which carry only a fresh resume revision."""
        ...

    def evict(self, pod_name: str, namespace: str = "") -> None:
        """Evict a pod through its eviction subresource."""
        ...

    def discover(self, group: str, version: str) -> list[dict[str, Any]]:
        """API discovery: the resources served under ``group/version``
        (``group=""`` is the core group) as APIResourceList entries
        (``{"name": plural, "kind": ..., "namespaced": ...}``); an error
        of ``NotFoundError``'s reason while the group/version is not yet
        discoverable. A client without it raises ``NotImplementedError``
        or has no such method, and crdutil then waits on the CRD's
        status instead."""
        ...


class ClientBase(Client):
    """The methods the JAX package's ``Client`` base class gives every
    client, for the port's clients that subclass it (the in-memory
    cluster and ``CachedClient``): ``patch_many`` as a serial loop over
    ``patch`` with each slot's error isolated, ``get_or_none`` and
    ``delete_if_exists``."""

    def patch_many(
        self,
        kind: str,
        patches: Sequence[tuple[str, Any, str]],
        namespace: str = "",
        field_manager: str = "",
        dry_run: bool = False,
    ) -> list:
        results: list = []
        for name, patch, patch_type in patches:
            try:
                results.append(
                    self.patch(
                        kind,
                        name,
                        namespace=namespace,
                        patch=patch,
                        patch_type=patch_type,
                        field_manager=field_manager,
                        dry_run=dry_run,
                    )
                )
            except Exception as e:  # noqa: BLE001 - per-item isolation
                results.append(e)
        return results

    def get_or_none(self, kind: str, name: str, namespace: str = "") -> Optional[Any]:
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def delete_if_exists(self, kind: str, name: str, namespace: str = "") -> bool:
        try:
            self.delete(kind, name, namespace)
            return True
        except NotFoundError:
            return False


def has_reason(exc: BaseException, kind: type[ApiError]) -> bool:
    """Whether ``exc`` is an API error of ``kind``, whichever client's
    class raised it."""
    return getattr(exc, "reason", None) == kind.reason


def is_api_error(exc: BaseException) -> bool:
    """An API error of any client: it carries the API's ``reason``."""
    return isinstance(getattr(exc, "reason", None), str)


def get_or_none(client, kind: str, name: str, namespace: str = "") -> Optional[Any]:
    """``client.get``, or ``None`` where the object does not exist."""
    try:
        return client.get(kind, name, namespace)
    except Exception as e:  # noqa: BLE001 - the client's own classes
        if has_reason(e, NotFoundError):
            return None
        raise


def delete_if_exists(client, kind: str, name: str, namespace: str = "") -> bool:
    """``client.delete``; ``False`` where the object did not exist."""
    try:
        client.delete(kind, name, namespace)
        return True
    except Exception as e:  # noqa: BLE001 - the client's own classes
        if has_reason(e, NotFoundError):
            return False
        raise


def patch_many(
    client,
    kind: str,
    patches: Sequence[tuple[str, Any, str]],
    namespace: str = "",
) -> list:
    """Patch a batch of ``kind`` objects, ``(name, patch, patch_type)`` a
    slot: through the client's own ``patch_many`` where it has one, else
    one ``client.patch`` a slot in order (the JAX base
    ``Client.patch_many``). ``rest.RestClient``'s own pipelines the slots
    on one connection. Each slot's result is the patched
    object or the exception that slot raised; a failed slot never fails
    the others."""
    own = getattr(client, "patch_many", None)
    if callable(own):
        return own(kind, list(patches), namespace=namespace)
    results: list = []
    for name, patch, patch_type in patches:
        try:
            results.append(
                client.patch(kind, name, namespace=namespace, patch=patch, patch_type=patch_type)
            )
        except Exception as e:  # noqa: BLE001 - per-slot isolation
            results.append(e)
    return results


def retry_on_conflict(fn: Callable[[], T], attempts: int = 5) -> T:
    """Run ``fn``, again on a conflict, at most ``attempts`` times; the last
    conflict is raised."""
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - the client's own classes
            if not has_reason(e, ConflictError) or attempt == attempts - 1:
                raise
    raise ValueError(f"attempts must be at least 1, not {attempts}")
