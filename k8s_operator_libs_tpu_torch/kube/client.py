"""API errors by reason, and the client helpers the device class uses.

A subset of the JAX package's ``kube/client.py``. The operator's client
raises its own exception classes, which this package does not import; it
recognises them by their ``reason`` attribute, the API's ``Status.reason``
(``NotFound``, ``AlreadyExists``, ``Conflict``). The HTTP status cannot tell
them apart: ``AlreadyExists`` and ``Conflict`` are both 409.

The client itself is duck-typed: ``get``, ``create``, ``update`` and
``delete`` with the JAX package's signatures.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, TypeVar

T = TypeVar("T")


class ApiError(Exception):
    """An API error; ``reason`` is the ``Status.reason`` it carries."""

    reason = "InternalError"


class NotFoundError(ApiError):
    reason = "NotFound"


class AlreadyExistsError(ApiError):
    reason = "AlreadyExists"


class ConflictError(ApiError):
    """Optimistic-concurrency failure (stale resourceVersion)."""

    reason = "Conflict"


def has_reason(exc: BaseException, kind: type[ApiError]) -> bool:
    """Whether ``exc`` is an API error of ``kind``, whichever client's
    class raised it."""
    return getattr(exc, "reason", None) == kind.reason


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
