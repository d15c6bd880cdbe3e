"""A read cache with explicit, controllable staleness.

The port's copy of the JAX package's ``kube/cache.py``: ``CachedClient``
over the port's :class:`~.fake.FakeCluster`, the first cached reader the
state provider's read-back (``reader=``) waits on in the port. ``close``
stops the auto mode's thread and joins it.

The reference reads through a controller-runtime watch cache that may lag the
apiserver; the state provider's correctness hinges on waiting until its own
write becomes visible in that cache (reference:
pkg/upgrade/node_upgrade_state_provider.go:92-117). This module makes that
staleness a first-class, testable property instead of an accident of the
environment:

* ``sync_mode="passthrough"`` — reads hit the backing store directly,
* ``sync_mode="manual"`` — reads serve a snapshot; tests advance it with
  :meth:`sync` to provoke exactly the staleness window the reference's
  cache-coherence poll exists for,
* ``sync_mode="auto"`` — a background thread applies watch events after
  ``lag_seconds``, emulating a live watch cache.

Writes always go straight to the backing cluster (as with controller-runtime,
where only reads are cached).

This cache intentionally wraps :class:`~.fake.FakeCluster` only — it is the
test/simulation harness's staleness model. Against a real cluster the REST
client reads the apiserver directly; a production watch cache is out of scope
for the framework (consumers embed it in their own controller runtime).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Mapping, Optional

from .client import ClientBase, NotFoundError
from .fake import FakeCluster, deep_copy_json
from .objects import KubeObject, wrap
from .selectors import LabelSelector, parse_field_selector, parse_selector


class CachedClient(ClientBase):
    def __init__(
        self,
        backing: FakeCluster,
        sync_mode: str = "passthrough",
        lag_seconds: float = 0.05,
    ) -> None:
        if sync_mode not in ("passthrough", "manual", "auto"):
            raise ValueError(f"unknown sync_mode {sync_mode!r}")
        self.backing = backing
        self.sync_mode = sync_mode
        self.lag_seconds = lag_seconds
        self._lock = threading.Condition()
        self._snapshot: dict[tuple[str, str, str], dict[str, Any]] = {}
        self._stop = threading.Event()
        if sync_mode != "passthrough":
            self.sync()
        if sync_mode == "auto":
            self._thread = threading.Thread(target=self._auto_sync, daemon=True)
            self._thread.start()

    # -- cache control -----------------------------------------------------
    def sync(self) -> None:
        """Make the cache consistent with the backing store right now."""
        with self.backing._lock:
            fresh = deep_copy_json(self.backing._store)
        with self._lock:
            self._snapshot = fresh
            self._lock.notify_all()

    def _auto_sync(self) -> None:
        # Track the backing write generation so a notification lost while we
        # were outside wait_for_change cannot leave the cache stale forever.
        seen = -1
        while not self._stop.is_set():
            gen = self.backing.wait_for_change(timeout=0.2, after_generation=seen)
            if self._stop.is_set():
                return
            if gen > seen:
                # Apply the change only after the configured lag.
                self._stop.wait(self.lag_seconds)
                self.sync()
                seen = gen

    def close(self) -> None:
        """Stop the auto mode's thread and wait for it (at most its poll
        tick plus the lag), so no thread outlives the cache."""
        self._stop.set()
        thread = getattr(self, "_thread", None)
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=1.0 + self.lag_seconds)

    def wait_until(
        self, predicate: Callable[["CachedClient"], bool], timeout: float
    ) -> bool:
        """Block until ``predicate(self)`` holds, waking on every cache sync.

        This replaces the reference's fixed 1 s cache-coherence polling loop
        (reference: node_upgrade_state_provider.go:100-117) with an
        event-driven wait: the caller wakes as soon as the cache catches up
        instead of on the next poll tick.
        """
        if self.sync_mode == "passthrough":
            return predicate(self)
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                if predicate(self):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return predicate(self)
                self._lock.wait(min(remaining, 0.5))

    # -- reads (cached) ----------------------------------------------------
    def get(self, kind: str, name: str, namespace: str = "") -> KubeObject:
        if self.sync_mode == "passthrough":
            return self.backing.get(kind, name, namespace)
        key = FakeCluster._key(kind, namespace, name)
        with self._lock:
            data = self._snapshot.get(key)
            if data is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found (cache)")
            return wrap(deep_copy_json(data))

    def list(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
        field_selector: Optional[str] = None,
    ) -> list[KubeObject]:
        if self.sync_mode == "passthrough":
            return self.backing.list(kind, namespace, label_selector, field_selector)
        if isinstance(label_selector, Mapping):
            selector = LabelSelector.from_match_labels(label_selector)
        else:
            selector = parse_selector(label_selector)
        fields = parse_field_selector(field_selector)
        out = []
        with self._lock:
            for (k, ns, _), data in sorted(self._snapshot.items()):
                if k != kind:
                    continue
                if namespace and ns != namespace:
                    continue
                labels = (data.get("metadata") or {}).get("labels") or {}
                if not selector.matches(labels):
                    continue
                if not fields.matches(data):
                    continue
                out.append(wrap(deep_copy_json(data)))
        return out

    # -- writes (pass through) ---------------------------------------------
    def create(
        self, obj: KubeObject, field_manager: str = "",
        dry_run: bool = False,
    ) -> KubeObject:
        return self.backing.create(
            obj, field_manager=field_manager, dry_run=dry_run
        )

    def apply(
        self,
        obj: KubeObject | Mapping[str, Any],
        field_manager: str,
        force: bool = False,
        dry_run: bool = False,
    ) -> KubeObject:
        return self.backing.apply(
            obj, field_manager, force=force, dry_run=dry_run
        )

    def update(
        self, obj: KubeObject, field_manager: str = "",
        dry_run: bool = False,
    ) -> KubeObject:
        return self.backing.update(
            obj, field_manager=field_manager, dry_run=dry_run
        )

    def update_status(
        self, obj: KubeObject, field_manager: str = "",
        dry_run: bool = False,
    ) -> KubeObject:
        return self.backing.update_status(
            obj, field_manager=field_manager, dry_run=dry_run
        )

    def patch(
        self,
        kind: str,
        name: str,
        namespace: str = "",
        patch: Optional[Mapping[str, Any] | list[Any]] = None,
        patch_type: str = "merge",
        field_manager: str = "",
        dry_run: bool = False,
    ) -> KubeObject:
        return self.backing.patch(
            kind,
            name,
            namespace,
            patch,
            patch_type=patch_type,
            field_manager=field_manager,
            dry_run=dry_run,
        )

    def delete(
        self,
        kind: str,
        name: str,
        namespace: str = "",
        grace_period_seconds: Optional[int] = None,
        propagation_policy: Optional[str] = None,
        precondition_uid: Optional[str] = None,
        precondition_resource_version: Optional[str] = None,
        dry_run: bool = False,
    ) -> None:
        return self.backing.delete(
            kind,
            name,
            namespace,
            grace_period_seconds,
            propagation_policy=propagation_policy,
            precondition_uid=precondition_uid,
            precondition_resource_version=precondition_resource_version,
            dry_run=dry_run,
        )

    def delete_collection(
        self,
        kind: str,
        namespace: str = "",
        label_selector=None,
        field_selector=None,
        propagation_policy=None,
        dry_run: bool = False,
    ):
        return self.backing.delete_collection(
            kind,
            namespace,
            label_selector=label_selector,
            field_selector=field_selector,
            propagation_policy=propagation_policy,
            dry_run=dry_run,
        )

    def evict(
        self, pod_name: str, namespace: str = "", dry_run: bool = False
    ) -> None:
        return self.backing.evict(pod_name, namespace, dry_run=dry_run)

    def discover(self, group: str, version: str) -> list:
        # Discovery is never cached (the poll exists to observe the
        # apiserver's CURRENT routing table).
        return self.backing.discover(group, version)
