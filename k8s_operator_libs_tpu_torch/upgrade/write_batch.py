"""WriteBatcher: group commit for the state provider's PATCHes.

The JAX package's ``upgrade/write_batch.py``. The provider stages each
node's PATCH here instead of sending it, and the caller that finds no
flush running becomes the **leader**: it takes everything staged so far,
flushes it through the client's ``patch_many`` (``kube.client.patch_many``:
the client's own, else one ``patch`` a slot), hands each slot its result,
and flushes what was staged meanwhile before it steps down. The batch
window is the flush itself, so there is no timer and no thread of its
own, and a single caller makes batches of one: the serial path, write for
write.

* **Never staged under the provider's per-node mutex.** A stage may wait
  out a whole flush; holding a node's mutex across it would queue every
  other writer of that node behind the batch.
* **Each slot's error is its own.** A failed slot (a conflict, a timeout,
  the ``upgrade.write_batch_partial`` fault point) is raised to that
  slot's caller; its batchmates complete.
* **One order.** Flushes run one at a time and slots flush in the order
  they were staged, so two writes of one node land in that order.

Each flush is one ``write.flush`` span (category ``write``) with the
slots it sent (``writes``) and took (``staged``), under the caller's
current span. ``RestClient``'s own ``patch_many`` pipelines a group's
slots on one pooled connection (``kube/rest.py``), so a flush of N nodes
costs one round trip, as the JAX batcher's does; a client without one
sends a ``patch`` a slot.
"""

from __future__ import annotations

import threading
from typing import Any, Mapping

from ..kube.client import Client, patch_many
from ..utils import tracing
from ..utils.faultpoints import fault_point
from ..utils.log import get_logger

log = get_logger("upgrade.write_batch")

#: A fault point: one slot of a batch fails mid-flush while its batchmates
#: land.
WRITE_BATCH_FAULT_POINT = "upgrade.write_batch_partial"

#: How long a follower waits for its result: only a leader that died
#: without resolving its batch lets this pass.
STAGE_TIMEOUT_SECONDS = 120.0


class WriteBatchError(Exception):
    """A staged write got no result (its leader died, or the wait ran
    out): its outcome is unknown, as after a wire error."""


class _Entry:
    __slots__ = ("kind", "namespace", "name", "patch", "patch_type", "event", "result")

    def __init__(
        self, kind: str, namespace: str, name: str, patch: Mapping[str, Any], patch_type: str
    ) -> None:
        self.kind = kind
        self.namespace = namespace
        self.name = name
        self.patch = patch
        self.patch_type = patch_type
        self.event = threading.Event()
        self.result: Any = None  # the patched object or the slot's exception


class WriteBatcher:
    """Stages PATCHes and flushes them in batches over one client; one a
    provider. ``max_batch`` bounds a flush."""

    def __init__(self, client: Client, max_batch: int = 64) -> None:
        self._client = client
        self._max_batch = max(1, int(max_batch))
        self._lock = threading.Lock()
        self._pending: list[_Entry] = []
        self._flushing = False
        self._batches_flushed = 0
        self._writes_flushed = 0
        self._max_batch_seen = 0

    def stats(self) -> dict[str, int]:
        """Batches flushed, writes flushed and the largest batch, in all."""
        with self._lock:
            return {
                "batches_flushed": self._batches_flushed,
                "writes_flushed": self._writes_flushed,
                "max_batch": self._max_batch_seen,
            }

    def stage(
        self,
        kind: str,
        name: str,
        patch: Mapping[str, Any],
        patch_type: str = "merge",
        namespace: str = "",
    ) -> Any:
        """Stage one PATCH and wait for its result: the patched object, or
        this slot's error raised. The caller may lead the flush and carry
        its batchmates' writes."""
        entry = _Entry(kind, namespace, name, patch, patch_type)
        with self._lock:
            self._pending.append(entry)
            leader = not self._flushing
            if leader:
                self._flushing = True
        if leader:
            self._drain()
        elif not entry.event.wait(STAGE_TIMEOUT_SECONDS):
            entry.result = WriteBatchError(
                f"staged write for {kind}/{name} never flushed within {STAGE_TIMEOUT_SECONDS}s"
            )
        if isinstance(entry.result, BaseException):
            raise entry.result
        return entry.result

    def _drain(self) -> None:
        """Flush until nothing is staged, then step down. A flush that
        raises fails every slot in flight or staged, and is raised."""
        while True:
            with self._lock:
                if not self._pending:
                    self._flushing = False
                    return
                batch = self._pending[: self._max_batch]
                del self._pending[: len(batch)]
                self._max_batch_seen = max(self._max_batch_seen, len(batch))
            try:
                self._flush(batch)
            except BaseException as e:
                with self._lock:
                    leftovers, self._pending = self._pending, []
                    self._flushing = False
                for entry in batch + leftovers:
                    if not entry.event.is_set():
                        entry.result = WriteBatchError(
                            f"batch flush failed: {type(e).__name__}: {e}"
                        )
                        entry.event.set()
                raise

    def _flush(self, batch: list[_Entry]) -> None:
        """One flush: the fault point a slot, then the live slots grouped
        by (kind, namespace) in stage order, a ``patch_many`` a group."""
        live: list[_Entry] = []
        for entry in batch:
            act = fault_point(WRITE_BATCH_FAULT_POINT, node=entry.name, kind=entry.kind)
            if act is not None and act.exc is not None:
                entry.result = act.exc
                entry.event.set()
                continue
            live.append(entry)
        groups: dict[tuple[str, str], list[_Entry]] = {}
        for entry in live:
            groups.setdefault((entry.kind, entry.namespace), []).append(entry)
        with tracing.span("write.flush", category="write", writes=len(live), staged=len(batch)):
            for (kind, namespace), entries in groups.items():
                results = patch_many(
                    self._client,
                    kind,
                    [(e.name, e.patch, e.patch_type) for e in entries],
                    namespace=namespace,
                )
                for entry, result in zip(entries, results):
                    entry.result = result
                    entry.event.set()
        with self._lock:
            self._batches_flushed += 1
            self._writes_flushed += len(live)
