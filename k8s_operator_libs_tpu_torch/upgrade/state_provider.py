"""NodeUpgradeStateProvider: the one writer of a node's upgrade state.

The JAX package's ``upgrade/state_provider.py`` without its cached reader
(ROADMAP A17). All upgrade state lives on the node (a state label
and a few annotations), which keeps the controller stateless and a pass
resumable after any crash. Every write goes through here, so that:

1. the writes of one node are serialized by a mutex per node, whichever
   manager's task makes them;
2. a write is checked before the caller goes on: the PATCH response (or,
   from a client that returns none, the node read back) must hold the
   values written;
3. a key that already holds its target value is not written (the provider
   is its only writer, so the node in hand is authoritative), and a node's
   label and annotation changes of one step go in one PATCH.

Two more, wired by the state machine: a **write-through**
(:meth:`NodeUpgradeStateProvider.set_write_through`) hands every patched
node to the informer snapshot source's store, so the next pass reads its
own writes before the watch brings them; and a **write batcher**
(:meth:`NodeUpgradeStateProvider.set_batcher`, ``write_batch.py``) through
which the PATCHes of a bucket's nodes share flushes. A batched write is
staged outside the node's mutex: under it the no-op check and an
optimistic update of the node in hand, then the stage with no lock held,
then under it again the count, the write-through and the check. A failed
stage rolls back each key that still holds the optimistic value.

Deleting an annotation is asked for by the value ``"null"``, which becomes
a JSON ``null`` in the merge patch. Each state label written is a
``state.transition`` event (``node``, ``frm``, ``to``, ``cause``) on the
current span: the bucket span that made it, whose parent is the pass.
"""

from __future__ import annotations

import threading
from typing import Callable, Mapping, Optional, Protocol, Union

from ..kube.client import Client
from ..kube.objects import KubeObject, Node
from ..utils import tracing
from ..utils.log import get_logger
from ..utils.sync import KeyedMutex
from .consts import NULL_STRING, UpgradeKeys, UpgradeState
from .write_batch import WriteBatcher

log = get_logger("upgrade.state_provider")


class _Recorder(Protocol):
    def eventf(self, obj, event_type, reason, fmt, *args) -> None: ...


class StateWriteError(Exception):
    """A state write whose result disagrees with what was written."""


class NodeUpgradeStateProvider:
    def __init__(
        self,
        client: Client,
        keys: UpgradeKeys,
        recorder: Optional[_Recorder] = None,
    ) -> None:
        self._client = client
        self._keys = keys
        self._recorder = recorder
        self._mutex = KeyedMutex()
        self._write_through: Optional[Callable[[KubeObject], None]] = None
        self._batcher: Optional[WriteBatcher] = None
        self._counter_lock = threading.Lock()
        self._writes_issued = 0
        self._writes_skipped = 0
        self._writes_coalesced = 0
        self._writes_batched = 0

    # -- wiring ------------------------------------------------------------
    def set_write_through(self, fn: Optional[Callable[[KubeObject], None]]) -> None:
        """``fn`` is called, under the node's mutex, with every patched
        node: the informer snapshot source's read-your-writes."""
        self._write_through = fn

    def set_batcher(self, batcher: Optional[WriteBatcher]) -> None:
        """Stage every later write through ``batcher`` (None: send each
        one itself). The batcher must write to the same API server."""
        self._batcher = batcher

    # -- write accounting --------------------------------------------------
    def write_stats(self) -> dict[str, int]:
        """Every write counter in one consistent read: ``issued`` PATCHes,
        ``skipped`` no-ops, ``coalesced`` keys that rode another key's
        PATCH, ``batched`` PATCHes staged through the batcher."""
        with self._counter_lock:
            return {
                "issued": self._writes_issued,
                "skipped": self._writes_skipped,
                "coalesced": self._writes_coalesced,
                "batched": self._writes_batched,
            }

    def _count_write(self, skipped: bool, coalesced: int = 0, batched: bool = False) -> None:
        with self._counter_lock:
            if skipped:
                self._writes_skipped += 1
            else:
                self._writes_issued += 1
                self._writes_coalesced += coalesced
                if batched:
                    self._writes_batched += 1

    # -- reads -------------------------------------------------------------
    def get_node(self, name: str) -> Node:
        """The node, read under its mutex like every write."""
        with self._mutex.locked(name):
            return Node(self._client.get("Node", name).raw)

    def get_upgrade_state(self, node: Node) -> UpgradeState:
        raw = (node.metadata.get("labels") or {}).get(self._keys.state_label, "")
        try:
            return UpgradeState(raw)
        except ValueError:
            log.warning("node %s has unrecognized upgrade state %r", node.name, raw)
            return UpgradeState.UNKNOWN

    # -- writes ------------------------------------------------------------
    def _event(self, node: Node, fmt: str, *args) -> None:
        self._recorder.eventf(node, "Normal", self._keys.event_reason(), fmt, *args)

    def change_node_upgrade_state(self, node: Node, new_state: Union[UpgradeState, str]) -> None:
        """Write the node's state label."""
        self.change_node_state_and_annotations(node, new_state, {})

    def change_node_upgrade_annotation(self, node: Node, key: str, value: str) -> None:
        """Write (or with ``"null"``, delete) one node annotation."""
        _, applied = self._write_keys(
            node,
            labels={},
            annotations={key: None if value == NULL_STRING else value},
            what=f"annotation {key}={value}",
        )
        if applied and self._recorder is not None:
            self._event(node, "Node upgrade annotation %s set to %s", key, value)

    def change_node_state_and_annotations(
        self,
        node: Node,
        new_state: Union[UpgradeState, str],
        annotations: Mapping[str, str],
    ) -> None:
        """One PATCH for the node's state transition and the given
        annotation writes (``"null"`` deletes); keys already at their
        target are left out, and nothing is sent when all are."""
        new_state = UpgradeState(new_state)
        value: Optional[str] = str(new_state) if new_state != UpgradeState.UNKNOWN else None
        ann = {k: (None if v == NULL_STRING else v) for k, v in annotations.items()}
        applied_labels, applied_ann = self._write_keys(
            node,
            labels={self._keys.state_label: value},
            annotations=ann,
            what=f"state={new_state or '<cleared>'}"
            + (f"+annotations {','.join(sorted(ann))}" if ann else ""),
        )
        if self._recorder is None:
            return
        if applied_labels:
            self._event(node, "Node upgrade state set to %s", str(new_state) or "<cleared>")
        for key in applied_ann:
            self._event(node, "Node upgrade annotation %s set to %s", key, annotations[key])

    def _write_keys(
        self,
        node: Node,
        labels: Mapping[str, Optional[str]],
        annotations: Mapping[str, Optional[str]],
        what: str,
    ) -> tuple[dict[str, Optional[str]], dict[str, Optional[str]]]:
        """Write the label and annotation targets (``None`` deletes) in one
        PATCH; the ``(labels, annotations)`` that changed (both empty:
        nothing was written). Without a batcher all of it runs under the
        node's mutex; with one the stage runs outside it (see the module
        doc)."""
        with self._mutex.locked(node.name):
            lab_changes = {k: v for k, v in labels.items() if node.labels.get(k) != v}
            ann_changes = {
                k: v for k, v in annotations.items() if node.annotations.get(k) != v
            }
            if not lab_changes and not ann_changes:
                self._count_write(skipped=True)
                return {}, {}
            prev_labels = {k: node.labels.get(k) for k in lab_changes}
            prev_annotations = {k: node.annotations.get(k) for k in ann_changes}
            meta: dict = {}
            if lab_changes:
                meta["labels"] = dict(lab_changes)
            if ann_changes:
                meta["annotations"] = dict(ann_changes)
            patch = {"metadata": meta}
            # A strategic merge patch for a pure label write, as the
            # upstream library sends; a merge patch where annotations go
            # too. For maps of strings the two agree.
            patch_type = "strategic" if lab_changes and not ann_changes else "merge"
            batcher = self._batcher
            if batcher is None:
                patched = self._client.patch(
                    "Node", node.name, patch=patch, patch_type=patch_type
                )
                self._commit_write(
                    node, patched, lab_changes, ann_changes, prev_labels, what, batched=False
                )
                return lab_changes, ann_changes
            # The values go into the node in hand now, so a concurrent
            # writer's no-op check sees them while the mutex is released.
            self._apply_in_memory(node, lab_changes, ann_changes)
        try:
            patched = batcher.stage("Node", node.name, patch, patch_type=patch_type)
        except BaseException:
            with self._mutex.locked(node.name):
                self._rollback_write(
                    node, lab_changes, ann_changes, prev_labels, prev_annotations
                )
            raise
        with self._mutex.locked(node.name):
            self._commit_write(
                node, patched, lab_changes, ann_changes, prev_labels, what, batched=True
            )
        return lab_changes, ann_changes

    def _commit_write(
        self,
        node: Node,
        patched: Optional[KubeObject],
        lab_changes: Mapping[str, Optional[str]],
        ann_changes: Mapping[str, Optional[str]],
        prev_labels: Mapping[str, Optional[str]],
        what: str,
        batched: bool,
    ) -> None:
        """Under the node's mutex: count the write, hand it to the
        write-through, check that it holds the values written, fold them
        into the node in hand, and report a state transition."""
        self._count_write(
            skipped=False,
            coalesced=len(lab_changes) + len(ann_changes) - 1,
            batched=batched,
        )
        if self._write_through is not None and patched is not None:
            self._write_through(patched)
        if patched is None:
            patched = self._client.get("Node", node.name)
        written = patched.raw.get("metadata") or {}
        labs = written.get("labels") or {}
        anns = written.get("annotations") or {}
        if any(labs.get(k) != v for k, v in lab_changes.items()) or any(
            anns.get(k) != v for k, v in ann_changes.items()
        ):
            raise StateWriteError(
                f"write of {what} on node {node.name} did not produce the expected value"
            )
        self._apply_in_memory(node, lab_changes, ann_changes)
        state_label = self._keys.state_label
        if state_label in lab_changes:
            cause = tracing.current_span()
            if cause is not None:
                tracing.add_event(
                    "state.transition",
                    node=node.name,
                    frm=prev_labels.get(state_label) or "",
                    to=lab_changes[state_label] or "",
                    cause=cause.name,
                )

    @staticmethod
    def _apply_in_memory(
        node: Node,
        lab_changes: Mapping[str, Optional[str]],
        ann_changes: Mapping[str, Optional[str]],
    ) -> None:
        for k, v in lab_changes.items():
            if v is None:
                node.labels.pop(k, None)
            else:
                node.labels[k] = v
        for k, v in ann_changes.items():
            if v is None:
                node.annotations.pop(k, None)
            else:
                node.annotations[k] = v

    @staticmethod
    def _rollback_write(
        node: Node,
        lab_changes: Mapping[str, Optional[str]],
        ann_changes: Mapping[str, Optional[str]],
        prev_labels: Mapping[str, Optional[str]],
        prev_annotations: Mapping[str, Optional[str]],
    ) -> None:
        """Under the node's mutex, after a failed stage: each key that
        still holds the optimistic value gets its old one back; a key a
        concurrent writer moved on since is theirs."""
        for current, changes, prev in (
            (node.labels, lab_changes, prev_labels),
            (node.annotations, ann_changes, prev_annotations),
        ):
            for k, v in changes.items():
                if current.get(k) != v:
                    continue
                if prev.get(k) is None:
                    current.pop(k, None)
                else:
                    current[k] = prev[k]
