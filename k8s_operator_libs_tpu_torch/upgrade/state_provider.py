"""NodeUpgradeStateProvider: the one writer of a node's upgrade state.

The JAX package's ``upgrade/state_provider.py`` without its write batcher,
its cached reader and informer write-through, and its tracing events. All
upgrade state lives on the node (a state label and a few annotations),
which keeps the controller stateless and a pass resumable after any
crash. Every write goes through here, so that:

1. the writes of one node are serialized by a mutex per node, whichever
   manager's task makes them;
2. a write is checked before the caller goes on: the PATCH response (or,
   from a client that returns none, the node read back) must hold the
   values written;
3. a key that already holds its target value is not written (the provider
   is its only writer, so the node in hand is authoritative), and a node's
   label and annotation changes of one step go in one PATCH.

Deleting an annotation is asked for by the value ``"null"``, which becomes
a JSON ``null`` in the merge patch.
"""

from __future__ import annotations

import threading
from typing import Mapping, Optional, Protocol, Union

from ..kube.client import Client
from ..kube.objects import Node
from ..utils.log import get_logger
from ..utils.sync import KeyedMutex
from .consts import NULL_STRING, UpgradeKeys, UpgradeState

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
        self._counter_lock = threading.Lock()
        self._writes_issued = 0
        self._writes_skipped = 0

    # -- write accounting --------------------------------------------------
    def write_stats(self) -> dict[str, int]:
        """``issued`` PATCHes and ``skipped`` no-ops, in one consistent read."""
        with self._counter_lock:
            return {"issued": self._writes_issued, "skipped": self._writes_skipped}

    def _count_write(self, skipped: bool) -> None:
        with self._counter_lock:
            if skipped:
                self._writes_skipped += 1
            else:
                self._writes_issued += 1

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
        PATCH under the node's mutex; the ``(labels, annotations)`` that
        changed (both empty: nothing was written)."""
        with self._mutex.locked(node.name):
            lab_changes = {k: v for k, v in labels.items() if node.labels.get(k) != v}
            ann_changes = {
                k: v for k, v in annotations.items() if node.annotations.get(k) != v
            }
            if not lab_changes and not ann_changes:
                self._count_write(skipped=True)
                return {}, {}
            meta: dict = {}
            if lab_changes:
                meta["labels"] = dict(lab_changes)
            if ann_changes:
                meta["annotations"] = dict(ann_changes)
            # A strategic merge patch for a pure label write, as the
            # upstream library sends; a merge patch where annotations go
            # too. For maps of strings the two agree.
            patch_type = "strategic" if lab_changes and not ann_changes else "merge"
            patched = self._client.patch(
                "Node", node.name, patch={"metadata": meta}, patch_type=patch_type
            )
            self._count_write(skipped=False)
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
            return lab_changes, ann_changes
