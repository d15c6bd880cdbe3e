"""Where ``build_state`` reads its view of the cluster.

The JAX package's ``upgrade/snapshot.py``, its protocol and its LIST
source. :class:`ClientSnapshotSource` reads three LISTs a pass, the driver
DaemonSets, their pods and every node, whatever the pool's size. The
informer-backed and incremental sources of the JAX module are not here
(ROADMAP A14).
"""

from __future__ import annotations

import threading
from typing import Mapping, Protocol

from ..kube.client import Client
from ..kube.objects import DaemonSet, Node, Pod


class SnapshotSource(Protocol):
    """What ``build_state`` reads."""

    def daemonsets(self, namespace: str, labels: Mapping[str, str]) -> list[DaemonSet]: ...

    def pods(self, namespace: str, labels: Mapping[str, str]) -> list[Pod]: ...

    def nodes(self) -> dict[str, Node]: ...

    def consume_reads(self) -> int:
        """Client reads since the last call."""
        ...


class ClientSnapshotSource:
    """Three LISTs a snapshot."""

    def __init__(self, client: Client) -> None:
        self._client = client
        self._reads_lock = threading.Lock()
        self._reads = 0

    def _count(self) -> None:
        with self._reads_lock:
            self._reads += 1

    def consume_reads(self) -> int:
        with self._reads_lock:
            reads, self._reads = self._reads, 0
            return reads

    def daemonsets(self, namespace: str, labels: Mapping[str, str]) -> list[DaemonSet]:
        self._count()
        return [
            DaemonSet(o.raw)
            for o in self._client.list(
                "DaemonSet", namespace=namespace, label_selector=dict(labels)
            )
        ]

    def pods(self, namespace: str, labels: Mapping[str, str]) -> list[Pod]:
        self._count()
        return [
            Pod(o.raw)
            for o in self._client.list("Pod", namespace=namespace, label_selector=dict(labels))
        ]

    def nodes(self) -> dict[str, Node]:
        self._count()
        return {o.name: Node(o.raw) for o in self._client.list("Node")}
