"""Kubernetes Events, written through the operator's client.

A subset of the JAX package's ``kube/events.py``: the recorder the monitor
calls on each condition transition. The monitor writes an Event only when
its condition changes, so this recorder writes each one as it comes; the
JAX recorder's correlation (dedup, aggregation, spam filter) guards hot
reconcile loops that this caller does not have.
"""

from __future__ import annotations

import uuid

from .objects import Event, KubeObject, rfc3339_now

EVENT_TYPE_NORMAL = "Normal"
EVENT_TYPE_WARNING = "Warning"


class EventRecorder:
    """Records events as Event objects in the cluster ``client`` serves."""

    def __init__(self, client, namespace: str = "default") -> None:
        self._client = client
        self._namespace = namespace

    def event(self, obj: KubeObject, event_type: str, reason: str, message: str) -> None:
        namespace = obj.namespace or self._namespace
        stamp = rfc3339_now()
        ev = Event.new(f"{obj.name}.{uuid.uuid4().hex[:10]}", namespace=namespace)
        ev.raw.update(
            {
                "type": event_type,
                "reason": reason,
                "message": message,
                "count": 1,
                "involvedObject": {
                    "kind": obj.raw.get("kind", ""),
                    "name": obj.name,
                    "namespace": obj.namespace,
                    "uid": obj.uid,
                },
                "firstTimestamp": stamp,
                "lastTimestamp": stamp,
            }
        )
        self._client.create(ev)

    def eventf(self, obj: KubeObject, event_type: str, reason: str, fmt: str, *args) -> None:
        self.event(obj, event_type, reason, fmt % args if args else fmt)
