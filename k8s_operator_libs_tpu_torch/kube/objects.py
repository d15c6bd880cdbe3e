"""Thin typed views over Kubernetes object dicts.

A subset of the JAX package's ``kube/objects.py``: ``Node``, ``Pod`` and
``DaemonSet`` with the accessors the GPU device class reads. Each view
keeps its document in ``.raw``, which is all an operator's client needs to
create or update it; the client's own objects come back wrapped again by
their ``.raw``.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping, Optional


def _ensure(d: dict[str, Any], key: str) -> dict[str, Any]:
    if d.get(key) is None:
        d[key] = {}
    return d[key]


class KubeObject:
    """Typed view over a Kubernetes object dict."""

    KIND = ""
    API_VERSION = ""

    def __init__(self, data: Optional[dict[str, Any]] = None) -> None:
        self.raw: dict[str, Any] = data if data is not None else {}
        self.raw.setdefault("apiVersion", self.API_VERSION)
        self.raw.setdefault("kind", self.KIND)
        self.raw.setdefault("metadata", {})

    @property
    def metadata(self) -> dict[str, Any]:
        return _ensure(self.raw, "metadata")

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def namespace(self) -> str:
        return self.metadata.get("namespace", "")

    @property
    def resource_version(self) -> str:
        return self.metadata.get("resourceVersion", "")

    @property
    def labels(self) -> dict[str, str]:
        return _ensure(self.metadata, "labels")

    @property
    def spec(self) -> dict[str, Any]:
        return _ensure(self.raw, "spec")

    def deep_copy(self):
        return type(self)(copy.deepcopy(self.raw))

    @classmethod
    def new(
        cls,
        name: str,
        namespace: str = "",
        labels: Optional[Mapping[str, str]] = None,
    ):
        obj = cls()
        obj.metadata["name"] = name
        if namespace:
            obj.metadata["namespace"] = namespace
        if labels:
            obj.labels.update(labels)
        return obj


class Node(KubeObject):
    KIND = "Node"
    API_VERSION = "v1"


class Pod(KubeObject):
    KIND = "Pod"
    API_VERSION = "v1"

    @property
    def node_name(self) -> str:
        return (self.raw.get("spec") or {}).get("nodeName", "")

    @node_name.setter
    def node_name(self, value: str) -> None:
        self.spec["nodeName"] = value

    @property
    def phase(self) -> str:
        return (self.raw.get("status") or {}).get("phase", "")

    def is_finished(self) -> bool:
        return self.phase in ("Succeeded", "Failed")


class DaemonSet(KubeObject):
    KIND = "DaemonSet"
    API_VERSION = "apps/v1"

    @property
    def match_labels(self) -> dict[str, str]:
        return ((self.raw.get("spec") or {}).get("selector") or {}).get(
            "matchLabels"
        ) or {}

    @match_labels.setter
    def match_labels(self, value: Mapping[str, str]) -> None:
        _ensure(self.spec, "selector")["matchLabels"] = dict(value)
