"""Thin typed views over Kubernetes object dicts.

A subset of the JAX package's ``kube/objects.py``: ``deep_copy_json``
(the informer's copy of a document), ``Node``, ``Pod``,
``DaemonSet``, ``ControllerRevision``, ``Service``, ``Event``, the leader
election's ``Lease`` and the external maintenance operator's
``NodeMaintenance`` with the accessors
the GPU device class, the monitor, the slice gang and the upgrade state
machine read, and the condition helpers the monitor writes with. Reads
do not insert: a view of a document another component holds (a snapshot
of the JAX package's in-memory cluster, say) gains no empty sections from
being looked at; a list-valued field is changed by assigning it. Each view
keeps its document in ``.raw``, which is all an operator's client needs to
create or update it; the client's own objects come back wrapped again by
their ``.raw``.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Iterable, Mapping, MutableMapping, Optional


def deep_copy_json(obj: Any) -> Any:
    """Deep copy of a JSON-shaped API document, far cheaper than
    ``copy.deepcopy`` (no memo table, no type dispatch): dicts and lists
    are copied, every other value is shared, which is safe because the
    scalars of an API document are immutable."""
    t = type(obj)
    if t is dict:
        return {k: deep_copy_json(v) for k, v in obj.items()}
    if t is list:
        return [deep_copy_json(v) for v in obj]
    return obj


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
    def uid(self) -> str:
        return self.metadata.get("uid", "")

    @property
    def labels(self) -> dict[str, str]:
        return _ensure(self.metadata, "labels")

    @property
    def annotations(self) -> dict[str, str]:
        return _ensure(self.metadata, "annotations")

    @property
    def finalizers(self) -> list[str]:
        """The finalizers; assign the property to change them (a read of
        an object without any inserts nothing)."""
        return self.metadata.get("finalizers") or []

    @finalizers.setter
    def finalizers(self, value: Iterable[str]) -> None:
        self.metadata["finalizers"] = list(value)

    @property
    def deletion_timestamp(self) -> Optional[Any]:
        return self.metadata.get("deletionTimestamp")

    @property
    def owner_references(self) -> list[dict[str, Any]]:
        return self.metadata.get("ownerReferences") or []

    def add_owner_reference(self, owner: "KubeObject", controller: bool = True) -> None:
        if self.metadata.get("ownerReferences") is None:
            self.metadata["ownerReferences"] = []
        self.metadata["ownerReferences"].append(
            {
                "apiVersion": owner.raw.get("apiVersion", ""),
                "kind": owner.raw.get("kind", ""),
                "name": owner.name,
                "uid": owner.uid,
                "controller": controller,
            }
        )

    @property
    def spec(self) -> dict[str, Any]:
        return _ensure(self.raw, "spec")

    @property
    def status(self) -> dict[str, Any]:
        return _ensure(self.raw, "status")

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


def condition_status(obj_status: Mapping[str, Any], cond_type: str) -> Optional[str]:
    """The status ("True", "False", "Unknown") of a condition, if set."""
    for cond in obj_status.get("conditions") or []:
        if cond.get("type") == cond_type:
            return cond.get("status")
    return None


def rfc3339_now() -> str:
    """The current UTC time in the RFC 3339 form the API requires."""
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def set_condition(
    obj_status: MutableMapping[str, Any],
    cond_type: str,
    status: str,
    reason: str = "",
    message: str = "",
) -> None:
    """Upsert a condition; ``lastTransitionTime`` moves only when the
    status changes."""
    if obj_status.get("conditions") is None:
        obj_status["conditions"] = []
    conds = obj_status["conditions"]
    for cond in conds:
        if cond.get("type") == cond_type:
            update = {"status": status, "reason": reason, "message": message}
            if cond.get("status") != status:
                update["lastTransitionTime"] = rfc3339_now()
            cond.update(update)
            return
    conds.append(
        {"type": cond_type, "status": status, "reason": reason,
         "message": message, "lastTransitionTime": rfc3339_now()}
    )


#: Pod label carrying the DaemonSet rollout hash.
CONTROLLER_REVISION_HASH_LABEL = "controller-revision-hash"

#: Annotation that marks a static (mirror) pod.
MIRROR_POD_ANNOTATION = "kubernetes.io/config.mirror"


class Node(KubeObject):
    KIND = "Node"
    API_VERSION = "v1"

    @property
    def unschedulable(self) -> bool:
        return bool((self.raw.get("spec") or {}).get("unschedulable", False))

    @unschedulable.setter
    def unschedulable(self, value: bool) -> None:
        self.spec["unschedulable"] = bool(value)

    def is_ready(self) -> bool:
        """Ready; a node without a Ready condition counts as ready."""
        status = condition_status(self.raw.get("status") or {}, "Ready")
        return status is None or status == "True"

    def set_ready(self, ready: bool) -> None:
        set_condition(self.status, "Ready", "True" if ready else "False")


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

    def is_ready(self) -> bool:
        return (
            self.phase == "Running"
            and condition_status(self.raw.get("status") or {}, "Ready") == "True"
        )

    def is_mirror_pod(self) -> bool:
        return MIRROR_POD_ANNOTATION in (self.metadata.get("annotations") or {})

    def is_daemonset_pod(self) -> bool:
        return any(
            ref.get("kind") == "DaemonSet" and ref.get("controller")
            for ref in self.owner_references
        )

    def has_controller(self) -> bool:
        return any(ref.get("controller") for ref in self.owner_references)

    def has_empty_dir(self) -> bool:
        return any(
            "emptyDir" in (vol or {})
            for vol in (self.raw.get("spec") or {}).get("volumes") or []
        )

    @property
    def container_statuses(self) -> list[dict[str, Any]]:
        return (self.raw.get("status") or {}).get("containerStatuses") or []

    @property
    def init_container_statuses(self) -> list[dict[str, Any]]:
        return (self.raw.get("status") or {}).get("initContainerStatuses") or []

    def controller_revision_hash(self) -> str:
        """The DaemonSet rollout hash the pod was created at."""
        return (self.metadata.get("labels") or {}).get(CONTROLLER_REVISION_HASH_LABEL, "")


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

    @property
    def desired_number_scheduled(self) -> int:
        return int((self.raw.get("status") or {}).get("desiredNumberScheduled", 0))


class ControllerRevision(KubeObject):
    """A DaemonSet's template revision; its name ends in the rollout hash."""

    KIND = "ControllerRevision"
    API_VERSION = "apps/v1"

    @property
    def revision(self) -> int:
        return int(self.raw.get("revision", 0))

    @revision.setter
    def revision(self, value: int) -> None:
        self.raw["revision"] = int(value)

    def hash_label(self) -> str:
        """The ``controller-revision-hash`` label; the read inserts
        nothing (snapshot sources serve revisions from their stores)."""
        return (self.metadata.get("labels") or {}).get("controller-revision-hash", "")


class Service(KubeObject):
    KIND = "Service"
    API_VERSION = "v1"

    def is_headless(self) -> bool:
        return (self.raw.get("spec") or {}).get("clusterIP") == "None"


class Event(KubeObject):
    KIND = "Event"
    API_VERSION = "v1"


class NodeMaintenance(KubeObject):
    """The external maintenance operator's request object (the NVIDIA
    maintenance operator's API, ``maintenance.nvidia.com/v1alpha1``): the
    requestor mode asks for a node's cordon and drain with one, and the
    operator reports ``Ready`` when it is done."""

    KIND = "NodeMaintenance"
    API_VERSION = "maintenance.nvidia.com/v1alpha1"

    CONDITION_READY = "Ready"
    CONDITION_REASON_READY = "Ready"

    @property
    def requestor_id(self) -> str:
        return (self.raw.get("spec") or {}).get("requestorID", "")

    @requestor_id.setter
    def requestor_id(self, value: str) -> None:
        self.spec["requestorID"] = value

    @property
    def additional_requestors(self) -> list[str]:
        """The other operators sharing the object; assign to change."""
        return (self.raw.get("spec") or {}).get("additionalRequestors") or []

    @additional_requestors.setter
    def additional_requestors(self, value: Iterable[str]) -> None:
        self.spec["additionalRequestors"] = list(value)

    @property
    def node_name(self) -> str:
        return (self.raw.get("spec") or {}).get("nodeName", "")

    @node_name.setter
    def node_name(self, value: str) -> None:
        self.spec["nodeName"] = value

    @property
    def node_health(self) -> Optional[dict[str, Any]]:
        """``{"score", "trend", "worstLinks"?}`` from the node's telemetry
        when the object was made; None where none was read (never a
        default score: "unmeasured" is not "healthy")."""
        value = (self.raw.get("spec") or {}).get("nodeHealth")
        return value if isinstance(value, dict) else None

    @node_health.setter
    def node_health(self, value: Optional[Mapping[str, Any]]) -> None:
        if value is None:
            self.spec.pop("nodeHealth", None)
        else:
            self.spec["nodeHealth"] = dict(value)

    @property
    def worst_links(self) -> list[dict[str, Any]]:
        """The sick links of ``nodeHealth.worstLinks`` (``peer``,
        ``verdict``, ``gbytesPerS``?, ``latencyS``?); empty without."""
        links = (self.node_health or {}).get("worstLinks")
        if not isinstance(links, list):
            return []
        return [dict(entry) for entry in links]

    def is_ready(self) -> bool:
        return condition_status(self.raw.get("status") or {}, self.CONDITION_READY) == "True"

    def ready_reason(self) -> str:
        for cond in (self.raw.get("status") or {}).get("conditions") or []:
            if cond.get("type") == self.CONDITION_READY:
                return cond.get("reason", "")
        return ""


class Lease(KubeObject):
    """coordination.k8s.io/v1 Lease: the lock object of leader election
    (``kube/leader.py``). The reads insert nothing."""

    KIND = "Lease"
    API_VERSION = "coordination.k8s.io/v1"

    def _spec_value(self, key: str) -> Any:
        return (self.raw.get("spec") or {}).get(key)

    @property
    def holder_identity(self) -> str:
        return self._spec_value("holderIdentity") or ""

    @property
    def lease_duration_seconds(self) -> int:
        return int(self._spec_value("leaseDurationSeconds") or 0)

    @property
    def renew_time(self) -> str:
        return self._spec_value("renewTime") or ""

    @property
    def lease_transitions(self) -> int:
        return int(self._spec_value("leaseTransitions") or 0)


class CustomResourceDefinition(KubeObject):
    """A CRD: its group, plural, the versions it serves and whether the
    API server has established it. The reads insert nothing."""

    KIND = "CustomResourceDefinition"
    API_VERSION = "apiextensions.k8s.io/v1"

    @property
    def group(self) -> str:
        return (self.raw.get("spec") or {}).get("group", "")

    @property
    def served_versions(self) -> list[str]:
        return [
            v.get("name", "")
            for v in (self.raw.get("spec") or {}).get("versions") or []
            if v.get("served", False)
        ]

    @property
    def plural(self) -> str:
        return ((self.raw.get("spec") or {}).get("names") or {}).get("plural", "")

    def is_established(self) -> bool:
        return condition_status(self.raw.get("status") or {}, "Established") == "True"


KINDS: dict[str, type] = {
    cls.KIND: cls
    for cls in (Node, Pod, DaemonSet, ControllerRevision, Service, Event, NodeMaintenance,
                Lease, CustomResourceDefinition)
}


def wrap(data: dict[str, Any]) -> KubeObject:
    """``data`` in the view of its kind (``KubeObject`` for other kinds)."""
    return KINDS.get(data.get("kind", ""), KubeObject)(data)
