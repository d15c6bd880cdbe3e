"""The slice gate: one probe gang per multi-node NVLink domain.

The per-node probe pod (``tpu/validation_pod.py``) exercises only its
node's own cards; on an NVLink domain that spans nodes (the nodes of one
``nvidia.com/gpu.clique``, or of one explicit slice-id label) the links
between the nodes, which a driver bump can break, are never touched. This
module provisions a probe gang instead: one pod per node of the slice, all
running the health payload with ``--coordinator``, ``--num-processes`` and
``--process-id``, so their ranks join one world over the cards of every
node and run one battery over the whole fabric.

How one shared run gates every member:

* the battery's collectives span every node's cards;
* it ends with the agreement all-reduce of every rank's verdict, so each
  pod learns whether every pod passed, and writes its ready file only on a
  unanimous pass: one bad node fails every pod of the gang;
* the state machine's per-node pod-readiness check then reads the node's
  own gang pod, whose readiness carries the slice's verdict.

Rendezvous: the pods set ``hostname``/``subdomain`` against a headless
Service, so rank 0's address (``<pod0>.<svc>:<port>``) is known when the
pods are created. A node with neither label (every HGX node without a
clique) is a slice of its own and takes the per-node
``ValidationPodManager`` pod.

The gang requests each member's full ``nvidia.com/gpu`` complement, so it
forms only when the whole slice is drained together: pair it with
``enable_slice_aware_planning``.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from typing import Optional

from ..kube.client import AlreadyExistsError, delete_if_exists, get_or_none, has_reason
from ..kube.objects import Node, Pod, Service
from ..parallel.topology import GPU_CLIQUE_LABEL
from ..upgrade.consts import UpgradeKeys, UpgradeState
from ..utils.log import get_logger
from .detector import TpuNodeDetector
from .libtpu import TPU_RESOURCE
from .validation_pod import (
    VALIDATION_APP,
    VALIDATION_APP_LABEL,
    ValidationPodManager,
    ValidationPodSpec,
)

log = get_logger("tpu.slice_gate")

#: Gang bookkeeping labels; the readiness selector stays the probe app's,
#: so one pod-selector gate watches the gang and the per-node pods alike.
GANG_SLICE_LABEL = "tpu-operator.dev/slice-gang"
GANG_GENERATION_LABEL = "tpu-operator.dev/gang-generation"
GANG_RANK_LABEL = "tpu-operator.dev/gang-rank"

#: Port of rank 0's TCP store.
DEFAULT_COORDINATOR_PORT = 8476

#: States in which a member still depends on its gang: in the pipeline,
#: before its validation verdict is consumed. Not FAILED: parked pods of a
#: failed node's gang would hold every healthy member's cards.
_GANG_CONSUMER_STATES: frozenset[str] = frozenset(
    str(s)
    for s in (
        UpgradeState.CORDON_REQUIRED,
        UpgradeState.WAIT_FOR_JOBS_REQUIRED,
        UpgradeState.CHECKPOINT_REQUIRED,
        UpgradeState.POD_DELETION_REQUIRED,
        UpgradeState.DRAIN_REQUIRED,
        UpgradeState.NODE_MAINTENANCE_REQUIRED,
        UpgradeState.POST_MAINTENANCE_REQUIRED,
        UpgradeState.POD_RESTART_REQUIRED,
        UpgradeState.VALIDATION_REQUIRED,
    )
)


def slice_slug(slice_id: str) -> str:
    """A DNS-safe, collision-resistant name fragment for a slice id (a
    label value, with no pod-name character guarantees)."""
    cleaned = re.sub(r"[^a-z0-9-]+", "-", slice_id.lower()).strip("-")[:20]
    digest = hashlib.sha256(slice_id.encode()).hexdigest()[:6]
    return f"{cleaned}-{digest}" if cleaned else digest


@dataclass
class SliceProbeSpec(ValidationPodSpec):
    """The gang's shape: the per-node probe's, plus the rendezvous port."""

    coordinator_port: int = DEFAULT_COORDINATOR_PORT


class SliceProbeGangManager:
    """A pod provisioner with one probe gang per multi-node slice; a slice
    of one node takes a per-node pod built from the same spec. It plugs
    into the state machine as ``ValidationPodManager`` does: ``ensure``
    before each readiness check, ``cleanup`` after the node passes.

    Gangs go by generation. A gang serves a node when the node's own pod is
    Ready (the verdict is in) or when the whole current generation exists
    with every member live. Anything else (a finished member, changed
    membership, a half-deleted set) can never complete the rendezvous, so
    ``ensure`` replaces the entire gang with a new generation under new pod
    names rather than leave ranks waiting on a dead one.
    """

    def __init__(
        self,
        client,
        spec: Optional[SliceProbeSpec] = None,
        detector: Optional[TpuNodeDetector] = None,
    ) -> None:
        self.client = client
        self.spec = spec or SliceProbeSpec()
        self.detector = detector or TpuNodeDetector()
        self._keys = UpgradeKeys(self.spec.device)
        self._fallback = ValidationPodManager(client, self.spec)
        #: node -> its cards, as its labels last said.
        self._cards: dict[str, int] = {}

    # -- slice membership --------------------------------------------------
    def slice_members(self, node) -> tuple[str, list[str]]:
        """``(slice id, sorted member node names)`` of the node's slice, as
        observed now: the nodes carrying the explicit slice-id label's
        value, else the node's ``gpu.clique``. A node with neither is a
        slice of one."""
        info = self.detector.detect(node)
        if info is None:
            return node.name, [node.name]
        self._cards[node.name] = info.chips
        labels = node.metadata.get("labels") or {}
        selector = None
        for label in (self.detector.slice_id_label, GPU_CLIQUE_LABEL):
            if labels.get(label) == info.slice_id:
                selector = f"{label}={info.slice_id}"
                break
        if selector is None:
            return info.slice_id, [node.name]
        members = []
        for obj in self.client.list("Node", label_selector=selector):
            candidate = Node(obj.raw)
            candidate_info = self.detector.detect(candidate)
            # An explicit slice id can carve a node out of its clique: the
            # detector's verdict wins over the selector.
            if candidate_info is not None and candidate_info.slice_id == info.slice_id:
                members.append(candidate.name)
                self._cards[candidate.name] = candidate_info.chips
        if node.name not in members:
            members.append(node.name)
        return info.slice_id, sorted(members)

    # -- naming ------------------------------------------------------------
    def service_name(self, slice_id: str) -> str:
        return f"{VALIDATION_APP}-{slice_slug(slice_id)}"

    def pod_name(self, slice_id: str, generation: int, rank: int) -> str:
        return f"{VALIDATION_APP}-{slice_slug(slice_id)}-g{generation}-{rank}"

    # -- gang construction -------------------------------------------------
    def build_service(self, slice_id: str) -> Service:
        svc = Service.new(self.service_name(slice_id), namespace=self.spec.namespace)
        svc.labels[VALIDATION_APP_LABEL] = VALIDATION_APP
        svc.labels[GANG_SLICE_LABEL] = slice_slug(slice_id)
        svc.spec.update(
            {
                # Headless: one DNS record a pod, no virtual IP.
                "clusterIP": "None",
                "selector": {GANG_SLICE_LABEL: slice_slug(slice_id)},
                "ports": [{"name": "coordinator", "port": self.spec.coordinator_port}],
            }
        )
        return svc

    def build_gang_pod(self, slice_id: str, generation: int, rank: int, members: list[str]) -> Pod:
        spec = self.spec
        name = self.pod_name(slice_id, generation, rank)
        svc = self.service_name(slice_id)
        coordinator = f"{self.pod_name(slice_id, generation, 0)}.{svc}:{spec.coordinator_port}"
        pod = self._fallback.build_pod(members[rank])
        pod.metadata["name"] = name
        pod.labels[GANG_SLICE_LABEL] = slice_slug(slice_id)
        pod.labels[GANG_GENERATION_LABEL] = str(generation)
        pod.labels[GANG_RANK_LABEL] = str(rank)
        # <hostname>.<subdomain> resolves once the headless Service exists,
        # before any pod starts: every rank can carry rank 0's address.
        pod.spec["hostname"] = name
        pod.spec["subdomain"] = svc
        (container,) = pod.spec["containers"]
        container["command"] = container["command"] + [
            "--coordinator", coordinator,
            "--num-processes", str(len(members)),
            "--process-id", str(rank),
            # Process -> node name, so the hops to other nodes are keyed by
            # node name in the link map; members are in rank order.
            "--link-peers", ",".join(members),
        ]
        container["ports"] = [{"containerPort": spec.coordinator_port}]
        cards = str(self._cards.get(members[rank], spec.tpu_chips))
        container["resources"] = {
            "requests": {TPU_RESOURCE: cards},
            "limits": {TPU_RESOURCE: cards},
        }
        return pod

    # -- provisioner protocol ----------------------------------------------
    def _gang_pods(self, slug: str) -> list[Pod]:
        return [
            Pod(o.raw)
            for o in self.client.list(
                "Pod", namespace=self.spec.namespace,
                label_selector=f"{GANG_SLICE_LABEL}={slug}",
            )
        ]

    def _consuming(self, names) -> list[str]:
        """The nodes of ``names`` still in the pipeline before their
        verdict is consumed."""
        out = []
        for name in sorted(names):
            obj = get_or_none(self.client, "Node", name)
            if obj is None:
                continue
            if Node(obj.raw).labels.get(self._keys.state_label, "") in _GANG_CONSUMER_STATES:
                out.append(name)
        return out

    def ensure(self, node) -> Pod:
        slice_id, members = self.slice_members(node)
        if len(members) == 1:
            return self._fallback.ensure(node)

        slug = slice_slug(slice_id)
        # A terminating pod lingers with a deletionTimestamp; counting it
        # would replace a healthy new generation every pass until it goes.
        pods = [p for p in self._gang_pods(slug) if p.deletion_timestamp is None]
        generation = max(
            (int(p.labels.get(GANG_GENERATION_LABEL, "0")) for p in pods), default=0
        )
        current = [p for p in pods if p.labels.get(GANG_GENERATION_LABEL) == str(generation)]
        mine = next((p for p in current if p.node_name == node.name), None)
        if mine is not None and mine.is_ready():
            return mine
        if mine is not None and not mine.is_finished():
            if (
                len(current) == len(members)
                and {p.node_name for p in current} == set(members)
                and not any(p.is_finished() for p in current)
            ):
                return mine
        # Replacing the gang destroys the peers' Ready pods too: while a
        # Ready peer's node has not consumed its verdict, fail this node's
        # provisioning instead (its validation clock keeps running).
        ready_peers = {
            p.node_name for p in current if p.node_name != node.name and p.is_ready()
        }
        still_consuming = self._consuming(ready_peers)
        if still_consuming:
            raise RuntimeError(
                f"slice {slice_id}: probe gang is mid-consumption "
                f"(Ready pods on {', '.join(still_consuming)}); "
                f"deferring re-provisioning for node {node.name}"
            )
        for p in pods:
            delete_if_exists(self.client, "Pod", p.name, self.spec.namespace)
        generation += 1
        log.info(
            "slice %s: provisioning probe gang generation %d across %d hosts (%s)",
            slice_id, generation, len(members), ", ".join(members),
        )
        self._ensure_service(slice_id)
        result: Optional[Pod] = None
        for rank, member in enumerate(members):
            desired = self.build_gang_pod(slice_id, generation, rank, members)
            try:
                created = Pod(self.client.create(desired).raw)
            except Exception as e:  # noqa: BLE001 - the client's own classes
                if not has_reason(e, AlreadyExistsError):
                    raise
                created = Pod(self.client.get("Pod", desired.name, self.spec.namespace).raw)
            if member == node.name:
                result = created
        assert result is not None  # the node is always a member
        return result

    def cleanup(self, node) -> None:
        """Tear the gang down once its last consumer is done: removing any
        one pod collapses the shared world (rank 0 holds the store) before
        the peers' gates have read their pods. The last member to pass
        deletes every gang pod and the Service."""
        if self.detector.detect(node) is None:
            self._fallback.cleanup(node)
            return
        slice_id, members = self.slice_members(node)
        if len(members) > 1:
            waiting = self._consuming(m for m in members if m != node.name)
            if waiting:
                log.info("slice %s: keeping probe gang alive for %s", slice_id, ", ".join(waiting))
                return
        for pod in self._gang_pods(slice_slug(slice_id)):
            delete_if_exists(self.client, "Pod", pod.name, self.spec.namespace)
        delete_if_exists(self.client, "Service", self.service_name(slice_id), self.spec.namespace)
        self._fallback.cleanup(node)

    def _ensure_service(self, slice_id: str) -> None:
        try:
            self.client.create(self.build_service(slice_id))
        except Exception as e:  # noqa: BLE001 - the client's own classes
            if not has_reason(e, AlreadyExistsError):
                raise


def make_validation_provisioner(
    client,
    spec: Optional[SliceProbeSpec] = None,
    detector: Optional[TpuNodeDetector] = None,
) -> SliceProbeGangManager:
    """The validation-pod provisioner for GPU pools: a gang on each
    multi-node slice, per-node pods everywhere else. Pass it as
    ``with_validation_enabled(pod_provisioner=...)`` with
    ``spec.pod_selector``, beside ``enable_slice_aware_planning``."""
    return SliceProbeGangManager(client, spec, detector)


__all__ = [
    "DEFAULT_COORDINATOR_PORT",
    "GANG_GENERATION_LABEL",
    "GANG_RANK_LABEL",
    "GANG_SLICE_LABEL",
    "SliceProbeGangManager",
    "SliceProbeSpec",
    "make_validation_provisioner",
    "slice_slug",
]
