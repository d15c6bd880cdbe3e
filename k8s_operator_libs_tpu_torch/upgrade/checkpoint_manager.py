"""CheckpointManager: the checkpoint before the drain, and the
restore-verified uncordon.

The JAX package's ``upgrade/checkpoint_manager.py``. A drain evicts the
workload pods on a node; a training job that is evicted unwarned starts
over. With a policy's ``checkpoint`` enabled, each node passes through
``checkpoint-required`` between the wait for jobs and the eviction, and
disruption is counted in training steps trained again, not in pods
evicted. For a node in ``checkpoint-required``:

1. **Request.** The controller stamps the node's durable checkpoint clock
   (``checkpoint_start_annotation``; the stamp is also the checkpoint
   epoch) and writes ``checkpoint_request_annotation=<epoch>`` on every
   selected workload pod of the node. A pass that re-enters after an
   aborted one reads the same epoch from the clock and writes only the
   requests that are missing.
2. **Ack.** The workload checkpoints, records a WorkloadCheckpoint object
   (``api/upgrade_v1alpha1.py``) and writes
   ``checkpoint_complete_annotation=<epoch>`` and the step on its pod. An
   ack of an earlier epoch does not count.
3. **Gate.** Once every selected pod acked, the node's manifest
   (``{"<ns>/<pod>": step}``) is written, the clock cleared, and the node
   goes on to the eviction path.
4. **Escalate.** If the deadline expires first, the manifest of the pods
   that did ack is written, the node is marked escalated, and it goes on
   all the same: a plain drain. A wedged workload never stalls the roll.
5. **Restore-verify.** After the driver upgrade and before the uncordon,
   the validation bucket checks each manifest entry against its
   WorkloadCheckpoint object (:meth:`CheckpointManager.restore_gate`). A
   checkpoint that cannot be verified defers the uncordon up to its own
   durable deadline, then degrades (the workload starts cold).

``coordinate`` runs on the bucket's tasks, one a node; the counters are
under a lock that nothing else is taken under. The JAX module's flight
recorder events (``tracing.add_event``) have no counterpart here until the
port has tracing (ROADMAP A15).
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from ..api.upgrade_v1alpha1 import (
    WORKLOAD_CHECKPOINT_KIND,
    CheckpointSpec,
    workload_checkpoint_name,
    workload_checkpoint_step,
)
from ..kube.client import Client, get_or_none
from ..kube.objects import Node, Pod
from ..utils.log import get_logger
from .consts import NULL_STRING, TRUE_STRING, UpgradeKeys, UpgradeState
from .state_provider import NodeUpgradeStateProvider
from .validation_manager import advance_durable_clock

log = get_logger("upgrade.checkpoint")

#: The default deadline of the restore-verified uncordon (the checkpoint
#: deadline bounds the arc before the drain; this one the check before the
#: uncordon).
RESTORE_VERIFY_TIMEOUT_SECONDS = 600


class CheckpointManager:
    def __init__(
        self,
        client: Client,
        state_provider: NodeUpgradeStateProvider,
        keys: UpgradeKeys,
        recorder=None,
        restore_timeout_seconds: int = RESTORE_VERIFY_TIMEOUT_SECONDS,
    ) -> None:
        self._client = client
        self._provider = state_provider
        self._keys = keys
        self._recorder = recorder
        self._restore_timeout = restore_timeout_seconds
        #: ``CheckpointSpec.verify_restore``, refreshed from the policy on
        #: every pass. Off, the gate still retires the manifest but never
        #: defers on a missing checkpoint.
        self._verify_restore = True
        self._counter_lock = threading.Lock()
        self._totals = {
            "requests": 0,
            "completions": 0,
            "escalations": 0,
            "advanced": 0,
            "restores_verified": 0,
            "restore_escalations": 0,
        }

    # -- counters ------------------------------------------------------------
    def _count(self, key: str, n: int = 1) -> None:
        with self._counter_lock:
            self._totals[key] += n

    def totals(self) -> dict[str, int]:
        """The lifetime counters; ``apply_state`` takes the difference of
        two for a pass's ``PassStats``."""
        with self._counter_lock:
            return dict(self._totals)

    def set_verify_restore(self, verify: bool) -> None:
        """Follow the policy in force: a change in the middle of a roll
        takes effect at the next gate check."""
        self._verify_restore = bool(verify)

    # -- before the drain (the checkpoint-required bucket) -------------------
    def eligible_pods(self, node: Node, spec: CheckpointSpec) -> list[Pod]:
        """The node's live workload pods that the spec selects: Running or
        Pending and not terminating (a pod on its way out cannot ack)."""
        pods = [
            Pod(o.raw)
            for o in self._client.list(
                "Pod",
                label_selector=spec.pod_selector or None,
                field_selector=f"spec.nodeName={node.name}",
            )
        ]
        return [
            p for p in pods if p.phase in ("Running", "Pending") and p.deletion_timestamp is None
        ]

    def coordinate(self, node: Node, spec: CheckpointSpec, next_state: UpgradeState) -> None:
        """One pass of the arc for one node: request, collect the acks, and
        either complete the gate or escalate at the deadline, into
        ``next_state``."""
        keys = self._keys
        clock_key = keys.checkpoint_start_annotation
        pods = self.eligible_pods(node, spec)
        if not pods:
            # Nothing to checkpoint: clear a clock an earlier pass may
            # have started, and go on.
            self._provider.change_node_upgrade_annotation(node, clock_key, NULL_STRING)
            self._advance(node, next_state)
            self._count("completions")
            log.info("no checkpoint-eligible pods on node %s; advancing", node.name)
            return
        # The epoch before the clock's tick: at expiry the clock is
        # cleared, and the escalation still needs the epoch for the acks
        # that did come.
        epoch = node.annotations.get(clock_key)
        acked = self._acked(pods, epoch)
        if epoch and len(acked) == len(pods):
            # Every pod acked this epoch: the checkpoint is complete,
            # whatever the clock says. A controller restarted after the
            # acks came re-enters here past the deadline, and a lapsed
            # clock must not make a finished checkpoint an escalated drain.
            self._complete_gate(
                node, acked, next_state,
                f"All {len(acked)} workload checkpoints found complete on "
                "re-entry; proceeding with a checkpoint-coordinated drain",
            )
            return
        if advance_durable_clock(self._provider, node, clock_key, spec.timeout_seconds):
            self._escalate(node, pods, epoch, next_state)
            return
        epoch = node.annotations.get(clock_key, epoch) or ""
        for pod in pods:
            if pod.annotations.get(keys.checkpoint_request_annotation) != epoch:
                request = {keys.checkpoint_request_annotation: epoch}
                self._client.patch(
                    "Pod", pod.name, pod.namespace, patch={"metadata": {"annotations": request}}
                )
                self._count("requests")
        acked = self._acked(pods, epoch)
        if len(acked) < len(pods):
            log.info(
                "node %s: %d/%d checkpoint acks (epoch %s); drain gated",
                node.name, len(acked), len(pods), epoch,
            )
            return
        self._complete_gate(
            node, acked, next_state,
            f"All {len(acked)} workload checkpoints complete; proceeding "
            "with a checkpoint-coordinated drain",
        )

    def _complete_gate(
        self, node: Node, acked: list[Pod], next_state: UpgradeState, message: str
    ) -> None:
        """The manifest first (a pass aborted after it re-enters with the
        manifest durable), then the clock retired, then the advance."""
        self._record_manifest(node, acked)
        self._provider.change_node_upgrade_annotation(
            node, self._keys.checkpoint_start_annotation, NULL_STRING
        )
        self._advance(node, next_state)
        self._count("completions")
        self._event(node, "Normal", message)

    def _acked(self, pods: list[Pod], epoch: Optional[str]) -> list[Pod]:
        if not epoch:
            return []
        key = self._keys.checkpoint_complete_annotation
        return [p for p in pods if p.annotations.get(key) == epoch]

    def _record_manifest(self, node: Node, acked: list[Pod]) -> None:
        """Write ``{"<ns>/<pod>": step}`` of the acked pods on the node
        (writing it again is a no-op)."""
        if not acked:
            return
        step_key = self._keys.checkpoint_step_annotation
        manifest: dict[str, int] = {}
        for pod in acked:
            try:
                step = int(pod.annotations.get(step_key, ""))
            except ValueError:
                step = 0
            manifest[f"{pod.namespace}/{pod.name}"] = step
        self._provider.change_node_upgrade_annotation(
            node, self._keys.checkpoint_manifest_annotation, json.dumps(manifest, sort_keys=True)
        )

    def _escalate(
        self, node: Node, pods: list[Pod], epoch: Optional[str], next_state: UpgradeState
    ) -> None:
        # A partial checkpoint is still worth restoring: only the pods
        # that did not ack start cold.
        acked = self._acked(pods, epoch)
        self._record_manifest(node, acked)
        self._provider.change_node_upgrade_annotation(
            node, self._keys.checkpoint_escalated_annotation, TRUE_STRING
        )
        self._advance(node, next_state)
        self._count("escalations")
        log.warning(
            "checkpoint deadline expired on node %s (%d/%d acks); escalating to a plain drain",
            node.name, len(acked), len(pods),
        )
        self._event(
            node, "Warning",
            f"Checkpoint deadline expired with {len(acked)}/{len(pods)} "
            "acks; escalating to a plain (uncoordinated) drain",
        )

    def _advance(self, node: Node, next_state: UpgradeState) -> None:
        self._provider.change_node_upgrade_state(node, next_state)
        self._count("advanced")

    def abandon(self, node: Node, next_state: UpgradeState) -> None:
        """The way out for a node whose policy withdrew the arc: clear its
        clock (left behind, it would read as expired on the next roll that
        checkpoints, which would escalate with no request made), then go
        on to the eviction path."""
        self._provider.change_node_upgrade_annotation(
            node, self._keys.checkpoint_start_annotation, NULL_STRING
        )
        self._advance(node, next_state)

    # -- before the uncordon (run by the validation bucket) ------------------
    def restore_gate(self, node: Node) -> bool:
        """True when the node's recorded checkpoints are verified
        restorable, or there is nothing to verify. False defers: the
        validation bucket asks again next pass, up to a durable deadline,
        after which the gate degrades (the loss is counted and the roll
        goes on; the workload starts cold)."""
        keys = self._keys
        manifest_raw = node.annotations.get(keys.checkpoint_manifest_annotation)
        if manifest_raw is None:
            return True
        try:
            manifest = json.loads(manifest_raw)
            if not isinstance(manifest, dict):
                raise ValueError("manifest is not an object")
        except ValueError as e:
            # A corrupt manifest gates nothing; the workloads still hold
            # their checkpoints.
            log.error(
                "node %s has corrupt checkpoint manifest %r (%s); clearing",
                node.name, manifest_raw, e,
            )
            self._clear_restore_state(node)
            return True
        if not self._verify_restore:
            log.info(
                "node %s: restore verification disabled by policy; "
                "retiring the checkpoint manifest unchecked", node.name,
            )
            self._clear_restore_state(node)
            return True
        missing = []
        for ref, recorded_step in manifest.items():
            ns, _, pod_name = ref.partition("/")
            cr = get_or_none(
                self._client, WORKLOAD_CHECKPOINT_KIND, workload_checkpoint_name(pod_name), ns
            )
            try:
                recorded = int(recorded_step)
            except (TypeError, ValueError):
                recorded = 0
            if cr is None or workload_checkpoint_step(cr.raw) < recorded:
                missing.append(ref)
        if not missing:
            self._clear_restore_state(node)
            self._count("restores_verified")
            log.info(
                "node %s: %d checkpoint(s) verified restorable; uncordon may proceed",
                node.name, len(manifest),
            )
            return True
        if advance_durable_clock(
            self._provider, node, keys.restore_verify_start_annotation, self._restore_timeout
        ):
            self._count("restore_escalations")
            log.warning(
                "restore verification deadline expired on node %s "
                "(unverifiable: %s); degrading to cold restart",
                node.name, ", ".join(sorted(missing)),
            )
            self._event(
                node, "Warning",
                f"Checkpoint restore verification timed out for "
                f"{len(missing)} workload(s); they will cold-start",
            )
            self._clear_restore_state(node)
            return True
        log.info(
            "node %s: %d checkpoint(s) not yet verifiable (%s); uncordon deferred",
            node.name, len(missing), ", ".join(sorted(missing)),
        )
        return False

    def _clear_restore_state(self, node: Node) -> None:
        """Retire the arc's node keys (each a no-op where absent)."""
        keys = self._keys
        for key in (
            keys.checkpoint_manifest_annotation,
            keys.restore_verify_start_annotation,
            keys.checkpoint_escalated_annotation,
        ):
            self._provider.change_node_upgrade_annotation(node, key, NULL_STRING)

    def has_manifest(self, node: Node) -> bool:
        return self._keys.checkpoint_manifest_annotation in node.annotations

    def _event(self, node: Node, event_type: str, message: str) -> None:
        if self._recorder is not None:
            self._recorder.eventf(node, event_type, self._keys.event_reason(), message)
