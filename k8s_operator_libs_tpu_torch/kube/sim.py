"""Stand-ins for the other parties of the state machine's protocols.

Two classes of the JAX package's ``kube/sim.py``, over any client of this
package (``kube/client.py``):

* ``CheckpointingWorkloadSimulator`` plays the training jobs of the
  checkpoint arc (``upgrade/checkpoint_manager.py``): it counts their
  steps, checkpoints and acks when asked, and counts the steps an
  eviction costs;
* ``MaintenanceOperatorSimulator`` plays NVIDIA's maintenance operator
  for the requestor mode (``upgrade/requestor.py``), which hands each
  node's cordon and drain to it through a ``NodeMaintenance`` object; it
  does the node operations itself through ``kube/drain.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..api.upgrade_v1alpha1 import (
    WORKLOAD_CHECKPOINT_KIND,
    make_workload_checkpoint,
    workload_checkpoint_name,
    workload_checkpoint_step,
)
from .client import AlreadyExistsError, Client, NotFoundError, get_or_none, has_reason
from .drain import DrainConfig, DrainHelper
from .objects import KubeObject, NodeMaintenance, Pod


@dataclass
class _Workload:
    """One simulated training job, bound to one node."""

    node: str
    pod_name: str
    #: The step the current incarnation resumed from.
    base_step: int = 0
    #: Steps trained by the current incarnation.
    local_steps: int = 0
    running: bool = False
    restarts: int = 0
    lost_steps: int = 0
    #: Ticks left before the pending checkpoint request is acked.
    ack_countdown: int = -1
    #: The request epoch the countdown belongs to.
    pending_epoch: str = ""

    @property
    def step(self) -> int:
        return self.base_step + self.local_steps


class CheckpointingWorkloadSimulator:
    """Training jobs that never stop, for the checkpoint arc: one training
    pod a node, bound to it, each Running pod training ``steps_per_tick``
    steps a ``step()``. The steps are counted, not run; a caller that runs
    a real model beside it trains each pod up to ``workload(node).step``.
    It plays the workload's side of the checkpoint contract:

    * a pod that sees ``checkpoint_request_annotation=<epoch>`` checkpoints
      ``ack_delay_steps`` ticks later: it writes a WorkloadCheckpoint
      object at its current step (``api/upgrade_v1alpha1.py``), then acks
      with ``checkpoint_complete_annotation=<epoch>`` and the step;
    * the pods of the nodes in ``nonacking`` are wedged: they see the
      request and never ack, so only the deadline's escalation gets past
      them;
    * an evicted or deleted pod is the disruption: its **lost steps** are
      the step it died at less the step its checkpoint restores (0
      without one, a full restart). The pod is made again once its node is
      schedulable, and resumes from the checkpoint.

    ``lost_steps()``, ``total_steps()`` and ``restarts()`` sum over the
    jobs, one for each node the client lists when the simulator is made."""

    def __init__(
        self,
        client: Client,
        keys,
        namespace: str = "training",
        name: str = "train",
        pod_labels: Optional[dict[str, str]] = None,
        ack_delay_steps: int = 1,
        steps_per_tick: int = 1,
        nonacking: tuple = (),
    ) -> None:
        self.client = client
        self.keys = keys
        self.namespace = namespace
        self.name = name
        self.pod_labels = dict(pod_labels or {"app": "trainer"})
        self.ack_delay_steps = ack_delay_steps
        self.steps_per_tick = steps_per_tick
        self.nonacking = frozenset(nonacking)
        self._workloads = {
            n.name: _Workload(node=n.name, pod_name=f"{name}-{n.name}") for n in client.list("Node")
        }

    # -- the jobs' accounting --------------------------------------------------
    def lost_steps(self) -> int:
        return sum(w.lost_steps for w in self._workloads.values())

    def total_steps(self) -> int:
        return sum(w.step for w in self._workloads.values())

    def restarts(self) -> int:
        return sum(w.restarts for w in self._workloads.values())

    def workload(self, node: str) -> _Workload:
        return self._workloads[node]

    # -- a tick of the kubelets and the job controller -------------------------
    def step(self) -> None:
        for w in self._workloads.values():
            self._step_one(w)

    def _checkpoint_step_of(self, w: _Workload) -> int:
        cr = get_or_none(
            self.client, WORKLOAD_CHECKPOINT_KIND, workload_checkpoint_name(w.pod_name),
            self.namespace,
        )
        if cr is None:
            return 0
        return max(0, workload_checkpoint_step(cr.raw))

    def _step_one(self, w: _Workload) -> None:
        pod = get_or_none(self.client, "Pod", w.pod_name, self.namespace)
        if pod is None or pod.raw["metadata"].get("deletionTimestamp"):
            if w.running:
                # The disruption: the steps to train again are known now,
                # while the step it died at is.
                w.lost_steps += max(0, w.step - self._checkpoint_step_of(w))
                w.restarts += 1
                w.running = False
                w.ack_countdown = -1
                w.pending_epoch = ""
            self._maybe_reschedule(w)
            return
        w.running = True  # the pod appeared
        w.local_steps += self.steps_per_tick
        self._handle_checkpoint_request(w, Pod(pod.raw))

    def _maybe_reschedule(self, w: _Workload) -> None:
        node = get_or_none(self.client, "Node", w.node)
        if node is None or (node.raw.get("spec") or {}).get("unschedulable"):
            return  # gone or cordoned: the scheduler would not place it
        restore_to = self._checkpoint_step_of(w)
        pod = Pod.new(w.pod_name, namespace=self.namespace, labels=self.pod_labels)
        pod.node_name = w.node
        pod.raw["status"] = {
            "phase": "Running",
            "conditions": [{"type": "Ready", "status": "True"}],
            "containerStatuses": [{"name": "trainer", "ready": True, "restartCount": 0}],
        }
        try:
            self.client.create(pod)
        except Exception as e:  # noqa: BLE001 - the client's own classes
            if has_reason(e, AlreadyExistsError):
                return  # another maker won; adopted on the next tick
            raise
        w.base_step = restore_to
        w.local_steps = 0
        w.running = True

    def _handle_checkpoint_request(self, w: _Workload, pod: Pod) -> None:
        request = pod.annotations.get(self.keys.checkpoint_request_annotation)
        ack = pod.annotations.get(self.keys.checkpoint_complete_annotation)
        if not request or ack == request:
            return
        if w.node in self.nonacking:
            return  # wedged: sees the request, never acks
        if w.pending_epoch != request:
            w.pending_epoch = request
            w.ack_countdown = self.ack_delay_steps
        w.ack_countdown -= 1
        if w.ack_countdown > 0:
            return
        # The checkpoint object first: an ack without a durable checkpoint
        # would let the drain destroy unsaved state.
        step = w.step
        cr = make_workload_checkpoint(w.pod_name, self.namespace, w.node, step=step,
                                      request_id=request)
        name = cr["metadata"]["name"]
        if get_or_none(self.client, WORKLOAD_CHECKPOINT_KIND, name, self.namespace) is None:
            self.client.create(KubeObject(cr))
        else:
            self.client.patch(WORKLOAD_CHECKPOINT_KIND, name, self.namespace,
                              patch={"spec": cr["spec"]})
        try:
            self.client.patch("Pod", w.pod_name, self.namespace, patch={"metadata": {
                "annotations": {
                    self.keys.checkpoint_complete_annotation: request,
                    self.keys.checkpoint_step_annotation: str(step),
                }
            }})
        except Exception as e:  # noqa: BLE001 - the client's own classes
            if has_reason(e, NotFoundError):
                return  # evicted in the middle of the ack; earned again later
            raise
        w.pending_epoch = ""
        w.ack_countdown = -1


class MaintenanceOperatorSimulator:
    """Each ``step`` moves every NodeMaintenance object of ``namespace``
    one stage on, as the operator's reconcile would:

    ``Pending → Cordon → WaitForPodCompletion → Draining → Ready``

    The stage is kept in the reason of the object's Ready condition, not
    here, so a new simulator carries on where another stopped. The
    simulator's finalizer is on every object it has seen; an object whose
    deletion has begun is finalized: the node uncordoned and the
    finalizer removed, so the delete completes."""

    FINALIZER = "maintenance.finalizers.sim"

    REASON_PENDING = "Pending"
    REASON_CORDON = "Cordon"
    REASON_WAIT = "WaitForPodCompletion"
    REASON_DRAIN = "Draining"
    REASON_READY = NodeMaintenance.CONDITION_REASON_READY

    def __init__(self, client: Client, namespace: str = "default") -> None:
        self.client = client
        self.namespace = namespace
        self.drain = DrainHelper(client)

    def step(self) -> None:
        for obj in self.client.list("NodeMaintenance", namespace=self.namespace):
            nm = NodeMaintenance(obj.raw)
            if nm.deletion_timestamp is not None:
                self._finalize(nm)
            else:
                self._advance(nm)

    def _advance(self, nm: NodeMaintenance) -> None:
        if self.FINALIZER not in nm.finalizers:
            nm.finalizers = nm.finalizers + [self.FINALIZER]
            self.client.update(nm)
            nm = NodeMaintenance(self.client.get("NodeMaintenance", nm.name, nm.namespace).raw)
        reason = nm.ready_reason() or self.REASON_PENDING
        if reason == self.REASON_PENDING:
            self._set_reason(nm, self.REASON_CORDON)
        elif reason == self.REASON_CORDON:
            self.drain.cordon(nm.node_name)
            self._set_reason(nm, self.REASON_WAIT)
        elif reason == self.REASON_WAIT:
            if self._completion_wait_done(nm):
                self._set_reason(nm, self.REASON_DRAIN)
        elif reason == self.REASON_DRAIN:
            self._drain(nm)
            self._set_reason(nm, self.REASON_READY, status="True")
        # Ready: the requestor releases the object when it is done.

    def _finalize(self, nm: NodeMaintenance) -> None:
        if nm.node_name:
            self.drain.uncordon(nm.node_name)
        if self.FINALIZER in nm.finalizers:
            nm.finalizers = [f for f in nm.finalizers if f != self.FINALIZER]
            self.client.update(nm)

    def _completion_wait_done(self, nm: NodeMaintenance) -> bool:
        """Every pod of the wait's selector on the node has finished (no
        selector: nothing to wait for)."""
        selector = (nm.spec.get("waitForPodCompletion") or {}).get("podSelector", "")
        if not selector:
            return True
        pods = self.client.list(
            "Pod", label_selector=selector, field_selector=f"spec.nodeName={nm.node_name}"
        )
        return all(Pod(p.raw).is_finished() for p in pods)

    def _drain(self, nm: NodeMaintenance) -> None:
        spec = nm.spec.get("drainSpec") or {}
        self.drain.drain(
            nm.node_name,
            DrainConfig(
                force=bool(spec.get("force", True)),
                delete_empty_dir=bool(spec.get("deleteEmptyDir", True)),
                pod_selector=spec.get("podSelector", ""),
                timeout_seconds=int(spec.get("timeoutSeconds", 0)),
            ),
        )

    def _set_reason(self, nm: NodeMaintenance, reason: str, status: str = "False") -> None:
        condition = {"type": NodeMaintenance.CONDITION_READY, "status": status, "reason": reason}
        self.client.patch(
            "NodeMaintenance", nm.name, nm.namespace,
            patch={"status": {"conditions": [condition]}},
        )
