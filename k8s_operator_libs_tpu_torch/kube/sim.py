"""A stand-in for the external maintenance operator.

The JAX package's ``kube/sim.py`` ``MaintenanceOperatorSimulator``, over
any client of this package (``kube/client.py``). The requestor mode
(``upgrade/requestor.py``) hands each node's cordon and drain to NVIDIA's
maintenance operator through a ``NodeMaintenance`` object; where that
operator does not run (the tests, a card with no cluster), this class
plays it, doing the node operations itself through ``kube/drain.py``.
"""

from __future__ import annotations

from .client import Client
from .drain import DrainConfig, DrainHelper
from .objects import NodeMaintenance, Pod


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
