"""Stand-ins for the other parties of the state machine's protocols.

The JAX package's ``kube/sim.py``, over any client of this package
(``kube/client.py``):

* ``DaemonSetSimulator`` plays the DaemonSet controller and the kubelets
  for the driver DaemonSet, the safe-load gate of its init container
  included;
* ``ValidationPodSimulator`` plays the kubelet for the probe pods of
  ``tpu/validation_pod.py``, and with a ``KubeletPayloadExecutor`` runs
  each pod's own command as a child process and turns the pod Ready from
  its ready file, as the pod's readiness probe does;
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

import os
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..api.upgrade_v1alpha1 import (
    WORKLOAD_CHECKPOINT_KIND,
    make_workload_checkpoint,
    workload_checkpoint_name,
    workload_checkpoint_step,
)
from .client import AlreadyExistsError, Client, NotFoundError, get_or_none, has_reason
from .drain import DrainConfig, DrainHelper
from .objects import ControllerRevision, DaemonSet, KubeObject, NodeMaintenance, Pod


class DaemonSetSimulator:
    """The DaemonSet controller and the kubelets for a driver DaemonSet.

    * ``set_template_hash`` is a driver image update: a new
      ControllerRevision, and the existing pods become stale;
    * ``step`` is one tick of the controller and the kubelets: every node
      gets a pod at the newest revision if it has none, and a new pod turns
      Ready after ``readiness_steps`` ticks (0: at once);
    * ``safe_load_annotation`` arms the safe-load handshake: every new
      pod's init container first SETS that annotation on its node and
      blocks, the pod NotReady, until the state machine's
      ``unblock_loading`` removes it; then the driver loads (at least one
      tick) and the pod turns Ready.
    """

    def __init__(
        self,
        client: Client,
        name: str = "driver",
        namespace: str = "driver-ns",
        match_labels: Optional[dict[str, str]] = None,
        readiness_steps: int = 0,
        initial_hash: str = "rev-1",
        safe_load_annotation: str = "",
    ) -> None:
        self.client = client
        self.namespace = namespace
        self.readiness_steps = readiness_steps
        self.safe_load_annotation = safe_load_annotation
        #: pod name -> node name, the pods whose init container blocks.
        self._safe_blocked: dict[str, str] = {}
        self._pending_ready: dict[str, int] = {}
        self._revision = 0
        ds = DaemonSet.new(name, namespace=namespace)
        ds.match_labels = dict(match_labels or {"app": name})
        ds.labels.update(ds.match_labels)
        self.ds = DaemonSet(client.create(ds).raw)
        self.current_hash = ""
        self.set_template_hash(initial_hash)

    # -- the rollout ---------------------------------------------------------
    def set_template_hash(self, hash_value: str) -> None:
        """Publish a new driver template revision (an image update)."""
        self._revision += 1
        cr = ControllerRevision.new(f"{self.ds.name}-{hash_value}", namespace=self.namespace)
        cr.revision = self._revision
        cr.labels.update(self.ds.match_labels)
        cr.labels["controller-revision-hash"] = hash_value
        cr.add_owner_reference(self.ds)
        self.client.create(cr)
        self.current_hash = hash_value

    # -- a tick of the controller and the kubelets ---------------------------
    def pod_name(self, node_name: str) -> str:
        return f"{self.ds.name}-{node_name}"

    def _node_names(self) -> list[str]:
        return [o.name for o in self.client.list("Node")]

    def step(self) -> None:
        nodes = self._node_names()
        for node_name in nodes:
            self._ensure_pod(node_name)
        # Readiness before the safe-load gate: a pod unblocked below takes
        # its load tick for real (its counter first counts down on the
        # NEXT tick), so an observer sees the driver-loading window.
        self._advance_readiness()
        self._advance_safe_load()
        self.client.patch(
            "DaemonSet", self.ds.name, self.namespace,
            patch={"status": {"desiredNumberScheduled": len(nodes)}},
        )

    def settle(self, max_steps: int = 10) -> None:
        """Tick until every node has a Ready pod at the newest revision."""
        for _ in range(max_steps):
            self.step()
            if self.all_pods_ready_and_current():
                return

    def _ensure_pod(self, node_name: str) -> None:
        name = self.pod_name(node_name)
        if get_or_none(self.client, "Pod", name, self.namespace) is not None:
            return
        pod = Pod.new(name, namespace=self.namespace)
        pod.node_name = node_name
        pod.labels.update(self.ds.match_labels)
        pod.labels["controller-revision-hash"] = self.current_hash
        pod.add_owner_reference(self.ds)
        if self.safe_load_annotation:
            # The init container's first step: annotate the node and block;
            # the pod stays Pending and NotReady until unblocked.
            self.client.patch(
                "Node", node_name,
                patch={"metadata": {"annotations": {self.safe_load_annotation: "true"}}},
            )
            pod.status["phase"] = "Pending"
            pod.status["conditions"] = [{"type": "Ready", "status": "False"}]
            pod.status["initContainerStatuses"] = [
                {"name": "safe-load-gate", "ready": False, "restartCount": 0}
            ]
            pod.status["containerStatuses"] = [
                {"name": "driver", "ready": False, "restartCount": 0}
            ]
            self._safe_blocked[name] = node_name
        elif self.readiness_steps == 0:
            self._make_ready(pod)
        else:
            pod.status["phase"] = "Pending"
            self._pending_ready[name] = self.readiness_steps
        self.client.create(pod)

    @staticmethod
    def _make_ready(pod: Pod) -> None:
        pod.status["phase"] = "Running"
        pod.status["conditions"] = [{"type": "Ready", "status": "True"}]
        pod.status["containerStatuses"] = [{"name": "driver", "ready": True, "restartCount": 0}]

    def _patch_pod(self, name: str, status: dict) -> bool:
        """Patch a pod's status; False where the pod is gone."""
        try:
            self.client.patch("Pod", name, self.namespace, patch={"status": status})
        except Exception as e:  # noqa: BLE001 - the client's own classes
            if has_reason(e, NotFoundError):
                return False
            raise
        return True

    def _advance_safe_load(self) -> None:
        """The handshake's second step: a blocked init container polls its
        node's annotation; once the state machine removed it, the init
        container completes and the driver loads over the next tick(s)."""
        for pod_name in list(self._safe_blocked):
            node = get_or_none(self.client, "Node", self._safe_blocked[pod_name])
            if node is None:
                del self._safe_blocked[pod_name]
                continue
            annotations = (node.raw.get("metadata") or {}).get("annotations") or {}
            if self.safe_load_annotation in annotations:
                continue  # still blocked
            del self._safe_blocked[pod_name]
            if not self._patch_pod(pod_name, {"initContainerStatuses": [
                {"name": "safe-load-gate", "ready": True, "restartCount": 0}
            ]}):
                continue
            # The driver's load takes at least one tick.
            self._pending_ready[pod_name] = max(1, self.readiness_steps)

    def _advance_readiness(self) -> None:
        for name in list(self._pending_ready):
            self._pending_ready[name] -= 1
            if self._pending_ready[name] > 0:
                continue
            del self._pending_ready[name]
            self._patch_pod(name, {
                "phase": "Running",
                "conditions": [{"type": "Ready", "status": "True"}],
                "containerStatuses": [{"name": "driver", "ready": True, "restartCount": 0}],
            })

    # -- for the caller's checks ---------------------------------------------
    def all_pods_ready_and_current(self) -> bool:
        for node_name in self._node_names():
            obj = get_or_none(self.client, "Pod", self.pod_name(node_name), self.namespace)
            if obj is None:
                return False
            pod = Pod(obj.raw)
            if pod.labels.get("controller-revision-hash") != self.current_hash:
                return False
            if not pod.is_ready():
                return False
        return True


@dataclass
class _PodExec:
    """The kubelet's state for one probe pod's container."""

    proc: subprocess.Popen
    ready_file: str
    started_at: float
    verdict: Optional[bool] = None


class KubeletPayloadExecutor:
    """The kubelet's container and readiness probe, for real.

    Runs a probe pod's container command as a child process (the
    ``python -m k8s_operator_libs_tpu_torch.tpu.health --ready-file ...
    --park`` argv the pod carries, ``tpu/validation_pod.py``) and reads its
    readiness as the pod's exec readiness probe does: the ready file
    existing. Plugged into :class:`ValidationPodSimulator`, the payload
    writing its ready file is what turns the pod Ready, so the chain
    payload, ready file, readiness probe, pod Ready, validation pass,
    uncordon has no scripted verdict in it.

    Each pod's ready file is moved to a private temporary directory (pods
    share no filesystem). ``env`` is the children's environment (the
    container's own ``env`` is not applied); ``extra_args`` appends
    payload flags (``--device cpu`` in the tests); ``argv_transform``
    rewrites a pod's argv before the spawn (to keep its output, say).
    ``python`` in the argv is this interpreter.

    Unlike a real kubelet, processes are keyed by pod NAME: a same-named
    pod made between two ticks inherits the earlier verdict. ``release``
    (the garbage collection of a pod seen deleted at a tick) covers the
    rest.
    """

    def __init__(
        self,
        env: Optional[dict] = None,
        extra_args: Optional[list[str]] = None,
        timeout_seconds: float = 600.0,
        argv_transform: Optional[Callable[[Pod, list[str]], list[str]]] = None,
    ) -> None:
        self.env = env
        self.extra_args = list(extra_args or [])
        self.timeout_seconds = timeout_seconds
        self.argv_transform = argv_transform
        #: One record a tracked pod, popped whole on release, so no stale
        #: verdict or ready file outlives its pod.
        self._pods: dict[str, _PodExec] = {}
        self._tmpdir = tempfile.TemporaryDirectory(prefix="kubelet-exec-")
        #: Every verdict recorded, kept after release: the audit trail.
        self.history: dict[str, bool] = {}

    def _start(self, pod: Pod) -> _PodExec:
        (container,) = pod.spec["containers"]
        argv = list(container["command"]) + self.extra_args
        argv[0] = sys.executable  # "python" in the image is this interpreter
        if self.argv_transform is not None:
            argv = self.argv_transform(pod, argv)
        ready_file = os.path.join(self._tmpdir.name, f"{pod.name}.ready")
        if os.path.exists(ready_file):  # never trust a stale pass
            os.unlink(ready_file)
        if "--ready-file" in argv:
            argv[argv.index("--ready-file") + 1] = ready_file
        else:
            argv += ["--ready-file", ready_file]
        proc = subprocess.Popen(
            argv, env=self.env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True,
        )
        return _PodExec(proc=proc, ready_file=ready_file, started_at=time.monotonic())

    def poll(self, pod: Pod) -> Optional[bool]:
        """One kubelet tick of the pod's container: True once the readiness
        probe passes (the payload wrote its ready file), False when the
        container failed (a non-zero exit, or the deadline), None while the
        battery runs."""
        name = pod.name
        rec = self._pods.get(name)
        if rec is None:
            self._pods[name] = self._start(pod)
            return None
        if rec.verdict is not None:
            return rec.verdict
        if os.path.exists(rec.ready_file):
            # --park keeps the process, and the Ready condition, alive: the
            # verdict is the probe's, not the exit code's.
            return self._record(name, True)
        rc = rec.proc.poll()
        if rc is not None:
            return self._record(name, rc == 0 and os.path.exists(rec.ready_file))
        if time.monotonic() - rec.started_at > self.timeout_seconds:
            self._kill(rec)
            return self._record(name, False)
        return None

    def _record(self, name: str, verdict: bool) -> bool:
        self._pods[name].verdict = verdict
        self.history[name] = verdict
        return verdict

    def ready_file_content(self, pod_name: str) -> Optional[str]:
        rec = self._pods.get(pod_name)
        if rec is None or not os.path.exists(rec.ready_file):
            return None
        with open(rec.ready_file) as fh:
            return fh.read()

    @staticmethod
    def _kill(rec: _PodExec) -> None:
        if rec.proc.poll() is not None:
            return
        try:
            os.killpg(rec.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            rec.proc.kill()
        try:
            rec.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:  # pragma: no cover - kernel lag
            pass

    def tracked_pods(self) -> set[str]:
        """Pods with a live payload process or a recorded verdict."""
        return set(self._pods)

    def release(self, pod_name: str) -> None:
        """The pod was deleted: kill its (possibly parked) payload and drop
        every trace, so a later same-named pod earns a fresh verdict."""
        rec = self._pods.pop(pod_name, None)
        if rec is None:
            return
        self._kill(rec)
        if os.path.exists(rec.ready_file):
            os.unlink(rec.ready_file)

    def close(self) -> None:
        for name in list(self._pods):
            self.release(name)
        self._tmpdir.cleanup()

    def __enter__(self) -> "KubeletPayloadExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ValidationPodSimulator:
    """The kubelet for the probe pods that ``ValidationPodManager.ensure``
    pins to nodes (``tpu/validation_pod.py``). Each ``step`` advances the
    pods not yet Ready nor finished: after ``readiness_steps`` ticks a pod
    turns Ready when ``decide(pod)`` says its node is healthy, or Failed
    (the payload exited non-zero; the pods do not restart) when it does
    not. ``decide`` defaults to healthy. With ``executor`` (a
    :class:`KubeletPayloadExecutor`) the pod's own command runs instead and
    the verdict is its readiness probe's; a pod seen deleted has its
    payload killed.
    """

    def __init__(
        self,
        client: Client,
        namespace: str = "kube-system",
        label_selector: Optional[str] = None,
        readiness_steps: int = 1,
        decide: Optional[Callable[[Pod], bool]] = None,
        executor: Optional[KubeletPayloadExecutor] = None,
    ) -> None:
        if label_selector is None:
            # The manager's probe-pod selector; imported here, as tpu/
            # imports kube/.
            from ..tpu.validation_pod import VALIDATION_APP, VALIDATION_APP_LABEL

            label_selector = f"{VALIDATION_APP_LABEL}={VALIDATION_APP}"
        self.client = client
        self.namespace = namespace
        self.label_selector = label_selector
        self.readiness_steps = readiness_steps
        self.decide = decide or (lambda pod: True)
        self.executor = executor
        self._pending: dict[str, int] = {}

    def step(self) -> None:
        pods = [
            Pod(o.raw)
            for o in self.client.list(
                "Pod", namespace=self.namespace, label_selector=self.label_selector
            )
        ]
        seen = set()
        for pod in pods:
            if pod.is_finished() or pod.is_ready():
                continue
            seen.add(pod.name)
            if self.executor is not None:
                verdict = self.executor.poll(pod)
                if verdict is None:
                    continue  # the battery still runs
                healthy = verdict
            else:
                remaining = self._pending.get(pod.name, self.readiness_steps) - 1
                if remaining > 0:
                    self._pending[pod.name] = remaining
                    continue
                self._pending.pop(pod.name, None)
                healthy = self.decide(pod)
            status = {
                "phase": "Running" if healthy else "Failed",
                "conditions": [{"type": "Ready", "status": "True" if healthy else "False"}],
                "containerStatuses": [{"name": "probe", "ready": healthy, "restartCount": 0}],
            }
            try:
                self.client.patch("Pod", pod.name, self.namespace, patch={"status": status})
            except Exception as e:  # noqa: BLE001 - the client's own classes
                if not has_reason(e, NotFoundError):
                    raise
        # Drop the counters of pods that are gone.
        for name in list(self._pending):
            if name not in seen:
                del self._pending[name]
        if self.executor is not None:
            # The kubelet's garbage collection: a deleted pod's payload,
            # parked or still probing, is killed and its devices freed.
            live = {pod.name for pod in pods}
            for name in self.executor.tracked_pods() - live:
                self.executor.release(name)


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
