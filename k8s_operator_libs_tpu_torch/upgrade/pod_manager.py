"""PodManager: the driver pod's revision, workload eviction, driver pod
restarts and the wait for workload pods to complete.

The JAX package's ``upgrade/pod_manager.py`` without its tracing spans and
its informer-backed revision reads: the DaemonSet's revision comes from a
LIST of its ControllerRevisions, kept for one snapshot.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from ..api.upgrade_v1alpha1 import PodDeletionSpec, WaitForCompletionSpec
from ..kube.client import Client, NotFoundError, get_or_none, has_reason
from ..kube.drain import DrainConfig, DrainError, DrainHelper
from ..kube.objects import ControllerRevision, DaemonSet, Node, Pod
from ..utils.faultpoints import wall_now
from ..utils.log import get_logger
from .consts import NULL_STRING, UpgradeKeys, UpgradeState
from .state_provider import NodeUpgradeStateProvider
from .task_runner import TaskRunner

log = get_logger("upgrade.pod")

#: True for a pod that must be deleted before the driver upgrade.
PodDeletionFilter = Callable[[Pod], bool]


class RevisionHashError(Exception):
    pass


@dataclass
class PodManagerConfig:
    nodes: Sequence[Node]
    deletion_spec: Optional[PodDeletionSpec] = None
    wait_for_completion_spec: Optional[WaitForCompletionSpec] = None
    drain_enabled: bool = False
    #: Where a node goes once its awaited workload pods finished or their
    #: wait timed out: ``pod-deletion-required``, or ``checkpoint-required``
    #: where the policy enables the checkpoint arc.
    completion_next_state: UpgradeState = UpgradeState.POD_DELETION_REQUIRED


class PodManager:
    def __init__(
        self,
        client: Client,
        state_provider: NodeUpgradeStateProvider,
        keys: UpgradeKeys,
        pod_deletion_filter: Optional[PodDeletionFilter] = None,
        runner: Optional[TaskRunner] = None,
        recorder=None,
        apply_width: Optional[int] = None,
    ) -> None:
        self._client = client
        self._provider = state_provider
        self._keys = keys
        self._filter = pod_deletion_filter
        self._runner = runner if runner is not None else TaskRunner()
        self._recorder = recorder
        self._apply_width = apply_width
        # DaemonSet uid -> (resourceVersion, rollout hash): one LIST of
        # ControllerRevisions a DaemonSet per snapshot, not one per node.
        # Cleared by every build_state, so a rollout that adds a revision
        # without touching the DaemonSet is read by the next pass.
        self._ds_hash_lock = threading.Lock()
        self._ds_hash_cache: dict[str, tuple[str, str]] = {}

    def reset_pass_caches(self) -> None:
        with self._ds_hash_lock:
            self._ds_hash_cache.clear()

    def _join_bucket(self, tasks: Sequence[tuple[str, Callable[[], None]]]) -> None:
        """Run the tasks as a bucket, then raise its first error."""
        for error in self._runner.run_bucket(tasks, width=self._apply_width):
            if error is not None:
                raise error

    # -- revision-hash sync ------------------------------------------------
    def get_pod_controller_revision_hash(self, pod: Pod) -> str:
        hash_value = pod.controller_revision_hash()
        if not hash_value:
            raise RevisionHashError(
                f"controller-revision-hash label not present for pod {pod.name}"
            )
        return hash_value

    def get_daemonset_controller_revision_hash(self, daemonset: DaemonSet) -> str:
        """The DaemonSet's latest rollout hash: its ControllerRevision of
        the highest revision, the name without the ``<ds-name>-`` prefix."""
        uid, rv = daemonset.uid, daemonset.resource_version
        if uid and rv:
            with self._ds_hash_lock:
                hit = self._ds_hash_cache.get(uid)
            if hit is not None and hit[0] == rv:
                return hit[1]
        revisions = [
            cr
            for cr in (
                ControllerRevision(o.raw)
                for o in self._client.list(
                    "ControllerRevision",
                    namespace=daemonset.namespace,
                    label_selector=daemonset.match_labels,
                )
            )
            if cr.name.startswith(daemonset.name)
        ]
        if not revisions:
            raise RevisionHashError(f"no revision found for daemonset {daemonset.name}")
        latest = max(revisions, key=lambda r: r.revision)
        hash_value = latest.name.removeprefix(f"{daemonset.name}-")
        if uid and rv:
            with self._ds_hash_lock:
                self._ds_hash_cache[uid] = (rv, hash_value)
        return hash_value

    # -- workload eviction -------------------------------------------------
    def schedule_pod_eviction(self, config: PodManagerConfig) -> None:
        if not config.nodes:
            log.info("no nodes scheduled for pod deletion")
            return
        if config.deletion_spec is None:
            raise ValueError("pod deletion spec should not be empty")
        if self._filter is None:
            raise ValueError("pod deletion filter not configured")
        spec = config.deletion_spec
        for node in config.nodes:
            if not self._runner.submit(
                node.name, lambda node=node: self._evict_one(node, spec, config)
            ):
                log.info("node %s already getting pods deleted, skipping", node.name)

    def _evict_one(self, node: Node, spec: PodDeletionSpec, config: PodManagerConfig) -> None:
        assert self._filter is not None
        if not any(self._filter(p) for p in self.list_pods(node_name=node.name)):
            log.info("no pods require deletion on node %s", node.name)
            self._provider.change_node_upgrade_state(node, UpgradeState.POD_RESTART_REQUIRED)
            return
        helper = DrainHelper(self._client)
        drain_cfg = DrainConfig(
            force=spec.force,
            delete_empty_dir=spec.delete_empty_dir,
            timeout_seconds=spec.timeout_seconds,
            extra_filters=(self._filter,),
        )
        try:
            eligible = helper.pods_to_evict(node.name, drain_cfg)
        except DrainError as e:
            # A pod selected for deletion is ineligible: deletion alone
            # cannot clear the node.
            log.error("cannot delete all required pods on %s: %s", node.name, e)
            self._update_node_to_drain_or_failed(node, config.drain_enabled)
            return
        try:
            for pod in eligible:
                self._client.evict(pod.name, pod.namespace)
            waited_s = self._wait_pods_gone(eligible, spec.timeout_seconds)
        except (DrainError, TimeoutError) as e:
            log.error("failed to delete pods on node %s: %s", node.name, e)
            self._event(
                node, "Warning",
                f"Failed to delete workload pods on the node for the driver upgrade, {e}",
            )
            self._update_node_to_drain_or_failed(node, config.drain_enabled)
            return
        log.info(
            "deleted %d pods on node %s (waited %.3fs for termination)",
            len(eligible), node.name, waited_s,
        )
        self._event(node, "Normal", "Deleted workload pods on the node for the driver upgrade")
        self._provider.change_node_upgrade_state(node, UpgradeState.POD_RESTART_REQUIRED)

    def _wait_pods_gone(
        self, pods: Sequence[Pod], timeout_seconds: int, poll: float = 0.05
    ) -> float:
        """Wait for evicted pods to go, polling from ``poll/16`` up to
        ``poll``; the seconds waited."""
        start = time.monotonic()
        deadline = start + timeout_seconds if timeout_seconds else None
        remaining = {(p.namespace, p.name) for p in pods}
        delay = poll / 16
        while remaining:
            remaining = {
                (ns, name)
                for ns, name in remaining
                if get_or_none(self._client, "Pod", name, ns) is not None
            }
            if not remaining:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{len(remaining)} pods still present after {timeout_seconds}s"
                )
            time.sleep(delay)
            delay = min(delay * 2, poll)
        return time.monotonic() - start

    def _update_node_to_drain_or_failed(self, node: Node, drain_enabled: bool) -> None:
        next_state = UpgradeState.FAILED
        if drain_enabled:
            log.info("pod deletion failed on %s but drain is enabled; will drain", node.name)
            self._event(
                node, "Warning",
                "Pod deletion failed but drain is enabled in spec. "
                "Will attempt a node drain",
            )
            next_state = UpgradeState.DRAIN_REQUIRED
        self._provider.change_node_upgrade_state(node, next_state)

    # -- driver pod restart ------------------------------------------------
    def schedule_pods_restart(self, pods: Sequence[Pod]) -> None:
        """Delete driver pods so their DaemonSet makes them again at the new
        revision; every delete is tried, then the first error raised."""
        if not pods:
            log.info("no pods scheduled to restart")
            return

        def restart(pod: Pod) -> None:
            log.info("deleting pod %s/%s", pod.namespace, pod.name)
            try:
                self._client.delete("Pod", pod.name, pod.namespace)
            except Exception as e:  # noqa: BLE001 - the client's own classes
                if has_reason(e, NotFoundError):
                    return  # already gone: the restart's goal
                self._event(pod, "Warning", f"Failed to restart driver pod {e}")
                raise

        self._join_bucket(
            [(f"{pod.namespace}/{pod.name}", (lambda pod=pod: restart(pod))) for pod in pods]
        )

    # -- completion waits --------------------------------------------------
    def schedule_check_on_pod_completion(self, config: PodManagerConfig) -> None:
        """Move each node whose awaited workload pods have finished on to
        ``config.completion_next_state``; otherwise leave it, with its
        timeout clock running. Joined before it returns."""
        if config.wait_for_completion_spec is None:
            raise ValueError("wait-for-completion spec should not be empty")
        spec = config.wait_for_completion_spec

        def check(node: Node) -> None:
            pods = self.list_pods(selector=spec.pod_selector, node_name=node.name)
            if any(self.is_pod_running_or_pending(p) for p in pods):
                log.info("workload pods still running on node %s", node.name)
                if spec.timeout_seconds != 0:
                    self.handle_timeout_on_pod_completions(
                        node, spec.timeout_seconds, next_state=config.completion_next_state
                    )
                return
            self._provider.change_node_upgrade_annotation(
                node, self._keys.wait_for_pod_completion_start_annotation, NULL_STRING
            )
            self._provider.change_node_upgrade_state(node, config.completion_next_state)

        self._join_bucket([(node.name, (lambda node=node: check(node))) for node in config.nodes])

    def handle_timeout_on_pod_completions(
        self,
        node: Node,
        timeout_seconds: int,
        next_state: UpgradeState = UpgradeState.POD_DELETION_REQUIRED,
    ) -> None:
        """Start, or check, the durable start-time annotation; at its
        expiry the node goes on to ``next_state``, and then the annotation
        is cleared (the JAX machine's order of writes and events)."""
        key = self._keys.wait_for_pod_completion_start_annotation
        now = int(wall_now())
        start_raw = node.annotations.get(key)
        try:
            expired = start_raw is not None and now > int(start_raw) + timeout_seconds
        except ValueError:
            log.error("node %s has invalid completion start-time %r; resetting",
                      node.name, start_raw)
            start_raw = None
        if start_raw is None:
            self._provider.change_node_upgrade_annotation(node, key, str(now))
        elif expired:
            self._provider.change_node_upgrade_state(node, next_state)
            self._provider.change_node_upgrade_annotation(node, key, NULL_STRING)

    # -- helpers -----------------------------------------------------------
    def list_pods(self, selector: str = "", node_name: str = "") -> list[Pod]:
        """Pods of every namespace by label selector and node."""
        field_selector = f"spec.nodeName={node_name}" if node_name else None
        return [
            Pod(o.raw)
            for o in self._client.list(
                "Pod", label_selector=selector or None, field_selector=field_selector
            )
        ]

    @staticmethod
    def is_pod_running_or_pending(pod: Pod) -> bool:
        return pod.phase in ("Running", "Pending")

    def _event(self, obj, event_type: str, message: str) -> None:
        if self._recorder is not None:
            self._recorder.eventf(obj, event_type, self._keys.event_reason(), message)
