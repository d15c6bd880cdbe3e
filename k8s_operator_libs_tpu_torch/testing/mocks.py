"""Recording mocks of the state machine's injectable managers.

The JAX package's ``testing/mocks.py``, the counterpart of the upstream
library's ``pkg/upgrade/mocks``. Each mock records every call as a
:class:`Call`, so a test can check exactly what the machine asked for;
outcomes are set through plain attributes and callables (testify's
``.On(...).Return(...)``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..upgrade.consts import NULL_STRING, UpgradeKeys, UpgradeState


@dataclass
class Call:
    """One recorded invocation: method name + positional summary."""

    method: str
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)


class _Recording:
    def __init__(self) -> None:
        self.calls: list[Call] = []

    def _record(self, method: str, *args, **kwargs) -> None:
        self.calls.append(Call(method, args, kwargs))

    def calls_to(self, method: str) -> list[Call]:
        return [c for c in self.calls if c.method == method]

    def reset(self) -> None:
        self.calls.clear()


class MockCordonManager(_Recording):
    """upstream: pkg/upgrade/mocks/CordonManager.go.

    ``fail_on`` is a set of node names whose cordon/uncordon raises.
    """

    def __init__(self, fail_on: Optional[set[str]] = None) -> None:
        super().__init__()
        self.fail_on = fail_on or set()
        self.cordoned: list[str] = []
        self.uncordoned: list[str] = []

    def cordon(self, node) -> None:
        self._record("cordon", node.name)
        if node.name in self.fail_on:
            raise RuntimeError(f"mock cordon failure for {node.name}")
        self.cordoned.append(node.name)
        node.spec["unschedulable"] = True

    def uncordon(self, node) -> None:
        self._record("uncordon", node.name)
        if node.name in self.fail_on:
            raise RuntimeError(f"mock uncordon failure for {node.name}")
        self.uncordoned.append(node.name)
        node.spec.pop("unschedulable", None)


class MockDrainManager(_Recording):
    """upstream: pkg/upgrade/mocks/DrainManager.go.

    By default records the request and does nothing (the async contract:
    scheduling is fire-and-forget, outcomes arrive as later state writes).
    Set ``on_schedule`` to drive node states synchronously in a test.
    """

    def __init__(
        self, on_schedule: Optional[Callable[[object], None]] = None
    ) -> None:
        super().__init__()
        self.on_schedule = on_schedule

    def schedule_nodes_drain(self, config) -> None:
        self._record(
            "schedule_nodes_drain", tuple(n.name for n in config.nodes)
        )
        if self.on_schedule is not None:
            self.on_schedule(config)


class MockPodManager(_Recording):
    """upstream: pkg/upgrade/mocks/PodManager.go.

    Revision-hash behavior: every pod/daemonset reports ``revision_hash``
    unless the pod's name is listed in ``out_of_sync_pods`` — the same fixed
    "test-hash-12345" the upstream suite uses.
    """

    def __init__(
        self,
        revision_hash: str = "test-hash-12345",
        out_of_sync_pods: Optional[set[str]] = None,
        pod_deletion_filter=None,
    ) -> None:
        super().__init__()
        self.revision_hash = revision_hash
        self.out_of_sync_pods = out_of_sync_pods or set()
        self._pod_deletion_filter = pod_deletion_filter
        self.restarted: list[str] = []

    @property
    def pod_deletion_filter(self):
        return self._pod_deletion_filter

    def get_pod_controller_revision_hash(self, pod) -> str:
        self._record("get_pod_controller_revision_hash", pod.name)
        if pod.name in self.out_of_sync_pods:
            return f"stale-{self.revision_hash}"
        return self.revision_hash

    def get_daemonset_controller_revision_hash(self, daemonset) -> str:
        self._record("get_daemonset_controller_revision_hash", daemonset.name)
        return self.revision_hash

    def schedule_pod_eviction(self, config) -> None:
        self._record(
            "schedule_pod_eviction", tuple(n.name for n in config.nodes)
        )

    def schedule_pods_restart(self, pods) -> None:
        names = tuple(p.name for p in pods)
        self._record("schedule_pods_restart", names)
        self.restarted.extend(names)

    def schedule_check_on_pod_completion(self, config) -> None:
        self._record(
            "schedule_check_on_pod_completion",
            tuple(n.name for n in config.nodes),
        )

    def handle_timeout_on_pod_completions(self, *args, **kwargs) -> None:
        self._record("handle_timeout_on_pod_completions")


class MockValidationManager(_Recording):
    """upstream: pkg/upgrade/mocks/ValidationManager.go.

    ``verdicts`` maps node name -> bool; unlisted nodes return ``default``.
    """

    def __init__(
        self, default: bool = True, verdicts: Optional[dict[str, bool]] = None
    ) -> None:
        super().__init__()
        self.default = default
        self.verdicts = verdicts or {}
        self.enabled = True

    def validate(self, node) -> bool:
        self._record("validate", node.name)
        return self.verdicts.get(node.name, self.default)


class MockNodeUpgradeStateProvider(_Recording):
    """upstream: pkg/upgrade/mocks/NodeUpgradeStateProvider.go, with the
    upstream suite's stateful behaviour: state and annotation writes change
    the in-memory node object directly, so state-machine tests check label
    transitions without any API server.
    """

    def __init__(self, keys: UpgradeKeys, nodes: Optional[dict] = None) -> None:
        super().__init__()
        self.keys = keys
        self.nodes = nodes or {}

    def add_node(self, node) -> None:
        self.nodes[node.name] = node

    def get_node(self, name: str):
        self._record("get_node", name)
        return self.nodes[name]

    def get_upgrade_state(self, node) -> UpgradeState:
        raw = node.labels.get(self.keys.state_label, "")
        try:
            return UpgradeState(raw)
        except ValueError:
            return UpgradeState.UNKNOWN

    def change_node_upgrade_state(self, node, new_state) -> None:
        new_state = UpgradeState(new_state)
        self._record("change_node_upgrade_state", node.name, str(new_state))
        if new_state == UpgradeState.UNKNOWN:
            node.labels.pop(self.keys.state_label, None)
        else:
            node.labels[self.keys.state_label] = str(new_state)

    def change_node_upgrade_annotation(self, node, key: str, value: str) -> None:
        self._record("change_node_upgrade_annotation", node.name, key, value)
        if value == NULL_STRING:
            node.annotations.pop(key, None)
        else:
            node.annotations[key] = value


def install_mocks(
    manager,
    cordon: Optional[MockCordonManager] = None,
    drain: Optional[MockDrainManager] = None,
    pod: Optional[MockPodManager] = None,
    validation: Optional[MockValidationManager] = None,
):
    """Swap a ClusterUpgradeStateManager's node-op managers for mocks, the
    injection point the upstream suite uses. Returns the installed mocks as a tuple
    ``(cordon, drain, pod, validation)``.
    """
    cordon = cordon or MockCordonManager()
    drain = drain or MockDrainManager()
    pod = pod or MockPodManager()
    validation = validation or MockValidationManager()
    manager.common.cordon_manager = cordon
    manager.common.drain_manager = drain
    manager.common.pod_manager = pod
    manager.common.validation_manager = validation
    return cordon, drain, pod, validation
