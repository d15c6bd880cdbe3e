"""Driver upgrade policy types (v1alpha1).

A copy of the JAX package's ``api/upgrade_v1alpha1.py``: the policy an
operator embeds in its CRD, with the same camelCase JSON, the same
defaults (``autoUpgrade`` false, ``maxParallelUpgrades`` 1,
``maxUnavailable`` "25%", drain and pod-deletion timeouts 300 s) and the
same eager validation, so every policy document of the JAX package parses
here and ``to_dict`` gives it back unchanged. ``CheckpointSpec`` drives
the checkpoint arc (``upgrade/checkpoint_manager.py``) and
``QuarantineSpec`` the quarantine arc (``upgrade/quarantine_manager.py``).

The WorkloadCheckpoint contract is the workload's side of the checkpoint
arc: asked to checkpoint, a workload persists its state, records it as a
WorkloadCheckpoint object named after its pod, and acks on the pod; the
restore-verified uncordon checks these objects against the node's
checkpoint manifest.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

from ..utils.intstr import IntOrString

DEFAULT_MAX_UNAVAILABLE = IntOrString("25%")
DEFAULT_DRAIN_TIMEOUT_SECONDS = 300
DEFAULT_POD_DELETION_TIMEOUT_SECONDS = 300
DEFAULT_CHECKPOINT_TIMEOUT_SECONDS = 300

WORKLOAD_CHECKPOINT_KIND = "WorkloadCheckpoint"
WORKLOAD_CHECKPOINT_API_VERSION = "upgrade.tpu-operator.dev/v1alpha1"
WORKLOAD_CHECKPOINT_PLURAL = "workloadcheckpoints"


def workload_checkpoint_name(pod_name: str) -> str:
    """The name of a pod's WorkloadCheckpoint: both sides of the contract
    derive it from the pod's name."""
    return f"{pod_name}-checkpoint"


def make_workload_checkpoint(
    pod_name: str,
    namespace: str,
    node_name: str,
    step: int,
    request_id: str = "",
) -> dict[str, Any]:
    """A raw WorkloadCheckpoint object, for any client's ``create``."""
    return {
        "apiVersion": WORKLOAD_CHECKPOINT_API_VERSION,
        "kind": WORKLOAD_CHECKPOINT_KIND,
        "metadata": {
            "name": workload_checkpoint_name(pod_name),
            "namespace": namespace,
        },
        "spec": {
            "podName": pod_name,
            "nodeName": node_name,
            "step": int(step),
            "requestId": request_id,
        },
    }


def workload_checkpoint_step(raw: Mapping[str, Any]) -> int:
    """The training step a WorkloadCheckpoint was taken at; -1 for a
    malformed object, so that a corrupt checkpoint reads as unusable
    rather than as step 0."""
    try:
        return int((raw.get("spec") or {}).get("step"))
    except (TypeError, ValueError):
        return -1


def _require_non_negative(name: str, value: int) -> None:
    if value < 0:
        raise ValueError(f"{name} must be >= 0, got {value}")


@dataclass(frozen=True)
class WaitForCompletionSpec:
    """Wait for selected workload pods to complete before upgrading."""

    pod_selector: str = ""
    #: Zero means wait forever.
    timeout_seconds: int = 0

    def __post_init__(self) -> None:
        _require_non_negative("waitForCompletion.timeoutSeconds", self.timeout_seconds)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "WaitForCompletionSpec":
        return WaitForCompletionSpec(
            pod_selector=d.get("podSelector", ""),
            timeout_seconds=int(d.get("timeoutSeconds", 0)),
        )

    def to_dict(self) -> dict[str, Any]:
        return {"podSelector": self.pod_selector, "timeoutSeconds": self.timeout_seconds}


@dataclass(frozen=True)
class PodDeletionSpec:
    """Deletion of pods using special resources during automatic upgrade."""

    force: bool = False
    timeout_seconds: int = DEFAULT_POD_DELETION_TIMEOUT_SECONDS
    delete_empty_dir: bool = False

    def __post_init__(self) -> None:
        _require_non_negative("podDeletion.timeoutSeconds", self.timeout_seconds)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "PodDeletionSpec":
        return PodDeletionSpec(
            force=bool(d.get("force", False)),
            timeout_seconds=int(
                d.get("timeoutSeconds", DEFAULT_POD_DELETION_TIMEOUT_SECONDS)
            ),
            delete_empty_dir=bool(d.get("deleteEmptyDir", False)),
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "force": self.force,
            "timeoutSeconds": self.timeout_seconds,
            "deleteEmptyDir": self.delete_empty_dir,
        }


@dataclass(frozen=True)
class CheckpointSpec:
    """Checkpoint-coordinated drain: before evicting workload pods, ask
    the ones matching ``pod_selector`` to checkpoint and gate the drain
    on their acks, escalating to a plain drain when the per-node deadline
    expires (the JAX package's docs/checkpoint-drain.md).

    ``timeout_seconds`` must be positive: a zero deadline would mean
    "wait forever", and the whole point of the escalation is that a
    wedged workload can never stall the roll. An enabled spec must also
    name a ``pod_selector``: an empty selector would select EVERY pod on
    the node (driver and system pods included), none of which ack — the
    whole roll would stall to the deadline and spuriously escalate.
    """

    enable: bool = False
    #: Label selector naming the checkpoint-coordinated workload pods.
    pod_selector: str = ""
    #: Per-node checkpoint deadline; expiry escalates to a plain drain.
    timeout_seconds: int = DEFAULT_CHECKPOINT_TIMEOUT_SECONDS
    #: Verify the recorded WorkloadCheckpoint CRs before uncordon (the
    #: restore-verified step); failures degrade after the deadline, they
    #: never stall the roll. False skips the verification (the manifest
    #: is still recorded and retired).
    verify_restore: bool = True

    def __post_init__(self) -> None:
        if self.timeout_seconds <= 0:
            raise ValueError(
                "checkpoint.timeoutSeconds must be > 0, got "
                f"{self.timeout_seconds} (a checkpoint arc without a "
                "deadline could stall the roll forever)"
            )
        if self.enable and not self.pod_selector:
            raise ValueError(
                "checkpoint.podSelector is required when checkpoint "
                "coordination is enabled (an empty selector would ask "
                "every pod on the node — driver pods included — to "
                "checkpoint, and none would ack)"
            )

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "CheckpointSpec":
        return CheckpointSpec(
            enable=bool(d.get("enable", False)),
            pod_selector=d.get("podSelector", ""),
            timeout_seconds=int(
                d.get("timeoutSeconds", DEFAULT_CHECKPOINT_TIMEOUT_SECONDS)
            ),
            verify_restore=bool(d.get("verifyRestore", True)),
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "enable": self.enable,
            "podSelector": self.pod_selector,
            "timeoutSeconds": self.timeout_seconds,
            "verifyRestore": self.verify_restore,
        }


@dataclass(frozen=True)
class QuarantineSpec:
    """Quarantine-on-degradation (the JAX package's
    docs/fleet-telemetry.md): a node whose telemetry health score
    (NodeHealthReport, ``api/telemetry_v1alpha1.py``) drops below
    ``unhealthy_score`` *outside any roll* is cordoned into the
    ``quarantined`` state, re-evaluated on an exponential backoff clock,
    and either rejoins once its score recovers past
    ``recovery_score`` (hysteresis — the two thresholds must differ or a
    score sitting at the line would flap cordon/uncordon every backoff
    tick) or, after ``handoff_after_seconds`` without recovery, is
    handed to the upgrade pipeline as a repair candidate. Admission is
    budget-aware: quarantine shares the roll's ``maxUnavailable``
    accounting, so a correlated telemetry flap can never cordon more
    capacity than the disruption budget allows."""

    enable: bool = False
    #: Entry threshold: scores strictly below this quarantine the node.
    unhealthy_score: float = 50.0
    #: Rejoin threshold (must be > unhealthy_score): hysteresis.
    recovery_score: float = 70.0
    #: Initial re-evaluation backoff; doubles per failed recheck.
    reprobe_backoff_seconds: int = 60
    #: Backoff cap.
    max_backoff_seconds: int = 900
    #: Quarantined this long without recovery ⇒ handed to the upgrade
    #: pipeline (upgrade-required, still cordoned). 0 disables handoff.
    handoff_after_seconds: int = 3600

    def __post_init__(self) -> None:
        if not 0.0 <= self.unhealthy_score <= 100.0:
            raise ValueError(
                "quarantine.unhealthyScore must be in [0, 100], got "
                f"{self.unhealthy_score}"
            )
        if self.recovery_score <= self.unhealthy_score:
            raise ValueError(
                "quarantine.recoveryScore must be > unhealthyScore "
                f"({self.recovery_score} <= {self.unhealthy_score}): "
                "without hysteresis a score jittering at the line flaps "
                "cordon/uncordon on every recheck"
            )
        if self.reprobe_backoff_seconds <= 0:
            raise ValueError(
                "quarantine.reprobeBackoffSeconds must be > 0, got "
                f"{self.reprobe_backoff_seconds}"
            )
        if self.max_backoff_seconds < self.reprobe_backoff_seconds:
            raise ValueError(
                "quarantine.maxBackoffSeconds must be >= "
                "reprobeBackoffSeconds"
            )
        _require_non_negative(
            "quarantine.handoffAfterSeconds", self.handoff_after_seconds
        )

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "QuarantineSpec":
        return QuarantineSpec(
            enable=bool(d.get("enable", False)),
            unhealthy_score=float(d.get("unhealthyScore", 50.0)),
            recovery_score=float(d.get("recoveryScore", 70.0)),
            reprobe_backoff_seconds=int(d.get("reprobeBackoffSeconds", 60)),
            max_backoff_seconds=int(d.get("maxBackoffSeconds", 900)),
            handoff_after_seconds=int(d.get("handoffAfterSeconds", 3600)),
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "enable": self.enable,
            "unhealthyScore": self.unhealthy_score,
            "recoveryScore": self.recovery_score,
            "reprobeBackoffSeconds": self.reprobe_backoff_seconds,
            "maxBackoffSeconds": self.max_backoff_seconds,
            "handoffAfterSeconds": self.handoff_after_seconds,
        }


@dataclass(frozen=True)
class DrainSpec:
    """Node drain configuration during automatic upgrade."""

    enable: bool = False
    force: bool = False
    pod_selector: str = ""
    timeout_seconds: int = DEFAULT_DRAIN_TIMEOUT_SECONDS
    delete_empty_dir: bool = False

    def __post_init__(self) -> None:
        _require_non_negative("drain.timeoutSeconds", self.timeout_seconds)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "DrainSpec":
        return DrainSpec(
            enable=bool(d.get("enable", False)),
            force=bool(d.get("force", False)),
            pod_selector=d.get("podSelector", ""),
            timeout_seconds=int(d.get("timeoutSeconds", DEFAULT_DRAIN_TIMEOUT_SECONDS)),
            delete_empty_dir=bool(d.get("deleteEmptyDir", False)),
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "enable": self.enable,
            "force": self.force,
            "podSelector": self.pod_selector,
            "timeoutSeconds": self.timeout_seconds,
            "deleteEmptyDir": self.delete_empty_dir,
        }


@dataclass(frozen=True)
class DriverUpgradePolicySpec:
    """Policy for automatic driver upgrades. ``auto_upgrade`` is the global
    switch: when false, every other option is ignored."""

    auto_upgrade: bool = False
    #: 0 means no limit — all nodes upgraded in parallel.
    max_parallel_upgrades: int = 1
    #: Absolute count or percentage of total nodes, rounded up.
    max_unavailable: Optional[IntOrString] = field(
        default_factory=lambda: DEFAULT_MAX_UNAVAILABLE
    )
    pod_deletion: Optional[PodDeletionSpec] = None
    wait_for_completion: Optional[WaitForCompletionSpec] = None
    drain: Optional[DrainSpec] = None
    checkpoint: Optional[CheckpointSpec] = None
    quarantine: Optional[QuarantineSpec] = None
    #: Policy-plugin composition (``policy.for_spec``): registry
    #: names, applied in order (first = most significant). Empty means
    #: the "default" policy.
    #: Validated against the registry at composition time (the spec
    #: layer stays kube-shaped and registry-free).
    policy: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        _require_non_negative("maxParallelUpgrades", self.max_parallel_upgrades)
        object.__setattr__(self, "policy", tuple(self.policy))
        if any(not n or not isinstance(n, str) for n in self.policy):
            raise ValueError(
                "policy entries must be non-empty registry names, got "
                f"{self.policy!r}"
            )

    def resolved_max_unavailable(self, total_nodes: int) -> int:
        """Scale ``max_unavailable`` against the cluster size, rounding up,
        clamped to [0, total_nodes]."""
        if self.max_unavailable is None:
            return total_nodes
        scaled = self.max_unavailable.scaled_value(total_nodes, round_up=True)
        return max(0, min(scaled, total_nodes))

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "DriverUpgradePolicySpec":
        # An explicit null means "no limit" and must survive round-trips;
        # a *missing* key takes the kubebuilder default of "25%".
        if "maxUnavailable" in d:
            max_unavailable = d["maxUnavailable"]
        else:
            max_unavailable = DEFAULT_MAX_UNAVAILABLE.value
        return DriverUpgradePolicySpec(
            auto_upgrade=bool(d.get("autoUpgrade", False)),
            max_parallel_upgrades=int(d.get("maxParallelUpgrades", 1)),
            max_unavailable=IntOrString.parse(max_unavailable),
            pod_deletion=(
                PodDeletionSpec.from_dict(d["podDeletion"])
                if d.get("podDeletion") is not None
                else None
            ),
            wait_for_completion=(
                WaitForCompletionSpec.from_dict(d["waitForCompletion"])
                if d.get("waitForCompletion") is not None
                else None
            ),
            drain=(
                DrainSpec.from_dict(d["drain"]) if d.get("drain") is not None else None
            ),
            checkpoint=(
                CheckpointSpec.from_dict(d["checkpoint"])
                if d.get("checkpoint") is not None
                else None
            ),
            quarantine=(
                QuarantineSpec.from_dict(d["quarantine"])
                if d.get("quarantine") is not None
                else None
            ),
            policy=tuple(d.get("policy") or ()),
        )

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "autoUpgrade": self.auto_upgrade,
            "maxParallelUpgrades": self.max_parallel_upgrades,
            # None (no limit) serializes as an explicit null so the
            # round-trip does not resurrect the "25%" default.
            "maxUnavailable": (
                self.max_unavailable.to_json()
                if self.max_unavailable is not None
                else None
            ),
        }
        if self.pod_deletion is not None:
            out["podDeletion"] = self.pod_deletion.to_dict()
        if self.wait_for_completion is not None:
            out["waitForCompletion"] = self.wait_for_completion.to_dict()
        if self.drain is not None:
            out["drain"] = self.drain.to_dict()
        if self.checkpoint is not None:
            out["checkpoint"] = self.checkpoint.to_dict()
        if self.quarantine is not None:
            out["quarantine"] = self.quarantine.to_dict()
        # Omitted when empty: a default-policy spec round-trips to the
        # same JSON as a spec without the field.
        if self.policy:
            out["policy"] = list(self.policy)
        return out
