"""Upgrade states, device class identity and the label and annotation keys
derived from it.

A subset of the JAX package's ``upgrade/consts.py``: the node states, the
states the budget counts, the value object that names a managed driver,
and the keys this package reads or writes. The states are a ``StrEnum``
with the JAX machine's own values, so a state here compares equal to the
JAX machine's bucket of the same name. For ``DeviceClass.nvidia("gpu")``
the keys take the shape of NVIDIA's upstream Go library,
``nvidia.com/gpu-driver-<suffix>``; both machines write the same keys for
the same device class, so a node's state reads the same to either.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class UpgradeState(enum.StrEnum):
    """A node's upgrade state, stored in its state label."""

    UNKNOWN = ""
    UPGRADE_REQUIRED = "upgrade-required"
    CORDON_REQUIRED = "cordon-required"
    WAIT_FOR_JOBS_REQUIRED = "wait-for-jobs-required"
    CHECKPOINT_REQUIRED = "checkpoint-required"
    POD_DELETION_REQUIRED = "pod-deletion-required"
    DRAIN_REQUIRED = "drain-required"
    NODE_MAINTENANCE_REQUIRED = "node-maintenance-required"
    POST_MAINTENANCE_REQUIRED = "post-maintenance-required"
    POD_RESTART_REQUIRED = "pod-restart-required"
    VALIDATION_REQUIRED = "validation-required"
    UNCORDON_REQUIRED = "uncordon-required"
    DONE = "upgrade-done"
    FAILED = "upgrade-failed"
    #: Cordoned by the telemetry quarantine, outside any roll.
    QUARANTINED = "quarantined"


#: States counted as managed (the budget's total). The two external
#: maintenance states are not, as in the JAX machine's default.
MANAGED_STATES: tuple[UpgradeState, ...] = (
    UpgradeState.UNKNOWN,
    UpgradeState.DONE,
    UpgradeState.UPGRADE_REQUIRED,
    UpgradeState.CORDON_REQUIRED,
    UpgradeState.WAIT_FOR_JOBS_REQUIRED,
    UpgradeState.CHECKPOINT_REQUIRED,
    UpgradeState.POD_DELETION_REQUIRED,
    UpgradeState.FAILED,
    UpgradeState.DRAIN_REQUIRED,
    UpgradeState.POD_RESTART_REQUIRED,
    UpgradeState.UNCORDON_REQUIRED,
    UpgradeState.VALIDATION_REQUIRED,
    UpgradeState.QUARANTINED,
)

#: The external-maintenance states of the requestor mode, outside the
#: budget's count by default; ``use_post_maintenance`` counts them
#: (``CommonUpgradeManager.count_maintenance_states``).
MAINTENANCE_STATES: tuple[UpgradeState, ...] = (
    UpgradeState.NODE_MAINTENANCE_REQUIRED,
    UpgradeState.POST_MAINTENANCE_REQUIRED,
)

#: Managed states that are not an upgrade in progress.
IDLE_STATES: frozenset[UpgradeState] = frozenset(
    {
        UpgradeState.UNKNOWN,
        UpgradeState.DONE,
        UpgradeState.UPGRADE_REQUIRED,
        UpgradeState.QUARANTINED,
    }
)

TRUE_STRING = "true"
#: Annotation value asking the state machine's provider to delete the key.
NULL_STRING = "null"


@dataclass(frozen=True)
class DeviceClass:
    """Identity of a managed device driver: class name, driver, key domain."""

    name: str  # e.g. "gpu"
    driver: str  # e.g. "gpu"
    domain: str = "tpu-operator.dev"

    def __post_init__(self) -> None:
        for attr in ("name", "driver", "domain"):
            v = getattr(self, attr)
            if not v or "/" in v:
                raise ValueError(f"invalid DeviceClass.{attr}: {v!r}")

    @staticmethod
    def nvidia(driver: str) -> "DeviceClass":
        """An NVIDIA device class: keys under ``nvidia.com``."""
        return DeviceClass(name="gpu", driver=driver, domain="nvidia.com")


@dataclass(frozen=True)
class UpgradeKeys:
    """The keys of one device class that this package uses."""

    device: DeviceClass

    def _key(self, suffix: str) -> str:
        return f"{self.device.domain}/{self.device.driver}-driver-{suffix}"

    @property
    def state_label(self) -> str:
        """Node label holding the node's upgrade state."""
        return self._key("upgrade-state")

    @property
    def safe_driver_load_annotation(self) -> str:
        """Node annotation the driver pod's init container sets and waits
        on until the state machine has drained the node."""
        return self._key("upgrade.driver-wait-for-safe-load")

    @property
    def skip_label(self) -> str:
        """Node label that keeps a node out of upgrades and probes."""
        return self._key("upgrade.skip")

    @property
    def skip_drain_pod_label(self) -> str:
        """Pod label that keeps a pod out of the drain (and out of the
        monitor's count of pods holding the cards)."""
        return self._key("upgrade-drain.skip")

    @property
    def initial_state_annotation(self) -> str:
        """Node annotation marking a node that was cordoned when its upgrade
        began; the upgrade ends without uncordoning it."""
        return self._key("upgrade.node-initial-state.unschedulable")

    @property
    def wait_for_pod_completion_start_annotation(self) -> str:
        """Durable clock of the wait for workload pods to complete."""
        return self._key("upgrade-wait-for-pod-completion-start-time")

    @property
    def validation_start_annotation(self) -> str:
        """Durable clock of the validation timeout."""
        return self._key("upgrade-validation-start-time")

    @property
    def post_maintenance_start_annotation(self) -> str:
        """Durable clock of the requestor mode's post-maintenance step."""
        return self._key("upgrade-post-maintenance-start-time")

    @property
    def validation_failed_annotation(self) -> str:
        """Marks a node whose ``upgrade-failed`` came from the validation
        gate: its recovery validates again instead of uncordoning."""
        return self._key("upgrade-validation-failed")

    # -- the checkpoint arc (checkpoint_manager.py) --------------------------
    @property
    def checkpoint_request_annotation(self) -> str:
        """Pod key the controller writes to ask a selected workload pod to
        checkpoint. Its value is the node's checkpoint epoch (the stamp of
        the node's checkpoint clock), so an ack from an earlier arc never
        satisfies a new one."""
        return self._key("upgrade-checkpoint-request")

    @property
    def checkpoint_complete_annotation(self) -> str:
        """Pod key the workload writes once its checkpoint is durable: the
        ack, valid only while it echoes the current epoch."""
        return self._key("upgrade-checkpoint-complete")

    @property
    def checkpoint_step_annotation(self) -> str:
        """Pod key holding the training step the checkpoint was taken at:
        disruption is counted in steps trained again."""
        return self._key("upgrade-checkpoint-step")

    @property
    def checkpoint_start_annotation(self) -> str:
        """Node key: the durable clock of the checkpoint deadline; its
        stamp is also the checkpoint epoch."""
        return self._key("upgrade-checkpoint-start-time")

    @property
    def checkpoint_manifest_annotation(self) -> str:
        """Node key: the JSON map ``{"<ns>/<pod>": step}`` of the
        checkpoints acknowledged before the drain, which the
        restore-verified uncordon checks against the WorkloadCheckpoint
        objects; retired by that check."""
        return self._key("upgrade-checkpoint-manifest")

    @property
    def checkpoint_escalated_annotation(self) -> str:
        """Node key marking that the checkpoint deadline expired and the
        drain went on as a plain drain; retired when the node's upgrade
        ends."""
        return self._key("upgrade-checkpoint-escalated")

    @property
    def restore_verify_start_annotation(self) -> str:
        """Node key: the durable clock of the restore-verified uncordon (a
        checkpoint that cannot be verified degrades to a cold restart at
        its deadline; it never stalls the roll)."""
        return self._key("upgrade-restore-verify-start-time")

    # -- the quarantine arc (quarantine_manager.py) ---------------------------
    @property
    def quarantine_start_annotation(self) -> str:
        """Node key: epoch seconds the node entered quarantine, the clock
        the hand-off deadline is measured against."""
        return self._key("upgrade-quarantine-start-time")

    @property
    def quarantine_recheck_annotation(self) -> str:
        """Node key: epoch seconds the next health re-evaluation is due (the
        backoff clock; a restarted controller keeps its schedule)."""
        return self._key("upgrade-quarantine-recheck-time")

    @property
    def quarantine_backoff_annotation(self) -> str:
        """Node key: the backoff in seconds, doubled up to its cap on every
        recheck that still finds the node unhealthy."""
        return self._key("upgrade-quarantine-backoff-seconds")

    @property
    def upgrade_requested_annotation(self) -> str:
        return self._key("upgrade-requested")

    @property
    def requestor_mode_annotation(self) -> str:
        return self._key("upgrade-requestor-mode")

    def event_reason(self) -> str:
        """Event reason with the driver upper-cased: ``GPUDriverUpgrade``."""
        return f"{self.device.driver.upper()}DriverUpgrade"
