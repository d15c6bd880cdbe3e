"""The rolling-upgrade state machine's in-place path, requestor mode,
checkpoint arc and quarantine arc, the health telemetry it reads, the
device class and its upgrade keys and states, and the metrics endpoint (a
subset of the JAX package's ``upgrade`` package; what the port's machine
does not run it refuses, naming the ROADMAP item: ``state_manager.py``)."""

from .checkpoint_manager import RESTORE_VERIFY_TIMEOUT_SECONDS, CheckpointManager
from .common_manager import ClusterUpgradeState, CommonUpgradeManager, NodeUpgradeState
from .consts import DeviceClass, UpgradeKeys, UpgradeState
from .cordon_manager import CordonManager
from .drain_manager import DrainConfiguration, DrainManager
from .health_source import HealthMetrics, HealthSource, LinkMetrics
from .inplace import InplaceNodeStateManager, ProcessNodeStateManager
from .pod_manager import PodDeletionFilter, PodManager, PodManagerConfig, RevisionHashError
from .quarantine_manager import QuarantineManager
from .requestor import (
    DEFAULT_NODE_MAINTENANCE_NAME_PREFIX,
    RequestorNodeStateManager,
    RequestorOptions,
    condition_changed_predicate,
    enable_requestor_mode,
    requestor_id_predicate,
)
from .safe_driver_load import SafeDriverLoadManager
from .snapshot import ClientSnapshotSource, SnapshotSource
from .state_manager import BuildStateError, ClusterUpgradeStateManager, PassStats, StateOptions
from .state_provider import NodeUpgradeStateProvider, StateWriteError
from .task_runner import TaskRunner
from .validation_manager import VALIDATION_TIMEOUT_SECONDS, ValidationManager

__all__ = [
    "BuildStateError",
    "CheckpointManager",
    "ClientSnapshotSource",
    "ClusterUpgradeState",
    "ClusterUpgradeStateManager",
    "CommonUpgradeManager",
    "DEFAULT_NODE_MAINTENANCE_NAME_PREFIX",
    "CordonManager",
    "DeviceClass",
    "DrainConfiguration",
    "DrainManager",
    "HealthMetrics",
    "HealthSource",
    "InplaceNodeStateManager",
    "LinkMetrics",
    "NodeUpgradeState",
    "NodeUpgradeStateProvider",
    "PassStats",
    "PodDeletionFilter",
    "PodManager",
    "PodManagerConfig",
    "ProcessNodeStateManager",
    "QuarantineManager",
    "RESTORE_VERIFY_TIMEOUT_SECONDS",
    "RequestorNodeStateManager",
    "RequestorOptions",
    "RevisionHashError",
    "SafeDriverLoadManager",
    "SnapshotSource",
    "StateOptions",
    "StateWriteError",
    "TaskRunner",
    "UpgradeKeys",
    "UpgradeState",
    "VALIDATION_TIMEOUT_SECONDS",
    "ValidationManager",
    "condition_changed_predicate",
    "enable_requestor_mode",
    "requestor_id_predicate",
]
