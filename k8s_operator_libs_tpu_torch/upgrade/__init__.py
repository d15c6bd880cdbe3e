"""The rolling-upgrade state machine's in-place path, requestor mode,
checkpoint arc and quarantine arc, the health telemetry it reads, its
snapshot sources (LIST, informer, incremental) and write batcher, the
device class and its upgrade keys and states, the machine's metrics and
their endpoint (a subset of the JAX package's ``upgrade`` package; what the port's machine
does not run it refuses, naming the ROADMAP item: ``state_manager.py``)."""

from .checkpoint_manager import RESTORE_VERIFY_TIMEOUT_SECONDS, CheckpointManager
from .common_manager import ClusterUpgradeState, CommonUpgradeManager, NodeUpgradeState
from .consts import DeviceClass, UpgradeKeys, UpgradeState
from .cordon_manager import CordonManager
from .drain_manager import DrainConfiguration, DrainManager
from .health_source import HealthMetrics, HealthSource, LinkMetrics
from .inplace import InplaceNodeStateManager, ProcessNodeStateManager
from .metrics import MetricsServer, UpgradeMetrics, WireMetrics
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
from .snapshot import (
    DEFAULT_RESYNC_PERIOD_S,
    ClientSnapshotSource,
    IncrementalSnapshotSource,
    InformerSnapshotSource,
    SnapshotDelta,
    SnapshotSource,
)
from .state_manager import BuildStateError, ClusterUpgradeStateManager, PassStats, StateOptions
from .state_provider import NodeUpgradeStateProvider, StateWriteError
from .task_runner import TaskRunner
from .validation_manager import VALIDATION_TIMEOUT_SECONDS, ValidationManager
from .write_batch import WRITE_BATCH_FAULT_POINT, WriteBatchError, WriteBatcher

__all__ = [
    "BuildStateError",
    "CheckpointManager",
    "ClientSnapshotSource",
    "ClusterUpgradeState",
    "ClusterUpgradeStateManager",
    "CommonUpgradeManager",
    "DEFAULT_NODE_MAINTENANCE_NAME_PREFIX",
    "DEFAULT_RESYNC_PERIOD_S",
    "CordonManager",
    "DeviceClass",
    "DrainConfiguration",
    "DrainManager",
    "HealthMetrics",
    "HealthSource",
    "IncrementalSnapshotSource",
    "InformerSnapshotSource",
    "InplaceNodeStateManager",
    "LinkMetrics",
    "MetricsServer",
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
    "SnapshotDelta",
    "SnapshotSource",
    "StateOptions",
    "StateWriteError",
    "TaskRunner",
    "UpgradeKeys",
    "UpgradeMetrics",
    "WireMetrics",
    "UpgradeState",
    "VALIDATION_TIMEOUT_SECONDS",
    "ValidationManager",
    "WRITE_BATCH_FAULT_POINT",
    "WriteBatchError",
    "WriteBatcher",
    "condition_changed_predicate",
    "enable_requestor_mode",
    "requestor_id_predicate",
]
