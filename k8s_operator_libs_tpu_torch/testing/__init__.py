"""Test doubles of the state machine's five injectable manager interfaces:
recording mocks with configurable outcomes, a stateful provider mock that
changes in-memory node labels, and ``install_mocks``. The deterministic
chaos harness is ``testing/chaos.py``; as in the JAX package, its names
are imported from that module and not re-exported here.
"""

from .mocks import (
    Call,
    MockCordonManager,
    MockDrainManager,
    MockNodeUpgradeStateProvider,
    MockPodManager,
    MockValidationManager,
    install_mocks,
)

__all__ = [
    "Call",
    "MockCordonManager",
    "MockDrainManager",
    "MockNodeUpgradeStateProvider",
    "MockPodManager",
    "MockValidationManager",
    "install_mocks",
]
