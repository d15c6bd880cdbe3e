"""Test doubles of the state machine's five injectable manager interfaces:
recording mocks with configurable outcomes, a stateful provider mock that
changes in-memory node labels, and ``install_mocks``. The JAX package's
``testing`` package but its chaos harness (``testing/chaos.py``), which
waits for ROADMAP A19.
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
