"""The supervised process runtime: the :class:`Component` protocol and the
:class:`Supervisor` that starts components producers first, stops them
consumers first within per-component budgets, and turns SIGTERM and
SIGINT into an event. The JAX package's ``runtime`` package but its
``OrchestratorDaemon`` (``runtime/daemon.py``), which runs the fleet
orchestrator and waits for ROADMAP A18.
"""

from .component import (
    Component,
    FuncComponent,
    ThreadComponent,
    lifecycle_resource,
    registered_resources,
)
from .supervisor import StopReport, Supervisor, SupervisorError

__all__ = [
    "Component",
    "FuncComponent",
    "StopReport",
    "Supervisor",
    "SupervisorError",
    "ThreadComponent",
    "lifecycle_resource",
    "registered_resources",
]
