"""The supervised process runtime: the :class:`Component` protocol, the
:class:`Supervisor` that starts components producers first, stops them
consumers first within per-component budgets, and turns SIGTERM and
SIGINT into an event, and the :class:`OrchestratorDaemon` that runs the
fleet orchestrator behind its own Lease. The JAX package's ``runtime``
package.
"""

from .component import (
    Component,
    FuncComponent,
    ThreadComponent,
    lifecycle_resource,
    registered_resources,
)
from .daemon import OrchestratorDaemon
from .supervisor import StopReport, Supervisor, SupervisorError

__all__ = [
    "Component",
    "FuncComponent",
    "OrchestratorDaemon",
    "StopReport",
    "Supervisor",
    "SupervisorError",
    "ThreadComponent",
    "lifecycle_resource",
    "registered_resources",
]
