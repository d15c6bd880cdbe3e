"""Kind to REST resource, and back: the port's one resource registry.

The JAX package's ``kube/resources.py``, with its public names. The REST
client routes every request through it, the watch relay maps a plural
back to its kind through it, and the in-memory cluster reads each kind's
scope and discovery entry from it. A consumer registers its own custom
kinds with :func:`register_resource`, as a Go operator registers its
types into the scheme.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..api.fleet_v1alpha1 import (
    FLEET_ROLLOUT_API_VERSION,
    FLEET_ROLLOUT_KIND,
    FLEET_ROLLOUT_PLURAL,
)
from ..api.telemetry_v1alpha1 import NODE_HEALTH_REPORT_API_VERSION
from ..api.upgrade_v1alpha1 import (
    WORKLOAD_CHECKPOINT_API_VERSION,
    WORKLOAD_CHECKPOINT_KIND,
    WORKLOAD_CHECKPOINT_PLURAL,
)
from .objects import KINDS


@dataclass(frozen=True)
class ResourceInfo:
    kind: str
    api_version: str  # "v1" or "group/version"
    plural: str
    namespaced: bool = True

    @property
    def group(self) -> str:
        return self.api_version.rpartition("/")[0]

    @property
    def path_prefix(self) -> str:
        """The URL prefix of the resource's API group."""
        if "/" in self.api_version:
            return f"/apis/{self.api_version}"
        return f"/api/{self.api_version}"


_REGISTRY: dict[str, ResourceInfo] = {}
_BY_PLURAL: dict[tuple[str, str], ResourceInfo] = {}


def register_resource(
    kind: str, api_version: str, plural: str, namespaced: bool = True
) -> ResourceInfo:
    info = ResourceInfo(kind, api_version, plural, namespaced)
    _REGISTRY[kind] = info
    _BY_PLURAL[(info.group, plural)] = info
    return info


def resource_for_kind(kind: str) -> ResourceInfo:
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise KeyError(
            f"kind {kind!r} has no registered REST resource; call "
            "kube.resources.register_resource(kind, apiVersion, plural)"
        ) from None


def resource_for_plural(group: str, plural: str) -> ResourceInfo:
    try:
        return _BY_PLURAL[(group, plural)]
    except KeyError:
        raise KeyError(f"no resource for {group!r}/{plural!r}") from None


def _bootstrap() -> None:
    specials = {
        "CustomResourceDefinition": "customresourcedefinitions",
        "NodeMaintenance": "nodemaintenances",
    }
    for kind, cls in KINDS.items():
        register_resource(
            kind,
            cls.API_VERSION,
            specials.get(kind, kind.lower() + "s"),
            cls.NAMESPACED,
        )
    # The framework's custom kinds with no typed view in KINDS: the
    # checkpoint contract (api/upgrade_v1alpha1.py), the monitor's
    # per-node reports, cluster-scoped and named after their node
    # (api/telemetry_v1alpha1.py), and the fleet tier's grant ledger,
    # cluster-scoped because a rollout spans pools (api/fleet_v1alpha1.py).
    register_resource(
        WORKLOAD_CHECKPOINT_KIND,
        WORKLOAD_CHECKPOINT_API_VERSION,
        WORKLOAD_CHECKPOINT_PLURAL,
        namespaced=True,
    )
    register_resource(
        "NodeHealthReport",
        NODE_HEALTH_REPORT_API_VERSION,
        "nodehealthreports",
        namespaced=False,
    )
    register_resource(
        FLEET_ROLLOUT_KIND,
        FLEET_ROLLOUT_API_VERSION,
        FLEET_ROLLOUT_PLURAL,
        namespaced=False,
    )


_bootstrap()
