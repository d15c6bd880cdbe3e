"""Device class identity and the label and annotation keys derived from it.

A subset of the JAX package's ``upgrade/consts.py``: the value object that
names a managed driver, and the keys this package reads or writes. For
``DeviceClass.nvidia("gpu")`` the keys take the shape of NVIDIA's upstream
Go library, ``nvidia.com/gpu-driver-<suffix>``; the shared state machine
writes the same keys for the same device class, so a key built here names
what the operator wrote.
"""

from __future__ import annotations

from dataclasses import dataclass


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
