"""Report types of the collective battery.

The battery itself (NCCL through ``torch.distributed``) comes with the
multi-GPU slice; the health report already carries these types so that a
report of either package parses into the other.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class CollectiveReport:
    op: str
    ok: bool
    elapsed_s: float = 0.0
    gbytes_per_s: float = 0.0
    error: str = ""


@dataclass
class LinkProbeReport:
    """One timed neighbor exchange, ``src`` device -> ``dst`` device;
    ``peer`` is the id the telemetry link map is keyed by."""

    src: int
    dst: int
    peer: str
    ok: bool
    latency_s: float = 0.0
    gbytes_per_s: float = 0.0
    error: str = ""
