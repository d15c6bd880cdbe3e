"""GPU node facts from the labels GPU Feature Discovery puts on a node.

The JAX package's ``parallel/topology.py`` reads a TPU slice from GKE's
accelerator and topology labels. Its counterpart here reads an NVIDIA node
from the public GPU Feature Discovery (GFD) labels:

* ``nvidia.com/gpu.present`` — ``"true"`` on a node with NVIDIA cards;
* ``nvidia.com/gpu.product`` — the card, e.g. ``NVIDIA-H100-80GB-HBM3``;
* ``nvidia.com/gpu.count`` — the cards on the node;
* ``nvidia.com/gpu.memory`` — each card's memory in MiB;
* ``nvidia.com/gpu.clique`` — the multi-node NVLink domain the node is in,
  where there is one.

On a GPU node the unit of the fabric is the node: its cards share NVLink,
and a node is its own host. So ``topology`` is ``(gpu.count,)``,
``chips_per_host`` is ``gpu.count`` and ``num_hosts`` is 1. The JAX
module's ``parse_topology``, ``TpuAccelerator`` and ``SliceTopology.v5e``
describe TPU facts only and have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

GPU_PRESENT_LABEL = "nvidia.com/gpu.present"
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"
GPU_COUNT_LABEL = "nvidia.com/gpu.count"
GPU_MEMORY_LABEL = "nvidia.com/gpu.memory"
GPU_CLIQUE_LABEL = "nvidia.com/gpu.clique"


def _positive_int(labels: Mapping[str, str], key: str, default: int) -> int:
    raw = labels.get(key)
    if raw is None or raw == "":
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"invalid {key} label: {raw!r}") from None
    if value <= 0:
        raise ValueError(f"invalid {key} label: {raw!r}")
    return value


@dataclass(frozen=True)
class SliceTopology:
    """One GPU node's cards: the product, how many, and each card's memory."""

    #: The product label verbatim; an unknown product is kept as it is.
    accelerator: str
    topology: tuple[int, ...]
    chips_per_host: int
    #: Each card's memory in MiB; 0 where GFD gave none.
    memory_mib: int = 0

    @staticmethod
    def from_labels(labels: Mapping[str, str]) -> Optional["SliceTopology"]:
        """Build from a node's GFD labels; ``None`` when it is not a GPU
        node. A GPU node whose count GFD has not labelled yet has one card."""
        if labels.get(GPU_PRESENT_LABEL) != "true":
            return None
        count = _positive_int(labels, GPU_COUNT_LABEL, 1)
        return SliceTopology(
            accelerator=labels.get(GPU_PRODUCT_LABEL, ""),
            topology=(count,),
            chips_per_host=count,
            memory_mib=_positive_int(labels, GPU_MEMORY_LABEL, 0),
        )

    @property
    def total_chips(self) -> int:
        return self.topology[0]

    @property
    def num_hosts(self) -> int:
        return max(1, self.total_chips // self.chips_per_host)


def local_gpu_labels() -> dict[str, str]:
    """The GFD labels of this host's cards, from the cards themselves:
    ``torch.cuda.get_device_name``, the device count, and each card's total
    memory as ``nvidia-smi`` reports it. Raises without a card."""
    import subprocess

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible")
    memory = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.total", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.split()[0]
    return {
        GPU_PRESENT_LABEL: "true",
        GPU_PRODUCT_LABEL: torch.cuda.get_device_name(0).replace(" ", "-"),
        GPU_COUNT_LABEL: str(torch.cuda.device_count()),
        GPU_MEMORY_LABEL: memory,
    }
