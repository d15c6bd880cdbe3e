"""GPU node detection and slice grouping.

The JAX package's ``tpu/detector.py`` recognises GKE TPU nodes and groups
them by ICI slice. Here a "slice" is the set of nodes one probe run can
vouch for: the cards joined by one NVLink fabric. Its identity, in order:

1. the explicit ``tpu-operator.dev/slice-id`` label;
2. ``nvidia.com/gpu.clique``, the multi-node NVLink domain GFD labels
   (e.g. the nodes of one GB200 NVL72 rack);
3. the node's own name: an HGX node's NVLink ends at the node.

Never the node pool. GKE puts one TPU slice in a pool, so the JAX detector
takes the pool as the slice; a pool of HGX H100 nodes is as many NVLink
domains as it has nodes, and taking it as one would let
``SliceScopedGate`` pass node B on node A's probe.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

from ..parallel.topology import GPU_CLIQUE_LABEL, SliceTopology

#: Optional explicit slice-identity label (takes precedence over the clique).
TPU_SLICE_ID_LABEL = "tpu-operator.dev/slice-id"


def _labels(node) -> Mapping[str, str]:
    return node.metadata.get("labels") or {}


@dataclass(frozen=True)
class TpuNodeInfo:
    """One GPU node: its cards and the slice (NVLink domain) it is in."""

    node_name: str
    topology: SliceTopology
    slice_id: str

    @property
    def chips(self) -> int:
        """The node's cards."""
        return self.topology.chips_per_host


class TpuNodeDetector:
    """Recognises GPU nodes by their GFD labels and groups them by slice.
    Nodes are the operator's own objects, read through ``.name`` and
    ``.metadata``."""

    def __init__(self, slice_id_label: str = TPU_SLICE_ID_LABEL) -> None:
        self._slice_id_label = slice_id_label

    @property
    def slice_id_label(self) -> str:
        """The explicit slice-identity label this detector honors first."""
        return self._slice_id_label

    @staticmethod
    def is_tpu_node(node) -> bool:
        """Whether ``node`` is a GPU node."""
        return SliceTopology.from_labels(_labels(node)) is not None

    def detect(self, node) -> Optional[TpuNodeInfo]:
        labels = _labels(node)
        topology = SliceTopology.from_labels(labels)
        if topology is None:
            return None
        slice_id = (
            labels.get(self._slice_id_label)
            or labels.get(GPU_CLIQUE_LABEL)
            or node.name
        )
        return TpuNodeInfo(node_name=node.name, topology=topology, slice_id=slice_id)

    def group_by_slice(self, nodes: Sequence) -> dict[str, list]:
        """Slice id -> nodes. A node that is not a GPU node is a group of
        its own, keyed by its name."""
        groups: dict[str, list] = {}
        for node in nodes:
            info = self.detect(node)
            key = info.slice_id if info is not None else node.name
            groups.setdefault(key, []).append(node)
        return groups
