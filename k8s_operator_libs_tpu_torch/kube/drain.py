"""Node cordon, uncordon and drain.

The JAX package's ``kube/drain.py``, the contract of ``kubectl drain``:

* cordon and uncordon patch ``spec.unschedulable``;
* a drain cordons, evicts every pod on the node that passes the filter
  chain, then waits for the evicted pods to go, within a timeout;
* the filters are kubectl's: DaemonSet pods and mirror pods stay, finished
  pods go freely, a pod without a controller is an error unless ``force``,
  and a pod with an emptyDir volume is an error unless
  ``delete_empty_dir``.

The pod selector goes to the server with the node's field selector, where
the JAX helper matches it on the client; the pods selected are the same.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .client import Client, NotFoundError, has_reason
from .objects import Pod


class DrainError(Exception):
    pass


class DrainTimeoutError(DrainError):
    pass


#: Extra per-pod hook: return False to leave the pod in place.
PodFilter = Callable[[Pod], bool]


@dataclass
class DrainConfig:
    """The knobs of ``kubectl drain`` that the managers set."""

    force: bool = False
    delete_empty_dir: bool = False
    #: 0 means no timeout.
    timeout_seconds: int = 0
    pod_selector: str = ""
    #: Filters ANDed onto kubectl's chain (the pod manager's deletion
    #: filter, the drain manager's skip label).
    extra_filters: tuple[PodFilter, ...] = field(default_factory=tuple)


#: Seconds between checks while evicted pods terminate.
POLL_INTERVAL_S = 0.05


def _gone(client: Client, pod: tuple[str, str]) -> bool:
    namespace, name = pod
    try:
        client.get("Pod", name, namespace)
    except Exception as e:  # noqa: BLE001 - the client's own classes
        if has_reason(e, NotFoundError):
            return True
        raise
    return False


class DrainHelper:
    def __init__(self, client: Client) -> None:
        self._client = client

    # -- cordon ------------------------------------------------------------
    def cordon(self, node_name: str) -> None:
        self._set_unschedulable(node_name, True)

    def uncordon(self, node_name: str) -> None:
        self._set_unschedulable(node_name, False)

    def _set_unschedulable(self, node_name: str, value: bool) -> None:
        self._client.patch("Node", node_name, patch={"spec": {"unschedulable": value}})

    # -- drain -------------------------------------------------------------
    def pods_to_evict(self, node_name: str, cfg: DrainConfig) -> list[Pod]:
        """The pods on the node that kubectl's filter chain would remove.

        Raises DrainError when a pod is ineligible (no controller without
        ``force``, emptyDir without ``delete_empty_dir``): as with kubectl,
        the drain fails as a whole instead of leaving the pod.
        """
        pods = self._client.list(
            "Pod",
            label_selector=cfg.pod_selector or None,
            field_selector=f"spec.nodeName={node_name}",
        )
        out: list[Pod] = []
        for obj in pods:
            pod = Pod(obj.raw)
            if pod.is_mirror_pod():
                continue
            if pod.is_daemonset_pod():
                continue
            if pod.deletion_timestamp is not None:
                continue  # already terminating
            # A pod the caller never wanted evicted must not fail the drain.
            if any(not f(pod) for f in cfg.extra_filters):
                continue
            if pod.is_finished():
                out.append(pod)
                continue
            if not pod.has_controller() and not cfg.force:
                raise DrainError(
                    f"pod {pod.namespace}/{pod.name} is unmanaged; use force to evict"
                )
            if pod.has_empty_dir() and not cfg.delete_empty_dir:
                raise DrainError(
                    f"pod {pod.namespace}/{pod.name} uses emptyDir; "
                    "use delete_empty_dir to evict"
                )
            out.append(pod)
        return out

    def drain(self, node_name: str, cfg: Optional[DrainConfig] = None) -> int:
        """Cordon the node, evict its eligible pods, wait until they are
        gone; the number of pods evicted. Raises DrainTimeoutError when
        pods remain at the deadline."""
        cfg = cfg or DrainConfig()
        deadline = time.monotonic() + cfg.timeout_seconds if cfg.timeout_seconds else None
        self.cordon(node_name)
        pods = self.pods_to_evict(node_name, cfg)
        for pod in pods:
            try:
                self._client.evict(pod.name, pod.namespace)
            except Exception as e:  # noqa: BLE001 - the client's own classes
                if not has_reason(e, NotFoundError):
                    raise  # one already gone is skipped
        remaining = {(p.namespace, p.name) for p in pods}
        while remaining:
            remaining = {key for key in remaining if not _gone(self._client, key)}
            if not remaining:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise DrainTimeoutError(
                    f"drain of {node_name} timed out with {len(remaining)} pods remaining"
                )
            time.sleep(POLL_INTERVAL_S)
        return len(pods)
