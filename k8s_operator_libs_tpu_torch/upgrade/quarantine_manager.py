"""QuarantineManager: the quarantine-on-degradation arc.

The JAX package's ``upgrade/quarantine_manager.py``. A node whose health
score (its NodeHealthReport, ``api/telemetry_v1alpha1.py``, read off
``ClusterUpgradeState.node_health``) falls below the policy's threshold
outside any roll is cordoned into the ``quarantined`` state, re-evaluated
on an exponential backoff clock, and either

* **released** when its score recovers to ``QuarantineSpec.recovery_score``
  (hysteresis above the entry threshold): uncordoned, the arc's
  annotations cleared, its state back to unknown, so that the next pass
  classifies it like any other node; or
* **handed off** after ``handoff_after_seconds`` without recovery: it stays
  cordoned and enters ``upgrade-required``, so that the roll, whose
  validation gate must pass before the node is uncordoned, repairs it.

Admission shares the roll's ``maxUnavailable`` (``CommonUpgradeManager``
counts the slots), so a telemetry flap across the fleet cannot cordon more
than the disruption budget allows; a refused admission is counted
(``budget_denied``) and tried again while the report stays degraded.

The clocks are node annotations, so a restarted controller keeps the
schedule, and either machine can finish an arc the other began; every
write goes through the state provider. The counters live under a leaf
lock and are exported by ``HealthMetrics`` (``health_source.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Mapping, Optional

from ..api.telemetry_v1alpha1 import NodeHealth, effective_node_score
from ..api.upgrade_v1alpha1 import QuarantineSpec
from ..kube.objects import Node
from ..utils.log import get_logger
from .consts import NULL_STRING, UpgradeKeys, UpgradeState
from .cordon_manager import CordonManager
from .state_provider import NodeUpgradeStateProvider

log = get_logger("upgrade.quarantine")


class QuarantineManager:
    def __init__(
        self,
        cordon_manager: CordonManager,
        state_provider: NodeUpgradeStateProvider,
        keys: UpgradeKeys,
        recorder=None,
        now=time.time,
    ) -> None:
        self._cordon = cordon_manager
        self._provider = state_provider
        self._keys = keys
        self._recorder = recorder
        #: The clock, injectable: tests advance it past the backoff and
        #: hand-off deadlines instead of sleeping.
        self._now = now
        # Leaf lock (nothing blocks under it) over the lifetime counters and
        # the members the gauge counts.
        self._counter_lock = threading.Lock()
        self._totals = {"entered": 0, "released": 0, "handed_off": 0, "budget_denied": 0}
        self._members: set[str] = set()

    # -- counters --------------------------------------------------------------
    def _count(self, key: str, n: int = 1) -> None:
        with self._counter_lock:
            self._totals[key] += n

    def totals(self) -> dict[str, int]:
        """The lifetime counters and the nodes in quarantine now."""
        with self._counter_lock:
            out = dict(self._totals)
            out["in_quarantine"] = len(self._members)
            return out

    def adopt(self, node_names) -> None:
        """The pass's quarantined bucket into the gauge: a restarted
        controller counts the nodes an earlier one quarantined, not as new
        entries."""
        with self._counter_lock:
            self._members.update(node_names)

    def _member_add(self, name: str) -> None:
        with self._counter_lock:
            self._members.add(name)

    def _member_drop(self, name: str) -> None:
        with self._counter_lock:
            self._members.discard(name)

    # -- admission -------------------------------------------------------------
    def enter(self, node: Node, spec: QuarantineSpec, score: float) -> None:
        """Cordon the node into quarantine and start both clocks: the entry
        stamp (the hand-off deadline) and the first recheck."""
        now = int(self._now())
        keys = self._keys
        backoff = int(spec.reprobe_backoff_seconds)
        self._cordon.cordon(node)
        self._provider.change_node_upgrade_annotation(
            node, keys.quarantine_start_annotation, str(now)
        )
        self._provider.change_node_upgrade_annotation(
            node, keys.quarantine_backoff_annotation, str(backoff)
        )
        self._provider.change_node_upgrade_annotation(
            node, keys.quarantine_recheck_annotation, str(now + backoff)
        )
        self._provider.change_node_upgrade_state(node, UpgradeState.QUARANTINED)
        self._count("entered")
        self._member_add(node.name)
        log.warning(
            "node %s quarantined: health score %.1f below threshold %.1f",
            node.name, score, spec.unhealthy_score,
        )
        self._event(
            node, "Warning",
            f"Node quarantined: health score {score:.1f} crossed the "
            f"{spec.unhealthy_score:.1f} threshold",
        )

    def deny_budget(self, node: Node, score: float) -> None:
        """A degraded node the budget could not cordon this pass: counted,
        and a candidate again next pass while its report stays degraded."""
        self._count("budget_denied")
        log.info(
            "node %s degraded (score %.1f) but quarantine deferred: "
            "disruption budget exhausted", node.name, score,
        )

    # -- the quarantined bucket (polled: its clocks are time-driven) -----------
    def evaluate(
        self,
        node: Node,
        spec: QuarantineSpec,
        health: Optional[Mapping[str, NodeHealth]],
        scores: Optional[Mapping[str, float]] = None,
    ) -> None:
        """One pass over one quarantined node: the hand-off deadline first,
        then the re-evaluation once its backoff has run out. ``scores`` is
        the pass's ``effective_scores(health)``, folded once for the whole
        bucket; without it the node's score is folded here."""
        now = int(self._now())
        keys = self._keys
        start_raw = node.annotations.get(keys.quarantine_start_annotation)
        try:
            start = int(start_raw) if start_raw is not None else None
        except ValueError:
            start = None
        if start is None:
            # A missing or corrupt entry stamp: start the deadline now,
            # rather than hand off at once or never.
            self._provider.change_node_upgrade_annotation(
                node, keys.quarantine_start_annotation, str(now)
            )
            start = now
        if spec.handoff_after_seconds > 0 and now - start > spec.handoff_after_seconds:
            self._hand_off(node, now - start)
            return
        recheck_raw = node.annotations.get(keys.quarantine_recheck_annotation)
        try:
            recheck = int(recheck_raw) if recheck_raw is not None else 0
        except ValueError:
            recheck = 0  # a corrupt clock: recheck now, and re-arm below
        if now < recheck:
            return
        # The effective score: a node held for a sick incident link is not
        # released on its own healthy score while the link stays sick. No
        # report (None) is no recovery.
        entry = (
            scores.get(node.name)
            if scores is not None
            else effective_node_score(node.name, health or {})
        )
        if entry is not None and entry >= spec.recovery_score:
            self.release(
                node,
                f"health score recovered to {entry:.1f} (>= {spec.recovery_score:.1f})",
            )
            return
        backoff_raw = node.annotations.get(keys.quarantine_backoff_annotation)
        try:
            backoff = int(backoff_raw) if backoff_raw is not None else 0
        except ValueError:
            backoff = 0
        backoff = max(backoff, int(spec.reprobe_backoff_seconds))
        next_backoff = min(backoff * 2, int(spec.max_backoff_seconds))
        self._provider.change_node_upgrade_annotation(
            node, keys.quarantine_backoff_annotation, str(next_backoff)
        )
        self._provider.change_node_upgrade_annotation(
            node, keys.quarantine_recheck_annotation, str(now + next_backoff)
        )
        log.info(
            "node %s still unhealthy (score %s); next quarantine recheck in %ds",
            node.name,
            f"{entry:.1f}" if entry is not None else "unreported",
            next_backoff,
        )

    def release(self, node: Node, reason: str) -> None:
        """Recovery, or a policy that no longer quarantines: uncordon, clear
        the clocks, state back to unknown."""
        if node.unschedulable:
            self._cordon.uncordon(node)
        self._clear_clocks(node)
        self._provider.change_node_upgrade_state(node, UpgradeState.UNKNOWN)
        self._count("released")
        self._member_drop(node.name)
        log.info("node %s released from quarantine: %s", node.name, reason)
        self._event(node, "Normal", f"Node released from quarantine: {reason}")

    def _hand_off(self, node: Node, quarantined_s: int) -> None:
        """The node stays cordoned (its hardware is still degraded) and
        enters upgrade-required: the roll repairs it, and its validation
        gate must pass before the node is uncordoned."""
        self._clear_clocks(node)
        self._provider.change_node_upgrade_state(node, UpgradeState.UPGRADE_REQUIRED)
        self._count("handed_off")
        self._member_drop(node.name)
        log.warning(
            "node %s quarantined for %ds without recovery; handing off "
            "to the upgrade pipeline", node.name, quarantined_s,
        )
        self._event(
            node, "Warning",
            f"Node unrecovered after {quarantined_s}s in quarantine; "
            "handed to the upgrade pipeline for repair",
        )

    def _clear_clocks(self, node: Node) -> None:
        keys = self._keys
        for key in (
            keys.quarantine_start_annotation,
            keys.quarantine_recheck_annotation,
            keys.quarantine_backoff_annotation,
        ):
            self._provider.change_node_upgrade_annotation(node, key, NULL_STRING)

    def _event(self, node: Node, event_type: str, message: str) -> None:
        if self._recorder is not None:
            self._recorder.eventf(node, event_type, self._keys.event_reason(), message)
