"""A roll's guarantees, checked from what the benchmark observed.

After every pass the benchmark reads each pool node's upgrade state and
cordon bit, and the version of the driver pod on it; the validation hook
records each verdict. ``RollChecker`` holds the roll to the upgrade
policy, as plain bookkeeping over those observations:

* no node is uncordoned before an ok verdict on it since its cordon;
* never more than ``maxParallelUpgrades`` nodes in an upgrade at once, nor
  more than ``maxUnavailable`` cordoned;
* every node whose roll ends has its driver pod at the target version;
* a node that ends ``upgrade-failed``, or a verdict that is not ok, is a
  failed node-roll.

It also keeps each node's outage (cordon to uncordon) and the longest run
of passes in which no pool node changed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

#: States of a node that is not in an upgrade.
IDLE_STATES = frozenset({"", "upgrade-done", "upgrade-required", "upgrade-failed"})
DONE = "upgrade-done"
FAILED = "upgrade-failed"


@dataclass
class NodeRoll:
    node: str
    cordoned_at: float
    uncordoned_at: Optional[float] = None
    state: str = ""
    ok: bool = False


@dataclass
class RollChecker:
    max_parallel: int
    max_unavailable: int
    #: Violations by kind.
    violations: dict = field(default_factory=dict)
    #: Node-rolls whose outage ended, in order.
    ended: list = field(default_factory=list)
    #: Node -> its open node-roll (cordoned, not yet back).
    open: dict = field(default_factory=dict)
    #: Node -> the times of its ok verdicts, and of its not-ok ones.
    passed_at: dict = field(default_factory=dict)
    verdicts_not_ok: int = 0
    failed_nodes: set = field(default_factory=set)
    longest_stall: int = 0
    _stall: int = 0
    _last: Optional[dict] = None

    def _violate(self, kind: str) -> None:
        self.violations[kind] = self.violations.get(kind, 0) + 1

    def verdict(self, node: str, ok: bool, at: float) -> None:
        if ok:
            self.passed_at.setdefault(node, []).append(at)
        else:
            self.verdicts_not_ok += 1

    def observe(self, at: float, nodes: dict, versions: dict, target: str,
                count_stall: bool = True) -> None:
        """One observation after a pass: ``nodes`` maps each pool node to
        (upgrade state, cordoned); ``versions`` each node to its driver
        pod's version (absent where it has none)."""
        in_upgrade = sum(1 for state, _ in nodes.values() if state not in IDLE_STATES)
        cordoned = sum(1 for _, out in nodes.values() if out)
        if in_upgrade > self.max_parallel:
            self._violate("more_in_upgrade_than_max_parallel")
        if cordoned > self.max_unavailable or cordoned > self.max_parallel:
            self._violate("more_cordoned_than_allowed")
        for name, (state, out) in nodes.items():
            if state == FAILED and name not in self.failed_nodes:
                self.failed_nodes.add(name)
            roll = self.open.get(name)
            if out and roll is None:
                self.open[name] = NodeRoll(name, at)
            elif not out and roll is not None:
                del self.open[name]
                roll.uncordoned_at, roll.state = at, state
                verdicts = [t for t in self.passed_at.get(name, []) if t >= roll.cordoned_at]
                roll.ok = bool(verdicts) and state == DONE
                if not verdicts:
                    self._violate("uncordoned_before_verdict")
                if state == DONE and versions.get(name) != target:
                    self._violate("driver_not_at_target")
                self.ended.append(roll)
        if count_stall:
            self._stall = self._stall + 1 if nodes == self._last else 0
            self.longest_stall = max(self.longest_stall, self._stall)
        self._last = dict(nodes)

    def unfinished(self) -> int:
        """Node-rolls still open: cordoned and not back."""
        return len(self.open)

    def violation_count(self) -> int:
        return sum(self.violations.values())
