"""Kubernetes label-selector semantics (string form and matchLabels form),
and field selectors.

The JAX package's ``kube/selectors.py``, whole. The reference leans on
apimachinery's labels.Parse for drain pod selectors, validation pod
selectors and DaemonSet selectors (reference:
pkg/upgrade/validation_manager.go:71-116, pod_manager.go:122-229). This
module implements the subset of the grammar those paths use: equality
(``=``, ``==``, ``!=``), set ops (``in``, ``notin``), existence (``key``,
``!key``), and comma-joined conjunction. The informer scopes its cached
reads with it, and a client without a server applies it to its lists and
watches.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Mapping

from .jsonpath import dotted_value


class SelectorError(ValueError):
    pass


@dataclass(frozen=True)
class Requirement:
    key: str
    op: str  # "=", "!=", "in", "notin", "exists", "!"
    values: tuple[str, ...] = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        present = self.key in labels
        value = labels.get(self.key)
        if self.op == "=":
            return present and value == self.values[0]
        if self.op == "!=":
            # apimachinery: NotEquals also matches when the key is absent.
            return not present or value != self.values[0]
        if self.op == "in":
            return present and value in self.values
        if self.op == "notin":
            return not present or value not in self.values
        if self.op == "exists":
            return present
        if self.op == "!":
            return not present
        raise SelectorError(f"unknown operator {self.op!r}")


@dataclass(frozen=True)
class LabelSelector:
    """A conjunction of label requirements."""

    requirements: tuple[Requirement, ...] = field(default_factory=tuple)

    def matches(self, labels: Mapping[str, str] | None) -> bool:
        labels = labels or {}
        return all(r.matches(labels) for r in self.requirements)

    @property
    def empty(self) -> bool:
        return not self.requirements

    @staticmethod
    def from_match_labels(match_labels: Mapping[str, str] | None) -> "LabelSelector":
        """Build from a LabelSelector.matchLabels map (used for DaemonSet
        selectors, reference: pkg/upgrade/common_manager.go:168-187)."""
        reqs = tuple(
            Requirement(key=k, op="=", values=(v,))
            for k, v in sorted((match_labels or {}).items())
        )
        return LabelSelector(requirements=reqs)


_SET_RE = re.compile(
    r"^\s*(?P<key>[^\s!=,()]+)\s+(?P<op>in|notin)\s+\((?P<vals>[^)]*)\)\s*$"
)

# Qualified label key: optional dns-ish prefix, then a name segment.
_KEY_RE = re.compile(r"^[A-Za-z0-9]([-A-Za-z0-9_./]*[A-Za-z0-9])?$")


def _validate_key(key: str, term: str) -> str:
    if not _KEY_RE.match(key):
        raise SelectorError(f"invalid label key {key!r} in selector term {term!r}")
    return key


def _split_top_level(expr: str) -> list[str]:
    """Split on commas not inside parentheses."""
    parts: list[str] = []
    depth = 0
    current: list[str] = []
    for ch in expr:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        if ch == "," and depth == 0:
            parts.append("".join(current))
            current = []
        else:
            current.append(ch)
    parts.append("".join(current))
    return [p for p in (s.strip() for s in parts) if p]


def _parse_requirement(term: str) -> Requirement:
    m = _SET_RE.match(term)
    if m:
        vals = tuple(v.strip() for v in m.group("vals").split(",") if v.strip())
        if not vals:
            raise SelectorError(f"empty value set in {term!r}")
        return Requirement(
            key=_validate_key(m.group("key"), term), op=m.group("op"), values=vals
        )
    if "!=" in term:
        key, _, val = term.partition("!=")
        return Requirement(key=_validate_key(key.strip(), term), op="!=", values=(val.strip(),))
    if "==" in term:
        key, _, val = term.partition("==")
        return Requirement(key=_validate_key(key.strip(), term), op="=", values=(val.strip(),))
    if "=" in term:
        key, _, val = term.partition("=")
        return Requirement(key=_validate_key(key.strip(), term), op="=", values=(val.strip(),))
    if term.startswith("!"):
        key = term[1:].strip()
        if not key:
            raise SelectorError("empty key in existence requirement")
        return Requirement(key=_validate_key(key, term), op="!")
    return Requirement(key=_validate_key(term.strip(), term), op="exists")


def parse_selector(selector: str | None) -> LabelSelector:
    """Parse a label-selector string; empty/None selects everything."""
    if not selector or not selector.strip():
        return LabelSelector()
    reqs = tuple(_parse_requirement(t) for t in _split_top_level(selector))
    return LabelSelector(requirements=reqs)


@dataclass(frozen=True)
class FieldRequirement:
    """One field-selector term. apimachinery's fields.Selector grammar:
    ``=``/``==`` (equality) and ``!=`` (inequality) — comparison is on
    the field's STRING form, with an absent field reading as ``""``
    (the real apiserver's behavior for e.g. an unscheduled pod's
    ``spec.nodeName``)."""

    key: str
    op: str  # "=" or "!="
    value: str

    def matches(self, data: Mapping) -> bool:
        actual = dotted_value(data, self.key)
        actual_s = "" if actual is None else str(actual)
        if self.op == "=":
            return actual_s == self.value
        return actual_s != self.value


@dataclass(frozen=True)
class FieldSelector:
    """A conjunction of field requirements: one matcher for a server's
    list and watch scopes and a client's cached reads, so the two can
    never disagree."""

    requirements: tuple[FieldRequirement, ...] = field(default_factory=tuple)

    @property
    def empty(self) -> bool:
        return not self.requirements

    def matches(self, data: Mapping | None) -> bool:
        data = data or {}
        return all(r.matches(data) for r in self.requirements)


def parse_field_selector(selector: str | None) -> FieldSelector:
    """Parse a field selector like ``spec.nodeName=node-1`` (comma-joined
    conjunction; ``=``, ``==`` and ``!=`` terms — the apimachinery
    fields.Selector grammar subset). Empty/None selects everything."""
    if not selector or not selector.strip():
        return FieldSelector()
    reqs: list[FieldRequirement] = []
    for term in selector.split(","):
        term = term.strip()
        if not term:
            continue
        if "!=" in term:
            key, _, val = term.partition("!=")
            op = "!="
        elif "=" in term:
            key, _, val = (
                term.partition("==") if "==" in term else term.partition("=")
            )
            op = "="
        else:
            raise SelectorError(f"unsupported field selector term {term!r}")
        key = key.strip()
        if not key:
            raise SelectorError(f"empty key in field selector term {term!r}")
        reqs.append(FieldRequirement(key=key, op=op, value=val.strip()))
    return FieldSelector(requirements=tuple(reqs))
