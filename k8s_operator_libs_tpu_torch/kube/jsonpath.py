"""Kubernetes printer-column JSONPath, the subset CRD
``additionalPrinterColumns`` use, and the dotted-path reads of API
documents.

The JAX package's ``kube/jsonpath.py``, copied. :func:`evaluate` serves
the Table transform (``kube/table.py``) that ``kubectl get`` asks for;
the NodeMaintenance CRD's columns (``manifests/crds/nodemaintenances.yaml``)
include the conditions filter ``.status.conditions[?(@.type=='Ready')].status``.
The dialect:

* dotted fields: ``.spec.nodeName``
* array index / wildcard: ``[0]`` / ``[*]``
* filter expressions: ``[?(@.type=='Ready')]`` (single or double
  quotes; the ``@`` path may itself be dotted)

``evaluate`` returns EVERY match (kubectl joins multiples with ``,``);
missing paths yield an empty list, never an error: a cell renders as
``<none>``, as kubectl's does. :func:`dotted_value` is the plain dotted
walk the field selectors take.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

_FILTER_RE = re.compile(
    r"^\?\(@\.(?P<path>[^=!<>]+?)\s*==\s*"
    r"(?:'(?P<sq>[^']*)'|\"(?P<dq>[^\"]*)\")\)$"
)


def _tokenize(path: str) -> list[str]:
    """Split ``.a.b[0][?(@.c=='d')].e`` into fields and bracket ops."""
    path = path.strip()
    if path.startswith("{") and path.endswith("}"):
        path = path[1:-1]  # kubectl's {.spec.x} wrapper form
    tokens: list[str] = []
    i = 0
    field = ""
    while i < len(path):
        ch = path[i]
        if ch == ".":
            if field:
                tokens.append(field)
                field = ""
            i += 1
        elif ch == "[":
            if field:
                tokens.append(field)
                field = ""
            depth = 1
            j = i + 1
            while j < len(path) and depth:
                if path[j] == "[":
                    depth += 1
                elif path[j] == "]":
                    depth -= 1
                j += 1
            tokens.append("[" + path[i + 1:j - 1] + "]")
            i = j
        else:
            field += ch
            i += 1
    if field:
        tokens.append(field)
    return tokens


def dotted_value(obj: Any, dotted_path: str) -> Any:
    """Walk a plain dotted path (``spec.nodeName``); None when any
    segment is missing. Shared with the field-selector traversal in
    ``fake.py``/``cache.py`` — one implementation for all dotted
    walks."""
    for part in dotted_path.strip().split("."):
        if not isinstance(obj, Mapping):
            return None
        obj = obj.get(part)
    return obj


def _apply_token(values: list[Any], token: str) -> list[Any]:
    out: list[Any] = []
    if token.startswith("["):
        inner = token[1:-1].strip()
        for value in values:
            if not isinstance(value, list):
                continue
            if inner == "*":
                out.extend(value)
            elif inner.lstrip("-").isdigit():
                index = int(inner)
                if -len(value) <= index < len(value):
                    out.append(value[index])
            else:
                m = _FILTER_RE.match(inner)
                if m is None:
                    continue  # unsupported expression: no match
                want = m.group("sq") if m.group("sq") is not None else m.group("dq")
                for element in value:
                    if isinstance(element, dict) and str(
                        dotted_value(element, m.group("path"))
                    ) == want:
                        out.append(element)
        return out
    for value in values:
        if isinstance(value, dict) and token in value:
            out.append(value[token])
    return out


def evaluate(path: str, obj: Any) -> list[Any]:
    """All matches of ``path`` in ``obj`` (empty list = no match)."""
    values = [obj]
    for token in _tokenize(path):
        values = _apply_token(values, token)
        if not values:
            return []
    return [v for v in values if v is not None]
