"""Dotted-path reads of API documents.

A subset of the JAX package's ``kube/jsonpath.py``: only
:func:`dotted_value`, which the field selectors walk with. The printer
columns' JSONPath evaluator waits for ROADMAP A19.
"""

from __future__ import annotations

from typing import Any, Mapping


def dotted_value(obj: Any, dotted_path: str) -> Any:
    """Walk a plain dotted path (``spec.nodeName``); None when any segment
    is missing."""
    for part in dotted_path.strip().split("."):
        if not isinstance(obj, Mapping):
            return None
        obj = obj.get(part)
    return obj
