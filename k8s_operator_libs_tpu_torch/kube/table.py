"""The Table transform: what ``kubectl get`` asks the API server for.

The JAX package's ``kube/table.py``, copied. kubectl sends ``Accept:
application/json;as=Table;v=v1;g=meta.k8s.io`` and the server answers a
``meta.k8s.io/v1 Table``: column definitions plus one row of rendered
cells per object. For CRD-backed kinds the columns come from the
version's ``additionalPrinterColumns`` (``FakeCluster.printer_columns``;
the NodeMaintenance CRD in ``manifests/crds`` declares such columns);
built-ins fall back to Name/Age here (a real server has per-type
printers).

``rows[].object`` defaults to PartialObjectMetadata and becomes the
full object with ``?includeObject=Object``, as upstream's does.
"""

from __future__ import annotations

import time
from typing import Any, Mapping, Optional

from .jsonpath import evaluate

#: The implicit leading column every server table carries.
_NAME_COLUMN = {
    "name": "Name",
    "type": "string",
    "format": "name",
    "description": "Name must be unique within a namespace.",
    "jsonPath": ".metadata.name",
}
_AGE_COLUMN = {
    "name": "Age",
    "type": "date",
    "description": "CreationTimestamp is a timestamp representing the "
                   "server time when this object was created.",
    "jsonPath": ".metadata.creationTimestamp",
}


def accepts_table(accept_header: str) -> bool:
    """True when the request negotiates the Table transform (kubectl's
    ``;as=Table`` Accept parameter)."""
    return any(
        part.strip().lower().startswith("as=table")
        for clause in (accept_header or "").split(",")
        for part in clause.split(";")
    )


def _age(value: Any, now: Optional[float] = None) -> str:
    """kubectl's short duration form from a creationTimestamp (epoch
    float here; RFC3339 strings pass through as-is)."""
    if not isinstance(value, (int, float)):
        return str(value) if value else "<unknown>"
    seconds = max(0, int((now if now is not None else time.time()) - value))
    if seconds < 120:
        return f"{seconds}s"
    minutes = seconds // 60
    if minutes < 120:
        return f"{minutes}m"
    hours = minutes // 60
    if hours < 48:
        return f"{hours}h"
    return f"{hours // 24}d"


def _cell(column: Mapping[str, Any], raw: Mapping[str, Any]) -> Any:
    matches = evaluate(column.get("jsonPath", ""), raw)
    if not matches:
        return "<none>"
    if column.get("type") == "date":
        return _age(matches[0])
    if len(matches) == 1:
        value = matches[0]
        return value if isinstance(value, (int, bool)) else str(value)
    return ",".join(str(m) for m in matches)  # kubectl joins multiples


def render_table(
    items: list[Mapping[str, Any]],
    *,
    crd_columns: Optional[list[dict[str, Any]]] = None,
    include_object: str = "Metadata",
    list_metadata: Optional[Mapping[str, Any]] = None,
) -> dict[str, Any]:
    """Render objects as a ``meta.k8s.io/v1 Table``."""
    columns = [dict(_NAME_COLUMN)]
    if crd_columns:
        # A CRD with additionalPrinterColumns gets Name + exactly its
        # declared columns — a real apiserver adds no implicit Age there
        # (most controller-gen CRDs declare their own Age column).
        columns.extend(dict(c) for c in crd_columns)
    else:
        columns.append(dict(_AGE_COLUMN))
    rows = []
    for raw in items:
        if include_object == "Object":
            obj: Any = raw
        elif include_object == "None":
            obj = None
        else:  # Metadata (the default)
            obj = {
                "kind": "PartialObjectMetadata",
                "apiVersion": "meta.k8s.io/v1",
                "metadata": raw.get("metadata") or {},
            }
        row: dict[str, Any] = {
            "cells": [_cell(c, raw) for c in columns],
        }
        if obj is not None:
            row["object"] = obj
        rows.append(row)
    table: dict[str, Any] = {
        "kind": "Table",
        "apiVersion": "meta.k8s.io/v1",
        "metadata": dict(list_metadata or {}),
        # Served definitions keep ``priority`` (kubectl hides
        # priority>0 columns outside -o wide) and drop ``jsonPath`` —
        # a CRD-spec field, not part of meta.k8s.io/v1
        # TableColumnDefinition.
        "columnDefinitions": [
            {k: v for k, v in c.items() if k != "jsonPath"}
            for c in columns
        ],
        "rows": rows,
    }
    return table
