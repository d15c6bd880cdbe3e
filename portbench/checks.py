"""The comparison that decides ``correct``.

Each number compared has a limit, set in the configuration's file under
``limits`` from two readings on the card (PERF.md gives them): the largest
that sound runs of the port gave over a dozen seeds or more, and the
smallest that the control gave. A run is correct when every number is at
or below its limit; a number that could not be read (an output that never
came) is infinite and fails.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def rel_err(got: Optional[np.ndarray], want: np.ndarray) -> float:
    """max |got - want| over max |want|; infinite where ``got`` is missing,
    of another shape or not finite."""
    if got is None or np.shape(got) != np.shape(want):
        return math.inf
    got = np.asarray(got, dtype=np.float64)
    if not np.all(np.isfinite(got)):
        return math.inf
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def loss_errs(got: Optional[list], want: list) -> tuple[float, float]:
    """(the worst step's |loss - reference| over |reference|, the gap
    between the two losses' drops over the reference's drop) of a run of
    SGD steps; infinite where ``got`` is missing or not finite."""
    if got is None or len(got) != len(want) or not all(math.isfinite(v) for v in got):
        return math.inf, math.inf
    loss = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    drop_want = want[0] - want[-1]
    drop = abs((got[0] - got[-1]) - drop_want) / max(abs(drop_want), 1e-30)
    return loss, drop


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value": v, "limit": l}}) for every number; a
    number without a limit is an error of the benchmark, not of the run."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"numbers without a limit: {missing}")
    table = {name: {"value": numbers[name], "limit": limits[name]} for name in numbers}
    ok = all(
        math.isfinite(row["value"]) and row["value"] <= row["limit"] for row in table.values()
    )
    return ok, table
