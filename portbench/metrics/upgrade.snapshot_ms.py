"""Mean milliseconds of a pass's snapshot (``build_state``), from the
state machine's own ``PassStats.snapshot_s`` of each pass in the window."""

from statistics import fmean


def read(run):
    values = run.counters.get("pass.snapshot_s")
    return 1e3 * fmean(values) if values else None
