"""What one run records for the per-layer readers: host spans, counters,
and with ``--trace 1`` the device trace.

Spans are the benchmark's own, taken around its calls into the port's
layers (the port's own spans cover under 1% of a roll). With tracing on a
span also enters the profiler's timeline as a ``record_function`` range
named ``portbench.<name>``, so device time can be put inside it.
"""

from __future__ import annotations

import contextlib
import gc
import time
from collections import defaultdict
from dataclasses import dataclass, field
from statistics import fmean
from typing import Optional

#: The prefix of every profiler range the benchmark opens.
RANGE_PREFIX = "portbench."


@dataclass
class Run:
    """One run's readings. ``spans[name]`` holds (start, end) host seconds
    (``time.perf_counter``), ``counters[name]`` the values counted."""

    trace: bool = False
    spans: dict = field(default_factory=lambda: defaultdict(list))
    counters: dict = field(default_factory=lambda: defaultdict(list))
    #: The merged device trace of the window (``devtrace.DeviceTrace``),
    #: with ``--trace 1``.
    device: Optional[object] = None
    #: The work each probe call asks of the card, by probe: (FLOPs, bytes)
    #: per call (``roofline``).
    work: dict = field(default_factory=dict)
    #: Where the run's time went, for standard error (not a metric).
    notes: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """Time the block as span ``name``. With tracing on it is also a
        profiler range, and ``sync`` is called before it closes, so the
        card's work is inside."""
        start = time.perf_counter()
        if not self.trace:
            try:
                yield
            finally:
                self.spans[name].append((start, time.perf_counter()))
            return
        import torch

        with torch.profiler.record_function(RANGE_PREFIX + name):
            try:
                yield
            finally:
                if sync is not None:
                    sync()
        self.spans[name].append((start, time.perf_counter()))

    def count(self, name: str, value: float) -> None:
        self.counters[name].append(value)

    def span_mean_s(self, name: str) -> Optional[float]:
        spans = self.spans.get(name)
        if not spans:
            return None
        return fmean(end - start for start, end in spans)


@contextlib.contextmanager
def gc_clock(notes: dict):
    """Count the interpreter's garbage collections in the block, and their
    seconds, by generation, into ``notes["gc"]``."""
    seconds = [0.0, 0.0, 0.0]
    counts = [0, 0, 0]
    started: list = []

    def callback(phase: str, info: dict) -> None:
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            generation = info["generation"]
            seconds[generation] += time.perf_counter() - started.pop()
            counts[generation] += 1

    gc.callbacks.append(callback)
    try:
        yield
    finally:
        gc.callbacks.remove(callback)
        notes["gc"] = {"collections": counts, "seconds": [round(s, 4) for s in seconds]}


@contextlib.contextmanager
def host_clock(notes: dict):
    """This process's CPU seconds in the block against its wall seconds,
    into ``notes["host"]`` (over 1: threads beside the caller's)."""
    import resource

    def cpu_s() -> float:
        usage = resource.getrusage(resource.RUSAGE_SELF)
        return usage.ru_utime + usage.ru_stime

    wall0, cpu0 = time.perf_counter(), cpu_s()
    try:
        yield
    finally:
        notes["host"] = {"wall_s": round(time.perf_counter() - wall0, 4),
                         "self_cpu_s": round(cpu_s() - cpu0, 4)}
