"""The device trace of a run's window: ``torch.profiler`` (CUPTI) in the
benchmark's process and in each rank process of the port's ``World``.

The gate runs its burn-in and collectives in the world's rank processes,
so a trace of the benchmark's process alone misses their kernels. The rank
functions below are module-level, so ``World.run`` can send them by name:
each rank starts a profiler and later hands back its device activity. Each
process's profiler keeps a clock of its own; each trace is moved onto the
host's wall clock (``time.time_ns``), which the processes of one host
share, by a range whose start is stamped on both clocks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from .record import RANGE_PREFIX

#: The range the benchmark opens around the whole measured window.
WINDOW_RANGE = RANGE_PREFIX + "window"
#: The range stamped on the profiler's clock and the host's, to align them.
CLOCK_RANGE = RANGE_PREFIX + "clock"

#: Device activity that is not a kernel: left out of kernel time, kept in
#: the busy time.
_NOT_KERNELS = ("Memcpy", "Memset")

#: The profiler a rank process holds between ``rank_start`` and
#: ``rank_stop`` (each rank process has its own copy of this module).
_rank_profiler = None


def start():
    """A started profiler of the host's ranges and the card's activity."""
    import torch
    from torch.profiler import ProfilerActivity

    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def collect(prof) -> dict:
    """Stop ``prof``: ``{"device": [(name, start_ns, end_ns, card)],
    "ranges": [(name, start_ns, end_ns)]}``, the cards' activity and the
    benchmark's ranges, on the host's wall clock in ns."""
    import torch
    from torch.autograd import DeviceType

    with torch.profiler.record_function(CLOCK_RANGE):
        stamp = time.time_ns()
    prof.stop()
    device, ranges, offset = [], [], None
    for event in prof.profiler.kineto_results.events():
        name = event.name()
        ours = name.startswith(RANGE_PREFIX)
        if event.device_type() == DeviceType.CUDA:
            # The profiler mirrors each host range on the card's timeline
            # as an annotation around its kernels: not device work.
            if not ours:
                device.append((name, event.start_ns(), event.end_ns(), event.device_index()))
        elif name == CLOCK_RANGE:
            offset = stamp - event.start_ns()
        elif ours:
            ranges.append((name, event.start_ns(), event.end_ns()))
    if offset is None:
        raise RuntimeError("the profiler lost its clock range")
    return {
        "device": [(n, s + offset, e + offset, c) for n, s, e, c in device],
        "ranges": [(n, s + offset, e + offset) for n, s, e in ranges],
    }


def rank_start() -> bool:
    """In a rank: start this rank's profiler."""
    global _rank_profiler
    _rank_profiler = start()
    return True


def rank_stop() -> dict:
    """In a rank: stop the profiler and hand back its trace."""
    global _rank_profiler
    prof, _rank_profiler = _rank_profiler, None
    return collect(prof) if prof is not None else {"device": [], "ranges": []}


def rank_memory_peak() -> list:
    """In a rank: ``[device string, peak bytes]`` of its allocator."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return ["cpu", 0]
    index = torch.cuda.current_device()
    return [f"cuda:{index}", int(torch.cuda.max_memory_allocated(index))]


def _union(intervals: list) -> list:
    merged: list = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def _is_kernel(name: str) -> bool:
    return not name.startswith(_NOT_KERNELS)


@dataclass
class DeviceTrace:
    """The window's device activity on one timeline."""

    window_s: float
    #: Seconds in which some operation ran on a card, averaged over cards.
    busy_s: float
    #: (name, seconds) of device operations, the longest first.
    ops: list = field(default_factory=list)
    #: (what the host was in, seconds) of the idle time, the longest first.
    idle_gaps: list = field(default_factory=list)
    #: The benchmark's ranges by name (without the prefix): [(start, end)] ns.
    ranges: dict = field(default_factory=dict)
    #: Kernels only: (start_ns, end_ns), sorted.
    kernels: list = field(default_factory=list)
    #: Device operations inside the window, by process (this one first).
    in_window: list = field(default_factory=list)

    def kernel_s_in(self, range_name: str) -> Optional[float]:
        """Device seconds of the kernels that started inside the ranges
        named ``range_name``; None where there is no such range."""
        spans = self.ranges.get(range_name)
        if not spans:
            return None
        import bisect

        starts = [k[0] for k in self.kernels]
        total = 0
        for lo, hi in spans:
            i = bisect.bisect_left(starts, lo)
            while i < len(self.kernels) and self.kernels[i][0] <= hi:
                total += self.kernels[i][1] - self.kernels[i][0]
                i += 1
        return total / 1e9

    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0:
            return None
        return max(0.0, 1.0 - self.busy_s / self.window_s)


def merge(main: dict, ranks: list, cards: int) -> DeviceTrace:
    """The window's trace from the benchmark process's and the ranks'. The
    window is the benchmark's ``window`` range; activity outside it is
    clipped. Busy time is each card's union of every process's activity
    on it, averaged over ``cards``."""
    windows = [(s, e) for n, s, e in main["ranges"] if n == WINDOW_RANGE]
    if not windows:
        raise ValueError("the trace holds no window range")
    lo, hi = windows[0]
    per_process = [
        [(name, max(s, lo), min(e, hi), card)
         for name, s, e, card in trace["device"] if e > lo and s < hi]
        for trace in [main, *ranks]
    ]
    events = [event for process in per_process for event in process]
    busy_ns = 0
    for card in {c for *_, c in events}:
        busy_ns += sum(e - s for s, e in _union([(s, e) for _, s, e, c in events
                                                 if c == card and e > s]))
    # The gaps are those of the cards' activity taken together.
    busy = _union([(s, e) for _, s, e, _ in events if e > s])
    by_name: dict = {}
    for name, s, e, _ in events:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ranges: dict = {}
    for name, s, e in main["ranges"]:
        if name != WINDOW_RANGE:
            ranges.setdefault(name[len(RANGE_PREFIX):], []).append((s, e))
    # Each idle gap goes to the innermost range of the benchmark's process
    # around its middle: what the host was doing while the card waited.
    # One sweep over range edges and gap middles; the ranges nest.
    marks = []
    edge = lo
    for start, end in [*busy, [hi, hi]]:
        if start > edge:
            marks.append(((edge + start) // 2, 1, start - edge))
        edge = max(edge, end)
    for name, spans in ranges.items():
        for s, e in spans:
            marks.append((s, 0, name))
            marks.append((e, 2, name))
    gaps: dict = {}
    open_ranges: list = []
    for _, kind, what in sorted(marks, key=lambda m: (m[0], m[1])):
        if kind == 0:
            open_ranges.append(what)
        elif kind == 2:
            if what in open_ranges:
                del open_ranges[len(open_ranges) - 1 - open_ranges[::-1].index(what)]
        else:
            owner = open_ranges[-1] if open_ranges else "outside_spans"
            gaps[owner] = gaps.get(owner, 0) + what
    return DeviceTrace(
        window_s=(hi - lo) / 1e9,
        busy_s=busy_ns / 1e9 / max(1, cards),
        ops=sorted(((n, t / 1e9) for n, t in by_name.items()), key=lambda x: -x[1]),
        idle_gaps=sorted(((n, t / 1e9) for n, t in gaps.items()), key=lambda x: -x[1]),
        ranges=ranges,
        kernels=sorted((s, e) for n, s, e, _ in events if _is_kernel(n)),
        in_window=[len(process) for process in per_process],
    )
