"""The port's spans and the device trace share one clock.

The port's tracer stamps spans with ``faultpoints.wall_now()``
(``time.time`` with no virtual clock installed), in seconds; ``devtrace``
moves each profiler's events onto ``time.time_ns``. A span's seconds times
1e9 are therefore on the trace's timeline with no offset of their own.
"""

from __future__ import annotations

import time

import pytest
import torch

from k8s_operator_libs_tpu_torch.utils import tracing
from portbench import devtrace

#: How far a range may stand outside the span it was opened in: the
#: rounding of a span's stamps (1 us) and the profiler's own entry.
SLACK_NS = 1_000_000


@pytest.fixture
def tracer():
    installed = tracing.Tracer()
    tracing.install_tracer(installed)
    try:
        yield installed
    finally:
        tracing.clear_tracer()


@pytest.mark.filterwarnings("ignore:CUDA is not available")
def test_a_range_inside_a_port_span_lies_inside_it_on_the_trace_timeline(tracer):
    prof = devtrace.start()
    with tracing.span("flash.oracle", "probe"):
        time.sleep(0.002)
        with torch.profiler.record_function(devtrace.RANGE_PREFIX + "inner"):
            time.sleep(0.010)
        time.sleep(0.002)
    trace = devtrace.collect(prof)
    (span,) = tracer.records()
    ((_, start_ns, end_ns),) = [r for r in trace["ranges"]
                                if r[0] == devtrace.RANGE_PREFIX + "inner"]
    assert end_ns - start_ns >= 10_000_000
    assert span["start"] * 1e9 - SLACK_NS <= start_ns
    assert end_ns <= span["end"] * 1e9 + SLACK_NS
