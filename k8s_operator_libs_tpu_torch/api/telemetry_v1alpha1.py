"""Metric keys of the NodeHealthReport contract (v1alpha1).

Only the keys ``HealthReport.observation()`` emits. The strings are the
contract's own, so a report from this package lands in the same
``status.metrics`` slots as one from the JAX package.
"""

METRIC_RING_GBYTES_PER_S = "ring_gbytes_per_s"
METRIC_PROBE_LATENCY_S = "probe_latency_s"
METRIC_TOKENS_PER_S = "tokens_per_s"
METRIC_MXU_TFLOPS = "mxu_tflops"
METRIC_WORST_LINK_GBYTES_PER_S = "worst_link_gbytes_per_s"
METRIC_WORST_LINK_LATENCY_S = "worst_link_latency_s"
