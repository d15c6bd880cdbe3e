"""The GPU device class: the health gate (``tpu/health.py``), the node
detector, the NVIDIA driver DaemonSet manager, the validation pod, the
slice-aware planner, the health monitor and the slice probe gang, at the
JAX package's paths.

Names are exported lazily: ``python -m k8s_operator_libs_tpu_torch.tpu.health``
(or ``.monitor``) runs the module as ``__main__``, and a package that
imported it here would load it twice.
"""

import importlib

_EXPORTS = {
    "DisruptionStats": "planner",
    "SliceAssessment": "planner",
    "SliceAwareInplaceManager": "planner",
    "SliceAwareRequestorManager": "planner",
    "assess_slices": "planner",
    "disruption_stats": "planner",
    "enable_slice_aware_planning": "planner",
    "start_slices_within_budget": "planner",
    "ICI_HEALTHY_CONDITION": "monitor",
    "MonitorMetrics": "monitor",
    "ReportPublisher": "monitor",
    "TpuHealthMonitor": "monitor",
    "make_quick_probe_guard": "monitor",
    "run_quick_probe_loop": "monitor",
    "tpu_chips_busy": "monitor",
    "SliceProbeGangManager": "slice_gate",
    "SliceProbeSpec": "slice_gate",
    "make_validation_provisioner": "slice_gate",
    "slice_slug": "slice_gate",
    "HealthGate": "health",
    "HealthReport": "health",
    "IciHealthGate": "health",
    "SliceScopedGate": "health",
    "SubprocessHealthGate": "health",
    "cache_warmup_hook": "health",
    "LibtpuDaemonSetManager": "libtpu",
    "LibtpuSpec": "libtpu",
    "TpuNodeDetector": "detector",
    "TpuNodeInfo": "detector",
    "ValidationPodManager": "validation_pod",
    "ValidationPodSpec": "validation_pod",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{module}", __name__), name)
