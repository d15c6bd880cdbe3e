"""The GPU device class: the health gate (``tpu/health.py``), the node
detector, the NVIDIA driver DaemonSet manager and the validation pod, at
the JAX package's paths.

Names are exported lazily: ``python -m k8s_operator_libs_tpu_torch.tpu.health``
runs the module as ``__main__``, and a package that imported it here would
load it twice.
"""

import importlib

_EXPORTS = {
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
