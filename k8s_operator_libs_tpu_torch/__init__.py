"""k8s_operator_libs_tpu_torch — the device side of ``k8s_operator_libs_tpu``
in PyTorch and CUDA, for NVIDIA Hopper cards.

The JAX package runs the post-upgrade health battery on a TPU; this package
runs the same battery on an H100 and prints reports of the same shape, so
the control plane reads either. Each module sits at the same relative path
as its JAX counterpart and keeps its public names. The package imports
``torch``, never ``jax``, and nothing of ``k8s_operator_libs_tpu``.

Layout:

* ``api``    — the telemetry metric keys the health report emits.
* ``ops``    — the probes: the collective battery (NCCL), the matmul
  probe around a hand-written CUDA matmul kernel, the flash-attention
  probe around a hand-written CUDA flash kernel (``ops/csrc``), ring and
  Ulysses attention, the probe harness with the quick battery, and the
  attention oracles.
* ``models`` — the burn-in transformer the gate trains for two steps,
  sharded dp x tp over the cards.
* ``parallel`` — the world of rank processes, one a card, and the process
  groups of its mesh axes.
* ``tpu``    — the health gate (``tpu/health.py``), its CLI payload and the
  subprocess gate.
* ``utils``  — logging and device resolution.
* ``tools``  — ``kernel_ab``: this checkout's kernels timed beside another
  checkout's on one card.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
