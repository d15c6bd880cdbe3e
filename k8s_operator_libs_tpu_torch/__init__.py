"""k8s_operator_libs_tpu_torch — the device side of ``k8s_operator_libs_tpu``
in PyTorch and CUDA, for NVIDIA Hopper cards.

The JAX package runs the post-upgrade health battery on a TPU; this package
runs the same battery on an H100 and prints reports of the same shape, so
the control plane reads either. Each module sits at the same relative path
as its JAX counterpart and keeps its public names. The package imports
``torch``, never ``jax``, and nothing of ``k8s_operator_libs_tpu``.

Layout:

* ``api``    — the NodeHealthReport contract: metric keys, score, trend,
  the link map and its fold.
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
  subprocess gate; the GPU device class (detector, driver DaemonSet,
  validation pod); the slice-aware planner, the health monitor and the
  slice probe gang.
* ``policy`` — the upgrade policies the planner's budget and order use.
* ``upgrade`` — the rolling-upgrade state machine
  (``ClusterUpgradeStateManager`` and its cordon, drain, pod, validation
  and safe-load managers; the requestor mode, the checkpoint and
  quarantine arcs), its snapshot sources (LIST, informer, incremental)
  and write batcher, the upgrade keys and states, and a metrics endpoint.
* ``crdutil`` — apply and delete CustomResourceDefinitions, waiting on
  API discovery; ``python -m k8s_operator_libs_tpu_torch.crdutil``.
* ``kube`` — object views, API errors, the drain helper, Events, label
  and field selectors, a minimal REST client and the informer.
* ``utils``  — logging, device resolution, int-or-percent values, per-node
  locks, the wall clock of the durable deadlines and the fault points.
* ``tools``  — ``kernel_ab``: this checkout's kernels timed beside another
  checkout's on one card.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
