"""The device probes: matmul and flash attention around hand-written CUDA
kernels (``csrc/``), the probe harness and the attention oracles."""
