"""The health gate (``tpu/health.py``), at the JAX package's path.

Import-light: ``python -m k8s_operator_libs_tpu_torch.tpu.health`` runs the
module as ``__main__``, and a package that imported it here would load it
twice.
"""
