"""The benchmark of the PyTorch/CUDA port, ``k8s_operator_libs_tpu_torch``.

One command runs one cell of ``BENCHMARK.json`` once and prints one JSON
line::

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``;
a configuration's ``system`` names its driver, ``drivers/<system>.py``.
``reference/`` holds the plain reference (NumPy and plain torch), which
imports nothing of the port, and ``checks.py`` the comparison that decides
``correct``. Nothing here imports JAX or the JAX package.
"""
