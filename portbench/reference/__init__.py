"""The plain reference: NumPy and plain torch, frozen here.

It imports neither JAX nor anything of the port, and takes nothing the
port has made: the benchmark makes each input from the seed
(``inputs.py``) and hands the same to the port and to the reference.
``matmul``, ``attention`` and ``burnin`` compute what the gate's probes
compute, in float64; each also has a ``control``, the same computation in
the precision below the one the configuration states, which the limits
of ``checks.py`` must fail. ``guarantees`` checks a roll's observations
against the upgrade policy.
"""
