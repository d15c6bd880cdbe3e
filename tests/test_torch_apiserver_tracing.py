"""The port's server-side spans (``server.request``, ``apf.queue``) held
to what the JAX package's wire-propagation cases ask.

Every case of ``tests/test_tracing.py``'s ``TestWirePropagation`` runs
here once more with the port's ``LocalApiServer`` serving twin clusters
(``tests/torch_cluster_twins.py``). The case's tracer is installed in
both packages' ``utils/tracing``, so the JAX client's spans and the port
server's land in the one flight recorder the case reads.
"""

import pytest

import test_tracing
from k8s_operator_libs_tpu.utils import tracing as jax_tracing
from k8s_operator_libs_tpu_torch.utils import tracing as port_tracing
from torch_cluster_twins import adopt_cases, twin_world

adopt_cases(test_tracing, globals(), server=True, only=["TestWirePropagation"])


@pytest.fixture
def tracer():
    t = jax_tracing.Tracer()
    jax_tracing.install_tracer(t)
    port_tracing.install_tracer(t)
    try:
        yield t
    finally:
        port_tracing.clear_tracer()
        jax_tracing.clear_tracer()


@pytest.fixture(autouse=True)
def twins(twin_world):
    return twin_world
