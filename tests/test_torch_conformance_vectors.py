"""The port's server and in-memory cluster held to the JAX package's:
conformance vectors (strategic merge, custom-resource 415, watch sequences).

Every case of ``tests/test_conformance_vectors.py`` runs here once more. The
``LocalApiServer`` the case starts is the port's, serving twin clusters
(``tests/torch_cluster_twins.py``: the JAX ``FakeCluster`` and the
port's in lockstep, every call's result and error compared, the stores
and journals at the end); the case's own assertions, made in process and
over HTTP through the JAX client, read the port's server.
"""

import pytest

import test_conformance_vectors
from torch_cluster_twins import adopt_cases, twin_world

adopt_cases(test_conformance_vectors, globals(), server=True)


@pytest.fixture(autouse=True)
def twins(twin_world):
    return twin_world
