"""The port's server and in-memory cluster held to the JAX package's:
watch bookmarks.

Every case of ``tests/test_bookmarks.py`` runs here once more. The
``LocalApiServer`` the case starts is the port's, serving twin clusters
(``tests/torch_cluster_twins.py``: the JAX ``FakeCluster`` and the
port's in lockstep, every call's result and error compared, the stores
and journals at the end); the case's own assertions, made in process and
over HTTP through the JAX client, read the port's server.
"""

import pytest

import test_bookmarks
from torch_cluster_twins import adopt_cases, twin_world

adopt_cases(test_bookmarks, globals(), server=True)


@pytest.fixture(autouse=True)
def twins(twin_world):
    return twin_world
