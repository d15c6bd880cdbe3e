"""The port's JSON patch (``kube/fake.py``) held to the JAX package's.

Every case of ``tests/test_json_patch.py`` runs here once more, with the JAX
in-memory cluster and the port's in lockstep
(``tests/torch_cluster_twins.py``): each call's result, arguments after
the call and error, and at the end each cluster's store, journal,
revision and subscriber streams, are compared; the case's own assertions
read the JAX side.
"""

import pytest

import test_json_patch
from torch_cluster_twins import adopt_cases, twin_world

adopt_cases(test_json_patch, globals())


@pytest.fixture(autouse=True)
def twins(twin_world):
    return twin_world
