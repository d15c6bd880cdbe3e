"""The port's server-side priority and fairness, delta lists and field
selectors, held to the JAX package's.

Every case of ``tests/test_watchhub.py``'s ``TestApf``, ``TestDeltaList``
and ``TestServerSideFieldSelectors`` runs here once more with the port's
``LocalApiServer``, ``ApfConfig``, ``FlowConfig`` and ``classify_flow``
(the last run on both packages and compared); the server serves twin
clusters (``tests/torch_cluster_twins.py``) and the cases drive it with
the JAX client and informers.
"""

import pytest

import test_watchhub
from torch_cluster_twins import adopt_cases, twin_world

adopt_cases(test_watchhub, globals(), server=True,
            only=["TestApf", "TestDeltaList", "TestServerSideFieldSelectors"])


@pytest.fixture(autouse=True)
def twins(twin_world):
    return twin_world
